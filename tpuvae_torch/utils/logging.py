"""Structured run logging and stage timing (counterpart of
``tpuvae/utils/logging.py``): JSONL event records, one line per event, to
a stream and/or a file, and per-stage wall-clock / throughput counters,
each stage optionally traced with ``torch.profiler`` (the preprocess
pipelines pass ``$TPUVAE_PROFILE_DIR``, which ``cli --profile`` sets).

The port's own spans (:func:`span`, :func:`recording`) are kept in memory
while a :func:`recording` is open and cost one check of a module-level
flag otherwise.  Their clock is ``time.time_ns()``: nanoseconds since the
Unix epoch, the clock ``torch.profiler`` stamps its host and device
records with, so a span can be laid over a profiler trace."""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Any, TextIO


class RunLogger:
    """JSONL event logger (stdout and/or file)."""

    def __init__(
        self,
        path: str | Path | None = None,
        echo: bool = True,
        stream: TextIO | None = None,
    ):
        self._fh = open(path, "a") if path else None
        self._echo = echo
        # None = whatever sys.stderr is when an event is logged: a default
        # bound at import time outlives a redirected (and closed) stream
        self._stream = stream
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec, default=str)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=self._stream or sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()


class StageTimer:
    """Wall-clock + items/sec counters per pipeline stage; with
    ``profile_dir``, each stage is also traced with ``torch.profiler``
    (CPU and, where there is one, CUDA activity) into a Chrome trace
    ``<profile_dir>/<stage>-<time>.json``."""

    def __init__(self, logger: RunLogger | None = None,
                 profile_dir: str | None = None):
        self.logger = logger
        self.profile_dir = profile_dir
        self.stages: dict[str, dict[str, float]] = {}

    def _trace(self, name: str):
        if not self.profile_dir:
            return contextlib.nullcontext()
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{name}-{time.strftime('%Y%m%d-%H%M%S')}.json"
        return torch.profiler.profile(
            activities=acts,
            on_trace_ready=lambda prof: prof.export_chrome_trace(str(path)))

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None):
        t0 = time.time()
        with self._trace(name):
            yield
        dt = time.time() - t0
        rec = {"seconds": dt}
        if items is not None:
            rec["items"] = items
            rec["items_per_sec"] = items / max(dt, 1e-9)
        self.stages[name] = rec
        if self.logger:
            self.logger.log("stage", name=name, **rec)


# the open recording's spans, or None: the one flag a span checks
_SPANS: list[dict] | None = None
_OPEN: list[int] = []           # indices of the spans open, innermost last
_OFF = contextlib.nullcontext()


def span(name: str, what: str | None = None):
    """A context manager that records ``name`` from its entry to its exit
    while a :func:`recording` is open, as a dict: ``name``, ``start_ns``
    and ``end_ns`` (``time.time_ns()``), ``parent`` (the index of the span
    that encloses it in the recording, or None) and ``attrs`` (``what``
    where given).  It enters to the span's ``attrs``, to which the caller
    may add, or to None while nothing records: then the span costs the
    check of one flag, allocates nothing and reads no clock.  Spans are
    recorded from one thread."""
    if _SPANS is None:
        return _OFF
    return _recorded(_SPANS, _OPEN, name, what)


@contextlib.contextmanager
def _recorded(spans: list[dict], open_: list[int], name: str,
              what: str | None):
    attrs = {} if what is None else {"what": what}
    rec = {"name": name, "start_ns": time.time_ns(), "end_ns": None,
           "parent": open_[-1] if open_ else None, "attrs": attrs}
    open_.append(len(spans))
    spans.append(rec)
    try:
        yield attrs
    finally:
        rec["end_ns"] = time.time_ns()
        open_.pop()


@contextlib.contextmanager
def recording():
    """Record the spans opened inside; yields the list they go into, in
    the order they were opened (a span's ``parent`` indexes it).  A
    recording opened inside another takes the spans until it closes."""
    global _SPANS, _OPEN
    outer = _SPANS, _OPEN
    _SPANS, _OPEN = [], []
    try:
        yield _SPANS
    finally:
        _SPANS, _OPEN = outer
