"""Structured run logging and stage timing (counterpart of
``tpuvae/utils/logging.py``): JSONL event records, one line per event, to
a stream and/or a file, and per-stage wall-clock / throughput counters,
each stage optionally traced with ``torch.profiler`` (the preprocess
pipelines pass ``$TPUVAE_PROFILE_DIR``, which ``cli --profile`` sets)."""

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
