"""Structured run logging and stage timing (counterpart of
``tpuvae/utils/logging.py``): JSONL event records, one line per event, to
a stream and/or a file, and per-stage wall-clock / throughput counters.
The JAX package's profiler hook (``TPUVAE_PROFILE_DIR``) is not ported
(ROADMAP.md, queue 1, item 9)."""

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
    """Wall-clock + items/sec counters per pipeline stage."""

    def __init__(self, logger: RunLogger | None = None):
        self.logger = logger
        self.stages: dict[str, dict[str, float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None):
        t0 = time.time()
        yield
        dt = time.time() - t0
        rec = {"seconds": dt}
        if items is not None:
            rec["items"] = items
            rec["items_per_sec"] = items / max(dt, 1e-9)
        self.stages[name] = rec
        if self.logger:
            self.logger.log("stage", name=name, **rec)
