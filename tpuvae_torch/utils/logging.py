"""Structured run logging (counterpart of ``tpuvae/utils/logging.py``):
JSONL event records, one line per event, to a stream and/or a file."""

from __future__ import annotations

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
        stream: TextIO = sys.stderr,
    ):
        self._fh = open(path, "a") if path else None
        self._echo = echo
        self._stream = stream
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec, default=str)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=self._stream)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
