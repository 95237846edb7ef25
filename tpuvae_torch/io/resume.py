"""Resumable extraction: shard manifest + already-done detection (own copy
of ``tpuvae/io/resume.py``, same shard and manifest format: a run begun by
one package is resumed by the other).

The reference only skip-and-tallies bad clips; a crash loses the whole
run.  Here each flushed device batch is persisted as a shard ``.npz`` keyed
by file ids, with a manifest recording completed ids — re-running the same
preprocess resumes after the last shard instead of re-extracting
everything.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class ExtractionManifest:
    def __init__(self, out_dir: str | Path):
        self.dir = Path(out_dir) / "shards"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "manifest.json"
        if self.path.exists():
            state = json.loads(self.path.read_text())
        else:
            state = {"shards": [], "done_ids": []}
        self.shards: list[str] = state["shards"]
        self.done_ids: set[str] = set(state["done_ids"])

    def filter_pending(self, entries):
        """Entries not yet covered by a shard."""
        return [e for e in entries if e.file_id not in self.done_ids]

    def add_shard(self, file_ids: list[str], arrays: dict[str, np.ndarray]) -> None:
        name = f"shard_{len(self.shards):05d}.npz"
        np.savez(self.dir / name, file_ids=np.array(file_ids), **arrays)
        self.shards.append(name)
        self.done_ids.update(file_ids)
        self.path.write_text(json.dumps(
            {"shards": self.shards, "done_ids": sorted(self.done_ids)}
        ))

    def iter_shards(self):
        """Yield ``(file_ids, arrays)`` per shard in manifest order — one
        shard resident at a time (the streaming-assembly read path)."""
        for name in self.shards:
            with np.load(self.dir / name, allow_pickle=True) as z:
                ids = z["file_ids"].tolist()
                arrays = {k: z[k] for k in z.files if k != "file_ids"}
            yield ids, arrays

    def total_rows(self) -> int:
        return len(self.done_ids)

    def load_all(self, keys=None) -> tuple[list[str], dict[str, np.ndarray]]:
        """Concatenate all shards in manifest order → (file_ids, arrays);
        with ``keys``, only those arrays are read."""
        ids: list[str] = []
        parts: dict[str, list[np.ndarray]] = {}
        for name in self.shards:
            with np.load(self.dir / name, allow_pickle=True) as z:
                ids.extend(z["file_ids"].tolist())
                for k in z.files:
                    if k != "file_ids" and (keys is None or k in keys):
                        parts.setdefault(k, []).append(z[k])
        return ids, {k: np.concatenate(v) for k, v in parts.items()}

    def cleanup(self) -> None:
        """Remove shards after the final artifacts are written."""
        for name in self.shards:
            (self.dir / name).unlink(missing_ok=True)
        self.path.unlink(missing_ok=True)
        try:
            self.dir.rmdir()
        except OSError:
            pass
