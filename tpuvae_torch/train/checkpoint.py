"""Checkpoint loading (counterpart of ``tpuvae/train/checkpoint.py:195``).

A checkpoint directory holds ``weights.npz`` (flax variables flattened to
``"params/..."`` / ``"batch_stats/..."`` keys) and ``metadata.json``; both
read without flax.  :func:`tpuvae_torch.convert.simple_vae_from_flax` maps
the flat dict onto the port's modules.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load_checkpoint(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """``(flat variables, metadata)`` of the checkpoint at ``path``."""
    path = Path(path)
    with np.load(path / "weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    metadata = json.loads((path / "metadata.json").read_text())
    return flat, metadata


def save_checkpoint(path: str | Path, flat: dict[str, np.ndarray],
                    metadata: dict | None = None) -> None:
    """Write ``flat`` variables and ``metadata`` in the same layout."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "weights.npz", **flat)
    (path / "metadata.json").write_text(json.dumps(metadata or {}, default=str))
