"""Checkpoints (counterpart of ``tpuvae/train/checkpoint.py``).

A checkpoint directory holds ``weights.npz`` (flax variables flattened to
``"params/..."`` / ``"batch_stats/..."`` keys) and ``metadata.json``; both
read and write without flax, so ``tpuvae.train.checkpoint.load_checkpoint``
reads what the port writes and the reverse.
:mod:`tpuvae_torch.convert` maps the flat dict onto the port's modules.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from torch import nn

from tpuvae_torch.convert import simple_vae_to_flax


def load_checkpoint(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """``(flat variables, metadata)`` of the checkpoint at ``path``."""
    path = Path(path)
    with np.load(path / "weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    metadata = json.loads((path / "metadata.json").read_text())
    return flat, metadata


def save_checkpoint(path: str | Path, model: nn.Module,
                    metadata: dict | None = None) -> None:
    """Write a SimpleVAE's weights and BatchNorm statistics in the flax
    layout, and ``metadata``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "weights.npz", **simple_vae_to_flax(model.state_dict()))
    (path / "metadata.json").write_text(json.dumps(metadata or {}, default=str))
