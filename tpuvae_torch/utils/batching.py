"""Batched application of a device function over host arrays
(counterpart of ``tpuvae/utils/batching.py``).

The JAX version pads the ragged final chunk so XLA compiles one executable
per geometry; PyTorch runs eagerly, so the last chunk runs at its own size.
"""

from __future__ import annotations

import numpy as np
import torch


def batched_apply(fn, arrays, batch_size: int = 32) -> np.ndarray:
    """Apply ``fn(*chunks) -> (B, ...)`` over ``arrays`` in batches of at
    most ``batch_size`` rows; returns the concatenated host result."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    n = arrays[0].shape[0]
    outs = []
    for i in range(0, n, batch_size):
        out = fn(*[a[i : i + batch_size] for a in arrays])
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        outs.append(np.asarray(out))
    return np.concatenate(outs)
