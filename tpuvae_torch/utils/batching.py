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


class RowView:
    """Lazy row view over a host array for streamed training and encoding
    (``tpuvae/utils/batching.py:37``).

    Composes an optional row subset (train/val split indices) and an
    optional trailing channel axis without materialising the base array: an
    ``np.memmap`` stays on disk.  ``fit(host_stream=True)`` and
    :func:`batched_apply` only read ``.shape`` / ``len()`` and take small
    row batches through ``__getitem__`` (slice or integer array), each
    returned as a float32 ndarray, so peak host memory is one batch.
    """

    def __init__(self, base, rows=None, add_channel: bool = False,
                 dtype=np.float32):
        self.base = base
        self.rows = None if rows is None else np.asarray(rows)
        self.add_channel = bool(add_channel)
        self.dtype = np.dtype(dtype)

    @property
    def shape(self) -> tuple:
        n = len(self.rows) if self.rows is not None else self.base.shape[0]
        s = (n,) + tuple(self.base.shape[1:])
        return s + (1,) if self.add_channel else s

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key) -> np.ndarray:
        sel = self.rows[key] if self.rows is not None else key
        out = np.asarray(self.base[sel], dtype=self.dtype)
        return out[..., None] if self.add_channel else out
