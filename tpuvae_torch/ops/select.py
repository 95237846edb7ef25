"""Batched masked-median order statistics (kernel 3 and its plain version).

Counterpart of ``tpuvae/ops/select.py``.  The staged tuning route
(``tpuvae_torch.dsp.chroma.estimate_tuning_batch(route='staged')``) needs
the median of the masked piptrack magnitudes per clip — an exact order
statistic over ~465 K elements.  :func:`select_stats` returns, per row of
biased int32 keys, ``(n, key_lo, cnt_le, min_above)``; the numpy-convention
median (mean of the two middles for even n, 0 for an empty mask) follows
from those four numbers in :func:`masked_median_batch`.

On a CUDA tensor the CUDA kernel ``csrc/select.cu`` runs (a cluster of
``CLUSTER`` CTAs per row, each reading its slice of the row once and
compacting the masked keys into a list, then a radix select over the
lists); on a CPU tensor the plain PyTorch version does (a sort).
"""

from __future__ import annotations

import ctypes

import torch

from tpuvae_torch.ops import _build

I32_MAX = 2**31 - 1

SELECT = _build.Kernel(
    "masked_median_select", "select", "tpuvae_masked_median_select",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_void_p])

# the kernel's cluster size and the longest list a CTA keeps in shared
# memory (csrc/select.cu holds the same numbers)
CLUSTER = 8
SMEM_LIST_ENTRIES = 27000


def slice_geometry(n_cols: int) -> tuple[int, int, int]:
    """``(slice, capacity, spill per CTA)`` of the kernel for rows of
    ``n_cols`` keys: CTA ``r`` of a row's cluster reads the keys
    ``[r slice, (r + 1) slice)`` (``slice`` a multiple of 4, so that the
    slices of an aligned row start on 16-byte boundaries); the first
    ``capacity`` keys of its list lie in shared memory and the rest, up to
    the whole slice (every key valid), in a global spill."""
    slice_ = max(4, -(-max(n_cols, 1) // (4 * CLUSTER)) * 4)
    capacity = min(slice_, SMEM_LIST_ENTRIES)
    return slice_, capacity, slice_ - capacity


def float_order_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> int32 key (``chroma._float_order_key`` of the
    JAX package, re-biased to signed order): non-negative floats keep their
    bits, negative floats flip their 31 low bits."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ I32_MAX)


def key_to_float(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ I32_MAX).view(torch.float32)


def select_stats_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 3: ``keys (B, N)`` int32 -> ``(B, 4)`` int32
    ``(n, key_lo, cnt_le, min_above)``."""
    n = (keys < I32_MAX).sum(dim=1)
    k_lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    srt = torch.sort(keys, dim=1).values
    key_lo = torch.gather(srt, 1, k_lo[:, None].long())
    cnt_le = (keys <= key_lo).sum(dim=1)
    above = torch.where(keys > key_lo, keys, torch.full_like(keys, I32_MAX))
    min_above = above.amin(dim=1)
    return torch.stack([n.to(torch.int32), key_lo[:, 0],
                        cnt_le.to(torch.int32), min_above], dim=1)


def select_stats(keys: torch.Tensor) -> torch.Tensor:
    """``(n, key_lo, cnt_le, min_above)`` per row of ``keys (B, N)`` int32.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`select_stats_plain`.  The kernel replaces
    ``tpuvae/ops/select.py:32`` (``_select_kernel``); it is bound by the
    bytes of the keys, and ``csrc/select.cu`` says how one pass over the
    keys and a radix select over the compacted lists replace the 32-round
    binary search.  Rows longer than ``CLUSTER * SMEM_LIST_ENTRIES`` keys
    get a global spill for the lists (allocated here), so the result is
    exact whatever the mask.
    """
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (B, N) int32, got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    if keys.device.type == "cpu":
        return select_stats_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    b, n = keys.shape
    out = torch.empty((b, 4), dtype=torch.int32, device=keys.device)
    slice_, capacity, spill_per_cta = slice_geometry(n)
    spill_entries = b * CLUSTER * spill_per_cta
    spill = (torch.empty((spill_entries,), dtype=torch.int32,
                         device=keys.device) if spill_per_cta and b else None)
    SELECT(_build.ptr(keys), b, n, slice_, capacity, spill_per_cta,
           None if spill is None else _build.ptr(spill), spill_entries,
           _build.ptr(out), _build.stream_ptr(keys.device))
    return out


def median_from_stats(stats: torch.Tensor) -> torch.Tensor:
    """Finish the numpy-convention median from ``select_stats`` output
    (``tpuvae/ops/select.py:119-132``); 0 where the mask is empty."""
    n_sel, key_lo, cnt_le, mn_above = stats.unbind(dim=1)
    v_lo = key_to_float(key_lo.contiguous())
    v_next = key_to_float(mn_above.contiguous())
    k_lo = torch.clamp(torch.div(n_sel - 1, 2, rounding_mode="floor"), min=0)
    k_hi = torch.clamp(torch.div(n_sel, 2, rounding_mode="floor"), min=0)
    v_hi = torch.where((k_hi == k_lo) | (cnt_le >= k_hi + 1), v_lo, v_next)
    return torch.where(n_sel > 0, 0.5 * (v_lo + v_hi),
                       torch.zeros_like(v_lo))


def masked_keys(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Biased int32 keys of ``values``, INT32_MAX where ``mask`` is off."""
    return torch.where(mask, float_order_key(values.float()),
                       torch.full(values.shape, I32_MAX, dtype=torch.int32,
                                  device=values.device))


def masked_median_batch(values: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values[b][mask[b]]`` per row (numpy convention) -> (B,),
    0 where the mask is empty."""
    return median_from_stats(select_stats(masked_keys(values, mask)))
