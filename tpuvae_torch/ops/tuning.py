"""Fused per-clip chroma tuning estimation (kernel 2 and its plain version).

Counterpart of ``tpuvae/ops/tuning.py``: librosa's ``estimate_tuning`` per
clip — piptrack on the 150-4000 Hz band, the exact masked median of the
candidate magnitudes, and the 100-bin residual vote — from the fused STFT
kernel's power spectrogram ``(B, n_fft//2+1, T)`` (bf16 or fp32) and its
per-frame max ``colmax (B, T)``.

On a CUDA tensor the CUDA kernel ``csrc/tuning.cu`` runs (a cluster of
``CLUSTER`` CTAs per clip, each over a slice of the frames); on a CPU
tensor the plain PyTorch version does, built from the staged pieces of
:mod:`tpuvae_torch.dsp.chroma`.  The two are bit-equal.
The port's power layout has exactly ``T`` frames and ``n_fft//2+1`` rows,
so the TPU layout's pad frames and mirror bins do not arise here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpuvae_torch.dsp.primitives import fft_frequencies
from tpuvae_torch.ops import _build

TUNING = _build.Kernel(
    "tuning", "tuning", "tpuvae_tuning",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
# CTAs per clip of csrc/tuning.cu, and the most candidate-list entries one of
# them keeps in shared memory (kCluster, kSmemListEntries there; the kernel
# refuses a launch whose global lists are shorter than its own geometry
# needs, or whose lists would not fit its shared memory)
CLUSTER = 8
SMEM_LIST_ENTRIES = 44000


def list_geometry(t: int, r8: int) -> tuple[int, int]:
    """``(frames per CTA, list capacity per CTA)`` of the kernel for ``t``
    frames and an ``r8``-row band: a frame holds at most ``ceil(r8 / 2)``
    candidates, since rows ``r`` and ``r + 1`` are never both local maxima
    (``st[r] > st[r-1]`` and ``st[r] >= st[r+1]``) and row 0 never is."""
    frames = max(1, -(-t // CLUSTER))
    return frames, frames * -(-r8 // 2)


@functools.lru_cache(maxsize=8)
def _tuning_consts(sr: int, n_fft: int, n_rows_total: int, resolution: float):
    """``(lo8, r8, fmask (r8,), binsb (r8,), edges (n_bins,), n_bins, binw)``
    (``tpuvae/ops/tuning.py:475``): the 8-aligned candidate band, its
    frequency mask and global bin indices, and the vote's bin edges."""
    from tpuvae_torch.dsp.chroma import (
        PIPTRACK_FMAX,
        PIPTRACK_FMIN,
        piptrack_band,
    )

    lo, hi = piptrack_band(sr, n_fft, n_rows_total)
    freqs = fft_frequencies(sr, n_fft)
    lo8 = (lo // 8) * 8
    r8 = -(-(hi - lo8) // 8) * 8
    idx = lo8 + np.arange(r8)
    band_freqs = freqs[np.minimum(idx, n_rows_total - 1)]
    valid = idx < n_rows_total
    fmask = ((band_freqs >= PIPTRACK_FMIN) & (band_freqs < PIPTRACK_FMAX)
             & valid).astype(np.float32)
    binsb = idx.astype(np.float32)
    n_bins = int(np.ceil(1.0 / resolution))
    edges = np.linspace(-0.5, 0.5, n_bins + 1, dtype=np.float32)
    binw = float(edges[1] - edges[0])
    return lo8, r8, fmask, binsb, edges[:n_bins], n_bins, binw


@functools.lru_cache(maxsize=8)
def _device_consts(device: str, sr: int, n_fft: int, n_rows: int,
                   resolution: float):
    lo8, r8, fmask, binsb, edges, n_bins, binw = _tuning_consts(
        sr, n_fft, n_rows, resolution)
    if lo8 + r8 > n_rows:
        # the 8-aligned band would read past the last row: clamp (every
        # in-mask row and its margin neighbours still lie inside)
        r8 = n_rows - lo8
        fmask, binsb = fmask[:r8], binsb[:r8]
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return lo8, r8, as_t(fmask), as_t(binsb), as_t(edges), n_bins, binw


def _check(power: torch.Tensor, colmax: torch.Tensor, n_fft: int) -> None:
    if power.dim() != 3 or power.shape[1] != n_fft // 2 + 1:
        raise ValueError(f"power must be (B, {n_fft // 2 + 1}, T), got "
                         f"{tuple(power.shape)}")
    if power.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"power must be float32 or bfloat16, got {power.dtype}")
    if colmax.shape != (power.shape[0], power.shape[2]):
        raise ValueError(f"colmax must be (B, T) = "
                         f"{(power.shape[0], power.shape[2])}, got "
                         f"{tuple(colmax.shape)}")
    if colmax.dtype != torch.float32:
        raise ValueError(f"colmax must be float32, got {colmax.dtype}")
    if colmax.device != power.device:
        raise ValueError("power and colmax must be on one device")


def estimate_tuning_plain(power: torch.Tensor, colmax: torch.Tensor, sr: int,
                          n_fft: int, resolution: float = 0.01,
                          bins_per_octave: int = 12) -> torch.Tensor:
    """Plain version of kernel 2: piptrack candidates, plain exact masked
    median, histogram vote -> ``(B,)`` tunings."""
    from tpuvae_torch.dsp.chroma import (
        _masked_median,
        _tuning_candidates,
        _tuning_vote,
    )

    _check(power, colmax, n_fft)
    pitches, mags, mask = _tuning_candidates(power.float(), sr, n_fft, colmax)
    thresh = _masked_median(mags, mask)
    return _tuning_vote(pitches, mags, mask, thresh, resolution,
                        bins_per_octave)


def estimate_tuning(power: torch.Tensor, colmax: torch.Tensor, sr: int,
                    n_fft: int, resolution: float = 0.01,
                    bins_per_octave: int = 12) -> torch.Tensor:
    """Batched fused tuning estimation ``(B, n_fft//2+1, T) -> (B,)``.

    Same function as ``tpuvae.ops.tuning.estimate_tuning_pallas`` given the
    per-frame max power ``colmax``.  A CUDA tensor goes through the CUDA
    kernel (or raises); a CPU tensor through :func:`estimate_tuning_plain`.
    The kernel replaces ``tpuvae/ops/tuning.py:352`` / ``:367``; it is
    bound by the bytes of the band it must read.  Each CTA compacts its
    candidates into shared memory, or, when a clip's frames need more than
    ``SMEM_LIST_ENTRIES`` a CTA, into a global buffer allocated here.
    """
    _check(power, colmax, n_fft)
    if power.device.type == "cpu":
        return estimate_tuning_plain(power, colmax, sr, n_fft, resolution,
                                     bins_per_octave)
    if power.device.type != "cuda":
        raise ValueError(f"unsupported device {power.device}")
    if not (power.is_contiguous() and colmax.is_contiguous()):
        raise ValueError("power and colmax must be contiguous")
    from tpuvae_torch.dsp.chroma import PIPTRACK_THRESHOLD

    b, n_rows, t = power.shape
    lo8, r8, fmask, binsb, edges, n_bins, binw = _device_consts(
        str(power.device), sr, n_fft, n_rows, resolution)
    out = torch.empty((b,), dtype=torch.float32, device=power.device)
    frames, capacity = list_geometry(t, r8)
    keys_g = buckets_g = None
    list_entries = 0
    if capacity > SMEM_LIST_ENTRIES and b:
        list_entries = b * CLUSTER * capacity
        keys_g = torch.empty((list_entries,), dtype=torch.int32,
                             device=power.device)
        buckets_g = torch.empty((list_entries,), dtype=torch.uint8,
                                device=power.device)
    TUNING(_build.ptr(power), int(power.dtype == torch.bfloat16),
           _build.ptr(colmax), b, n_rows, t, lo8, r8, _build.ptr(fmask),
           _build.ptr(binsb), _build.ptr(edges), n_bins, binw,
           float(sr) / n_fft, float(bins_per_octave), PIPTRACK_THRESHOLD,
           frames, capacity,
           None if keys_g is None else _build.ptr(keys_g),
           None if buckets_g is None else _build.ptr(buckets_g),
           list_entries, _build.ptr(out), _build.stream_ptr(power.device))
    return out
