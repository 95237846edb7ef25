"""Chroma features with per-clip tuning estimation (own copy of
``tpuvae/dsp/chroma.py``, batched over clips).

Replicates ``librosa.feature.chroma_stft(tuning=None)``: piptrack pitch
candidates, the exact masked-median magnitude threshold, the 100-bin
residual vote, then the tuning-dependent chroma filterbank.  Two routes
estimate the tuning, as in the JAX package:

* ``'fused'`` (the main path): kernel 2, :func:`tpuvae_torch.ops.tuning.estimate_tuning`;
* ``'staged'``: candidates here, the median through kernel 3
  (:func:`tpuvae_torch.ops.select.masked_median_batch`), the vote here —
  ``tpuvae/dsp/chroma.py:313-329``.

Every step keeps the JAX package's float32 operation order, so the staged
pieces, the plain kernel versions and the CUDA kernels agree bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuvae_torch.dsp.primitives import fft_frequencies, normalize_inf

# librosa piptrack defaults, shared with ops/tuning.py
PIPTRACK_FMIN = 150.0
PIPTRACK_FMAX = 4000.0
PIPTRACK_THRESHOLD = 0.1

TUNING_ROUTES = ("fused", "staged")


def piptrack_band(sr: int, n_fft: int, n_rows: int) -> tuple[int, int]:
    """[lo, hi) row bounds of the piptrack candidate band, with one margin
    row each side for the local-max / parabolic-interpolation neighbours."""
    freqs = fft_frequencies(sr, n_fft)
    lo = max(int(np.searchsorted(freqs, PIPTRACK_FMIN, side="left")) - 1, 0)
    hi = min(int(np.searchsorted(freqs, PIPTRACK_FMAX, side="left")) + 1,
             n_rows)
    return lo, hi


def _localmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """librosa.util.localmax: strictly greater than left, >= right (edge pad)."""
    x = torch.movedim(x, dim, 0)
    left = torch.cat([x[:1], x[:-1]], dim=0)
    right = torch.cat([x[1:], x[-1:]], dim=0)
    return torch.movedim((x > left) & (x >= right), 0, dim)


def piptrack_from_power(s: torch.Tensor, sr: int, n_fft: int,
                        ref_value: torch.Tensor, row_offset: int = 0):
    """librosa.piptrack on a band of rows ``s (B, R, T)`` (global rows
    ``row_offset ..``) with the per-frame threshold ``ref_value (B, 1, T)``
    taken over the full column -> ``(pitches, mags)``, zero off the mask."""
    up, dn = s[:, 2:], s[:, :-2]
    avg = 0.5 * (up - dn)
    shift_den = 2 * s[:, 1:-1] - up - dn
    tiny = float(np.finfo(np.float32).tiny)
    shift = avg / (shift_den + (torch.abs(shift_den) < tiny).to(s.dtype))
    pad = (0, 0, 1, 1)
    avg = torch.nn.functional.pad(avg, pad)
    shift = torch.nn.functional.pad(shift, pad)
    dskew = 0.5 * avg * shift

    n_rows = s.shape[1]
    freqs = fft_frequencies(sr, n_fft)[row_offset : row_offset + n_rows]
    freq_mask = torch.from_numpy(
        (PIPTRACK_FMIN <= freqs) & (freqs < PIPTRACK_FMAX)).to(s.device)
    mask = freq_mask[None, :, None] & _localmax(s * (s > ref_value), dim=1)

    bins = (row_offset + torch.arange(n_rows, dtype=torch.float32,
                                      device=s.device))[None, :, None]
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    pitches = torch.where(mask, (bins + shift) * (sr / n_fft), zero)
    mags = torch.where(mask, s + dskew, zero)
    return pitches, mags


def _tuning_candidates(s_power: torch.Tensor, sr: int, n_fft: int,
                       colmax: torch.Tensor | None = None):
    """Banded piptrack candidates ``(pitches, mags, mask)``, each
    ``(B, R, T)``, for fp32 power ``(B, n_bins, T)``.  ``colmax (B, T)`` is
    the per-frame max over the full column (the fused STFT kernel emits
    it); without it the max is taken here."""
    lo, hi = piptrack_band(sr, n_fft, s_power.shape[1])
    full_max = (colmax[:, None, :] if colmax is not None
                else torch.amax(s_power, dim=1, keepdim=True))
    ref_value = PIPTRACK_THRESHOLD * full_max
    pitches, mags = piptrack_from_power(s_power[:, lo:hi], sr, n_fft,
                                        ref_value, row_offset=lo)
    return pitches, mags, pitches > 0


def _masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values[b][mask[b]]`` per clip (numpy convention), 0 for
    an empty mask — plain version, through the int32 order keys."""
    from tpuvae_torch.ops.select import (
        masked_keys,
        median_from_stats,
        select_stats_plain,
    )

    b = values.shape[0]
    keys = masked_keys(values.reshape(b, -1), mask.reshape(b, -1))
    return median_from_stats(select_stats_plain(keys))


def _tuning_vote(pitches, mags, pitch_mask, thresh, resolution: float,
                 bins_per_octave: int) -> torch.Tensor:
    """Histogram vote over threshold-passing candidates -> ``(B,)`` tuning."""
    b = pitches.shape[0]
    sel = pitch_mask & (mags >= thresh.reshape(b, 1, 1))
    safe_pitch = torch.where(sel, pitches, torch.full_like(pitches, 440.0))
    # _hz_to_octs(f) = log2(16 f / 440) at tuning 0
    residual = torch.remainder(
        bins_per_octave * torch.log2(16.0 * safe_pitch / 440.0), 1.0)
    residual = torch.where(residual >= 0.5, residual - 1.0, residual)

    n_bins = int(np.ceil(1.0 / resolution))
    edges = np.linspace(-0.5, 0.5, n_bins + 1, dtype=np.float32)
    bucket = torch.clamp(
        torch.floor((residual + 0.5) / float(edges[1] - edges[0])).to(torch.int64),
        0, n_bins - 1)
    bucket = torch.where(sel, bucket, torch.full_like(bucket, n_bins))
    offs = torch.arange(b, device=bucket.device)[:, None] * (n_bins + 1)
    counts = torch.bincount((bucket.reshape(b, -1) + offs).reshape(-1),
                            minlength=b * (n_bins + 1)).reshape(b, n_bins + 1)
    arg = torch.argmax(counts[:, :n_bins], dim=1)
    tuning = torch.from_numpy(edges[:-1]).to(bucket.device)[arg]
    return torch.where(sel.reshape(b, -1).any(dim=1), tuning,
                       torch.zeros_like(tuning))


def estimate_tuning_batch(s_power: torch.Tensor, sr: int, n_fft: int,
                          colmax: torch.Tensor, resolution: float = 0.01,
                          bins_per_octave: int = 12,
                          route: str = "fused") -> torch.Tensor:
    """Batched tuning estimation ``(B, n_bins, T) -> (B,)``.

    ``route='fused'`` runs kernel 2 over the band; ``'staged'`` computes
    the candidates here and takes the median through kernel 3.  Both give
    the same tunings.
    """
    if route == "fused":
        from tpuvae_torch.ops.tuning import estimate_tuning

        return estimate_tuning(s_power, colmax, sr, n_fft, resolution,
                               bins_per_octave)
    if route != "staged":
        raise ValueError(f"route must be one of {TUNING_ROUTES}, got {route!r}")
    from tpuvae_torch.ops.select import masked_median_batch

    pitches, mags, mask = _tuning_candidates(s_power.float(), sr, n_fft,
                                             colmax)
    b = mags.shape[0]
    thresh = masked_median_batch(mags.reshape(b, -1), mask.reshape(b, -1))
    return _tuning_vote(pitches, mags, mask, thresh, resolution,
                        bins_per_octave)


@functools.lru_cache(maxsize=4)
def _chroma_fb_table(sr: int, n_fft: int, n_chroma: int,
                     resolution: float) -> np.ndarray:
    """Every chroma filterbank the tuning estimator can select
    ``(ceil(1/resolution), n_chroma, 1 + n_fft//2)``: ``estimate_tuning``
    returns one of the histogram edges, so the filterbank is a table
    lookup.  Same float32 numpy arithmetic as ``tpuvae/dsp/chroma.py:336``.
    """
    n_bins = int(np.ceil(1.0 / resolution))
    edges = np.linspace(-0.5, 0.5, n_bins + 1, dtype=np.float32)[:-1]
    ctroct, octwidth = 5.0, 2.0
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    out = np.empty((n_bins, n_chroma, 1 + n_fft // 2), np.float32)
    for i, t in enumerate(edges):
        a440 = np.float32(440.0) * np.float32(2.0) ** (
            np.float32(t) / np.float32(n_chroma))
        frqbins = np.float32(n_chroma) * np.log2(
            np.float32(16.0) * frequencies.astype(np.float32) / a440)
        frqbins = np.concatenate(
            [frqbins[:1] - np.float32(1.5 * n_chroma), frqbins])
        binwidth = np.concatenate(
            [np.maximum(frqbins[1:] - frqbins[:-1], np.float32(1.0)),
             np.ones((1,), np.float32)])
        d = frqbins[None, :] - np.arange(n_chroma, dtype=np.float32)[:, None]
        half = round(n_chroma / 2)
        d = np.remainder(d + half + 10 * n_chroma, n_chroma) - half
        wts = np.exp(np.float32(-0.5) * (2.0 * d / binwidth[None, :]) ** 2,
                     dtype=np.float32)
        length = np.sqrt(np.sum(wts ** 2, axis=0, keepdims=True))
        length = np.where(length < np.finfo(np.float32).tiny, 1.0, length)
        wts = wts / length
        wts = wts * np.exp(
            -0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)
        ).astype(np.float32)[None, :]
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
        out[i] = wts[:, : 1 + n_fft // 2]
    return out


def _tuning_grid_index(tuning_b: torch.Tensor, resolution: float):
    n_bins = int(np.ceil(1.0 / resolution))
    return torch.clamp(torch.round((tuning_b + 0.5) * n_bins).to(torch.int64),
                       0, n_bins - 1)


def chroma_batch(s_power: torch.Tensor, sr: int, n_fft: int,
                 colmax: torch.Tensor, n_chroma: int = 12,
                 tuning_route: str = "fused") -> torch.Tensor:
    """Batched chroma ``(B, n_bins, T) -> (B, n_chroma, T)`` with the tuning
    estimated per clip (librosa's ``tuning=None``).

    A bf16 spectrogram (fast mode) is projected with the filterbank rounded
    to bf16, as the JAX package does; products of two bf16 values are
    exact in fp32, and the sum runs in fp32.
    """
    resolution = 0.01
    tuning_b = estimate_tuning_batch(s_power, sr, n_fft, colmax,
                                     resolution=resolution,
                                     bins_per_octave=n_chroma,
                                     route=tuning_route)
    table = torch.from_numpy(
        _chroma_fb_table(sr, n_fft, n_chroma, resolution)).to(s_power.device)
    fb = table[_tuning_grid_index(tuning_b, resolution)]
    if s_power.dtype == torch.bfloat16:
        fb = fb.to(torch.bfloat16)
    raw = torch.bmm(fb.float(), s_power.float())
    return normalize_inf(raw, dim=1)
