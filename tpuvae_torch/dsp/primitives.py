"""Low-level DSP building blocks (own copy of ``tpuvae/dsp/primitives.py``).

Host constant builders in numpy (identical arithmetic to the JAX package,
so both packages see bit-identical windows and filterbanks) and the few
tensor functions the serving slice needs, in PyTorch:

  * ``hann_window``: periodic Hann window (scipy ``get_window('hann')``);
  * ``mel_filterbank``: Slaney mel scale, ``norm='slaney'``;
  * ``power_to_db``: ``10*log10(max(S, amin))`` relative to ``ref``,
    floored at ``max - top_db`` per clip;
  * ``dct_ii_ortho``: orthonormal DCT-II as a dense fp32 matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic ('fftbins') Hann window, as scipy.signal.get_window('hann', n)."""
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(dtype)


def num_frames(n_samples: int, hop_length: int) -> int:
    """Frame count of a centered STFT (librosa: ``1 + n_samples // hop``)."""
    return 1 + n_samples // hop_length


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float32)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(f, min_log_hz)
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank ``(n_mels, n_fft//2+1)``."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)),
                          _hz_to_mel(np.array(fmax)), n_mels + 2)
    mel_f = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def power_to_db(
    s: torch.Tensor,
    *,
    ref: torch.Tensor | float | str = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
    per_clip_dims: tuple = (-2, -1),
) -> torch.Tensor:
    """librosa.power_to_db with per-clip ``top_db`` flooring.

    ``ref`` is a scalar, a tensor broadcastable against ``s``, or ``'max'``
    (the per-clip max, the reference's ``ref=np.max``).
    """
    if isinstance(ref, str):
        if ref != "max":
            raise ValueError(ref)
        ref = torch.amax(s, dim=per_clip_dims, keepdim=True)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    if isinstance(ref, torch.Tensor):
        log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    else:
        log_spec = log_spec - 10.0 * float(np.log10(max(amin, ref)))
    if top_db is not None:
        floor = torch.amax(log_spec, dim=per_clip_dims, keepdim=True) - top_db
        log_spec = torch.maximum(log_spec, floor)
    return log_spec


@functools.lru_cache(maxsize=4)
def _dct_ii_ortho_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix ``(n, n)``: out = M @ x."""
    k = np.arange(n)[:, None]
    t = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * t + 1) / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m.astype(np.float32)


def dct_ii_ortho(x: torch.Tensor, n_out: int, dim: int = -2) -> torch.Tensor:
    """DCT-II (ortho) along ``dim``, keeping the first ``n_out`` coefficients
    (a dense fp32 matmul)."""
    n = x.shape[dim]
    m = torch.from_numpy(_dct_ii_ortho_matrix(n)[:n_out]).to(x.device)
    out = torch.matmul(m, torch.movedim(x, dim, -2))
    return torch.movedim(out, -2, dim)


def normalize_inf(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``librosa.util.normalize(x, norm=np.inf)``: max-abs per slice, slices
    below the float32 tiny threshold pass through unscaled."""
    length = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    tiny = float(np.finfo(np.float32).tiny)
    length = torch.where(length < tiny, torch.ones_like(length), length)
    return x / length
