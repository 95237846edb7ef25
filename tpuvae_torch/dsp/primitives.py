"""Low-level DSP building blocks (own copy of ``tpuvae/dsp/primitives.py``).

Host constant builders in numpy (identical arithmetic to the JAX package,
so both packages see bit-identical windows and filterbanks) and the
tensor functions the extractors need, in PyTorch:

  * ``hann_window``: periodic Hann window (scipy ``get_window('hann')``);
  * ``frame_signal`` / ``stft_power``: centred frames and the power
    spectrogram, by one of five methods (two of them CUDA kernels), and
    :func:`resolve_stft_method`, what ``'auto'`` runs;
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


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect", "wrap": "circular"}


def center_pad(y: torch.Tensor, frame_length: int,
               pad_mode: str = "constant") -> torch.Tensor:
    """``y (B, T)`` padded by ``frame_length // 2`` on both sides.
    ``pad_mode`` takes numpy's names for what ``torch.nn.functional.pad``
    offers (constant, edge, reflect, wrap) and raises for the rest."""
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {sorted(_PAD_MODES)}, got "
                         f"{pad_mode!r}")
    half = frame_length // 2
    if pad_mode == "constant":
        return torch.nn.functional.pad(y, (half, half))
    return torch.nn.functional.pad(y[:, None, :], (half, half),
                                   mode=_PAD_MODES[pad_mode])[:, 0]


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int, *,
                 pad_mode: str = "constant") -> torch.Tensor:
    """Center-pad and slice ``y (B, T)`` into frames ``(B, n_frames,
    frame_length)`` (a strided view of the padded signal).

    ``pad_mode='constant'`` matches librosa.stft's zero padding; ``'edge'``
    matches librosa.feature.zero_crossing_rate's padding.
    """
    return center_pad(y, frame_length, pad_mode).unfold(
        -1, frame_length, hop_length)


@functools.lru_cache(maxsize=4)
def _dft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis (cos, -sin) matrices, each ``(n_fft, n_fft//2 + 1)``."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


STFT_METHODS = ("auto", "ct_pallas", "pallas", "fft", "dft", "ct")

_CT_N2 = 128  # inner DFT length of the 'ct' method's Cooley-Tukey chain


def resolve_stft_method(method: str, n_fft: int, hop_length: int, *,
                        window: np.ndarray | None = None,
                        pad_mode: str = "constant") -> str:
    """The method ``stft_power`` and the extractors run for ``method``.

    ``'auto'`` is kernel 1 (``'ct_pallas'``) where its wrapper takes the
    geometry (:func:`tpuvae_torch.ops.stft.stft_kernel_supports`) with the
    Hann window and constant padding, the JAX package's domain and
    defaults for that kernel; everywhere else it is ``'fft'``.  It decides
    from the geometry alone, before any launch, and never raises for a
    valid one.  Any other name is returned as it is (``ValueError`` for an
    unknown one)."""
    if method not in STFT_METHODS:
        raise ValueError(f"stft method must be one of {STFT_METHODS}, got "
                         f"{method!r}")
    if method != "auto":
        return method
    from tpuvae_torch.ops.stft import stft_kernel_supports

    if (window is None and pad_mode == "constant"
            and stft_kernel_supports(n_fft, hop_length)):
        return "ct_pallas"
    return "fft"


@functools.lru_cache(maxsize=4)
def _ct_basis(n_fft: int) -> tuple[np.ndarray, ...]:
    """Constant matrices of the two-stage Cooley-Tukey real DFT (own copy
    of ``tpuvae/dsp/primitives.py:94``): with ``n = n1 + N1 n2`` and
    ``k = k2 + N2 k1`` (N2 = 128 inner bins, N1 = n_fft / 128 outer),
    ``X[k2 + N2 k1] = sum_n1 W_N1^(n1 k1) W_N^(n1 k2) sum_n2
    x[n1 + N1 n2] W_N2^(n2 k2)``; only ``N1 / 2 + 1`` outer rows are
    evaluated.  Built in float64, cast once to fp32."""
    n2 = _CT_N2
    n1 = n_fft // n2
    k1 = n1 // 2 + 1
    a = np.arange(n2, dtype=np.float64)
    inner = 2.0 * np.pi * a[:, None] * a[None, :] / n2
    f = np.arange(n1, dtype=np.float64)
    tw = 2.0 * np.pi * f[:, None] * a[None, :] / n_fft
    out = 2.0 * np.pi * f[:, None] * np.arange(k1)[None, :] / n1
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return (f32(np.cos(inner)), f32(-np.sin(inner)), f32(np.cos(tw)),
            f32(-np.sin(tw)), f32(np.cos(out)), f32(-np.sin(out)))


def _stft_power_ct(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Power of windowed ``frames (B, T, n_fft)`` -> ``(B, T, n_bins)`` by
    the Cooley-Tukey chain of :func:`_ct_basis` as fp32 matmuls (the JAX
    package leaves it to XLA outside any kernel)."""
    n2 = _CT_N2
    n1 = n_fft // n2
    cre, cim, twre, twim, ere, eim = (torch.from_numpy(m).to(frames.device)
                                      for m in _ct_basis(n_fft))
    fr = frames.reshape(*frames.shape[:-1], n2, n1)
    b1re = torch.einsum("...nf,nk->...fk", fr, cre)
    b1im = torch.einsum("...nf,nk->...fk", fr, cim)
    c_re = b1re * twre - b1im * twim
    c_im = b1re * twim + b1im * twre
    xre = (torch.einsum("...fk,fl->...kl", c_re, ere)
           - torch.einsum("...fk,fl->...kl", c_im, eim))
    xim = (torch.einsum("...fk,fl->...kl", c_re, eim)
           + torch.einsum("...fk,fl->...kl", c_im, ere))
    power = xre * xre + xim * xim                    # [..., k2, k1]
    k1 = n1 // 2 + 1
    power = power.transpose(-1, -2).reshape(*frames.shape[:-1], k1 * n2)
    return power[..., : n_fft // 2 + 1]


def stft_power(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 512, *,
               window: np.ndarray | None = None, pad_mode: str = "constant",
               method: str = "auto") -> torch.Tensor:
    """Power spectrogram ``|STFT|^2`` of shape ``(B, n_fft//2+1, n_frames)``,
    fp32.  The methods keep the JAX package's names:

    * ``'ct_pallas'``: kernel 1 without its epilogue
      (:func:`tpuvae_torch.ops.stft.stft_power`), an fp32 FFT per frame;
    * ``'pallas'``: kernel 4, the dense-DFT products
      (:func:`tpuvae_torch.ops.stft.stft_power_dense`);
    * ``'fft'``: ``torch.fft.rfft`` on the framed signal;
    * ``'dft'``: two ``torch.matmul`` against the cos / sin bases, outside
      any kernel, as the JAX package computes it;
    * ``'ct'``: the JAX package's two-stage Cooley-Tukey chain of fp32
      matmuls (n_fft a multiple of 256);
    * ``'auto'``: :func:`resolve_stft_method`.

    The two kernel methods run their plain versions on a CPU tensor.  They
    bake in the Hann window: a custom ``window=`` is only supported by
    ``'fft'``, ``'dft'`` and ``'ct'``.
    """
    method = resolve_stft_method(method, n_fft, hop_length, window=window,
                                 pad_mode=pad_mode)
    if method in ("pallas", "ct_pallas"):
        if window is not None:
            raise ValueError(
                f"method={method!r} bakes in the hann window; custom "
                f"window= is only supported by 'fft'/'dft'/'ct'")
        from tpuvae_torch.ops import stft as ops_stft

        if method == "pallas":
            return ops_stft.stft_power_dense(y, n_fft, hop_length,
                                             pad_mode=pad_mode)
        return ops_stft.stft_power(y, n_fft, hop_length, pad_mode=pad_mode)
    if method == "ct" and n_fft % (2 * _CT_N2):
        raise ValueError(
            f"method='ct' requires n_fft to be a multiple of "
            f"{2 * _CT_N2}; got {n_fft} (use 'dft' or 'fft')")
    if window is None:
        window = hann_window(n_fft)
    frames = frame_signal(y, n_fft, hop_length, pad_mode=pad_mode)
    frames = frames * torch.from_numpy(
        np.asarray(window, np.float32)).to(y.device)
    if method == "ct":
        power = _stft_power_ct(frames, n_fft)
    elif method == "dft":
        cos_b, sin_b = (torch.from_numpy(m).to(y.device)
                        for m in _dft_basis(n_fft))
        re = torch.matmul(frames, cos_b)
        im = torch.matmul(frames, sin_b)
        power = re * re + im * im
    else:
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
    return power.transpose(1, 2).contiguous()


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
