"""STFT power kernels and their plain versions: the fused STFT power +
spectral-feature epilogue (kernel 1) and the dense-DFT STFT power
(kernel 4, at the end of the module).

Counterpart of ``tpuvae/ops/stft.py``'s fused Cooley-Tukey kernel
(``stft_fused_features_ct_pallas``) and, through :func:`stft_power`, of its
power-only variant (``stft_power_ct_pallas``).  One pass over a batch of
waveforms ``y (B, n_samples)`` gives, per centred Hann-windowed frame:

* ``power (B, n_fft//2+1, T)`` — bfloat16 when ``exact=False``, else fp32;
* ``mel_power (B, n_mels, T)``;
* ``centroid``, ``bandwidth``, ``rolloff`` (85%), ``zcr`` (librosa edge
  semantics), ``rms`` and ``colmax`` (the per-frame max power, the tuning
  stage's piptrack reference), each ``(B, T)``.

Every statistic is computed from fp32 power whatever the stored dtype.
The TPU kernel's padded bin-order layout and hop-row pre-layout served
Mosaic's DMA alignment and have no counterpart here.

On a CUDA tensor the CUDA kernel ``csrc/stft_features.cu`` runs; on a CPU
tensor the plain PyTorch version does (``torch.fft.rfft`` on framed input
plus the staged features of :mod:`tpuvae_torch.dsp.features`).

Kernel 4 (``csrc/stft_dense.cu``) is the counterpart of
``tpuvae/ops/stft.py``'s ``stft_power_pallas``: the same power spectrogram
as two dense products of the frames against window-folded cos / sin bases,
in fp32, with any ``n_fft`` that ``hop_length`` divides.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpuvae_torch.dsp import primitives as prim
from tpuvae_torch.ops import _build

KERNEL_N_FFT = (2048,)   # sizes the CUDA kernel is instantiated for

STFT_FEATURES = _build.Kernel(
    "stft_features", "stft_features", "tpuvae_stft_features",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p])


class FusedFrontEnd(NamedTuple):
    """Outputs of :func:`stft_fused_features`."""

    power: torch.Tensor
    mel_power: torch.Tensor
    centroid: torch.Tensor
    bandwidth: torch.Tensor
    rolloff: torch.Tensor
    zcr: torch.Tensor
    rms: torch.Tensor
    colmax: torch.Tensor


def _check_waveform(y: torch.Tensor) -> None:
    if y.dim() != 2:
        raise ValueError(f"y must be batched waveforms (B, n_samples), got "
                         f"shape {tuple(y.shape)} — wrap single clips with "
                         f"y[None, :]")
    if y.dtype != torch.float32:
        raise ValueError(f"y must be float32, got {y.dtype}")


def stft_power_plain(y: torch.Tensor, n_fft: int = 2048,
                     hop_length: int = 512) -> torch.Tensor:
    """Plain STFT power ``(B, n_fft//2+1, T)`` fp32: centred, zero-padded,
    periodic-Hann-windowed frames through ``torch.fft.rfft``."""
    half = n_fft // 2
    frames = torch.nn.functional.pad(y, (half, half)).unfold(-1, n_fft,
                                                              hop_length)
    window = torch.from_numpy(prim.hann_window(n_fft)).to(y.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    return power.transpose(1, 2).contiguous()


def stft_fused_features_plain(y: torch.Tensor, n_fft: int = 2048,
                              hop_length: int = 512, *, sr: float,
                              n_mels: int, exact: bool = False
                              ) -> FusedFrontEnd:
    """Plain version of kernel 1 (same function, staged PyTorch ops)."""
    from tpuvae_torch.dsp import features as feat

    _check_waveform(y)
    power = stft_power_plain(y, n_fft, hop_length)
    s_mag = torch.sqrt(power)
    freqs = torch.from_numpy(prim.fft_frequencies(sr, n_fft)).to(y.device)
    cent = feat.spectral_centroid(s_mag, freqs)
    return FusedFrontEnd(
        power=power if exact else power.to(torch.bfloat16),
        mel_power=feat.mel_power_from_stft(power, sr, n_fft, n_mels),
        centroid=cent,
        bandwidth=feat.spectral_bandwidth(s_mag, freqs, cent),
        rolloff=feat.spectral_rolloff(s_mag, freqs),
        zcr=feat.zero_crossing_rate(y, n_fft, hop_length),
        rms=feat.rms(y, n_fft, hop_length),
        colmax=torch.amax(power, dim=1),
    )


@functools.lru_cache(maxsize=8)
def _fft_consts(device: str, n_fft: int):
    """Periodic Hann window and float64-built twiddles exp(-2 pi i k/n_fft),
    k = 0 .. n_fft/2, on ``device``."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = -2.0 * np.pi * k / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    tw[np.abs(tw) < 1e-12] = 0.0
    return (torch.from_numpy(prim.hann_window(n_fft)).to(device),
            torch.from_numpy(tw.astype(np.float32)).to(device))


@functools.lru_cache(maxsize=8)
def _epilogue_consts(device: str, sr: float, n_fft: int, n_mels: int):
    """Bin frequencies, mel filterbank and each filter's non-zero bin range
    ``[first, last)``, on ``device``."""
    fb = prim.mel_filterbank(sr, n_fft, n_mels)
    nz = fb != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    last = np.where(nz.any(axis=1), fb.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    rng = np.stack([first, last], axis=1).astype(np.int32)
    return (torch.from_numpy(prim.fft_frequencies(sr, n_fft)).to(device),
            torch.from_numpy(fb).to(device), torch.from_numpy(rng).to(device))


def _launch(y: torch.Tensor, n_fft: int, hop_length: int,
            power_dtype: torch.dtype, sr: float | None = None,
            n_mels: int = 0):
    """Run kernel 1; with ``sr`` given also its epilogue (mel + stats)."""
    _check_waveform(y)
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    if n_fft not in KERNEL_N_FFT:
        raise ValueError(f"the CUDA STFT kernel supports n_fft in "
                         f"{KERNEL_N_FFT}, got {n_fft}")
    if hop_length <= 0:
        raise ValueError(f"hop_length must be positive, got {hop_length}")
    b, n_samples = y.shape
    t = prim.num_frames(n_samples, hop_length)
    dev = y.device
    window, tw = _fft_consts(str(dev), n_fft)
    power = torch.empty((b, n_fft // 2 + 1, t), dtype=power_dtype, device=dev)
    null = ctypes.c_void_p(None)
    freqs = fb = rng = mel = stats = None
    if sr is not None:
        freqs, fb, rng = _epilogue_consts(str(dev), float(sr), n_fft, n_mels)
        mel = torch.empty((b, n_mels, t), dtype=torch.float32, device=dev)
        # one contiguous (B, T) plane per statistic
        stats = torch.empty((6, b, t), dtype=torch.float32, device=dev)
    p = lambda x: null if x is None else _build.ptr(x)  # noqa: E731
    STFT_FEATURES(
        _build.ptr(y), b, n_samples, n_fft, hop_length, t, p(window), p(tw),
        p(freqs), p(fb), p(rng), n_mels, p(power),
        int(power_dtype == torch.bfloat16), p(mel), p(stats),
        _build.stream_ptr(dev))
    return power, mel, stats


def stft_fused_features(y: torch.Tensor, n_fft: int = 2048,
                        hop_length: int = 512, *, sr: float, n_mels: int,
                        exact: bool = False) -> FusedFrontEnd:
    """STFT power with the spectral-feature epilogue fused in.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`stft_fused_features_plain`.  The kernel replaces
    ``tpuvae/ops/stft.py:418`` (``_make_ct_kernel``); it is bound by the
    bytes it must move, and ``csrc/stft_features.cu`` says how its design
    keeps the frames and the fp32 power out of device memory.
    """
    if y.device.type == "cpu":
        return stft_fused_features_plain(y, n_fft, hop_length, sr=sr,
                                         n_mels=n_mels, exact=exact)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    power, mel, stats = _launch(
        y, n_fft, hop_length, torch.float32 if exact else torch.bfloat16,
        sr=sr, n_mels=n_mels)
    cent, bw, roll, zcr, rms, colmax = stats.unbind(dim=0)
    return FusedFrontEnd(power=power, mel_power=mel, centroid=cent,
                         bandwidth=bw, rolloff=roll, zcr=zcr, rms=rms,
                         colmax=colmax)


def stft_power(y: torch.Tensor, n_fft: int = 2048,
               hop_length: int = 512) -> torch.Tensor:
    """STFT power only ``(B, n_fft//2+1, T)`` fp32 — kernel 1 without its
    epilogue on a CUDA tensor, :func:`stft_power_plain` on a CPU tensor."""
    if y.device.type == "cpu":
        _check_waveform(y)
        return stft_power_plain(y, n_fft, hop_length)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    power, _, _ = _launch(y, n_fft, hop_length, torch.float32)
    return power


# -----------------------------------------------------------------------------
# Kernel 4: dense-DFT STFT power
# -----------------------------------------------------------------------------

STFT_DENSE = _build.Kernel(
    "stft_dense", "stft_dense", "tpuvae_stft_dense",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

_DENSE_K_CHUNK = 16      # samples the kernel stages per step
_DENSE_BIN_TILE = 128    # packed bins per CTA


def _check_dense_geometry(n_fft: int, hop_length: int) -> None:
    if hop_length <= 0 or n_fft % hop_length:
        # the JAX kernel's message: 'pallas' is the method's name in both
        raise ValueError("pallas STFT requires hop_length | n_fft")


@functools.lru_cache(maxsize=4)
def _folded_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """``(cos, -sin)`` real-DFT bases ``(n_fft, n_fft//2 + 1)`` with the
    periodic Hann window folded in (float64 angles, cast to fp32, then an
    fp32 multiply — the arithmetic of ``stft_power_pallas``)."""
    cos_b, sin_b = prim._dft_basis(n_fft)
    window = prim.hann_window(n_fft).astype(np.float32)[:, None]
    return cos_b * window, sin_b * window


@functools.lru_cache(maxsize=4)
def _packed_basis(device: str, n_fft: int):
    """The folded bases in the kernel's layout, on ``device``: ``n_fft // 2``
    packed columns padded with zeros to a multiple of the bin tile.  The sin
    column of bin 0 (identically zero) carries the Nyquist bin's cosine,
    whose own sine is zero as well."""
    cos_w, sin_w = _folded_basis(n_fft)
    n_half = n_fft // 2
    nb_pad = -(-n_half // _DENSE_BIN_TILE) * _DENSE_BIN_TILE
    cos_p = np.zeros((n_fft, nb_pad), np.float32)
    sin_p = np.zeros((n_fft, nb_pad), np.float32)
    cos_p[:, :n_half] = cos_w[:, :n_half]
    sin_p[:, :n_half] = sin_w[:, :n_half]
    sin_p[:, 0] = cos_w[:, n_half]
    return (torch.from_numpy(cos_p).to(device),
            torch.from_numpy(sin_p).to(device), nb_pad)


def stft_power_dense_plain(y: torch.Tensor, n_fft: int = 2048,
                           hop_length: int = 512, *,
                           pad_mode: str = "constant") -> torch.Tensor:
    """Plain version of kernel 4: pad, frame, one ``torch.matmul`` against
    each window-folded basis, square and add -> ``(B, n_fft//2+1, T)``."""
    _check_dense_geometry(n_fft, hop_length)
    _check_waveform(y)
    frames = prim.frame_signal(y, n_fft, hop_length, pad_mode=pad_mode)
    cos_w, sin_w = (torch.from_numpy(m).to(y.device)
                    for m in _folded_basis(n_fft))
    re = torch.matmul(frames, cos_w)
    im = torch.matmul(frames, sin_w)
    return (re * re + im * im).transpose(1, 2).contiguous()


def stft_power_dense(y: torch.Tensor, n_fft: int = 2048,
                     hop_length: int = 512, *,
                     pad_mode: str = "constant") -> torch.Tensor:
    """Dense-DFT STFT power ``(B, n_fft//2+1, 1 + n_samples // hop)`` fp32.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`stft_power_dense_plain`.  The kernel replaces
    ``tpuvae/ops/stft.py:73`` (``_make_kernel``); it is bound by its fp32
    operations, and ``csrc/stft_dense.cu`` says how its design gathers the
    frames from the waveform and keeps ``re`` and ``im`` in registers.
    Padding stays out here, as in the JAX wrapper: the kernel reads the
    padded signal.
    """
    _check_dense_geometry(n_fft, hop_length)
    if y.device.type == "cpu":
        return stft_power_dense_plain(y, n_fft, hop_length, pad_mode=pad_mode)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    _check_waveform(y)
    if n_fft % _DENSE_K_CHUNK:
        raise ValueError(f"the CUDA dense-DFT kernel needs n_fft to be a "
                         f"multiple of {_DENSE_K_CHUNK}, got {n_fft}")
    b, n_samples = y.shape
    t = prim.num_frames(n_samples, hop_length)
    y_pad = prim.center_pad(y, n_fft, pad_mode).contiguous()
    cos_p, sin_p, nb_pad = _packed_basis(str(y.device), n_fft)
    out = torch.empty((b, n_fft // 2 + 1, t), dtype=torch.float32,
                      device=y.device)
    if b:
        STFT_DENSE(_build.ptr(y_pad), b, y_pad.shape[1], n_fft, hop_length, t,
                   _build.ptr(cos_p), _build.ptr(sin_p), nb_pad,
                   _build.ptr(out), _build.stream_ptr(y.device))
    return out
