"""Batched basic feature extraction (counterpart of ``tpuvae/dsp/features.py``).

``extract_basic_features`` is the 370-d vector of the reference's
``extract_all_features`` (``1_preprocessing.py:105-129``): one STFT per
batch of clips through the fused front end (kernel 1), every feature
derived from it, chroma with the per-clip tuning estimate (kernel 2, or
kernel 3 on the staged route).

The plain spectral functions below (``mel_power_from_stft``,
``spectral_*``, ``zero_crossing_rate``, ``rms``) are the staged form of
kernel 1's epilogue; :func:`tpuvae_torch.ops.stft.stft_fused_features_plain`
is built from them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvae_torch.config import PreprocessConfig
from tpuvae_torch.dsp import primitives as prim
from tpuvae_torch.dsp.chroma import chroma_batch

_TINY = float(np.finfo(np.float32).tiny)


# -----------------------------------------------------------------------------
# Spectrogram-domain features
# -----------------------------------------------------------------------------

def mel_power_from_stft(s_power: torch.Tensor, sr: int, n_fft: int,
                        n_mels: int) -> torch.Tensor:
    """Mel power spectrogram ``(B, n_mels, T)`` from ``(B, n_bins, T)``."""
    fb = torch.from_numpy(prim.mel_filterbank(sr, n_fft, n_mels)).to(
        s_power.device)
    return torch.matmul(fb, s_power.float())


def mel_db_ref_max(mel_power: torch.Tensor) -> torch.Tensor:
    """``power_to_db(mel, ref=np.max)`` per clip (ref ``1_preprocessing.py:57``)."""
    return prim.power_to_db(mel_power, ref="max")


def mfcc_from_mel_power(mel_power: torch.Tensor, n_mfcc: int) -> torch.Tensor:
    """librosa.feature.mfcc: dB (ref=1) mel -> orthonormal DCT-II over mel axis."""
    mel_db = prim.power_to_db(mel_power, ref=1.0)
    return prim.dct_ii_ortho(mel_db, n_mfcc, dim=-2)


def spectral_centroid(s_mag: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """(B, T) spectral centroid from magnitude spectrogram (B, n_bins, T)."""
    num = torch.einsum("f,bft->bt", freqs, s_mag)
    den = torch.sum(s_mag, dim=1)
    return num / torch.clamp(den, min=_TINY)


def spectral_bandwidth(s_mag: torch.Tensor, freqs: torch.Tensor,
                       centroid: torch.Tensor) -> torch.Tensor:
    """librosa.feature.spectral_bandwidth (norm=True, p=2) -> (B, T)."""
    s_norm = s_mag / torch.clamp(torch.sum(s_mag, dim=1, keepdim=True),
                                 min=_TINY)
    dev = torch.abs(freqs[None, :, None] - centroid[:, None, :])
    return torch.sqrt(torch.sum(s_norm * dev * dev, dim=1))


def spectral_rolloff(s_mag: torch.Tensor, freqs: torch.Tensor,
                     roll_percent: float = 0.85) -> torch.Tensor:
    """Lowest frequency holding ``roll_percent`` of the magnitude -> (B, T)
    (a prefix sum over the bin axis)."""
    total = torch.cumsum(s_mag, dim=1)
    thresh = roll_percent * torch.sum(s_mag, dim=1, keepdim=True)
    big = torch.full_like(total, float(np.finfo(np.float32).max))
    cand = torch.where(total >= thresh, freqs[None, :, None].expand_as(total),
                       big)
    return torch.amin(cand, dim=1)


# -----------------------------------------------------------------------------
# Time-domain features
# -----------------------------------------------------------------------------

def zero_crossing_rate(y: torch.Tensor, frame_length: int = 2048,
                       hop_length: int = 512,
                       threshold: float = 1e-10) -> torch.Tensor:
    """librosa.feature.zero_crossing_rate -> (B, T): centre edge padding,
    tiny samples zeroed, sign-bit changes counted per frame."""
    half = frame_length // 2
    y_pad = torch.nn.functional.pad(y[:, None, :], (half, half),
                                    mode="replicate")[:, 0]
    z = torch.where(torch.abs(y_pad) <= threshold, torch.zeros_like(y_pad),
                    y_pad)
    change = (torch.signbit(z[:, 1:]) != torch.signbit(z[:, :-1])).float()
    # frame f covers the pairs starting at f*hop .. f*hop + frame_length - 2
    csum = torch.nn.functional.pad(torch.cumsum(change, dim=1, dtype=torch.float64),
                                   (1, 0))
    n = prim.num_frames(y.shape[1], hop_length)
    starts = torch.arange(n, device=y.device) * hop_length
    count = csum[:, starts + frame_length - 1] - csum[:, starts]
    return (count / frame_length).float()


def rms(y: torch.Tensor, frame_length: int = 2048,
        hop_length: int = 512) -> torch.Tensor:
    """librosa.feature.rms (centre, zero padding) -> (B, T)."""
    half = frame_length // 2
    frames = torch.nn.functional.pad(y, (half, half)).unfold(
        -1, frame_length, hop_length)
    return torch.sqrt(torch.sum(frames * frames, dim=-1) / frame_length)


# -----------------------------------------------------------------------------
# Pipeline extractor
# -----------------------------------------------------------------------------

def _spectral_front_end(y: torch.Tensor, cfg: PreprocessConfig, exact: bool):
    """``FusedFrontEnd`` of one batch: kernel 1 on a CUDA tensor, its plain
    version on a CPU tensor."""
    from tpuvae_torch.ops.stft import stft_fused_features

    return stft_fused_features(y, cfg.n_fft, cfg.hop_length,
                               sr=cfg.sample_rate, n_mels=cfg.n_mels,
                               exact=exact)


def _resolve_exact(cfg) -> bool:
    mode = getattr(cfg, "precision_mode", "exact")
    if mode not in ("exact", "fast"):
        raise ValueError(f"precision_mode must be 'exact'|'fast', got {mode!r}")
    return mode == "exact"


def _mean_std(x: torch.Tensor):
    return torch.mean(x, dim=-1), torch.std(x, dim=-1, correction=0)


def extract_basic_features(y: torch.Tensor, cfg: PreprocessConfig, *,
                           tuning_route: str = "fused") -> torch.Tensor:
    """The 370-d vector of ``extract_all_features`` (``1_preprocessing.py:105-129``).

    Layout: [mel_db mean(128) | mel_db std(128) | mfcc mean(40) | mfcc std(40)
             | (centroid, bandwidth, rolloff, zcr, rms) x (mean, std)
             | chroma mean(12) | chroma std(12)]
    """
    if y.dim() != 2:
        raise ValueError(
            f"extract_basic_features takes batched waveforms (B, num_samples);"
            f" got shape {tuple(y.shape)} — wrap single clips with y[None, :]")
    fe = _spectral_front_end(y, cfg, _resolve_exact(cfg))
    mel_db = mel_db_ref_max(fe.mel_power)
    mfcc = mfcc_from_mel_power(fe.mel_power, cfg.n_mfcc)
    chrom = chroma_batch(fe.power, cfg.sample_rate, cfg.n_fft, fe.colmax,
                         n_chroma=cfg.n_chroma, tuning_route=tuning_route)
    parts = []
    for feat in (mel_db, mfcc):
        parts += list(_mean_std(feat))
    for feat in (fe.centroid, fe.bandwidth, fe.rolloff, fe.zcr, fe.rms):
        m, s = _mean_std(feat)
        parts += [m[:, None], s[:, None]]
    parts += list(_mean_std(chrom))
    return torch.cat(parts, dim=-1)


def resolve_transfer_dtype(cfg) -> np.dtype:
    """numpy dtype for the host->device wire format: 'int16' ships PCM and
    widens on device with the exact ``x * 2**-15`` scale; 'auto' maps to
    int16 in fast mode and float32 in exact mode."""
    raw = getattr(cfg, "transfer_dtype", "auto")
    if raw == "auto":
        raw = ("int16" if getattr(cfg, "precision_mode", "fast") == "fast"
               else "float32")
    if raw not in ("int16", "float32"):
        raise ValueError(
            f"transfer_dtype must be 'auto'|'int16'|'float32', got {raw!r}")
    return np.dtype(raw)


def make_extractor(fn, cfg, device: torch.device, **kwargs):
    """``fn(y, cfg, **kwargs)`` over host batches: a ``(B, num_samples)``
    numpy array goes to ``device``; int16 input is the PCM wire encoding
    and is widened there with the exact ``x * 2**-15`` scale (counterpart
    of ``tpuvae.dsp.features.jit_extractor``).  Returns a tensor on
    ``device``."""

    def wrapped(y) -> torch.Tensor:
        y = torch.as_tensor(np.asarray(y)).to(device)
        if y.dim() != 2:
            raise ValueError(
                f"extractors take batched waveforms (B, num_samples); got "
                f"shape {tuple(y.shape)} — wrap single clips with y[None, :]")
        if y.dtype == torch.int16:
            y = y.float() * (1.0 / 32768.0)
        with torch.no_grad():
            return fn(y.float().contiguous(), cfg, **kwargs)

    return wrapped
