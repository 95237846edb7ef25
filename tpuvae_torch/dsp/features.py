"""Batched feature extraction (counterpart of ``tpuvae/dsp/features.py``).

One STFT per batch of clips, every feature derived from it:

  * ``extract_basic_features``: the (B, 370) vector of the reference's
    ``extract_all_features`` (``1_preprocessing.py:105-129``);
  * ``extract_mel_image``: the (B, n_mels, fixed_time_steps) dB image of
    ``1_preprocessing_advanced.py:97-114`` (truncate / pad with the min);
  * ``extract_flat_features``: the (B, 290) vector of
    ``1_preprocessing_advanced.py:120-156`` (no MFCC);
  * ``extract_advanced``: the last two from one shared STFT.

``stft_method`` picks the front end (:func:`resolve_numerics`):
``'ct_pallas'``, and ``'auto'`` where kernel 1 takes the geometry, run
the fused front end (kernel 1) and estimate the tuning with kernel 2;
every other method (``'pallas'`` = kernel 4, ``'fft'``, ``'dft'``,
``'ct'``) runs the staged front end — fp32 power from
:func:`tpuvae_torch.dsp.primitives.stft_power`, then the plain spectral
functions below — and the staged tuning route (kernel 3).

The plain spectral functions (``mel_power_from_stft``, ``spectral_*``,
``zero_crossing_rate``, ``rms``) are also the staged form of kernel 1's
epilogue; :func:`tpuvae_torch.ops.stft.stft_fused_features_plain` is built
from them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvae_torch.config import AdvancedPreprocessConfig, PreprocessConfig
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
# Pipeline extractors
# -----------------------------------------------------------------------------

def resolve_numerics(cfg, stft_method: str | None = None) -> tuple[bool, str]:
    """``(exact, stft_method)`` for a preprocess config.

    ``precision_mode='exact'`` keeps the power spectrogram in fp32;
    ``'fast'`` stores it as bfloat16 on the fused route (the staged route
    keeps fp32 power in both modes).  An explicit ``stft_method`` (argument
    or config) wins over ``'auto'``; ``'auto'`` resolves through
    :func:`tpuvae_torch.dsp.primitives.resolve_stft_method`: the fused
    front end, ``'ct_pallas'`` (kernel 1 on a CUDA tensor, its plain
    version on a CPU tensor), where kernel 1 takes ``(n_fft, hop_length)``,
    else ``'fft'``.
    """
    mode = getattr(cfg, "precision_mode", "exact")
    if mode not in ("exact", "fast"):
        raise ValueError(f"precision_mode must be 'exact'|'fast', got {mode!r}")
    method = stft_method or getattr(cfg, "stft_method", "auto")
    if method not in prim.STFT_METHODS:
        raise ValueError(f"stft_method must be one of {prim.STFT_METHODS}, "
                         f"got {method!r}")
    return mode == "exact", prim.resolve_stft_method(method, cfg.n_fft,
                                                      cfg.hop_length)


def _spectral_front_end(y: torch.Tensor, cfg, exact: bool,
                        method: str = "ct_pallas"):
    """``FusedFrontEnd`` of one batch.  ``'ct_pallas'`` is one fused pass
    (kernel 1 on a CUDA tensor, its plain version on a CPU tensor); the
    other methods compute fp32 power with
    :func:`tpuvae_torch.dsp.primitives.stft_power` and derive the rest
    with the staged functions above, leaving ``colmax`` to the tuning
    stage (``None``)."""
    from tpuvae_torch.ops.stft import FusedFrontEnd, stft_fused_features

    sr, n_fft, hop = cfg.sample_rate, cfg.n_fft, cfg.hop_length
    if method == "ct_pallas":
        return stft_fused_features(y, n_fft, hop, sr=sr, n_mels=cfg.n_mels,
                                   exact=exact)
    s_power = prim.stft_power(y, n_fft, hop, method=method)
    s_mag = torch.sqrt(s_power)
    freqs = torch.from_numpy(prim.fft_frequencies(sr, n_fft)).to(y.device)
    cent = spectral_centroid(s_mag, freqs)
    return FusedFrontEnd(
        power=s_power,
        mel_power=mel_power_from_stft(s_power, sr, n_fft, cfg.n_mels),
        centroid=cent,
        bandwidth=spectral_bandwidth(s_mag, freqs, cent),
        rolloff=spectral_rolloff(s_mag, freqs),
        zcr=zero_crossing_rate(y, n_fft, hop),
        rms=rms(y, n_fft, hop),
        colmax=None,
    )


def _mean_std(x: torch.Tensor):
    return torch.mean(x, dim=-1), torch.std(x, dim=-1, correction=0)


def _require_batched(y: torch.Tensor, fn_name: str) -> None:
    if y.dim() != 2:
        raise ValueError(
            f"{fn_name} takes batched waveforms (B, num_samples);"
            f" got shape {tuple(y.shape)} — wrap single clips with y[None, :]")


def _front_end_and_chroma(y, cfg, stft_method, tuning_route):
    """The front end of one batch and its chroma.  ``tuning_route=None``
    follows the front end: kernel 2 (``'fused'``) behind the fused front
    end, kernel 3 (``'staged'``) behind a staged one."""
    exact, method = resolve_numerics(cfg, stft_method)
    if tuning_route is None:
        tuning_route = "fused" if method == "ct_pallas" else "staged"
    fe = _spectral_front_end(y, cfg, exact, method)
    chrom = chroma_batch(fe.power, cfg.sample_rate, cfg.n_fft, fe.colmax,
                         n_chroma=cfg.n_chroma, tuning_route=tuning_route)
    return fe, chrom


def _stat_columns(feats_2d, feats_1d) -> list[torch.Tensor]:
    """[mean | std] over time of each ``(B, C, T)`` feature, then (mean,
    std) of each ``(B, T)`` one, as a list of ``(B, n)`` column blocks."""
    parts = []
    for feat in feats_2d:
        parts += list(_mean_std(feat))
    for feat in feats_1d:
        m, s = _mean_std(feat)
        parts += [m[:, None], s[:, None]]
    return parts


def _mel_image(mel_db: torch.Tensor, fixed_time_steps: int) -> torch.Tensor:
    """Truncate the time axis to ``fixed_time_steps`` or right-pad it with
    the clip's min dB value."""
    t = mel_db.shape[-1]
    if t >= fixed_time_steps:
        return mel_db[..., :fixed_time_steps]
    pad_val = torch.amin(mel_db, dim=(-2, -1), keepdim=True)
    pad = pad_val.expand(*mel_db.shape[:-1], fixed_time_steps - t)
    return torch.cat([mel_db, pad], dim=-1)


def extract_basic_features(y: torch.Tensor, cfg: PreprocessConfig, *,
                           stft_method: str | None = None,
                           tuning_route: str | None = None) -> torch.Tensor:
    """The 370-d vector of ``extract_all_features`` (``1_preprocessing.py:105-129``).

    Layout: [mel_db mean(128) | mel_db std(128) | mfcc mean(40) | mfcc std(40)
             | (centroid, bandwidth, rolloff, zcr, rms) x (mean, std)
             | chroma mean(12) | chroma std(12)]
    """
    _require_batched(y, "extract_basic_features")
    fe, chrom = _front_end_and_chroma(y, cfg, stft_method, tuning_route)
    mel_db = mel_db_ref_max(fe.mel_power)
    mfcc = mfcc_from_mel_power(fe.mel_power, cfg.n_mfcc)
    parts = _stat_columns(
        (mel_db, mfcc), (fe.centroid, fe.bandwidth, fe.rolloff, fe.zcr, fe.rms))
    parts += list(_mean_std(chrom))
    return torch.cat(parts, dim=-1)


def extract_mel_image(y: torch.Tensor, cfg: AdvancedPreprocessConfig, *,
                      stft_method: str | None = None) -> torch.Tensor:
    """Hi-res fixed-size mel-dB image (``1_preprocessing_advanced.py:97-114``):
    dB with per-clip ``ref=max``; the time axis truncated to
    ``fixed_time_steps`` or right-padded with the clip's min dB value."""
    _require_batched(y, "extract_mel_image")
    exact, method = resolve_numerics(cfg, stft_method)
    fe = _spectral_front_end(y, cfg, exact, method)
    return _mel_image(mel_db_ref_max(fe.mel_power), cfg.fixed_time_steps)


def _flat_features(fe, chrom, mel_db) -> torch.Tensor:
    parts = _stat_columns(
        (mel_db,), (fe.centroid, fe.bandwidth, fe.rolloff, fe.zcr, fe.rms))
    parts += list(_mean_std(chrom))
    return torch.cat(parts, dim=-1)


def extract_flat_features(y: torch.Tensor, cfg: AdvancedPreprocessConfig, *,
                          stft_method: str | None = None,
                          tuning_route: str | None = None) -> torch.Tensor:
    """The 290-d vector of ``extract_flattened_features``
    (``1_preprocessing_advanced.py:120-156``) — like the basic vector but
    without MFCCs."""
    _require_batched(y, "extract_flat_features")
    fe, chrom = _front_end_and_chroma(y, cfg, stft_method, tuning_route)
    return _flat_features(fe, chrom, mel_db_ref_max(fe.mel_power))


def extract_advanced(y: torch.Tensor, cfg: AdvancedPreprocessConfig, *,
                     stft_method: str | None = None,
                     tuning_route: str | None = None):
    """Both advanced-pipeline outputs from one shared STFT: ``(mel_image
    (B, n_mels, fixed_time_steps), flat (B, 290))`` — the per-worker output
    pair of ``process_single_file`` (``1_preprocessing_advanced.py:158-183``),
    fully batched."""
    _require_batched(y, "extract_advanced")
    fe, chrom = _front_end_and_chroma(y, cfg, stft_method, tuning_route)
    mel_db = mel_db_ref_max(fe.mel_power)
    return (_mel_image(mel_db, cfg.fixed_time_steps),
            _flat_features(fe, chrom, mel_db))


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
    """``fn(y, cfg, **kwargs)`` over one batch ``(B, num_samples)``
    (counterpart of ``tpuvae.dsp.features.jit_extractor``).  A numpy array
    is copied to ``device``; a tensor that already lies there (the
    pipeline's pinned, non-blocking copy) is taken as it is.  int16 input
    is the PCM wire encoding and is widened on the device with the exact
    ``x * 2**-15`` scale.  Returns ``fn``'s tensor(s) on ``device``."""

    def wrapped(y):
        if not isinstance(y, torch.Tensor):
            y = torch.as_tensor(np.asarray(y))
        y = y.to(device)
        if y.dim() != 2:
            raise ValueError(
                f"extractors take batched waveforms (B, num_samples); got "
                f"shape {tuple(y.shape)} — wrap single clips with y[None, :]")
        if y.dtype == torch.int16:
            y = y.float() * (1.0 / 32768.0)
        with torch.no_grad():
            return fn(y.float().contiguous(), cfg, **kwargs)

    return wrapped
