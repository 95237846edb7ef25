"""Audio decoding + resampling (counterpart of ``tpuvae/io/wav.py``).

``librosa.load`` (reference ``1_preprocessing.py:137-153``) decodes, mixes
to mono (channel mean), resamples to the target rate, truncates to
``duration`` and zero-pads short clips.  :func:`load_audio` does the same
through the native C++ loader (``tpuvae_torch.io.native_loader``: WAV and
FLAC), and through the Python decoders for what that loader does not read:
RIFF/WAVE parsed in numpy (PCM 8/16/24/32-bit and float32/64), FLAC
(``io/flac.py``) and MP3 (``io/mp3.py``, libmpg123), resampled by scipy's
polyphase filter.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from tpuvae_torch.io import native_loader


def raw_np(buf: bytes, dtype) -> np.ndarray:
    return np.frombuffer(buf, dtype=dtype)


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file -> (float32 samples (n, channels), sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if channels == 0 or sr == 0:
        raise ValueError(f"{path}: invalid fmt (channels={channels}, sr={sr})")
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real code is the
        # first 2 bytes of the SubFormat GUID at offset 24 of the fmt body
        if fmt_body is not None and len(fmt_body) >= 26:
            audio_format = struct.unpack("<H", fmt_body[24:26])[0]
        else:
            raise ValueError(f"{path}: extensible WAV without SubFormat GUID")

    if audio_format == 1:  # PCM
        if bits == 8:
            x = (raw_np(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = raw_np(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = raw_np(raw, np.uint8).reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = raw_np(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3 and bits in (32, 64):  # IEEE float
        x = raw_np(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels), sr


def to_mono(x: np.ndarray) -> np.ndarray:
    """Channel mean, like librosa.to_mono."""
    return x.mean(axis=1) if x.ndim == 2 else x


def resample_poly(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling (scipy, Kaiser window)."""
    if sr_in == sr_out:
        return x.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(sr_in, sr_out)
    return _rp(x, sr_out // g, sr_in // g).astype(np.float32)


def load_audio(path: str | Path, sample_rate: int = 22050,
               duration: float | None = 30.0, prefer_native: bool = True,
               out: np.ndarray | None = None) -> np.ndarray:
    """librosa.load-compatible: mono float32 at ``sample_rate``; truncated to
    ``duration`` and zero-padded when short (ref ``1_preprocessing.py:137-153``).

    The order of the JAX package (``tpuvae/io/wav.py:98-146``): the native
    loader, then FLAC by its ``fLaC`` magic, then MP3, then WAV.  Unlike
    the JAX package, only an ``IOError`` of the native loader — a file its
    C++ decoder cannot read, such as an MP3 — falls through to the Python
    decoders (as the JAX package's ``_extract_batched`` does); a failed
    build raises.  With ``out`` (a flat float32 or int16 array of at least
    ``sample_rate * duration`` samples, e.g. a row of a pinned batch
    buffer) the clip is written into it, zeros after, and ``out`` is
    returned; int16 is the fast mode's wire, rounded to nearest and
    clamped.
    """
    if (prefer_native and duration is not None
            and native_loader.native_available()):
        try:
            if out is None:
                return native_loader.load_audio_native(path, sample_rate,
                                                       duration)
            native_loader.load_audio_into_native(path, out, sample_rate,
                                                 duration)
            return out
        except IOError:
            pass    # a container the C++ decoder does not know: below
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"fLaC":
        from tpuvae_torch.io.flac import read_flac

        x, sr = read_flac(path)
    elif magic[:4] != b"RIFF":
        from tpuvae_torch.io import mp3

        if mp3.looks_like_mp3(magic):
            x, sr = mp3.read_mp3(path)
        else:
            x, sr = read_wav(path)   # raises the WAV parser's clear error
    else:
        x, sr = read_wav(path)
    y = to_mono(x)
    if duration is not None:
        # decode-side truncation before resample (librosa truncates at load)
        y = y[: int(round(duration * sr))]
    y = resample_poly(y, sr, sample_rate)
    if duration is not None:
        n = int(sample_rate * duration)
        if len(y) < n:
            y = np.pad(y, (0, n - len(y)))
        else:
            y = y[:n]
    native_loader.count_decode("python")
    y = y.astype(np.float32)
    if out is None:
        return y
    if out.dtype == np.int16:
        y = np.clip(np.rint(y * 32768.0), -32768, 32767)
    out[:len(y)] = y
    out[len(y):] = 0
    return out
