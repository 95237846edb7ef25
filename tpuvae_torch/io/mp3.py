"""MP3 decode via the system/pygame-bundled libmpg123 (ctypes, no pip;
own copy of ``tpuvae/io/mp3.py``).

Container breadth of `librosa.load` (the reference loads any audioread
container at ``1_preprocessing.py:140-144`` — its own datasets are WAV, so
this is a breadth feature, not a parity requirement).  libmpg123 ships
both as a distro library and inside pygame.libs; this module binds
whichever is present with ctypes (``$TPUVAE_MPG123`` names one
explicitly) and decodes to float32 at the stream's native rate.
`tpuvae_torch.io.wav.load_audio` then applies the same
mono/resample/truncate contract every other container gets.

The binding: open → getformat → force MPG123_ENC_FLOAT_32 via
format_none/format → REOPEN (mpg123 applies a format table only at open
time) → read loop.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
from pathlib import Path

import numpy as np

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_ENC_FLOAT_32 = 0x200

_lib = None
_load_failed = False


def _candidate_paths() -> list[str]:
    cands = []
    env = os.environ.get("TPUVAE_MPG123")
    if env:
        cands.append(env)
    found = ctypes.util.find_library("mpg123")
    if found:
        cands.append(found)
    cands += [
        "/usr/lib/x86_64-linux-gnu/libmpg123.so.0",
        "libmpg123.so.0",
    ]
    # pygame bundles a relocatable copy (pygame.libs/libmpg123-*.so.*)
    try:
        import pygame  # noqa: F401 — only to locate its .libs dir

        libs = Path(pygame.__file__).parent.parent / "pygame.libs"
        cands += sorted(glob.glob(str(libs / "libmpg123*")))
    except Exception:
        pass
    return cands


def _get_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for cand in _candidate_paths():
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        try:
            lib.mpg123_init()   # no-op after the first call in mpg123 >= 1.27
            lib.mpg123_new.restype = ctypes.c_void_p
            lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.mpg123_close.argtypes = [ctypes.c_void_p]
            lib.mpg123_delete.argtypes = [ctypes.c_void_p]
            lib.mpg123_getformat.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
            lib.mpg123_format.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
            lib.mpg123_read.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t)]
            _lib = lib
            return _lib
        except Exception:
            continue
    _load_failed = True
    return None


def mp3_available() -> bool:
    """True when a usable libmpg123 was found (distro or pygame bundle)."""
    return _get_lib() is not None


def looks_like_mp3(magic: bytes) -> bool:
    """Sniff an MP3 from the first bytes: ID3v2 tag or an MPEG frame sync
    (11 set bits; layer bits != 00 excludes random 0xFF bytes slightly)."""
    if magic[:3] == b"ID3":
        return True
    return (len(magic) >= 2 and magic[0] == 0xFF
            and (magic[1] & 0xE0) == 0xE0 and (magic[1] & 0x06) != 0)


def read_mp3(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a whole MP3 to float32 at its native rate.

    Returns ``(samples, sample_rate)`` with samples shaped ``(n,)`` mono or
    ``(n, channels)`` — the same contract as :func:`tpuvae_torch.io.wav.read_wav`
    / :func:`tpuvae_torch.io.flac.read_flac`.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(
            "MP3 decode needs libmpg123 (system package or pygame bundle); "
            "none found — set TPUVAE_MPG123 to a libmpg123.so path")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise IOError(f"mpg123_new failed (err={err.value})")
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise IOError(f"mpg123 cannot open {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise IOError(f"mpg123 cannot read format of {path}")
        # pin float32 output at the native rate/channels, then REOPEN —
        # mpg123 consults the format table when the decoder starts
        lib.mpg123_format_none(h)
        if lib.mpg123_format(h, rate, channels, _ENC_FLOAT_32) != _MPG123_OK:
            raise IOError(f"mpg123 refuses float32 at {rate.value} Hz")
        lib.mpg123_close(h)
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise IOError(f"mpg123 cannot reopen {path}")

        chunks: list[bytes] = []
        buf = ctypes.create_string_buffer(1 << 16)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise IOError(f"mpg123 read error rc={rc} on {path}")
        data = np.frombuffer(b"".join(chunks), dtype=np.float32)
        ch = channels.value
        if ch > 1:
            data = data[: len(data) - len(data) % ch].reshape(-1, ch)
        return data, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
