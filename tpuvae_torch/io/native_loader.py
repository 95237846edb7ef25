"""ctypes bindings for the native C++ audio loader (counterpart of
``tpuvae/io/native_loader.py``).

The port carries its own copy of the C++ sources
(``tpuvae_torch/native/{wavload.cpp, flac.cpp, audio.h}``) and builds them
at first use with ``g++ -O3 -fPIC -shared -std=c++17`` into
``build/tpuvae_torch/`` of the checkout.  The library's file name carries a
hash of the sources and flags, so an edited source rebuilds and a stale
library is never loaded; the build writes a temporary name and renames it
into place, so two processes building at once cannot load half a file.
No ``-march=native``: the hash cannot see which CPU compiled a library.
A failed build raises; nothing falls back to the Python decoders behind
the caller's back.  ``TPUVAE_DISABLE_NATIVE=1`` turns the loader off
explicitly (as in the JAX package).

:func:`decode_counts` tallies the clips each path decoded — native here,
Python in ``tpuvae_torch.io.wav.load_audio`` — so a run can show which one
did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuvae_torch"
SOURCES = ("wavload.cpp", "flac.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_LOCK = threading.Lock()
_COUNTS = {"native": 0, "python": 0}


def count_decode(decoder: str) -> None:
    """Add one clip to ``decoder``'s tally (``"native"`` or ``"python"``)."""
    with _LOCK:
        _COUNTS[decoder] += 1


def decode_counts() -> dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def reset_decode_counts() -> None:
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def library_path() -> Path:
    h = hashlib.sha256()
    for name in sorted(p.name for p in SRC_DIR.iterdir()
                       if p.suffix in (".cpp", ".h")):
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwavload-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set $CXX): the native audio loader "
                           "builds from tpuvae_torch/native at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native audio loader build failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.tpuvae_load_audio.restype = ctypes.c_int
            lib.tpuvae_load_audio.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ]
            lib.tpuvae_load_audio_batch.restype = ctypes.c_int
            lib.tpuvae_load_audio_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.tpuvae_load_audio_rows.restype = ctypes.c_int
            lib.tpuvae_load_audio_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ]
            lib.tpuvae_load_audio_rows_i16.restype = ctypes.c_int
            lib.tpuvae_load_audio_rows_i16.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
    return _lib


def native_available() -> bool:
    """False only when ``TPUVAE_DISABLE_NATIVE=1``; otherwise builds the
    library if needed (raising if the build fails) and returns True."""
    if os.environ.get("TPUVAE_DISABLE_NATIVE", "0") == "1":
        return False
    _get_lib()
    return True


def load_audio_native(path, sample_rate: int = 22050,
                      duration: float = 30.0) -> np.ndarray:
    """Native decode + mono + resample + truncate / pad; raises ``IOError``
    when the C++ decoder cannot read the file."""
    n = int(sample_rate * duration)
    out = np.empty(n, dtype=np.float32)
    rc = _get_lib().tpuvae_load_audio(
        str(path).encode(), sample_rate, float(duration),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if rc != 0:
        raise IOError(f"native decode failed for {path} (rc={rc})")
    count_decode("native")
    return out


def load_audio_batch_native(paths, sample_rate: int = 22050,
                            duration: float = 30.0):
    """Batch decode -> ((count, n) float32, per-file status array); a
    failed file's row is zeros and its status 1."""
    n = int(sample_rate * duration)
    count = len(paths)
    out = np.empty((count, n), dtype=np.float32)
    status = np.empty(count, dtype=np.int32)
    blob = b"\0".join(str(p).encode() for p in paths) + b"\0"
    _get_lib().tpuvae_load_audio_batch(
        blob, count, sample_rate, float(duration),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    with _LOCK:
        _COUNTS["native"] += int((status == 0).sum())
    return out, status


def load_audio_into_native(path, dest: np.ndarray, sample_rate: int = 22050,
                           duration: float = 30.0, offset: int = 0) -> None:
    """Decode one clip straight into ``dest`` (a flat, C-contiguous float32
    or int16 array — typically one row of a pinned batch buffer): zeros
    before ``offset``, the clip at ``[offset, offset + sr*duration)``, zeros
    after.  int16 is the fast mode's wire: round to nearest with clamp,
    bit-exact for int16 sources at the target rate.  Raises ``IOError``
    when the C++ decoder cannot read the file."""
    if dest.ndim != 1 or not dest.flags.c_contiguous:
        raise ValueError("dest must be a flat, C-contiguous array")
    lib = _get_lib()
    if dest.dtype == np.int16:
        rc = lib.tpuvae_load_audio_rows_i16(
            str(path).encode(), sample_rate, float(duration),
            dest.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            dest.size, int(offset))
    elif dest.dtype == np.float32:
        rc = lib.tpuvae_load_audio_rows(
            str(path).encode(), sample_rate, float(duration),
            dest.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dest.size, int(offset))
    else:
        raise ValueError(f"dest dtype must be float32 or int16, got {dest.dtype}")
    if rc != 0:
        raise IOError(f"native decode failed for {path} (rc={rc})")
    count_decode("native")
