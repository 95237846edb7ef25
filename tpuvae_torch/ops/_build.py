"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-shared -Xcompiler -fPIC``), at first use, into ``build/tpuvae_torch/`` of
the checkout.  The file name carries a hash of every source and flag, so
an edited source rebuilds and a stale library is never loaded.  All
libraries build in parallel (one ``nvcc`` per source, started together).

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :class:`Kernel` raises when that is
non-zero and counts its launches, so a run can show it went through the
kernel.  A call made while a CUDA graph is captured launches nothing: it is
recorded in the capture's tally (:func:`capture_tally`), and every replay
of the graph adds the tally to the counts (:func:`count_replay`).  Nothing
here is touched when a module is imported: the CPU tests import every
module of the package.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuvae_torch"

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# kernels 2 and 3 are held bit-equal to their plain versions: no a*b+c
# contraction into FMA, so each multiply and add rounds on its own
_EXTRA_FLAGS = {
    "stft_features": [],
    "stft_small": [],
    "stft_large_a": [],
    "stft_large_b": [],
    "stft_large_c": [],
    "tuning": ["-fmad=false"],
    "select": ["-fmad=false"],
    "pairwise": [],
    "stft_dense": ["-ldl"],      # looks cuTensorMapEncodeTiled up at run time
    "fusedconv": [],
    "bn_leaky": [],
    "s2_dgrad": [],
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_KERNELS: list["Kernel"] = []
# the launches recorded by the CUDA graph being captured, if one is
_TALLY: dict["Kernel", int] | None = None
# per (device, stream): the kernels' tickets, int32 zeros that the kernels
# set back to 0
_TICKETS: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build from source at first use")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS + _EXTRA_FLAGS[name]).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> float:
    """Compile every kernel library that is missing; returns the seconds
    spent (0.0 when all were built already).  Raises with nvcc's output on
    a failed build."""
    with _LOCK:
        todo = [n for n in _EXTRA_FLAGS if not library_path(n).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *_NVCC_FLAGS, *_EXTRA_FLAGS[name], "-I", str(CSRC),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                              f"{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) of the last
    build of ``name``, or '' if it was built by another process."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.tpuvae_error_string.argtypes = [ctypes.c_int]
                lib.tpuvae_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


class Kernel:
    """One C entry point of a kernel library, with its launch counter."""

    def __init__(self, name: str, library: str, symbol: str, argtypes):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        _KERNELS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = _library(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = _library(self.library).tpuvae_error_string(rc)
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {rc} "
                f"({msg.decode() if msg else 'unknown'})")
        if _TALLY is None:
            self.launches += 1
        else:
            _TALLY[self] = _TALLY.get(self, 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Inside, kernel calls are recorded (they run only when the graph
    captured meanwhile is replayed) in the dict this yields, by kernel."""
    global _TALLY
    outer, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def count_replay(tally: dict[Kernel, int]) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    for kernel, n in tally.items():
        kernel.launches += n


def kernels() -> list[Kernel]:
    return list(_KERNELS)


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def reserve_tickets(device, batch: int):
    """The current stream's ticket buffer, at least ``batch + 1`` zeros,
    allocated now if it is missing or short.  The kernels that finish
    their sums in a fixed order (kernel 6, one ticket per image and one for
    the batch; ``bn_leaky``, one per channel group) hand their tickets back
    as 0, so one buffer serves every launch on its stream, replays of a
    CUDA graph included.  A graph is captured on its own stream: reserve
    that stream's buffer before the capture, outside the graph's memory
    pool (``graphs.CapturedGraph`` does, with its eager first call)."""
    import torch

    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = torch.cuda.current_stream(index).cuda_stream
    key = (index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < batch + 1:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the kernels need a ticket buffer of "
                f"{batch + 1} on the stream being captured: call "
                "_build.reserve_tickets on that stream before the capture")
        t = torch.zeros(max(batch + 1, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
