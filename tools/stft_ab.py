#!/usr/bin/env python3
"""Check and time the two STFT kernels of ``tpuvae_torch`` on one GPU, and
time them against an earlier design of the same kernels in alternating
rounds in one process.

    python3 tools/stft_ab.py                       # check + time this tree
    python3 tools/stft_ab.py --old DIR             # ... and A/B against DIR

``DIR`` holds ``stft_features.cu`` and ``stft_dense.cu`` of the earlier
design (the radix-2 shared-memory FFT and the fp32 CUDA-core GEMM), e.g.

    mkdir -p build/old_csrc
    git show <commit>:tpuvae_torch/csrc/stft_features.cu > build/old_csrc/stft_features.cu
    git show <commit>:tpuvae_torch/csrc/stft_dense.cu > build/old_csrc/stft_dense.cu

They are compiled here with the flags of ``tpuvae_torch/ops/_build.py``
(the common ones plus each kernel's own) and called through their own C
interface.  Each round times old, new, new, old
(median of ``--runs`` CUDA-event timings each, L2 flushed before every
launch); the card's name and power limit are printed beside the numbers.
Shapes: ``--clips`` clips of 30 s at 22,050 Hz, n_fft 2048, hop 512, 128
mels (kernel 1 in fast mode).  Exits non-zero if a kernel disagrees with
its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def build_old(old_dir: Path) -> dict:
    from tpuvae_torch.ops import _build

    out_dir = _build.BUILD_DIR / "old"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("stft_features", "stft_dense"):
        lib = out_dir / f"lib{name}_old.so"
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS, *_build._EXTRA_FLAGS[name],
               "-o", str(lib), str(old_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}.cu (earlier design):\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  ptxas earlier {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def old_callers(torch, libs, y, n_fft, hop, sr, n_mels):
    """Closures that launch the earlier kernels on ``y`` through the C
    interface they had: dense mel filterbank with per-filter bin ranges for
    kernel 1, (n_fft, bins) cos / sin bases for kernel 4."""
    from tpuvae_torch.dsp import primitives as prim
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops.stft import _folded_basis

    dev = y.device
    b, n_samples = y.shape
    t = prim.num_frames(n_samples, hop)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptr = _build.ptr

    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    tw = np.stack([np.cos(-2 * np.pi * k / n_fft),
                   np.sin(-2 * np.pi * k / n_fft)], axis=1)
    tw[np.abs(tw) < 1e-12] = 0.0
    fb = prim.mel_filterbank(sr, n_fft, n_mels)
    nz = fb != 0
    rng = np.stack([nz.argmax(axis=1),
                    fb.shape[1] - nz[:, ::-1].argmax(axis=1)],
                   axis=1).astype(np.int32)
    consts = [torch.from_numpy(a).to(dev) for a in (
        prim.hann_window(n_fft), tw.astype(np.float32),
        prim.fft_frequencies(sr, n_fft), fb, rng)]
    power = torch.empty((b, n_fft // 2 + 1, t), dtype=torch.bfloat16,
                        device=dev)
    mel = torch.empty((b, n_mels, t), device=dev)
    stats = torch.empty((6, b, t), device=dev)
    f1 = libs["stft_features"].tpuvae_stft_features
    f1.argtypes = [vp, ll, ll, ci, ci, ci, vp, vp, vp, vp, vp, ci, vp, ci,
                   vp, vp, vp]
    f1.restype = ci

    def k1():
        rc = f1(ptr(y), b, n_samples, n_fft, hop, t, *map(ptr, consts),
                n_mels, ptr(power), 1, ptr(mel), ptr(stats),
                _build.stream_ptr(dev))
        if rc:
            raise RuntimeError(f"earlier kernel 1 failed to launch: {rc}")
        return power, mel, stats

    cos_w, sin_w = _folded_basis(n_fft)
    n_half = n_fft // 2
    cos_p = np.ascontiguousarray(cos_w[:, :n_half])
    sin_p = np.ascontiguousarray(sin_w[:, :n_half])
    sin_p[:, 0] = cos_w[:, n_half]
    cos_d, sin_d = torch.from_numpy(cos_p).to(dev), torch.from_numpy(sin_p).to(dev)
    y_pad = prim.center_pad(y, n_fft, "constant").contiguous()
    out = torch.empty((b, n_half + 1, t), device=dev)
    f4 = libs["stft_dense"].tpuvae_stft_dense
    f4.argtypes = [vp, ll, ll, ci, ci, ci, vp, vp, ci, vp, vp]
    f4.restype = ci

    def k4():
        rc = f4(ptr(y_pad), b, y_pad.shape[1], n_fft, hop, t, ptr(cos_d),
                ptr(sin_d), n_half, ptr(out), _build.stream_ptr(dev))
        if rc:
            raise RuntimeError(f"earlier kernel 4 failed to launch: {rc}")
        return out

    return k1, k4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--clips", type=int, default=cs.BATCH)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--skip-checks", action="store_true",
                    help="time without checking: for experiments on a copy "
                         "whose kernel is wrong on purpose (loads disabled, "
                         "...) to see what a part of it costs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("stft_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_power,
        stft_power_dense,
    )

    card = cs.card_line()
    cs.log(f"card: {card}")
    cs.log(f"build: {_build.build_all():.1f} s")
    for name in ("stft_features", "stft_dense"):
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line or "warning" in line
                    or "Warning" in line):
                cs.log(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    n_samples = int(cs.SR * cs.DURATION)
    waves = cs.tones(min(args.clips, 64), n_samples, cs.SEED)
    waves = np.concatenate([waves] * -(-args.clips // len(waves)))[:args.clips]
    y = torch.from_numpy(waves).to(dev)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)

    # -- correctness against the plain versions ------------------------------
    pmax = float("nan")

    def check_k1():
        nonlocal pmax
        _, pl_x, pmax, err_x, roll_x = cs.check_stft_features(torch, y, True)
        cs.log(f"kernel 1 exact: power max abs err {err_x:.4g} = "
               f"{err_x / pmax:.3g} of max power; rolloff max err "
               f"{roll_x:.4g} Hz")
        torch.testing.assert_close(stft_power(y, cs.N_FFT, cs.HOP),
                                   pl_x.power, rtol=1e-4, atol=1e-6 * pmax)
        del pl_x
        *_, err_f, roll_f = cs.check_stft_features(torch, y, False)
        cs.log(f"kernel 1 fast: bf16 power max abs err {err_f:.4g}; rolloff "
               f"max err {roll_f:.4g} Hz; power-only within tolerance")
        odd = y[:3, :2 * cs.SR + 101].contiguous()   # ragged tile, odd length
        cs.check_stft_features(torch, odd, False)
        cs.check_stft_features(torch, odd, True)

    def check_k4():
        ragged = y[:3, :2 * cs.SR].contiguous()
        cs.check_stft_dense(torch, ragged[:, :5000].contiguous(), 512, 512)
        cs.check_stft_dense(torch, ragged, cs.N_FFT, cs.HOP)
        cs.check_stft_dense(torch, ragged[:, :30001].contiguous(), 1024, 256)
        cs.check_stft_dense(torch, ragged[:, :5003].contiguous(), 48, 6)
        cs.check_stft_dense(torch, y, cs.N_FFT, cs.HOP)

    failed = []
    checks = (("stft_features", check_k1), ("stft_dense", check_k4))
    for name, fn in () if args.skip_checks else checks:
        try:
            fn()
        except (AssertionError, RuntimeError) as e:
            failed.append(name)
            cs.log(f"FAILED {name}: {str(e)[:1500]}")
    if failed:
        return 1

    # -- timing ---------------------------------------------------------------
    def new_k1():
        return stft_fused_features(y, cs.N_FFT, cs.HOP, sr=cs.SR,
                                   n_mels=cs.N_MELS)

    def new_k4():
        return stft_power_dense(y, cs.N_FFT, cs.HOP)

    result = {"card": card, "clips": args.clips, "runs": args.runs}
    if args.old is None:
        for name, fn in (("stft_features", new_k1), ("stft_dense", new_k4)):
            result[name] = {"new_ms": [
                cs.time_ms(torch, fn, flush, runs=args.runs)
                for _ in range(args.rounds)]}
    else:
        old_k1, old_k4 = old_callers(torch, build_old(args.old), y, cs.N_FFT,
                                     cs.HOP, cs.SR, cs.N_MELS)
        # the earlier kernels compute the same function: hold them to the new
        got_new, got_old = new_k1(), old_k1()
        torch.testing.assert_close(got_old[1], got_new.mel_power, rtol=1e-4,
                                   atol=1e-6 * pmax)
        torch.testing.assert_close(old_k4(), new_k4(), rtol=1e-4,
                                   atol=1e-6 * pmax)
        del got_new, got_old
        for name, old, new in (("stft_features", old_k1, new_k1),
                               ("stft_dense", old_k4, new_k4)):
            times = {"old_ms": [], "new_ms": []}
            for _ in range(args.rounds):
                for key, fn in (("old_ms", old), ("new_ms", new),
                                ("new_ms", new), ("old_ms", old)):
                    times[key].append(
                        cs.time_ms(torch, fn, flush, runs=args.runs))
            result[name] = times
    # kernel 1 without its epilogue (fp32 power only), for the share of the
    # time that the FFT and the store take
    result["stft_power_only"] = {"new_ms": [
        cs.time_ms(torch, lambda: stft_power(y, cs.N_FFT, cs.HOP), flush,
                   runs=args.runs) for _ in range(args.rounds)]}
    for name in ("stft_features", "stft_power_only", "stft_dense"):
        cs.log(f"time {name} at {args.clips} clips, ms: "
               + json.dumps({k: [round(v, 4) for v in vs]
                             for k, vs in result[name].items()}))
    cs.log(f"card: {cs.card_line()}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
