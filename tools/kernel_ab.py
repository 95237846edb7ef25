#!/usr/bin/env python3
"""Check and time kernels 2 (chroma tuning) and 6 (the fused conv +
BatchNorm-statistics pair) of ``tpuvae_torch`` on one GPU, and time them
against an earlier design of the same kernels in alternating rounds in one
process.

    python3 tools/kernel_ab.py                     # check + time this tree
    python3 tools/kernel_ab.py --old DIR           # ... and A/B against DIR
    python3 tools/kernel_ab.py --ablate            # ... and conv1's parts

``DIR`` holds ``tuning.cu``, ``radix_select.cuh`` and ``fusedconv.cu`` of
the earlier design (one CTA per clip with six passes over the band; a
CUDA-core conv1 whose wrapper sums per-CTA partials), e.g.

    mkdir -p build/old_csrc
    for f in tuning.cu radix_select.cuh fusedconv.cu; do
      git show <commit>:tpuvae_torch/csrc/$f > build/old_csrc/$f; done

They are compiled here with the flags of ``tpuvae_torch/ops/_build.py``
(the common ones plus each kernel's own, ``-fmad=false`` for kernel 2) and
called through their own C interface; the earlier pair runs with the
earlier wrapper's reductions.  Each round times old, new, new, old (median
of ``--runs`` CUDA-event timings each, L2 flushed before every launch),
once as ``chip_smoke.py`` times (``*_ms``: the card's waits for the host's
launches included) and once with the card kept busy while the host
enqueues (``*_device_ms``: a 1 ms sleep kernel before the start event, so
only device time counts); the card's name and power limit are printed
beside the numbers.  Shapes:
kernel 2 on the bf16 power of 32 and 128 seeded 30 s clips (n_fft 2048,
hop 512), kernel 6 at 32 x 128 x 1024.  Exits non-zero if a kernel
disagrees with its plain version or with its earlier design.

``--ablate`` also builds conv1 of this tree with one part of its work cut
out at a time and times each against the whole kernel, alternating,
through the C interface (device time): what each part costs.  The parts
are the lines of ``fusedconv.cu`` marked ``// ablate: NAME``: the
statistics, the tensor-core products, the tile loads, the normalisation
(``ABLATIONS`` holds each line's replacement).  A cut kernel's output is
wrong; it is only timed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


# a sleep of about 1 ms (at the card's ~2 GHz) before each timed launch:
# longer than the host takes to enqueue the earlier pair's ~20 launches
BUSY_CYCLES = 2_000_000


def time_ms(torch, fn, flush, runs: int, busy_cycles: int = 0) -> float:
    """``chip_smoke.time_ms`` (median of CUDA-event times, L2 flushed
    before each run), with ``busy_cycles`` of a sleep kernel before the
    start event: the card stays busy while the host enqueues ``fn``'s
    launches, so only device time counts."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        if busy_cycles:
            torch.cuda._sleep(busy_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_old(old_dir: Path) -> dict:
    from tpuvae_torch.ops import _build

    out_dir = _build.BUILD_DIR / "old"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("tuning", "fusedconv"):
        lib = out_dir / f"lib{name}_old.so"
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS, *_build._EXTRA_FLAGS[name],
               "-I", str(old_dir), "-o", str(lib), str(old_dir / f"{name}.cu")]
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


# conv1 with one part of its work cut out: the code that replaces the line
# of csrc/fusedconv.cu marked `// ablate: NAME`
ABLATIONS = {
    "no_statistics": "continue;",
    "no_products": "for (int tap = 0; tap < 0; ++tap) {",
    "no_tile_loads": "for (int e = wtid; e < 0; e += 128) {",
    "no_normalisation": "for (int e = wtid; e < 0; e += 128) {",
}


def ablated(src: str, name: str) -> str:
    """``src`` with the line marked ``// ablate: name`` replaced by
    ``ABLATIONS[name]`` (its indentation kept)."""
    pattern = re.compile(rf"^([ \t]*).*// ablate: {name}$", re.MULTILINE)
    if len(pattern.findall(src)) != 1:
        raise RuntimeError(f"ablation {name}: fusedconv.cu must mark one "
                           f"line `// ablate: {name}`")
    return pattern.sub(lambda m: m.group(1) + ABLATIONS[name], src)


def build_ablations() -> dict:
    from tpuvae_torch.ops import _build

    src = (_build.CSRC / "fusedconv.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("whole", *ABLATIONS):
        cu = out_dir / f"{name}.cu"
        cu.write_text(src if name == "whole" else ablated(src, name))
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS,
               *_build._EXTRA_FLAGS["fusedconv"], "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ablation {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def conv1_caller(torch, lib, y0, scale, shift, w1, b1):
    """A closure that launches ``lib``'s conv1 (this tree's C interface)."""
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import fusedconv as fc

    b, h, w, c = y0.shape
    tiles = fc._tiles(h // 2, w // 2, fc._TILE1)
    y1 = torch.empty((b, h // 2, w // 2, 64), device=y0.device)
    part = torch.empty((b * tiles, 2, 64), device=y0.device)
    sums = torch.empty((2, b, 1, 64), device=y0.device)
    stats = torch.empty((2, 64), device=y0.device)
    tickets = torch.zeros(b + 1, dtype=torch.int32, device=y0.device)
    fn = lib.tpuvae_fusedconv_conv1
    fn.argtypes = fc.CONV1.argtypes
    fn.restype = ctypes.c_int
    ptr = _build.ptr
    args = [ptr(t) for t in (y0, scale, shift, w1, b1)] + [
        b, h, w, c, 64, tiles] + [ptr(t) for t in (y1, part, sums, tickets,
                                                   stats)]

    def run():
        rc = fn(*args, _build.stream_ptr(y0.device))
        if rc:
            raise RuntimeError(f"conv1 failed to launch: {rc}")

    return run


def old_tuning(torch, lib, power, colmax):
    """A closure that launches the earlier kernel 2 on ``power``."""
    from tpuvae_torch.dsp.chroma import PIPTRACK_THRESHOLD
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops.tuning import _device_consts

    b, n_rows, t = power.shape
    lo8, r8, fmask, binsb, edges, n_bins, binw = _device_consts(
        str(power.device), cs.SR, cs.N_FFT, n_rows, 0.01)
    out = torch.empty((b,), device=power.device)
    vp, ci, cf, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn = lib.tpuvae_tuning
    fn.argtypes = [vp, ci, vp, ll, ll, ci, ci, ci, vp, vp, vp, ci, cf, cf, cf,
                   cf, vp, vp]
    fn.restype = ci
    ptr = _build.ptr

    def run():
        rc = fn(ptr(power), int(power.dtype == torch.bfloat16), ptr(colmax), b,
                n_rows, t, lo8, r8, ptr(fmask), ptr(binsb), ptr(edges), n_bins,
                binw, float(cs.SR) / cs.N_FFT, 12.0, PIPTRACK_THRESHOLD,
                ptr(out), _build.stream_ptr(power.device))
        if rc:
            raise RuntimeError(f"earlier kernel 2 failed to launch: {rc}")
        return out

    return run


def old_fusedconv(torch, lib):
    """``(conv0_stats, conv1_norm_stats)`` of the earlier design: its
    kernels through their C interface, each followed by the earlier
    wrapper's sum over the per-CTA partials."""
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import fusedconv as fc

    vp, ci = ctypes.c_void_p, ctypes.c_int
    f0 = lib.tpuvae_fusedconv_conv0
    f0.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp]
    f1 = lib.tpuvae_fusedconv_conv1
    f1.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]
    f0.restype = f1.restype = ci
    ptr = _build.ptr

    def conv0(x, w0, b0):
        x, w0, b0 = x.contiguous(), w0.contiguous(), b0.contiguous()
        b, h, w = x.shape
        tiles = fc._tiles(h // 2, w // 2, (8, 32))
        y0 = torch.empty((b, h // 2, w // 2, 32), device=x.device)
        part = torch.empty((2, b, tiles, 32), device=x.device)
        rc = f0(ptr(x), ptr(w0), ptr(b0), b, h, w, 32, tiles, ptr(y0),
                ptr(part[0]), ptr(part[1]), _build.stream_ptr(x.device))
        if rc:
            raise RuntimeError(f"earlier conv0 failed to launch: {rc}")
        sums = part.sum(dim=2, keepdim=True)
        return y0, sums[0], sums[1]

    def conv1(y0, scale, shift, w1, b1):
        y0, scale, shift, w1, b1 = (t.contiguous()
                                    for t in (y0, scale, shift, w1, b1))
        b, h, w, c = y0.shape
        tiles = fc._tiles(h // 2, w // 2, (8, 16))
        y1 = torch.empty((b, h // 2, w // 2, 64), device=y0.device)
        part = torch.empty((2, b, tiles, 64), device=y0.device)
        rc = f1(ptr(y0), ptr(scale), ptr(shift), ptr(w1), ptr(b1), b, h, w, c,
                64, tiles, ptr(y1), ptr(part[0]), ptr(part[1]),
                _build.stream_ptr(y0.device))
        if rc:
            raise RuntimeError(f"earlier conv1 failed to launch: {rc}")
        sums = part.sum(dim=2, keepdim=True)
        return y1, sums[0], sums[1]

    return conv0, conv1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpuvae_torch.device import resolve_device
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import fusedconv as fc
    from tpuvae_torch.ops.stft import stft_fused_features
    from tpuvae_torch.ops.tuning import estimate_tuning, estimate_tuning_plain

    card = cs.card_line()
    cs.log(f"card: {card}")
    cs.log(f"build: {_build.build_all():.1f} s")
    for name in ("tuning", "fusedconv"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                cs.log(f"  ptxas {name}: {line.strip()}")

    dev = resolve_device("cuda")
    n_samples = int(cs.SR * cs.DURATION)
    waves = cs.tones(cs.N_CORPUS, n_samples, cs.SEED)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    power = {}
    for n in (cs.BATCH, cs.EXTRACT_BATCH):
        y = torch.from_numpy(np.concatenate([waves, waves])[:n]).to(dev)
        fe = stft_fused_features(y, cs.N_FFT, cs.HOP, sr=cs.SR,
                                 n_mels=cs.N_MELS)
        power[n] = (fe.power, fe.colmax)
        del y, fe
    k6_args = cs.fusedconv_inputs(torch, dev)
    x, w0, b0, g0, be0, w1, b1 = k6_args
    x_hw, w0_hwf = x[..., 0].contiguous(), w0[:, :, 0].contiguous()
    y0 = fc.conv0_stats(x_hw, w0_hwf, b0)[0]
    ones, zeros = torch.ones(32, device=dev), torch.zeros(32, device=dev)

    # -- correctness against the plain versions ------------------------------
    for n, (p, c) in power.items():
        check_eq = torch.equal(estimate_tuning(p, c, cs.SR, cs.N_FFT),
                               estimate_tuning_plain(p, c, cs.SR, cs.N_FFT))
        cs.check(check_eq, f"kernel 2 != plain at {n} clips")
    k6_errs = cs.check_fusedconv(torch, k6_args)
    cs.log(f"kernel 2 equal to plain at {sorted(power)} clips; kernel 6 "
           f"errors {json.dumps(k6_errs)}")

    def new_pair():
        return fc.fused_trunk2_forward(*k6_args)

    new = {
        "tuning_32": lambda: estimate_tuning(*power[cs.BATCH], cs.SR, cs.N_FFT),
        "tuning_128": lambda: estimate_tuning(*power[cs.EXTRACT_BATCH], cs.SR,
                                              cs.N_FFT),
        "fusedconv_pair": new_pair,
        "fusedconv_conv0": lambda: fc.conv0_stats(x_hw, w0_hwf, b0),
        "fusedconv_conv1": lambda: fc.conv1_norm_stats(y0, ones, zeros, w1, b1),
    }
    result = {"card": card, "runs": args.runs}
    if args.old is None:
        for name, fn in new.items():
            result[name] = {
                f"new_{tag}ms": [time_ms(torch, fn, flush, args.runs, busy)
                                 for _ in range(args.rounds)]
                for busy, tag in ((0, ""), (BUSY_CYCLES, "device_"))}
    else:
        libs = build_old(args.old)
        conv0_old, conv1_old = old_fusedconv(torch, libs["fusedconv"])

        def old_pair():
            # the earlier wrapper: each half, then _finalize / _fold in PyTorch
            y0o, s0, ss0 = conv0_old(x[..., 0], w0[:, :, 0, :], b0)
            m0, v0 = fc._finalize(s0, ss0, y0o.shape[0] * y0o.shape[1]
                                  * y0o.shape[2])
            y1o, s1, ss1 = conv1_old(y0o, *fc._fold(m0, v0, g0, be0, 1e-5),
                                     w1, b1)
            return y1o, (m0, v0), fc._finalize(
                s1, ss1, y1o.shape[0] * y1o.shape[1] * y1o.shape[2])

        old = {
            "tuning_32": old_tuning(torch, libs["tuning"], *power[cs.BATCH]),
            "tuning_128": old_tuning(torch, libs["tuning"],
                                     *power[cs.EXTRACT_BATCH]),
            "fusedconv_pair": old_pair,
            "fusedconv_conv0": lambda: conv0_old(x_hw, w0_hwf, b0),
            "fusedconv_conv1": lambda: conv1_old(y0, ones, zeros, w1, b1),
        }
        # the earlier designs compute the same functions: hold them to the new
        for name in ("tuning_32", "tuning_128"):
            cs.check(torch.equal(old[name](), new[name]()),
                     f"earlier kernel 2 != new at {name}")
        got_old, got_new = old_pair(), new_pair()
        torch.testing.assert_close(got_old[0], got_new[0], rtol=1e-4, atol=1e-4)
        for (m, v), (pm, pv) in zip(got_old[1:], got_new[1:]):
            torch.testing.assert_close(m, pm, rtol=0, atol=1e-5)
            torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-6)
        cs.log("earlier designs agree with the new ones (kernel 2 equal, "
               "kernel 6 within its tolerances)")
        del got_old, got_new
        for name in new:
            times = {}
            for busy, tag in ((0, ""), (BUSY_CYCLES, "device_")):
                for key in (f"old_{tag}ms", f"new_{tag}ms"):
                    times[key] = []
                for _ in range(args.rounds):
                    for key, fn in ((f"old_{tag}ms", old[name]),
                                    (f"new_{tag}ms", new[name]),
                                    (f"new_{tag}ms", new[name]),
                                    (f"old_{tag}ms", old[name])):
                        times[key].append(time_ms(torch, fn, flush,
                                                  args.runs, busy))
                n, o = times[f"new_{tag}ms"], times[f"old_{tag}ms"]
                times[f"new_over_old_{tag}per_round"] = [
                    (n[2 * i] + n[2 * i + 1]) / (o[2 * i] + o[2 * i + 1])
                    for i in range(args.rounds)]
            result[name] = times
            cs.log(f"time {name}, ms: " + json.dumps(
                {k: [round(v, 4) for v in vs] for k, vs in times.items()}))
    if args.ablate:
        runs = {name: conv1_caller(torch, lib, y0, ones, zeros, w1, b1)
                for name, lib in build_ablations().items()}
        times = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name in [*runs, *reversed(runs)]:
                times[name].append(time_ms(torch, runs[name], flush,
                                           args.runs, BUSY_CYCLES))
        result["conv1_ablations"] = times
        cs.log("conv1 with a part cut out (kernel alone, C interface), ms: "
               + json.dumps({k: [round(v, 4) for v in vs]
                             for k, vs in times.items()}))
    if args.old is None:
        for name in new:
            cs.log(f"time {name}, ms: " + json.dumps(
                {k: [round(v, 4) for v in vs]
                 for k, vs in result[name].items()}))
    cs.log(f"card: {cs.card_line()}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
