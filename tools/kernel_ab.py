#!/usr/bin/env python3
"""Check and time kernels 2 (chroma tuning), 3 (masked-median select), 5
(pairwise distances) and 6 (the fused conv + BatchNorm-statistics pair)
of ``tpuvae_torch`` on one GPU, and time them against an earlier design of
the same kernels in alternating rounds in one process.

    python3 tools/kernel_ab.py                     # check + time this tree
    python3 tools/kernel_ab.py --old DIR           # ... and A/B against DIR
    python3 tools/kernel_ab.py --kernels select,pairwise --old DIR
    python3 tools/kernel_ab.py --ablate            # ... and kernels' parts

``--kernels`` picks among ``tuning``, ``select``, ``pairwise`` and
``fusedconv`` (default: all).  ``DIR`` holds the earlier design's sources
of the kernels picked and the headers they include: ``tuning.cu`` (one
CTA per clip with six passes over the band; or a later one with this
tree's C interface), ``fusedconv.cu`` (a CUDA-core conv1 whose wrapper
sums per-CTA partials), ``select.cu`` (one CTA per row, five passes over
the keys), ``pairwise.cu`` (64 x 64 tiles, 4 x 4 micro-tiles, both
triangles), e.g.

    mkdir -p build/old_csrc
    for f in select.cu radix_select.cuh pairwise.cu tuning.cu \
        cluster_select.cuh; do
      git show <commit>:tpuvae_torch/csrc/$f > build/old_csrc/$f; done

They are compiled here with the flags of ``tpuvae_torch/ops/_build.py``
(the common ones plus each kernel's own, ``-fmad=false`` for kernels 2 and
3) and called through their own C interface; the earlier pair runs with
the earlier wrapper's reductions.  Each round times old, new, new, old
(median of ``--runs`` CUDA-event timings each, L2 flushed before every
launch), once as ``chip_smoke.py`` times (``*_ms``: the card's waits for
the host's launches included) and once with the card kept busy while the
host enqueues (``*_device_ms``: a 1 ms sleep kernel before the start
event, so only device time counts); the card's name and power limit are
printed beside the numbers.  Shapes: kernel 2 on the bf16 power of 32 and
128 seeded 30 s clips (n_fft 2048, hop 512); kernel 3 on those clips'
piptrack keys (32 and 128 rows x 475,456) and on 32 all-valid rows (its
lists spill to global memory); kernel 5 ``self_distances`` at N = 186,
1,336 and 10,240, D = 32 (also at both tile sides, 64 and 128, through
the C interface); kernel 6 at 32 x 128 x 1024.  Exits non-zero if
a kernel disagrees with its plain version or with its earlier design.

``--ablate`` also builds conv1 (``fusedconv``), kernel 3 (``select``) and
kernel 5 (``pairwise``, self mode at N = 10,240) of this tree, where
picked, with one part of the work cut out at a time and times each
against the whole kernel, alternating, through the C interface (device
time): what each part costs.  The parts are the lines of ``<kernel>.cu`` marked ``// ablate:
NAME`` (``ABLATIONS`` holds each variant's replacements): conv1's
statistics, tensor-core products, tile loads and normalisation; kernel 3's
rank across the cluster (32 rows of piptrack keys); kernel 5's products,
mirror, all its stores, its square roots, and (not a cut) its streaming
stores made plain.  A cut kernel's output is wrong; it is only timed.
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


KERNELS = ("tuning", "select", "pairwise", "fusedconv")


def build_old(old_dir: Path, names) -> dict:
    from tpuvae_torch.ops import _build

    out_dir = _build.BUILD_DIR / "old"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
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


# a kernel with one part of its work cut out: each variant replaces the
# lines of csrc/<kernel>.cu marked `// ablate: MARK` by the code given
ABLATIONS = {
    "fusedconv": {                     # conv1
        "no_statistics": {"no_statistics": "continue;"},
        "no_products": {"no_products": "for (int tap = 0; tap < 0; ++tap) {"},
        "no_tile_loads": {
            "no_tile_loads": "for (int e = wtid; e < 0; e += 128) {"},
        "no_normalisation": {
            "no_normalisation": "for (int e = wtid; e < 0; e += 128) {"},
    },
    "select": {                        # 32 rows of piptrack keys
        # the read and the compaction alone: no rank across the cluster
        "no_rank": {"rank": "const tpuvae::MedianRank med{n_mine, 0, 0, 0};"},
    },
    "pairwise": {                      # self_distances at N = 10,240
        "no_products": {"products": "for (int c = 0; c < 0; ++c) {"},
        "no_mirror": {"mirror": "const bool mirror = false;"},
        # the values are still computed: a store that never runs keeps
        # them alive
        "no_stores": {"mirror": "const bool mirror = false;",
                      "direct_stores": "if (row4.x + row4.y + row4.z + row4.w"
                                       " < 0.f) __stcs(out, row4.x);"},
        "no_sqrt": {"sqrt": "v[qr][qc] = s;"},
        # write-back stores instead of streaming ones
        "plain_stores": {
            "st1": "__device__ __forceinline__ void st1(float* p, float v) "
                   "{ *p = v; }",
            "st4": "*reinterpret_cast<float4*>(p) = v;"},
    },
}


def ablated(src: str, kernel: str, marks: dict) -> str:
    """``src`` with each line marked ``// ablate: MARK`` replaced by
    ``marks[MARK]`` (its indentation kept)."""
    for mark, code in marks.items():
        pattern = re.compile(rf"^([ \t]*).*// ablate: {mark}$", re.MULTILINE)
        if len(pattern.findall(src)) != 1:
            raise RuntimeError(f"ablation: {kernel}.cu must mark one line "
                               f"`// ablate: {mark}`")
        src = pattern.sub(lambda m, code=code: m.group(1) + code, src)
    return src


def build_ablations(kernel: str) -> dict:
    from tpuvae_torch.ops import _build

    src = (_build.CSRC / f"{kernel}.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, marks in {"whole": {}, **ABLATIONS[kernel]}.items():
        cu = out_dir / f"{kernel}_{name}.cu"
        cu.write_text(ablated(src, kernel, marks))
        lib = out_dir / f"lib{kernel}_{name}.so"
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS,
               *_build._EXTRA_FLAGS[kernel], "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ablation {kernel} {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def select_caller(torch, lib, keys):
    """A closure that launches ``lib``'s kernel 3 (this tree's C interface)
    on ``keys``."""
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import select as sel

    b, n = keys.shape
    slice_, capacity, spill_per_cta = sel.slice_geometry(n)
    spill = torch.empty(max(1, b * sel.CLUSTER * spill_per_cta),
                        dtype=torch.int32, device=keys.device)
    out = torch.empty((b, 4), dtype=torch.int32, device=keys.device)
    fn = lib.tpuvae_masked_median_select
    fn.argtypes = sel.SELECT.argtypes
    fn.restype = ctypes.c_int

    def run():
        rc = fn(_build.ptr(keys), b, n, slice_, capacity, spill_per_cta,
                _build.ptr(spill) if spill_per_cta else None,
                b * sel.CLUSTER * spill_per_cta, _build.ptr(out),
                _build.stream_ptr(keys.device))
        if rc:
            raise RuntimeError(f"kernel 3 failed to launch: {rc}")

    return run


def pairwise_caller(torch, lib, x, tile=None):
    """A closure that launches ``lib``'s kernel 5 (this tree's C interface)
    on ``x`` in self mode, at ``tile`` (default: the wrapper's choice)."""
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import pairwise as pw

    n, d = x.shape
    out = torch.empty((n, n), device=x.device)
    fn = lib.tpuvae_pairwise_distances
    fn.argtypes = pw.PAIRWISE.argtypes
    fn.restype = ctypes.c_int
    if tile is None:
        tile = pw.tile_size(n, n, True, pw._sm_count(x.device))

    def run():
        rc = fn(_build.ptr(x), _build.ptr(x), n, n, d, _build.ptr(out), 1,
                tile, _build.stream_ptr(x.device))
        if rc:
            raise RuntimeError(f"kernel 5 failed to launch: {rc}")

    return run


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


def old_tuning_same_interface(torch, lib, power, colmax):
    """A closure that runs ``estimate_tuning`` with ``lib``'s kernel 2 in
    place of this tree's: for an earlier design with this tree's C
    interface (the wrapper's host path is then the same for both)."""
    from tpuvae_torch.ops import tuning as tn

    fn = lib.tpuvae_tuning
    fn.argtypes = tn.TUNING.argtypes
    fn.restype = ctypes.c_int

    def run():
        launches, saved = tn.TUNING.launches, tn.TUNING._fn
        tn.TUNING._fn = fn
        try:
            return tn.estimate_tuning(power, colmax, cs.SR, cs.N_FFT)
        finally:
            tn.TUNING._fn, tn.TUNING.launches = saved, launches

    return run


def old_tuning(torch, lib, power, colmax):
    """A closure that launches the earlier kernel 2 on ``power`` through
    the C interface of the one-CTA-per-clip design."""
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


def old_select(torch, lib, keys):
    """A closure that launches the earlier kernel 3 on ``keys``."""
    from tpuvae_torch.ops import _build

    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = lib.tpuvae_masked_median_select
    fn.argtypes = [vp, ll, ll, vp, vp]
    fn.restype = ctypes.c_int

    def run():
        # allocates its output as the wrappers do
        out = torch.empty((keys.shape[0], 4), dtype=torch.int32,
                          device=keys.device)
        rc = fn(_build.ptr(keys), keys.shape[0], keys.shape[1],
                _build.ptr(out), _build.stream_ptr(keys.device))
        if rc:
            raise RuntimeError(f"earlier kernel 3 failed to launch: {rc}")
        return out

    return run


def old_self_distances(torch, lib, x):
    """A closure that launches the earlier kernel 5 (self mode) on ``x``."""
    from tpuvae_torch.ops import _build

    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = lib.tpuvae_pairwise_distances
    fn.argtypes = [vp, vp, ll, ll, ll, vp, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    n, d = x.shape

    def run():
        out = torch.empty((n, n), device=x.device)
        rc = fn(_build.ptr(x), _build.ptr(x), n, n, d, _build.ptr(out), 1,
                _build.stream_ptr(x.device))
        if rc:
            raise RuntimeError(f"earlier kernel 5 failed to launch: {rc}")
        return out

    return run


def select_inputs(torch, power) -> dict:
    """Kernel 3's inputs: the piptrack keys of the clips' power at 32 and
    128 rows, and 32 all-valid rows of as many keys (ties and signed
    zeros: values on a grid of 1/8)."""
    from tpuvae_torch.dsp.chroma import _tuning_candidates
    from tpuvae_torch.ops.select import float_order_key, masked_keys

    keys = {}
    for n, (p, c) in power.items():
        _, mags, mask = _tuning_candidates(p.float(), cs.SR, cs.N_FFT, c)
        keys[f"select_{n}"] = masked_keys(mags.reshape(n, -1),
                                          mask.reshape(n, -1)).contiguous()
        del mags, mask
    n_cols = keys[f"select_{cs.BATCH}"].shape[1]
    g = torch.Generator(device=p.device).manual_seed(cs.SEED)
    vals = torch.randint(-4000, 4000, (cs.BATCH, n_cols), generator=g,
                         device=p.device).float() * 0.125
    vals[:, ::5] = -0.0
    keys["select_all_valid_32"] = float_order_key(vals).contiguous()
    return keys


def check_pairwise_self(torch, x, got) -> None:
    """``got`` is ``self_distances(x)``: exactly symmetric, a zero
    diagonal, within the square root of 1e-5 x (2 max|x|^2) of plain."""
    from tpuvae_torch.ops.pairwise import self_distances_plain

    sq = float((x * x).sum(dim=1).max())
    err = (got - self_distances_plain(x)).abs().max().item()
    cs.check(torch.equal(got, got.T), f"kernel 5 not symmetric at {x.shape}")
    cs.check(bool((got.diagonal() == 0).all()), "kernel 5 diagonal not 0")
    cs.check(err <= (2e-5 * sq) ** 0.5, f"kernel 5 off by {err} at {x.shape}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    picked = [k for k in args.kernels.split(",") if k]
    if not picked or set(picked) - set(KERNELS):
        ap.error(f"--kernels: a comma list of {', '.join(KERNELS)}")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpuvae_torch.device import resolve_device
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import fusedconv as fc
    from tpuvae_torch.ops import pairwise as pw
    from tpuvae_torch.ops.pairwise import self_distances
    from tpuvae_torch.ops.select import select_stats, select_stats_plain
    from tpuvae_torch.ops.stft import stft_fused_features
    from tpuvae_torch.ops.tuning import estimate_tuning, estimate_tuning_plain

    card = cs.card_line()
    cs.log(f"card: {card}")
    cs.log(f"build: {_build.build_all():.1f} s")
    for name in picked:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                cs.log(f"  ptxas {name}: {line.strip()}")

    dev = resolve_device("cuda")
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    new, old, libs = {}, {}, {}
    if args.old is not None:
        libs = build_old(args.old, picked)

    if "tuning" in picked or "select" in picked:
        n_samples = int(cs.SR * cs.DURATION)
        waves = cs.tones(cs.N_CORPUS, n_samples, cs.SEED)
        power = {}
        for n in (cs.BATCH, cs.EXTRACT_BATCH):
            y = torch.from_numpy(np.concatenate([waves, waves])[:n]).to(dev)
            fe = stft_fused_features(y, cs.N_FFT, cs.HOP, sr=cs.SR,
                                     n_mels=cs.N_MELS)
            power[n] = (fe.power, fe.colmax)
            del y, fe

    if "tuning" in picked:
        for n, (p, c) in power.items():
            cs.check(torch.equal(estimate_tuning(p, c, cs.SR, cs.N_FFT),
                                 estimate_tuning_plain(p, c, cs.SR, cs.N_FFT)),
                     f"kernel 2 != plain at {n} clips")
            new[f"tuning_{n}"] = (lambda p=p, c=c:
                                  estimate_tuning(p, c, cs.SR, cs.N_FFT))
            if libs:
                same = "list_entries" in (args.old / "tuning.cu").read_text()
                old[f"tuning_{n}"] = (old_tuning_same_interface if same
                                      else old_tuning)(torch, libs["tuning"],
                                                       p, c)
                cs.check(torch.equal(old[f"tuning_{n}"](), new[f"tuning_{n}"]()),
                         f"earlier kernel 2 != new at {n} clips")
        cs.log(f"kernel 2 equal to plain at {sorted(power)} clips")

    if "select" in picked:
        select_keys = select_inputs(torch, power)
        for name, keys in select_keys.items():
            got = select_stats(keys)
            cs.check(torch.equal(got, select_stats_plain(keys)),
                     f"kernel 3 != plain on {name}")
            new[name] = lambda keys=keys: select_stats(keys)
            if libs:
                old[name] = old_select(torch, libs["select"], keys)
                cs.check(torch.equal(old[name](), got),
                         f"earlier kernel 3 != new on {name}")
            cs.log(f"kernel 3 equal to plain on {name} {tuple(keys.shape)}: "
                   f"n of rows 0-3 {got[:4, 0].tolist()}")

    pairwise_x = {}
    if "pairwise" in picked:
        for n in (186, cs.N_TRAIN, cs.N_SCALE):
            x = pairwise_x[n] = cs.seeded_latents(torch, dev, n)
            check_pairwise_self(torch, x, self_distances(x))
            new[f"pairwise_{n}"] = lambda x=x: self_distances(x)
            if libs:
                old[f"pairwise_{n}"] = old_self_distances(
                    torch, libs["pairwise"], x)
                err = (old[f"pairwise_{n}"]() - self_distances(x)).abs().max()
                cs.check(err.item() <= (2e-5 * float(
                    (x * x).sum(dim=1).max())) ** 0.5,
                         f"earlier kernel 5 differs from new by {err} at {n}")
        cs.log("kernel 5 symmetric, zero diagonal, within tolerance of plain "
               f"at N = 186, {cs.N_TRAIN}, {cs.N_SCALE}")

    if "fusedconv" in picked:
        k6_args = cs.fusedconv_inputs(torch, dev)
        x, w0, b0, g0, be0, w1, b1 = k6_args
        x_hw, w0_hwf = x[..., 0].contiguous(), w0[:, :, 0].contiguous()
        y0 = fc.conv0_stats(x_hw, w0_hwf, b0)[0]
        ones, zeros = torch.ones(32, device=dev), torch.zeros(32, device=dev)
    if "fusedconv" in picked:
        cs.log(f"kernel 6 errors {json.dumps(cs.check_fusedconv(torch, k6_args))}")

        def new_pair():
            return fc.fused_trunk2_forward(*k6_args)

        new["fusedconv_pair"] = new_pair
        new["fusedconv_conv0"] = lambda: fc.conv0_stats(x_hw, w0_hwf, b0)
        new["fusedconv_conv1"] = lambda: fc.conv1_norm_stats(y0, ones, zeros,
                                                             w1, b1)
        if libs:
            conv0_old, conv1_old = old_fusedconv(torch, libs["fusedconv"])

            def old_pair():
                # the earlier wrapper: each half, then _finalize / _fold
                y0o, s0, ss0 = conv0_old(x[..., 0], w0[:, :, 0, :], b0)
                m0, v0 = fc._finalize(s0, ss0, y0o.shape[0] * y0o.shape[1]
                                      * y0o.shape[2])
                y1o, s1, ss1 = conv1_old(y0o, *fc._fold(m0, v0, g0, be0, 1e-5),
                                         w1, b1)
                return y1o, (m0, v0), fc._finalize(
                    s1, ss1, y1o.shape[0] * y1o.shape[1] * y1o.shape[2])

            old["fusedconv_pair"] = old_pair
            old["fusedconv_conv0"] = lambda: conv0_old(x_hw, w0_hwf, b0)
            old["fusedconv_conv1"] = lambda: conv1_old(y0, ones, zeros, w1, b1)
            got_old, got_new = old_pair(), new_pair()
            torch.testing.assert_close(got_old[0], got_new[0], rtol=1e-4,
                                       atol=1e-4)
            for (m, v), (pm, pv) in zip(got_old[1:], got_new[1:]):
                torch.testing.assert_close(m, pm, rtol=0, atol=1e-5)
                torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-6)
            del got_old, got_new
    if libs:
        cs.log("earlier designs agree with the new ones (kernels 2 and 3 "
               "equal, 5 and 6 within their tolerances)")

    result = {"card": card, "runs": args.runs}
    for name, fn in new.items():
        times = {}
        for busy, tag in ((0, ""), (BUSY_CYCLES, "device_")):
            if not libs:
                times[f"new_{tag}ms"] = [time_ms(torch, fn, flush, args.runs,
                                                 busy)
                                         for _ in range(args.rounds)]
                continue
            for key in (f"old_{tag}ms", f"new_{tag}ms"):
                times[key] = []
            for _ in range(args.rounds):
                for key, f in ((f"old_{tag}ms", old[name]),
                               (f"new_{tag}ms", fn), (f"new_{tag}ms", fn),
                               (f"old_{tag}ms", old[name])):
                    times[key].append(time_ms(torch, f, flush, args.runs,
                                              busy))
            n, o = times[f"new_{tag}ms"], times[f"old_{tag}ms"]
            times[f"new_over_old_{tag}per_round"] = [
                (n[2 * i] + n[2 * i + 1]) / (o[2 * i] + o[2 * i + 1])
                for i in range(args.rounds)]
        result[name] = times
        cs.log(f"time {name}, ms: " + json.dumps(
            {k: [round(v, 4) for v in vs] for k, vs in times.items()}))
    if pairwise_x:
        # kernel 5 at both tile sides, alternating (device time): what
        # ops/pairwise.py:tile_size chooses between
        lib = _build._library("pairwise")
        for n, x in pairwise_x.items():
            runs = {t: pairwise_caller(torch, lib, x, t) for t in (64, 128)}
            times = {t: [] for t in runs}
            for _ in range(args.rounds):
                for t in (64, 128, 128, 64):
                    times[t].append(time_ms(torch, runs[t], flush, args.runs,
                                            BUSY_CYCLES))
            result[f"pairwise_{n}_by_tile"] = times
            cs.log(f"kernel 5 at N = {n} by tile side (chosen: "
                   f"{pw.tile_size(n, n, True, pw._sm_count(dev))}), device "
                   f"ms: " + json.dumps({k: [round(v, 4) for v in vs]
                                         for k, vs in times.items()}))
    for kernel in [k for k in ABLATIONS if args.ablate and k in picked]:
        libs_cut = build_ablations(kernel)
        if kernel == "fusedconv":
            runs = {name: conv1_caller(torch, lib, y0, ones, zeros, w1, b1)
                    for name, lib in libs_cut.items()}
        elif kernel == "select":
            runs = {name: select_caller(torch, lib, select_keys[
                f"select_{cs.BATCH}"]) for name, lib in libs_cut.items()}
        else:
            x_scale = cs.seeded_latents(torch, dev, cs.N_SCALE)
            runs = {name: pairwise_caller(torch, lib, x_scale)
                    for name, lib in libs_cut.items()}
        times = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name in [*runs, *reversed(runs)]:
                times[name].append(time_ms(torch, runs[name], flush,
                                           args.runs, BUSY_CYCLES))
        result[f"{kernel}_ablations"] = times
        cs.log(f"{kernel} with a part cut out (kernel alone, C interface), "
               "ms: " + json.dumps({k: [round(v, 4) for v in vs]
                                    for k, vs in times.items()}))
    cs.log(f"card: {cs.card_line()}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
