#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpuvae_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``tpuvae_torch/csrc`` (``nvcc``);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (32 clips x 661,500 samples): kernel 1 (fused STFT features) in
   exact and fast mode and power-only, within its stated tolerance;
   kernels 2 (tuning) and 3 (masked-median select) bit-equal;
4. serve the Simple VAE: a seeded corpus of 30 s WAVs, features on the
   card, fitted normalizers, a full-width SimpleVAE from a seeded
   ``torch.Generator``, k = 4 centres, a serving bundle, ``make_server``
   with micro-batching, ``/healthz`` and concurrent ``/encode`` requests
   (``paths`` and ``audio_b64``); launch counters are set to 0 just before
   the requests and read just after; then the staged tuning route, which
   launches kernel 3, through the same entry points;
5. time each kernel, its plain version and the library yardstick with
   CUDA events (median of 15 runs, L2 flushed before each), and ``/encode``
   latency;
6. print the ``kernels`` JSON line, then the ``ok`` line last.
"""

from __future__ import annotations

import base64
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import wave
from pathlib import Path

import numpy as np

SR = 22050
DURATION = 30.0
N_FFT = 2048
HOP = 512
N_MELS = 128
BATCH = 32            # device batch of the serving path (tpuvae/infer.py:241)
N_CORPUS = 64
K_CENTRES = 4
SEED = 1234

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s and fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- data ------------------------------------------------------------------

def tones(n: int, n_samples: int, seed: int) -> np.ndarray:
    """Harmonic tones at random pitch with noise (as tests/test_ops.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float64) / SR
    out = np.empty((n, n_samples), np.float32)
    for i in range(n):
        f0 = 110 * 2 ** rng.uniform(0, 3)
        n_harm = 1 + i % 4
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(n_harm))
        out[i] = 0.25 * sig / n_harm + 0.03 * rng.normal(size=n_samples)
    return out


def write_wav(path: Path, y: np.ndarray) -> None:
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


# -- timing ----------------------------------------------------------------

def time_ms(torch, fn, flush, runs: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` with CUDA events; the L2 is flushed
    (a 128 MB write) before each timed run, outside the timed region."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- HTTP ------------------------------------------------------------------

def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=300) as r:
        return json.loads(r.read())


def post_json(url: str, body: dict) -> tuple[dict, float]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
        status = r.status
    ms = (time.perf_counter() - t0) * 1e3
    check(status == 200, f"/encode returned {status}: {out}")
    return out, ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        import tpuvae_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import tpuvae_torch ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    from tpuvae_torch.device import resolve_device
    from tpuvae_torch.ops import _build

    # ---- 1. the card --------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    dev = resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------------
    build_s = _build.build_all()
    log(f"build: {build_s:.1f} s (0 = already built)")
    for name in ("stft_features", "tuning", "select"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    work = repo / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        return run(torch, dev, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(torch, dev, work: Path, card: str) -> int:
    from tpuvae_torch import ops
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.chroma import _tuning_candidates, estimate_tuning_batch
    from tpuvae_torch.dsp.features import extract_basic_features, make_extractor
    from tpuvae_torch.dsp.primitives import mel_filterbank
    from tpuvae_torch.infer import ClipEncoder, save_serving_bundle
    from tpuvae_torch.io.normalize import impute_and_scale
    from tpuvae_torch.io.wav import load_audio
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.ops.select import (
        masked_keys,
        select_stats,
        select_stats_plain,
    )
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
        stft_power,
    )
    from tpuvae_torch.ops.tuning import (
        _tuning_consts,
        estimate_tuning,
        estimate_tuning_plain,
    )
    from tpuvae_torch.serve import ServingApp, make_server

    n_samples = int(SR * DURATION)
    n_frames = 1 + n_samples // HOP
    cfg = PreprocessConfig(duration=DURATION)   # precision_mode fast
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)

    # ---- corpus -------------------------------------------------------------
    t0 = time.perf_counter()
    corpus = tones(N_CORPUS, n_samples, SEED)
    paths = []
    for i, y in enumerate(corpus):
        p = work / f"clip_{i:03d}.wav"
        write_wav(p, y)
        paths.append(p)
    log(f"corpus: {N_CORPUS} clips of {DURATION:g} s written in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels against their plain versions -----------------------------
    waves = np.stack([load_audio(p, SR, DURATION) for p in paths])
    y = torch.from_numpy(waves[:BATCH]).to(dev)
    results = {}

    fe_x = stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=N_MELS,
                               exact=True)
    pl_x = stft_fused_features_plain(y, N_FFT, HOP, sr=SR, n_mels=N_MELS,
                                     exact=True)
    torch.cuda.synchronize()
    pmax = pl_x.power.max().item()
    k1_err = (fe_x.power - pl_x.power).abs().max().item()
    for name in ("power", "mel_power", "colmax"):
        torch.testing.assert_close(getattr(fe_x, name), getattr(pl_x, name),
                                   rtol=1e-4, atol=1e-6 * pmax)
    for name in ("centroid", "bandwidth", "zcr", "rms"):
        torch.testing.assert_close(getattr(fe_x, name), getattr(pl_x, name),
                                   rtol=1e-4, atol=1e-6)
    roll_err = (fe_x.rolloff - pl_x.rolloff).abs().max().item()
    check(roll_err <= SR / N_FFT * 1.0001, f"rolloff off by {roll_err} Hz")
    log(f"kernel 1 exact: power max abs err {k1_err:.4g} (max power "
        f"{pmax:.4g}); rolloff max err {roll_err:.4g} Hz — within rtol 1e-4 "
        f"/ atol 1e-6 x max power, one bin")
    fe_f = stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=N_MELS,
                               exact=False)
    pl_f = stft_fused_features_plain(y, N_FFT, HOP, sr=SR, n_mels=N_MELS,
                                     exact=False)
    check(fe_f.power.dtype == torch.bfloat16, "fast mode stores bf16 power")
    torch.testing.assert_close(fe_f.power.float(), pl_f.power.float(),
                               rtol=2.0 ** -7, atol=1e-6 * pmax)
    torch.testing.assert_close(fe_f.mel_power, pl_f.mel_power, rtol=1e-4,
                               atol=1e-6 * pmax)
    bf16_diff = (fe_f.power != pl_f.power).float().mean().item()
    log(f"kernel 1 fast: bf16 power within one bf16 step; share of bins that "
        f"differ {bf16_diff:.3g}")
    p_only = stft_power(y, N_FFT, HOP)
    torch.testing.assert_close(p_only, pl_x.power, rtol=1e-4,
                               atol=1e-6 * pmax)
    log("kernel 1 power-only: within rtol 1e-4 / atol 1e-6 x max power")
    results["stft_features"] = {"max_abs_err": k1_err}
    del pl_x, pl_f, p_only

    t_k = estimate_tuning(fe_f.power, fe_f.colmax, SR, N_FFT)
    t_p = estimate_tuning_plain(fe_f.power, fe_f.colmax, SR, N_FFT)
    check(torch.equal(t_k, t_p), f"tuning kernel {t_k} != plain {t_p}")
    t_kx = estimate_tuning(fe_x.power, fe_x.colmax, SR, N_FFT)
    t_px = estimate_tuning_plain(fe_x.power, fe_x.colmax, SR, N_FFT)
    check(torch.equal(t_kx, t_px), "tuning kernel != plain on f32 power")
    log(f"kernel 2: equal to plain on bf16 and f32 power; tunings "
        f"{t_k[:8].tolist()} ...")
    results["tuning"] = {"max_abs_err": 0.0}

    _, mags, mask = _tuning_candidates(fe_f.power.float(), SR, N_FFT,
                                       fe_f.colmax)
    mags = mags.reshape(BATCH, -1)
    mask = mask.reshape(BATCH, -1).clone()
    mask[0] = False                     # empty-mask row
    mask[1] = False
    mask[1, mask.shape[1] // 2] = True  # single-element row
    keys = masked_keys(mags, mask).contiguous()
    s_k = select_stats(keys)
    s_p = select_stats_plain(keys)
    check(torch.equal(s_k, s_p), "select kernel != plain")
    log(f"kernel 3: equal to plain on keys {tuple(keys.shape)} (rows 0/1: "
        f"empty / single element; n of row 2 = {s_k[2, 0].item()})")
    results["masked_median_select"] = {"max_abs_err": 0.0}
    del mags, mask, fe_x

    # ---- 4. the main path: serve the Simple VAE ------------------------------
    extract = make_extractor(extract_basic_features, cfg, dev)
    feats = np.concatenate([extract(waves[i:i + BATCH]).cpu().numpy()
                            for i in range(0, N_CORPUS, BATCH)])
    check(feats.shape == (N_CORPUS, 370) and np.isfinite(feats).all(),
          f"features {feats.shape} finite {np.isfinite(feats).all()}")
    normed, imputer, scaler = impute_and_scale(feats)
    gen = torch.Generator().manual_seed(SEED)
    model = SimpleVAE()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                # flax's lecun_normal init, from the explicit generator
                mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 2.0, generator=gen)
    model.eval()
    with torch.no_grad():
        lat = model.latent(torch.from_numpy(normed)).numpy()
    centres = lat[np.linspace(0, N_CORPUS - 1, K_CENTRES).astype(int)]
    results_dir, data_dir = work / "results", work / "processed_data1"
    meta = {"arch": "simple", "input_dim": 370, "hidden_dims": [128, 64, 32],
            "latent_dim": 32, "dropout": 0.2, "data_dir": str(data_dir)}
    save_serving_bundle(results_dir, data_dir, model, centres, pre_cfg=cfg,
                        imputer=imputer, scaler=scaler, meta=meta)
    enc = ClipEncoder.load("simple", results_dir=str(results_dir))
    check(enc.device == dev, f"encoder on {enc.device}, not {dev}")
    enc.encode_waveforms(waves[:1])      # warm-up: first launches, cuFFT plans
    srv = make_server(enc, port=0, quiet=True, batch_wait_ms=20.0,
                      max_batch=BATCH)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        health = get_json(url + "/healthz")
        check(health["status"] == "ok" and health["device"] == str(dev),
              f"healthz {health}")
        requests = [
            {"paths": [str(p) for p in paths[0:8]]},
            {"paths": [str(p) for p in paths[8:20]]},
            {"audio_b64": [base64.b64encode(paths[i].read_bytes()).decode()
                           for i in (20, 21)]},
            {"audio_b64": [base64.b64encode(paths[i].read_bytes()).decode()
                           for i in (22, 23, 24)]},
        ]
        order = [list(range(0, 8)), list(range(8, 20)), [20, 21],
                 [22, 23, 24]]
        replies = [None] * len(requests)

        def one(i):
            replies[i] = post_json(url + "/encode", requests[i])

        ops.reset_launch_counts()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(requests))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall_ms = (time.perf_counter() - t0) * 1e3
        served_counts = ops.launch_counts()
        check(not any(th.is_alive() for th in threads), "requests hung")
        check(all(r is not None for r in replies), "a request failed")
        log(f"main path: {len(requests)} concurrent /encode requests "
            f"({sum(len(o) for o in order)} clips) in {wall_ms:.1f} ms; "
            f"launch counts {served_counts}; healthz {get_json(url + '/healthz')}")
        for name in ("stft_features", "tuning"):
            check(served_counts[name] > 0, f"{name} not launched on the path")

        got = np.zeros((25, 32), np.float32)
        clusters = np.zeros(25, np.int64)
        for (out, _), idx in zip(replies, order):
            got[idx] = np.asarray(out["latents"], np.float32)
            clusters[idx] = out["clusters"]
        direct = enc.encode_waveforms(waves[:25])
        check(np.isfinite(got).all(), "served latents finite")
        np.testing.assert_allclose(got, direct.latents, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(clusters, direct.clusters)
        check(((clusters >= 0) & (clusters < K_CENTRES)).all(),
              f"clusters {clusters}")
        log(f"served latents == ClipEncoder.encode_waveforms (atol 1e-5); "
            f"clusters {np.bincount(clusters, minlength=K_CENTRES).tolist()}")

        seq_ms = [post_json(url + "/encode", {"paths": [str(paths[30 + i])]})[1]
                  for i in range(8)]
        encode_ms = {
            "concurrent_request_ms": [round(r[1], 3) for r in replies],
            "single_clip_request_ms_median": statistics.median(seq_ms),
            "single_clip_request_ms": [round(v, 3) for v in seq_ms],
        }
    finally:
        srv.shutdown()
        srv.server_close()
        srv.app.close()
        thread.join(timeout=30)

    # where an encode's time goes: host decode, device extraction (kernels
    # 1 and 2 plus the plain tensor ops around them), host normalizers,
    # device encoder; host clock around synchronised stages, median of 3
    for n_clips in (1, BATCH):
        stages = {"load": [], "extract": [], "normalize": [], "latent": []}
        for _ in range(3):
            t0 = time.perf_counter()
            w = enc.load_waveforms(paths[BATCH:BATCH + n_clips])
            t1 = time.perf_counter()
            raw = enc.extract(w).cpu().numpy()
            t2 = time.perf_counter()
            x = enc.normalize(raw)
            t3 = time.perf_counter()
            enc.apply_latent(x).cpu()
            t4 = time.perf_counter()
            for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[k].append(dt * 1e3)
        encode_ms[f"stages_ms_{n_clips}_clips"] = {
            k: round(statistics.median(v), 3) for k, v in stages.items()}

    # staged tuning route through the same entry points: kernel 3
    staged = ClipEncoder.load("simple", results_dir=str(results_dir),
                              tuning_route="staged")
    app = ServingApp(staged)
    ops.reset_launch_counts()
    out_staged = app.encode({"paths": [str(p) for p in paths[:BATCH]]})
    staged_counts = ops.launch_counts()
    log(f"staged route: launch counts {staged_counts}")
    check(staged_counts["masked_median_select"] > 0, "kernel 3 not launched")
    check(staged_counts["tuning"] == 0, "staged route must not run kernel 2")
    fused_lat = enc.encode_waveforms(waves[:BATCH]).latents
    np.testing.assert_allclose(np.asarray(out_staged["latents"]), fused_lat,
                               rtol=0, atol=1e-6)
    t_fused = estimate_tuning_batch(fe_f.power, SR, N_FFT, fe_f.colmax,
                                    route="fused")
    t_staged = estimate_tuning_batch(fe_f.power, SR, N_FFT, fe_f.colmax,
                                     route="staged")
    check(torch.equal(t_fused, t_staged), "staged tunings != fused tunings")
    log("staged route: tunings equal kernel 2's; latents equal the fused "
        "route's")

    # ---- 5. timing ----------------------------------------------------------
    nbins = N_FFT // 2 + 1
    fb = mel_filterbank(SR, N_FFT, N_MELS)
    frames = BATCH * n_frames
    k1_flops = frames * (5 * (N_FFT // 2) * np.log2(N_FFT // 2)   # complex FFT
                         + 10 * nbins + 3 * nbins                # split, power
                         + 2 * int((fb != 0).sum())              # sparse mel
                         + 13 * nbins                            # statistics
                         + N_FFT + 4 * N_FFT)                    # window, zcr/rms
    k1_bytes = (y.numel() * 4 + BATCH * nbins * n_frames * 2
                + BATCH * N_MELS * n_frames * 4 + BATCH * 6 * n_frames * 4)
    window = torch.hann_window(N_FFT, periodic=True, device=dev)
    fb_t = torch.from_numpy(fb).to(dev)

    def library_k1():
        spec = torch.stft(y, N_FFT, HOP, window=window, center=True,
                          pad_mode="constant", return_complex=True)
        p = spec.real.square() + spec.imag.square()
        return p.to(torch.bfloat16), torch.matmul(fb_t, p)

    lo8, r8, *_ = _tuning_consts(SR, N_FFT, nbins, 0.01)
    band = BATCH * r8 * n_frames
    k2_bytes = band * 2 + BATCH * n_frames * 4 + BATCH * 4
    # ~25 fp32 ops per band element: piptrack's threshold, compares,
    # parabolic shift and magnitude, the order key, and the vote's residual
    k2_flops = band * 25
    k3_bytes = keys.numel() * 4 + BATCH * 16
    k3_flops = keys.numel() * 2             # a compare and a count per key

    timings = {
        "stft_features": (
            lambda: stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=N_MELS,
                                        exact=False),
            lambda: stft_fused_features_plain(y, N_FFT, HOP, sr=SR,
                                              n_mels=N_MELS, exact=False),
            library_k1, k1_bytes, k1_flops),
        "tuning": (
            lambda: estimate_tuning(fe_f.power, fe_f.colmax, SR, N_FFT),
            lambda: estimate_tuning_plain(fe_f.power, fe_f.colmax, SR, N_FFT),
            None, k2_bytes, k2_flops),
        "masked_median_select": (
            lambda: select_stats(keys),
            lambda: select_stats_plain(keys),
            None, k3_bytes, k3_flops),
    }
    static = {
        "stft_features": ("tpuvae_torch/csrc/stft_features.cu",
                          "tpuvae/ops/stft.py:418", "served /encode"),
        "tuning": ("tpuvae_torch/csrc/tuning.cu", "tpuvae/ops/tuning.py:352",
                   "served /encode"),
        "masked_median_select": ("tpuvae_torch/csrc/select.cu",
                                 "tpuvae/ops/select.py:32",
                                 "staged tuning route via ServingApp.encode"),
    }
    counts = dict(served_counts)
    counts["masked_median_select"] = staged_counts["masked_median_select"]
    kernels = []
    for name, (kern, plain, lib, nbytes, nflops) in timings.items():
        ms = time_ms(torch, kern, flush)
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, lib, flush) if lib is not None else None
        b_ms, b_by = bound(nbytes, nflops)
        src, replaces, path = static[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": results[name]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "path": path,
            "bytes": int(nbytes), "flops": float(nflops),
        })
        log(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    log("encode latency: " + json.dumps(encode_ms))
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
