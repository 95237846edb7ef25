#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpuvae_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (``nvidia-smi``);
2. build the five CUDA kernels from ``tpuvae_torch/csrc`` (``nvcc``, one
   process per source, all started together);
3. hold each serving kernel against its plain PyTorch version at the main
   path's shapes (32 clips x 661,500 samples): kernel 1 (fused STFT
   features) in exact and fast mode and power-only, within its stated
   tolerance; kernels 2 (tuning) and 3 (masked-median select) bit-equal;
4. serve the Simple VAE: a seeded corpus of 30 s WAVs, features on the
   card, fitted normalizers, a full-width SimpleVAE from a seeded
   ``torch.Generator``, k = 4 centres, a serving bundle, ``make_server``
   with micro-batching, ``/healthz`` and concurrent ``/encode`` requests
   (``paths`` and ``audio_b64``); launch counters are set to 0 just before
   the requests and read just after; then the staged tuning route, which
   launches kernel 3, through the same entry points;
5. train the Simple VAE and cluster its latents: a seeded
   ``processed_data1`` of 1,336 rows x 370 (the reference dataset's size)
   with 8 planted groups, written through ``save_basic``; ``run_simple_vae``
   on the card at full width (batch 32, 3 epochs, k in {3, 5, 7, 9},
   n_init 10), launch counters set to 0 just before it and read just
   after (kernel 5 must have run); the CSV's two rows finite, and
   ``ClipEncoder.load`` serving the trained bundle; then kernel 5 against
   its plain version at N = 1,336 and 10,240, D = 32;
6. kernel 4 (dense-DFT STFT power) against its plain version at
   32 x 661,500 and at two ragged shapes, within its stated tolerance
   (rtol 1e-4 / atol 1e-6 x max power);
7. the preprocess path at full width: ``generate_dataset`` writes a seeded
   corpus of 192 WAVs of 30 s plus one truncated file; ``preprocess_basic``
   (``stft_method=auto``: kernels 1 + 2) and ``preprocess_advanced``
   (``stft_method=pallas``: kernels 4 + 3) run through the entry points on
   the card with ``extract_batch`` 128, launch counters set to 0 just
   before each and read just after (each kernel once per device batch);
   artifact shapes, zero-mean / unit-variance features, exactly one failed
   clip (the truncated one), and the 290 columns the two runs share held
   to the fast-mode contract (2% rtol / 1.0 atol);
8. the paths joined: ``run_simple_vae`` on the ``processed_data1`` that
   phase 7 wrote, and ``ClipEncoder`` serving that bundle;
9. time each kernel, its plain version and the library yardstick with
   CUDA events (median of 15 runs, L2 flushed before each); kernels 1-4
   also at the pipelines' 128 clips and partial batches, each held
   against its plain version there too; the extract stage's parts,
   ``/encode`` latency and the training and preprocess paths' stages;
10. print the ``kernels`` JSON line, then the ``ok`` line last.
"""

from __future__ import annotations

import base64
import json
import os
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
N_TRAIN = 1336        # rows of the reference's processed_data1
N_GROUPS = 8
N_SCALE = 10240       # the pairwise scale point of bench.py
LATENT = 32
EXTRACT_BATCH = 128   # device batch of the preprocess pipelines
CLIPS_PER_GENRE_LANG = 32   # x 3 genres x 2 languages = 192 clips

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


# -- phase 5: the training path ----------------------------------------------

def train_simple_vae(torch, dev, work: Path, clips: np.ndarray) -> dict:
    """``run_simple_vae`` on the card at full width on a seeded
    ``processed_data1`` (N_TRAIN x 370, N_GROUPS planted groups), then the
    trained bundle served through ``ClipEncoder``.  Returns the launch
    counts of the run and its stage times."""
    import pandas as pd

    from tpuvae_torch import ops
    from tpuvae_torch.config import (
        ClusterConfig,
        PreprocessConfig,
        SimpleVAEConfig,
    )
    from tpuvae_torch.infer import ClipEncoder
    from tpuvae_torch.io.artifacts import save_basic
    from tpuvae_torch.io.normalize import impute_and_scale
    from tpuvae_torch.pipelines import run_simple_vae
    from tpuvae_torch.utils.logging import RunLogger

    rng = np.random.default_rng(SEED)
    groups = np.arange(N_TRAIN) % N_GROUPS
    centres = rng.normal(0.0, 2.0, (N_GROUPS, 370))
    raw = (centres[groups] + rng.normal(size=(N_TRAIN, 370))).astype(np.float32)
    normed, imputer, scaler = impute_and_scale(raw)
    labels = np.array([f"genre_{g}" for g in groups])
    meta = pd.DataFrame({
        "path": [f"clip_{i:04d}.wav" for i in range(N_TRAIN)],
        "genre": labels,
        "language": np.where(groups % 2, "bangla", "english")})
    data_dir = work / "processed_data1_train"
    save_basic(data_dir, features_raw=raw, features_normalized=normed,
               labels=labels, metadata=meta, scaler=scaler, imputer=imputer,
               config=PreprocessConfig(duration=DURATION))
    cfg = SimpleVAEConfig(epochs=3, batch_size=BATCH)
    ccfg = ClusterConfig(simple_k_sweep=(3, 5, 7, 9), kmeans_n_init=10)

    def one_run(tag: str):
        log_path = work / f"train_{tag}.jsonl"
        logger = RunLogger(log_path, echo=False)
        try:
            t0 = time.perf_counter()
            df = run_simple_vae(str(data_dir), str(work / f"train_{tag}"),
                                cfg, ccfg, logger, make_plots=False,
                                device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            logger.close()
        records = [json.loads(line)
                   for line in log_path.read_text().splitlines()]
        events = {rec["event"]: rec for rec in records}
        fit = events["fit"]
        return df, events, {
            "timeline_s": [(rec["event"], rec["t"]) for rec in records],
            "run_simple_vae_s": wall_s, "epochs": fit["epochs"],
            "fit_s": fit["seconds"],
            "ms_per_epoch": fit["seconds"] * 1e3 / fit["epochs"],
            "steps_per_sec": fit["steps_per_sec"],
            "k_sweep_ms": events["k_sweep"]["seconds"] * 1e3,
            "pca_row_ms": events["pca_row"]["seconds"] * 1e3,
            "best_k": events["k_sweep"]["best_k"],
            "k_scores": events["k_sweep"]["scores"],
            "metrics": df.to_dict("records")}

    ops.reset_launch_counts()
    df, events, stages = one_run("first")
    counts = ops.launch_counts()
    log(f"training path: run_simple_vae {N_TRAIN} x 370 in "
        f"{stages['run_simple_vae_s']:.2f} s; launch counts {counts}; rows "
        f"{df.to_dict('records')}")
    check(counts["pairwise"] > 0, "kernel 5 not launched by run_simple_vae")
    check(df["Method"].tolist() == ["VAE + KMeans", "PCA + KMeans"],
          f"metric rows {df['Method'].tolist()}")
    check(np.isfinite(df[["Silhouette", "Calinski-Harabasz"]].to_numpy()).all(),
          "metrics not finite")
    best_k = int(events["k_sweep"]["best_k"])
    check(best_k in ccfg.simple_k_sweep, f"best_k {best_k}")

    enc = ClipEncoder.load("simple", results_dir=str(work / "train_first"))
    check(enc.device == dev, f"encoder on {enc.device}, not {dev}")
    served = enc.encode_waveforms(clips)
    check(served.latents.shape == (len(clips), LATENT)
          and np.isfinite(served.latents).all(), "served latents")
    check(((served.clusters >= 0) & (served.clusters < best_k)).all(),
          f"served clusters {served.clusters}")
    log(f"trained bundle served: clusters {served.clusters.tolist()} of "
        f"best_k {best_k}")
    # the same run again in this process: what is one-time set-up (imports,
    # first launches) and what every run pays
    df_warm, _, warm = one_run("again")
    log(f"training path, second run in the process: "
        f"{warm['run_simple_vae_s']:.2f} s; metrics equal to the first run's: "
        f"{df_warm.equals(df)}")
    return {"counts": counts, "stages": {"first": stages, "again": warm}}


def seeded_latents(torch, dev, n: int):
    """``(n, LATENT)`` seeded normal rows with one near-duplicate pair (the
    clamp at 0)."""
    g = torch.Generator(device=dev).manual_seed(SEED + n)
    x = torch.randn((n, LATENT), generator=g, device=dev)
    x[1] = x[0] + 1e-4
    return x.contiguous()


def check_pairwise(torch, x) -> dict:
    """Kernel 5 against its plain version on ``x``: squared distances
    within 1e-5 x (max|x|^2 + max|y|^2), self-distances with an exactly-zero
    diagonal and within the square root of that bound."""
    from tpuvae_torch.ops.pairwise import (
        self_distances,
        self_distances_plain,
        squared_distances,
        squared_distances_plain,
    )

    d2k = squared_distances(x, x)
    d2p = squared_distances_plain(x, x)
    dk = self_distances(x)
    dp = self_distances_plain(x)
    torch.cuda.synchronize()
    sq = float((x * x).sum(dim=1).max())
    tol = 1e-5 * (sq + sq)
    err2 = (d2k - d2p).abs().max().item()
    err = (dk - dp).abs().max().item()
    check(err2 <= tol, f"kernel 5 squared distances off by {err2} > {tol}")
    check(float(d2k.min()) >= 0.0, "negative squared distance")
    check(bool((dk.diagonal() == 0).all()), "self-distance diagonal not 0")
    check(err <= tol ** 0.5, f"kernel 5 distances off by {err} > {tol ** 0.5}")
    fused = torch.sqrt(d2k).fill_diagonal_(0.0)
    torch.testing.assert_close(dk, fused, rtol=1e-6, atol=0)
    log(f"kernel 5 at N = {x.shape[0]}, D = {x.shape[1]}: squared max abs "
        f"err {err2:.4g} (bound {tol:.4g}), distances {err:.4g}; diagonal 0; "
        f"fused sqrt equal to sqrt of squared mode: "
        f"{bool(torch.equal(dk, fused))}")
    return {"max_abs_err": err, "squared_max_abs_err": err2}


# -- phase 3 (and again at 128 clips): kernel 1 against its plain version ------

def check_stft_features(torch, y, exact: bool):
    """Kernel 1 against its plain version on ``y``.  It computes an fp32
    radix-2 FFT where the plain version calls cuFFT: power, mel power and
    column maxima within rtol 1e-4 / atol 1e-6 x max power (bf16 power in
    fast mode within one bf16 step, rtol 2^-7); centroid, bandwidth, zcr
    and rms within rtol 1e-4 / atol 1e-6; rolloff within one bin (a prefix
    sum in another order).  Returns ``(kernel, plain, max power, power max
    abs err, rolloff max err)``."""
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
    )

    got = stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=N_MELS, exact=exact)
    want = stft_fused_features_plain(y, N_FFT, HOP, sr=SR, n_mels=N_MELS,
                                     exact=exact)
    torch.cuda.synchronize()
    check(got.power.dtype == (torch.float32 if exact else torch.bfloat16),
          f"kernel 1 power dtype {got.power.dtype} (exact={exact})")
    pmax = want.power.float().max().item()
    err = (got.power.float() - want.power.float()).abs().max().item()
    for name in ("power", "mel_power", "colmax"):
        rtol = 2.0 ** -7 if (name == "power" and not exact) else 1e-4
        torch.testing.assert_close(getattr(got, name).float(),
                                   getattr(want, name).float(), rtol=rtol,
                                   atol=1e-6 * pmax)
    for name in ("centroid", "bandwidth", "zcr", "rms"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-6)
    roll_err = (got.rolloff - want.rolloff).abs().max().item()
    check(roll_err <= SR / N_FFT * 1.0001, f"rolloff off by {roll_err} Hz")
    return got, want, pmax, err, roll_err


# -- phase 6: kernel 4 against its plain version -------------------------------

def check_stft_dense(torch, y, n_fft: int, hop: int) -> float:
    """Kernel 4 against its plain version on ``y``: rtol 1e-4 with an atol
    of 1e-6 x max power.  The two sum 2,048 fp32 products per bin in
    different orders, an absolute error near sqrt(K) x eps of the largest
    terms; relative error is unbounded where ``re`` and ``im`` cancel, so
    the atol scales with the maximum power (as tests/test_ops.py states
    the JAX kernel's).  The noise floor of the seeded clips has a mean
    power near 0.7 against a maximum near 1.7e4, so this atol is a few
    percent of an off-peak bin."""
    from tpuvae_torch.ops.stft import stft_power_dense, stft_power_dense_plain

    got = stft_power_dense(y, n_fft, hop)
    want = stft_power_dense_plain(y, n_fft, hop)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (
        y.shape[0], n_fft // 2 + 1, 1 + y.shape[1] // hop),
        f"kernel 4 shape {tuple(got.shape)}")
    pmax = want.max().item()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * pmax)
    log(f"kernel 4 at {tuple(y.shape)}, n_fft {n_fft}, hop {hop}: max abs "
        f"err {err:.4g} (max power {pmax:.4g}) — within rtol 1e-4 / atol "
        f"1e-6 x max power")
    return err


# -- phases 7 and 8: the preprocess path, then the paths joined ---------------

def preprocess_path(torch, dev, work: Path) -> dict:
    """``generate_dataset`` -> ``preprocess_basic`` (auto) ->
    ``preprocess_advanced`` (pallas) -> ``run_simple_vae`` ->
    ``ClipEncoder``, through the entry points on the card at full width.
    Returns launch counts and stage times."""
    import pandas as pd

    from tpuvae_torch import ops, pipelines
    from tpuvae_torch.config import (
        AdvancedPreprocessConfig,
        ClusterConfig,
        PreprocessConfig,
        SimpleVAEConfig,
    )
    from tpuvae_torch.infer import ClipEncoder
    from tpuvae_torch.io.artifacts import load_advanced, load_basic
    from tpuvae_torch.io.synthetic import generate_dataset
    from tpuvae_torch.utils.logging import RunLogger

    root = work / "Datasets"
    t0 = time.perf_counter()
    meta_csv = generate_dataset(root, clips_per_genre_lang=CLIPS_PER_GENRE_LANG,
                                sr=SR, duration=DURATION, seed=SEED)
    n_clips = 6 * CLIPS_PER_GENRE_LANG
    # one deliberately truncated file, catalogued with lyrics so that both
    # pipelines try to decode it
    bad = root / "English_Datasets" / "rock" / "en_rock_truncated.wav"
    good = sorted((root / "English_Datasets" / "rock").glob("*.wav"))[0]
    bad.write_bytes(good.read_bytes()[:16])
    meta = pd.read_csv(meta_csv)
    meta.loc[len(meta)] = {"ID": bad.stem, "genre": "rock",
                           "lyrics": "a truncated file with lyrics enough"}
    meta.to_csv(meta_csv, index=False)
    n_lyricless = 6
    size_mb = sum(f.stat().st_size for f in root.rglob("*.wav")) / 2**20
    log(f"preprocess corpus: {n_clips} clips of {DURATION:g} s + 1 truncated, "
        f"{size_mb:.0f} MB, written in {time.perf_counter() - t0:.1f} s")

    common = dict(sample_rate=SR, duration=DURATION, dataset_root=str(root),
                  metadata_csv=str(meta_csv), extract_batch=EXTRACT_BATCH)
    out = {"host_cores": os.cpu_count(),
           "loader_threads": pipelines._loader_workers()}

    def one(tag, fn, cfg, n_entries, expect, forbid):
        logger = RunLogger(work / f"{tag}.jsonl", echo=False)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = fn(cfg, device="cuda", logger=logger)
            torch.cuda.synchronize()
        finally:
            logger.close()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        batches = -(-n_entries // EXTRACT_BATCH)
        stage = res["stages"][f"extract_{tag}"]
        detail = res["extract_detail"]
        idle = 1.0 - detail["device_s"] / stage["seconds"]
        log(f"preprocess_{tag}: {res['n']} clips ok, {len(res['failed'])} "
            f"failed, wall {wall:.3f} s; extract stage {stage['seconds']:.3f} s "
            f"= {stage['items_per_sec']:.1f} clips/s, device idle share "
            f"{idle:.3f}; host cores {out['host_cores']}, loader threads "
            f"{out['loader_threads']}; launch counts {counts}")
        log(f"preprocess_{tag} extract_detail: " + json.dumps(detail))
        log(f"preprocess_{tag} stages_s: " + json.dumps(
            {k: round(v["seconds"], 4) for k, v in res["stages"].items()}))
        check(len(res["failed"]) == 1 and res["failed"][0][0] == str(bad),
              f"failed clips {res['failed']}")
        for name in expect:
            check(counts[name] == batches,
                  f"{name} launched {counts[name]} times for {batches} batches")
        for name in forbid:
            check(counts[name] == 0, f"{name} launched on the {tag} run")
        out[tag] = {"counts": counts, "wall_s": wall, "n": res["n"],
                    "clips_per_s": stage["items_per_sec"],
                    "device_idle_share": idle, "extract_detail": detail,
                    "stages_s": {k: v["seconds"]
                                 for k, v in res["stages"].items()}}
        return res

    d1 = work / "preprocess" / "processed_data1"
    d2 = work / "preprocess" / "processed_data2"
    one("basic", pipelines.preprocess_basic,
        PreprocessConfig(output_dir=str(d1), stft_method="auto", **common),
        n_clips + 1, ("stft_features", "tuning"),
        ("stft_dense", "masked_median_select"))
    one("advanced", pipelines.preprocess_advanced,
        AdvancedPreprocessConfig(output_dir=str(d2), stft_method="pallas",
                                 **common),
        n_clips - n_lyricless + 1, ("stft_dense", "masked_median_select"),
        ("stft_features", "tuning"))

    basic, adv = load_basic(d1), load_advanced(d2)
    n_adv = n_clips - n_lyricless
    check(basic["features"].shape == (n_clips, 370)
          and basic["features_raw"].shape == (n_clips, 370),
          f"processed_data1 features {basic['features'].shape}")
    check(adv["mel"].shape == (n_adv, N_MELS, 1024)
          and adv["handcrafted"].shape == (n_adv, 290)
          and adv["text"].shape == (n_adv, 768),
          f"processed_data2 shapes {adv['mel'].shape} "
          f"{adv['handcrafted'].shape} {adv['text'].shape}")
    for name, x in (("processed_data1 features", basic["features"]),
                    ("processed_data2 features", adv["handcrafted"]),
                    ("processed_data2 mel", adv["mel"].reshape(n_adv, -1))):
        check(np.isfinite(x).all(), f"{name} not finite")
        mean, std = x.mean(axis=0), x.std(axis=0)
        # a column without variance passes through the scaler unscaled
        check(np.abs(mean[std > 0]).max() < 1e-3
              and np.abs(std[std > 0] - 1.0).max() < 1e-2,
              f"{name} not standardized: |mean| {np.abs(mean).max()}, std in "
              f"[{std.min()}, {std.max()}]")
    check(len(basic["labels"]) == n_clips and len(adv["labels"]) == n_adv
          and set(adv["labels"]) == {"rock", "classical", "pop"}, "labels")
    # the 290 columns both runs compute (mel-dB and the spectral and chroma
    # statistics), rows joined on the file id: kernel 1 + 2 against kernel
    # 4 + 3, held to the fast-mode contract
    raw2 = np.load(d2 / "features_raw.npy")
    row1 = {Path(f).stem: i for i, f in enumerate(basic["metadata"]["filename"])}
    rows = [row1[i] for i in adv["metadata"]["file_id"]]
    shared1 = np.concatenate([basic["features_raw"][rows][:, :2 * N_MELS],
                              basic["features_raw"][rows][:, -34:]], axis=1)
    np.testing.assert_allclose(raw2, shared1, rtol=0.02, atol=1.0)
    dev290 = np.abs(raw2 - shared1)
    log(f"auto (kernels 1 + 2) vs pallas (kernels 4 + 3) on {n_adv} clips x "
        f"290 shared columns: max abs diff {dev290.max():.4g}, max over "
        f"mel-dB columns {dev290[:, :2 * N_MELS].max():.4g}, chroma columns "
        f"{dev290[:, -24:].max():.4g} — within 2% rtol / 1.0 atol")

    # ---- 8. the paths joined: train on what preprocess_basic wrote ----------
    results = work / "results_joined"
    logger = RunLogger(work / "joined.jsonl", echo=False)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        df = pipelines.run_simple_vae(
            str(d1), str(results), SimpleVAEConfig(epochs=3, batch_size=BATCH),
            ClusterConfig(simple_k_sweep=(3, 5, 7, 9), kmeans_n_init=10),
            logger, make_plots=False, device="cuda")
        torch.cuda.synchronize()
    finally:
        logger.close()
    out["joined_train_s"] = time.perf_counter() - t0
    check(ops.launch_counts()["pairwise"] == 3, "kernel 5 on the joined run")
    check(np.isfinite(df[["Silhouette", "Calinski-Harabasz"]].to_numpy()).all(),
          "joined metrics not finite")
    enc = ClipEncoder.load("simple", results_dir=str(results))
    check(Path(enc.meta["data_dir"]) == d1, "bundle points at processed_data1")
    wavs = sorted((root / "Bangla_Datasets" / "pop").glob("*.wav"))[:4]
    served = enc.encode_paths(wavs)
    check(served.latents.shape == (4, LATENT)
          and np.isfinite(served.latents).all() and (served.clusters >= 0).all(),
          "joined serving")
    log(f"paths joined: run_simple_vae on the preprocessed {n_clips} x 370 in "
        f"{out['joined_train_s']:.2f} s, rows {df.to_dict('records')}; "
        f"ClipEncoder clusters {served.clusters.tolist()}")
    return out


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
    for name in ("stft_features", "tuning", "select", "pairwise",
                 "stft_dense"):
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
    from tpuvae_torch.dsp.chroma import (
        _tuning_candidates,
        chroma_batch,
        estimate_tuning_batch,
    )
    from tpuvae_torch.dsp.features import extract_basic_features, make_extractor
    from tpuvae_torch.dsp.primitives import mel_filterbank
    from tpuvae_torch.infer import ClipEncoder, save_serving_bundle
    from tpuvae_torch.io.normalize import impute_and_scale
    from tpuvae_torch.io.wav import load_audio
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.ops.pairwise import self_distances, self_distances_plain
    from tpuvae_torch.ops.select import (
        I32_MAX,
        key_to_float,
        masked_keys,
        select_stats,
        select_stats_plain,
    )
    from tpuvae_torch.ops.stft import (
        _folded_basis,
        stft_fused_features,
        stft_fused_features_plain,
        stft_power,
        stft_power_dense,
        stft_power_dense_plain,
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

    fe_x, pl_x, pmax, k1_err, roll_err = check_stft_features(torch, y, True)
    log(f"kernel 1 exact: power max abs err {k1_err:.4g} (max power "
        f"{pmax:.4g}); rolloff max err {roll_err:.4g} Hz — within rtol 1e-4 "
        f"/ atol 1e-6 x max power, one bin")
    fe_f, pl_f, *_ = check_stft_features(torch, y, False)
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

    # ---- 5. the training path: train the Simple VAE, cluster its latents ---
    train = train_simple_vae(torch, dev, work, waves[:4])
    x1336 = seeded_latents(torch, dev, N_TRAIN)
    x_scale = seeded_latents(torch, dev, N_SCALE)
    for x in (x1336, x_scale):
        results["pairwise"] = check_pairwise(torch, x)

    # ---- 6. kernel 4 against its plain version -------------------------------
    k4_err = check_stft_dense(torch, y, N_FFT, HOP)
    ragged = torch.from_numpy(waves[:3, :2 * SR].copy()).to(dev)
    check_stft_dense(torch, ragged, N_FFT, HOP)
    check_stft_dense(torch, ragged[:, :30001].contiguous(), 1024, 256)
    results["stft_dense"] = {"max_abs_err": k4_err}

    # ---- 7 + 8. the preprocess path, then the paths joined -------------------
    pre = preprocess_path(torch, dev, work)

    # ---- 9. timing ----------------------------------------------------------
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
    # one PyTorch call computes kernel 3's function: the median of the
    # unmasked values, NaN marking the masked-off ones (linear
    # interpolation = numpy's mean of the two middles for even n)
    k3_values = torch.where(keys < I32_MAX, key_to_float(keys),
                            torch.tensor(float("nan"), device=dev))
    n_sc = x_scale.shape[0]
    k5_bytes = 2 * n_sc * LATENT * 4 + n_sc * n_sc * 4
    k5_flops = 2 * n_sc * n_sc * LATENT + 3 * n_sc * n_sc
    # kernel 4: two dense products of every frame against the 1,025 bins
    k4_flops = 4.0 * frames * N_FFT * nbins
    k4_bytes = (y.numel() * 4 + 2 * N_FFT * nbins * 4
                + BATCH * nbins * n_frames * 4)
    basis_cat = torch.from_numpy(
        np.concatenate(_folded_basis(N_FFT), axis=1)).to(dev)

    def library_k4_cublas():
        # the same arithmetic through cuBLAS: frames x [cos | sin]
        fr = torch.nn.functional.pad(y, (N_FFT // 2, N_FFT // 2)).unfold(
            -1, N_FFT, HOP)
        z = torch.matmul(fr, basis_cat)
        return (z[..., :nbins].square() + z[..., nbins:].square()).transpose(1, 2)

    def library_k4_stft():
        spec = torch.stft(y, N_FFT, HOP, window=window, center=True,
                          pad_mode="constant", return_complex=True)
        return spec.real.square() + spec.imag.square()

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
            lambda: torch.nanquantile(k3_values, 0.5, dim=1),
            k3_bytes, k3_flops),
        "pairwise": (
            lambda: self_distances(x_scale),
            lambda: self_distances_plain(x_scale),
            lambda: torch.cdist(x_scale, x_scale,
                                compute_mode="use_mm_for_euclid_dist"),
            k5_bytes, k5_flops),
        "stft_dense": (
            lambda: stft_power_dense(y, N_FFT, HOP),
            lambda: stft_power_dense_plain(y, N_FFT, HOP),
            library_k4_stft, k4_bytes, k4_flops),
    }
    static = {
        "stft_features": ("tpuvae_torch/csrc/stft_features.cu",
                          "tpuvae/ops/stft.py:418", "served /encode"),
        "tuning": ("tpuvae_torch/csrc/tuning.cu", "tpuvae/ops/tuning.py:352",
                   "served /encode"),
        "masked_median_select": ("tpuvae_torch/csrc/select.cu",
                                 "tpuvae/ops/select.py:32",
                                 "staged tuning route via ServingApp.encode"),
        "pairwise": ("tpuvae_torch/csrc/pairwise.cu",
                     "tpuvae/ops/pairwise.py:27",
                     f"run_simple_vae at {N_TRAIN} x 370 (timed at "
                     f"N = {N_SCALE}, D = {LATENT})"),
        "stft_dense": ("tpuvae_torch/csrc/stft_dense.cu",
                       "tpuvae/ops/stft.py:73",
                       f"preprocess_advanced(stft_method='pallas') at "
                       f"extract_batch {EXTRACT_BATCH} (timed at {BATCH} "
                       f"clips)"),
    }
    counts = dict(served_counts)
    counts["masked_median_select"] = staged_counts["masked_median_select"]
    counts["pairwise"] = train["counts"]["pairwise"]
    counts["stft_dense"] = pre["advanced"]["counts"]["stft_dense"]
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
    k4_cublas_ms = time_ms(torch, library_k4_cublas, flush)
    log(f"time stft_dense, the cuBLAS form (unfold x [cos | sin], square, "
        f"add): {k4_cublas_ms:.4f} ms")
    kernels[-1]["cublas_form_ms"] = k4_cublas_ms
    del basis_cat

    # where the extract stage's time goes at 32 clips (its host clock read
    # 21 ms around ~4.5 ms of kernels 1 + 2): each part alone, CUDA events
    waves32 = waves[:BATCH]
    pinned = torch.from_numpy(waves32).pin_memory()
    fe32 = stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=N_MELS)
    parts = {
        "h2d_pageable_f32": lambda: torch.as_tensor(waves32).to(dev),
        "h2d_pinned_f32": lambda: pinned.to(dev, non_blocking=True),
        "extract_basic_features_on_card": lambda: extract_basic_features(y, cfg),
        "chroma_batch (kernel 2 + projection)": lambda: chroma_batch(
            fe32.power, SR, N_FFT, fe32.colmax),
        "features_d2h": lambda: feats_dev.cpu(),
    }
    feats_dev = extract_basic_features(y, cfg)
    extract_parts = {k: round(time_ms(torch, fn, flush, runs=7), 4)
                     for k, fn in parts.items()}
    log("extract stage parts at 32 clips, ms: " + json.dumps(extract_parts))
    del fe32, pinned

    # kernels 1-3 at the preprocess pipelines' device batch of 128 clips
    # (the band of kernels 2 and 3 no longer fits the L2 there)
    y128 = torch.from_numpy(np.concatenate([waves, waves])[:EXTRACT_BATCH]).to(dev)
    fe128 = stft_fused_features(y128, N_FFT, HOP, sr=SR, n_mels=N_MELS)
    _, mags128, mask128 = _tuning_candidates(fe128.power.float(), SR, N_FFT,
                                             fe128.colmax)
    keys128 = masked_keys(mags128.reshape(EXTRACT_BATCH, -1),
                          mask128.reshape(EXTRACT_BATCH, -1)).contiguous()
    del mags128, mask128
    check(torch.equal(estimate_tuning(fe128.power, fe128.colmax, SR, N_FFT),
                      estimate_tuning_plain(fe128.power, fe128.colmax, SR,
                                            N_FFT)),
          "kernel 2 != plain at 128 clips")
    check(torch.equal(select_stats(keys128), select_stats_plain(keys128)),
          "kernel 3 != plain at 128 clips")
    # kernels 1 and 4 at the shapes the pipelines launch them at: the full
    # device batch and each run's partial one (193 = 128 + 65 clips decoded
    # by the basic run, 187 = 128 + 59 by the advanced one)
    for part in (y128, y128[:65]):
        *_, err128, roll128 = check_stft_features(torch, part, False)
        log(f"kernel 1 fast at {tuple(part.shape)}: bf16 power max abs err "
            f"{err128:.4g}, rolloff max err {roll128:.4g} Hz — within phase "
            f"3's tolerance")
    for part in (y128, y128[:59]):
        check_stft_dense(torch, part, N_FFT, HOP)
    at128 = {
        "stft_features": time_ms(torch, lambda: stft_fused_features(
            y128, N_FFT, HOP, sr=SR, n_mels=N_MELS), flush, runs=7),
        "tuning": time_ms(torch, lambda: estimate_tuning(
            fe128.power, fe128.colmax, SR, N_FFT), flush, runs=7),
        "masked_median_select": time_ms(
            torch, lambda: select_stats(keys128), flush, runs=7),
        "stft_dense": time_ms(torch, lambda: stft_power_dense(
            y128, N_FFT, HOP), flush, runs=5),
    }
    log(f"kernels at {EXTRACT_BATCH} clips (1 and 4 within tolerance of "
        f"plain, 2 and 3 equal), ms: "
        + json.dumps({k: round(v, 4) for k, v in at128.items()}))
    del y128, fe128, keys128

    log("preprocess path: " + json.dumps(pre))
    log("encode latency: " + json.dumps(encode_ms))
    log("training path: " + json.dumps(train["stages"]))
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
