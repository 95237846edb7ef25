"""Parity and quality gates (counterpart of ``tpuvae/parity.py``).

:func:`run_parity` runs the whole 3-VAE x clustering sweep twice and
requires every metric of ``clustering_metrics.csv`` to reproduce within
``tol`` (0.01, the parity bar of ``BASELINE.json``): reproducibility of the
port's own pipeline under the reference's seeding (seed 42 everywhere).
XLA gives the JAX package that for free; PyTorch on a card does not, so
the two runs go under :func:`deterministic_algorithms` (deterministic
cuDNN algorithms, no autotuning, a fixed cuBLAS workspace).  The six
hand-written kernels are bit-equal run to run by construction.

:func:`run_quality` runs the sweep once on a corpus with planted genre
structure and requires the pipeline to recover it: a numerics regression
that degrades every run alike passes parity but fails here.
"""

from __future__ import annotations

import contextlib
import math
import os
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from tpuvae_torch.cluster.kmeans import kmeans
from tpuvae_torch.config import (
    ClusterConfig,
    ConditionalVAEConfig,
    HybridVAEConfig,
    SimpleVAEConfig,
)
from tpuvae_torch.device import resolve_device
from tpuvae_torch.metrics.external import adjusted_rand_score, purity_score
from tpuvae_torch.metrics.labels import compact_labels
from tpuvae_torch.utils.logging import RunLogger


def compare_metrics_csv(a: str | Path, b: str | Path,
                        tol: float = 0.01) -> list[str]:
    """Human-readable mismatches between two consolidated metric CSVs
    (empty list == parity)."""
    da = pd.read_csv(a)
    db = pd.read_csv(b)
    problems: list[str] = []
    if len(da) != len(db):
        return [f"row count differs: {len(da)} vs {len(db)}"]
    key_cols = [c for c in ("Architecture", "Method", "Algorithm")
                if c in da.columns]
    da = da.sort_values(key_cols).reset_index(drop=True)
    db = db.sort_values(key_cols).reset_index(drop=True)
    for col in da.columns:
        if col not in db.columns:
            problems.append(f"missing column {col}")
            continue
        for i in range(len(da)):
            va, vb = da.at[i, col], db.at[i, col]
            if isinstance(va, float) and isinstance(vb, float):
                if math.isnan(va) and math.isnan(vb):
                    continue
                if abs(va - vb) > tol:
                    problems.append(
                        f"{col}[{i}] ({da.at[i, key_cols[0]] if key_cols else i}): "
                        f"{va:.4f} vs {vb:.4f}")
            elif str(va) != str(vb):
                problems.append(f"{col}[{i}]: {va!r} vs {vb!r}")
    return problems


@contextlib.contextmanager
def deterministic_algorithms():
    """Run the body with ``torch.use_deterministic_algorithms(True,
    warn_only=True)``, cuDNN autotuning off and ``CUBLAS_WORKSPACE_CONFIG``
    set (unless already set); restores all three after.  Yields the list of
    the nondeterminism warnings the body raised (an op with no
    deterministic implementation warns instead of failing)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.benchmark)
    set_env = "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    if set_env:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    seen: list[str] = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
        seen.extend(sorted({str(w.message).split("\n")[0] for w in caught
                            if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.benchmark = prev[2]
        if set_env:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def _run_sweep(data1, data2, results, ov, ccfg, logger, device) -> None:
    from tpuvae_torch.pipelines import (
        run_conditional_vae,
        run_hybrid_vae,
        run_simple_vae,
    )

    run_simple_vae(data1, results, SimpleVAEConfig(**ov), ccfg, logger=logger,
                   make_plots=False, device=device)
    run_conditional_vae(data2, results, ConditionalVAEConfig(**ov), ccfg,
                        logger=logger, make_plots=False, device=device)
    run_hybrid_vae(data2, results, HybridVAEConfig(**ov), ccfg, logger=logger,
                   make_plots=False, device=device)


def run_parity(
    data1: str = "processed_data1",
    data2: str = "processed_data2",
    work_dir: str = "parity_runs",
    tol: float = 0.01,
    fast: bool = True,
    cluster_cfg=None,
    overrides: dict | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the full sweep twice on ``device``; return ``{'ok', 'problems',
    'nondeterministic_ops'}``.

    ``cluster_cfg`` / ``overrides`` (extra model-config fields, e.g.
    ``{"epochs": 2, "batch_size": 8}``) let the harness run on small test
    corpora; the defaults reproduce the reference geometry (3 epochs when
    ``fast``).
    """
    dev = resolve_device(device)
    work = Path(work_dir)
    ov = dict(overrides or {})
    if fast:
        ov.setdefault("epochs", 3)
    logger = RunLogger(echo=False)
    ccfg = cluster_cfg if cluster_cfg is not None else ClusterConfig()
    with deterministic_algorithms() as nondeterministic:
        for run in ("run_a", "run_b"):
            _run_sweep(data1, data2, str(work / run), ov, ccfg, logger, dev)
    problems = compare_metrics_csv(
        work / "run_a" / "clustering_metrics.csv",
        work / "run_b" / "clustering_metrics.csv", tol=tol)
    return {"ok": not problems, "problems": problems,
            "nondeterministic_ops": nondeterministic}


# -----------------------------------------------------------------------------
# Quality gate: does the pipeline RECOVER planted structure?
# -----------------------------------------------------------------------------

# The floors are the JAX package's values, copied as they stand; their
# two-corpus calibration (the default generator at separation 1.0, and a
# harder corpus at 0.75) is recorded with them in tpuvae/parity.py:95-125.
# They are properties of io/synthetic.py's generator, which the port
# reproduces.  Trained-metric floors gate "learned nothing / collapsed",
# not "matched the best run".
QUALITY_FLOORS = {
    # K-Means on the basic 370-d features: no VAE training, so a miss here
    # means the DSP / normalization chain regressed
    "direct370_ari": 0.7,
    "direct370_purity": 0.85,
    # K-Means on the MFCC-less 290-d flats ("Direct Spectral"): margins
    # above chance, the separability of these features is corpus-dependent
    "direct_ari": 0.3,
    "direct_purity_margin": 0.4,   # above the majority-class share
    "cvae_purity_margin": 0.15,    # above the majority-class share
    "hybrid_ari": 0.1,
    "silhouette": 0.0,
}

# Floors for the hard corpus profile (separation <= 0.95)
QUALITY_FLOORS_HARD = {
    "direct370_ari": 0.5,
    "direct370_purity": 0.7,
    "direct_ari": 0.2,
    "direct_purity_margin": 0.3,
    "cvae_purity_margin": 0.1,
    "hybrid_ari": 0.05,
    "silhouette": 0.0,
}


def quality_floors(separation: float = 1.0) -> dict:
    """Floor set for a corpus difficulty (``io/synthetic.py``
    ``separation``): the default set above 0.95, the hard set at or
    below."""
    return dict(QUALITY_FLOORS if separation > 0.95 else QUALITY_FLOORS_HARD)


def direct370_scores(data1: str, device: str | torch.device = "cuda",
                     seed: int = 42) -> tuple[float, float]:
    """``(ARI, purity)`` of K-Means (k = number of genres, n_init 10) on the
    normalized 370-d features of ``data1`` against its labels: the gate's
    training-free check of the DSP chain."""
    x = np.load(Path(data1) / "features_normalized.npy").astype(np.float32)
    y = np.load(Path(data1) / "labels.npy", allow_pickle=True)
    classes, yt = np.unique(y, return_inverse=True)
    km = kmeans(torch.from_numpy(x).to(resolve_device(device)), len(classes),
                n_init=10, seed=seed)
    lab, k = compact_labels(km.labels)
    return (adjusted_rand_score(yt, lab, len(classes), k),
            purity_score(yt, lab, len(classes), k))


def run_quality(
    data1: str = "processed_data1",
    data2: str = "processed_data2",
    results_dir: str = "quality_run",
    cluster_cfg=None,
    overrides: dict | None = None,
    floors: dict | None = None,
    fast: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the full 3-VAE x clustering sweep ONCE on ``device`` and assert
    that it recovers the corpus's planted genres.  Returns ``{'ok',
    'problems', 'values'}``."""
    dev = resolve_device(device)
    fl = dict(QUALITY_FLOORS)
    fl.update(floors or {})
    ov = dict(overrides or {})
    if fast:
        ov.setdefault("epochs", 3)
    ccfg = cluster_cfg if cluster_cfg is not None else ClusterConfig()
    _run_sweep(data1, data2, results_dir, ov, ccfg, RunLogger(echo=False),
               dev)

    df = pd.read_csv(Path(results_dir) / "clustering_metrics.csv")
    labels = np.load(Path(data2) / "labels.npy", allow_pickle=True)
    _, counts = np.unique(labels, return_counts=True)
    majority = counts.max() / counts.sum()

    problems: list[str] = []
    values: dict[str, float] = {"majority_class_share": round(float(majority), 4)}

    ari370, pur370 = direct370_scores(data1, dev)
    values["direct370_ari"] = ari370
    values["direct370_purity"] = pur370
    if ari370 < fl["direct370_ari"]:
        problems.append(
            f"370-d direct K-Means ARI {ari370:.3f} < floor "
            f"{fl['direct370_ari']} — the DSP/normalization chain regressed")
    if pur370 < fl["direct370_purity"]:
        problems.append(
            f"370-d direct K-Means purity {pur370:.3f} < floor "
            f"{fl['direct370_purity']}")

    def _one(mask, what):
        rows = df[mask]
        if len(rows) == 0:
            problems.append(f"missing row: {what}")
            return None
        return rows.iloc[0]

    method = df.get("Method", pd.Series(dtype=str))
    r = _one(method == "Direct Spectral", "Direct Spectral")
    if r is not None:
        values["direct_ari"] = float(r["ARI"])
        values["direct_purity"] = float(r["Purity"])
        if r["ARI"] < fl["direct_ari"]:
            problems.append(
                f"Direct Spectral ARI {r['ARI']:.3f} < floor "
                f"{fl['direct_ari']} — 290-d flats carry no genre signal")
        floor = majority + fl["direct_purity_margin"]
        if r["Purity"] < floor:
            problems.append(
                f"Direct Spectral purity {r['Purity']:.3f} < "
                f"majority-share+margin {floor:.3f}")

    r = _one(method == "CVAE (Multi-Modal)", "CVAE (Multi-Modal)")
    if r is not None:
        values["cvae_purity"] = float(r["Purity"])
        floor = majority + fl["cvae_purity_margin"]
        if r["Purity"] < floor:
            problems.append(
                f"CVAE purity {r['Purity']:.3f} < majority-share+margin "
                f"{floor:.3f} — latent carries no class structure")

    algo = df.get("Algorithm", pd.Series(dtype=str)).astype(str)
    r = _one(algo.str.startswith("K-Means-Main"), "Hybrid K-Means-Main")
    if r is not None:
        values["hybrid_ari"] = float(r["ARI"])
        values["hybrid_silhouette"] = float(r["Silhouette"])
        if r["ARI"] < fl["hybrid_ari"]:
            problems.append(
                f"Hybrid K-Means ARI {r['ARI']:.3f} < floor {fl['hybrid_ari']}")
        if r["Silhouette"] <= fl["silhouette"]:
            problems.append(
                f"Hybrid K-Means silhouette {r['Silhouette']:.3f} <= "
                f"{fl['silhouette']} — latent space has no cluster geometry")

    r = _one(method == "VAE + KMeans", "Simple VAE + KMeans")
    if r is not None:
        values["simple_silhouette"] = float(r["Silhouette"])
        if r["Silhouette"] <= fl["silhouette"]:
            problems.append(
                f"Simple VAE silhouette {r['Silhouette']:.3f} <= "
                f"{fl['silhouette']}")

    return {"ok": not problems, "problems": problems, "values": values}
