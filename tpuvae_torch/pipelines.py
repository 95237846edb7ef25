"""End-to-end pipelines (counterpart of ``tpuvae/pipelines.py``).

Ported so far: ``run_simple_vae`` (≙ ``src/Simple_VAE.py``), step for step
as ``tpuvae/pipelines.py:587-676`` runs it — fit, ``best_vae_model/``,
latents, the silhouette k-sweep, the VAE row, the serving bundle, the
PCA + KMeans row and the consolidated metrics CSV — on one device.  The
artifact and CSV contracts are the JAX pipeline's, so either package reads
what the other writes.
"""

from __future__ import annotations

import time

import numpy as np
import pandas as pd
import torch

from tpuvae_torch.cluster.kmeans import centers_from_labels, kmeans
from tpuvae_torch.cluster.pca import pca_transform
from tpuvae_torch.cluster.sweeps import kmeans_k_sweep
from tpuvae_torch.config import ClusterConfig, SimpleVAEConfig
from tpuvae_torch.device import resolve_device
from tpuvae_torch.infer import save_serving_model
from tpuvae_torch.io.artifacts import load_basic
from tpuvae_torch.io.results import consolidate_metrics
from tpuvae_torch.metrics.internal import (
    calinski_harabasz_score,
    silhouette_from_distances,
)
from tpuvae_torch.metrics.labels import compact_labels
from tpuvae_torch.metrics.pairwise import self_distances
from tpuvae_torch.models import SimpleVAE
from tpuvae_torch.train.checkpoint import save_checkpoint
from tpuvae_torch.train.loop import FitConfig, fit
from tpuvae_torch.train.objectives import simple_vae_objective
from tpuvae_torch.train.state import create_state
from tpuvae_torch.utils.batching import batched_apply
from tpuvae_torch.utils.logging import RunLogger


def _silhouette_ch(x: torch.Tensor, labels: np.ndarray) -> tuple[float, float]:
    lab, k = compact_labels(labels)
    sil = float(silhouette_from_distances(self_distances(x), lab, k))
    return sil, float(calinski_harabasz_score(x, lab, k))


def run_simple_vae(
    data_dir: str = "processed_data1",
    results_dir: str = "results",
    cfg: SimpleVAEConfig = SimpleVAEConfig(),
    ccfg: ClusterConfig = ClusterConfig(),
    logger: RunLogger | None = None,
    make_plots: bool = False,
    device: str = "cuda",
) -> pd.DataFrame:
    """Train the Simple VAE on ``data_dir`` (a ``processed_data1``) and
    write its metrics, best weights and serving bundle under
    ``results_dir``.  Returns the two metric rows.

    ``device`` defaults to CUDA and raises without a card.  The t-SNE plot
    of the JAX pipeline is not ported: ``make_plots=True`` raises.
    """
    if make_plots:
        raise NotImplementedError(
            "t-SNE and plots are not ported to tpuvae_torch yet (ROADMAP.md, "
            "queue 1, item 9: viz/); pass make_plots=False")
    dev = resolve_device(device)
    logger = logger or RunLogger()
    data = load_basic(data_dir)
    features = np.asarray(data["features"], np.float32)
    input_dim = features.shape[1]

    model = SimpleVAE(input_dim=input_dim, hidden_dims=tuple(cfg.hidden_dims),
                      latent_dim=cfg.latent_dim, dropout=cfg.dropout,
                      generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    state = create_state(model, cfg.learning_rate)
    fit_cfg = FitConfig(
        epochs=cfg.epochs, batch_size=cfg.batch_size, patience=cfg.patience,
        monitor="train", restore_best=True,
        plateau_patience=cfg.plateau_patience, plateau_factor=cfg.plateau_factor,
        seed=cfg.seed, scan_epochs=cfg.scan_epochs,
        # mid-train checkpoints (off by default): fit does not take them yet
        checkpoint_dir=(f"{results_dir}/Simple_VAE/checkpoints"
                        if cfg.checkpoint_every > 0 else None),
    )
    xd = torch.from_numpy(features).to(dev)
    t0 = time.perf_counter()
    res = fit(state, simple_vae_objective(cfg.beta), (xd,), fit_cfg,
              logger=logger)
    epochs_run = len(res.history["train_loss"])
    logger.log("fit", seconds=time.perf_counter() - t0, epochs=epochs_run,
               best_epoch=res.best_epoch, steps_per_sec=res.steps_per_sec)
    save_checkpoint(f"{results_dir}/Simple_VAE/best_vae_model", model,
                    {"best_epoch": res.best_epoch})

    model.eval()
    with torch.no_grad():
        latents = batched_apply(
            lambda x: model.latent(torch.from_numpy(x).to(dev)),
            (features,), cfg.batch_size)
    logger.log("latents", shape=list(latents.shape))

    # K-sweep by silhouette (ref :239-252)
    t0 = time.perf_counter()
    xl = torch.from_numpy(latents).to(dev)
    sweep = kmeans_k_sweep(xl, ccfg.simple_k_sweep,
                           n_init=ccfg.kmeans_n_init, seed=ccfg.seed)
    best_k = int(sweep.best_param)
    vae_clusters = sweep.best_labels
    logger.log("k_sweep", seconds=time.perf_counter() - t0, best_k=best_k,
               scores=sweep.scores)
    vae_sil, vae_ch = _silhouette_ch(xl, vae_clusters)

    centers = centers_from_labels(latents, vae_clusters)
    serving = save_serving_model(
        results_dir, model, centers,
        meta={"arch": "simple", "best_epoch": res.best_epoch,
              "best_k": best_k, "input_dim": int(input_dim),
              "hidden_dims": list(cfg.hidden_dims),
              "latent_dim": cfg.latent_dim, "dropout": cfg.dropout,
              "data_dir": str(data_dir)})
    logger.log("serving_saved", dir=str(serving), n_centers=len(centers))

    # PCA(latent_dim)+KMeans baseline (ref :258-263)
    t0 = time.perf_counter()
    pca_feats = pca_transform(xd, cfg.latent_dim)
    pca_res = kmeans(pca_feats, best_k, n_init=ccfg.kmeans_n_init, seed=ccfg.seed)
    pca_sil, pca_ch = _silhouette_ch(pca_feats, pca_res.labels)
    logger.log("pca_row", seconds=time.perf_counter() - t0)

    df = pd.DataFrame({
        "Method": ["VAE + KMeans", "PCA + KMeans"],
        "Silhouette": [vae_sil, pca_sil],
        "Calinski-Harabasz": [vae_ch, pca_ch],
    })
    consolidate_metrics(results_dir, df, "Simple VAE")
    logger.log("metrics", architecture="Simple VAE",
               rows=df.to_dict("records"))
    return df
