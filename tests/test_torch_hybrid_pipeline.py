"""The Hybrid VAE pipeline of the port, on the CPU, against the JAX
package: ``run_hybrid_vae`` / ``cli train-hybrid`` on the tiny
``processed_data2`` of ``tests/test_torch_cvae_pipeline.py`` (24 clips, mel
64 x 128), beside the JAX pipeline's run on the same data.

Tolerances: latents of the port's trained weights through the flax model
rtol 1e-4 / atol 1e-5 (twelve fp32 conv layers in two libraries); the
metric rows recomputed by the JAX functions on the port's written latents
1e-5 (silhouette and Davies-Bouldin fp32 sums in two libraries, ARI
float64 in the port, float32 in the JAX package), ``n_clusters`` equal;
host-streamed losses equal to the resident epoch's bit for bit (the same
batches, noise and op order).  Trained weights cannot match the JAX
pipeline's (the RNGs differ), so its run is held to the artifacts' shapes,
keys and row layout only.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from test_torch_cvae_pipeline import HW, N, _write_processed_data2

torch.set_num_threads(2)

LATENT = 128
EPOCHS = 2
ROWS = ["K-Means-Main", "K-Means-Language (k=2)", "Agglomerative", "DBSCAN"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``run_hybrid_vae(device='cpu')`` of the port and the JAX pipeline's
    run on one tiny corpus."""
    from tpuvae.config import ClusterConfig as JaxCluster
    from tpuvae.config import HybridVAEConfig as JaxHybrid
    from tpuvae.pipelines import run_hybrid_vae as jax_run
    from tpuvae.utils import RunLogger as JaxLogger

    from tpuvae_torch.config import ClusterConfig, HybridVAEConfig
    from tpuvae_torch.pipelines import run_hybrid_vae
    from tpuvae_torch.utils.logging import RunLogger

    root = tmp_path_factory.mktemp("hybrid")
    data = root / "processed_data2"
    genres = _write_processed_data2(data)
    log = root / "run.jsonl"
    logger = RunLogger(log, echo=False)
    cfg = HybridVAEConfig(epochs=EPOCHS, batch_size=8)
    try:
        df = run_hybrid_vae(str(data), str(root / "results"), cfg,
                            ClusterConfig(), logger, make_plots=False,
                            device="cpu")
    finally:
        logger.close()
    jdf = jax_run(str(data), str(root / "jax_results"),
                  JaxHybrid(epochs=EPOCHS, batch_size=8), JaxCluster(),
                  JaxLogger(echo=False), make_plots=False)
    events = [json.loads(line) for line in log.read_text().splitlines()]
    return {"root": root, "data": data, "results": root / "results",
            "jax_results": root / "jax_results", "df": df, "jdf": jdf,
            "genres": genres, "events": {e["event"]: e for e in events}}


def test_run_hybrid_vae_writes_the_jax_pipelines_artifacts(runs):
    df, jdf = runs["df"], runs["jdf"]
    assert list(df.columns) == list(jdf.columns) == [
        "Algorithm", "Silhouette", "Davies-Bouldin", "ARI", "n_clusters"]
    for frame in (df, jdf):
        names = frame["Algorithm"].tolist()
        assert len(names) == 4 and all(n.startswith(r)
                                       for n, r in zip(names, ROWS))
    for sub in ("", "Convolutional_VAE"):
        got = pd.read_csv(runs["results"] / sub / "clustering_metrics.csv")
        want = pd.read_csv(runs["jax_results"] / sub / "clustering_metrics.csv")
        assert list(got.columns) == list(want.columns)
        assert (got["Architecture"] == "Convolutional VAE").all()
        assert len(got) == len(want) == 4
    lat = np.load(runs["results"] / "Convolutional_VAE"
                  / "hybrid_latent_features.npy")
    jlat = np.load(runs["jax_results"] / "Convolutional_VAE"
                   / "hybrid_latent_features.npy")
    assert lat.shape == jlat.shape == (N, LATENT)
    assert lat.dtype == jlat.dtype == np.float32 and np.isfinite(lat).all()
    serving = runs["results"] / "Convolutional_VAE" / "serving"
    jserving = runs["jax_results"] / "Convolutional_VAE" / "serving"
    meta = json.loads((serving / "model" / "metadata.json").read_text())
    jmeta = json.loads((jserving / "model" / "metadata.json").read_text())
    assert set(meta) == set(jmeta) == {"arch", "latent_dim", "text_dim",
                                       "input_hw", "compute_dtype", "best_k",
                                       "data_dir"}
    for key in ("arch", "latent_dim", "text_dim", "input_hw",
                "compute_dtype", "data_dir"):
        assert meta[key] == jmeta[key], key
    assert meta["arch"] == "hybrid" and meta["input_hw"] == list(HW)
    centers = np.load(serving / "kmeans_centers.npy")
    assert centers.shape == (meta["best_k"], LATENT)
    assert np.load(jserving / "kmeans_centers.npy").shape[1] == LATENT
    with np.load(serving / "model" / "weights.npz") as w, \
            np.load(jserving / "model" / "weights.npz") as jw:
        assert set(w.files) == set(jw.files)
        for k in w.files:
            assert w[k].shape == jw[k].shape, k
    ev = runs["events"]
    assert ev["fit_start"]["n_train"] == 20 and ev["fit_start"]["n_val"] == 4
    assert ev["fit"]["epochs"] == EPOCHS
    assert ev["latents"]["shape"] == [N, LATENT]
    assert set(ev["sweeps"]["seconds"]) == {"kmeans", "agglomerative",
                                            "dbscan"}
    assert ev["rows"]["rows"] == 4


def test_trained_weights_load_into_the_flax_model_with_equal_latents(runs):
    from tpuvae.models import HybridVAE as JaxHybrid
    from tpuvae.train.checkpoint import load_checkpoint as jax_load

    from tpuvae_torch.convert import from_flax, to_flax
    from tpuvae_torch.io.artifacts import load_advanced
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.train.checkpoint import load_checkpoint

    ckpt = runs["results"] / "Convolutional_VAE" / "serving" / "model"
    params, batch_stats, _ = jax_load(ckpt)
    data = load_advanced(runs["data"])
    mel = np.asarray(data["mel"], np.float32)[..., None]
    text = np.asarray(data["text"], np.float32)
    flat, _ = load_checkpoint(ckpt)
    model = HybridVAE(input_hw=HW)
    model.load_state_dict(from_flax(flat))
    model.eval()
    # convert.to_flax of the loaded weights is the written file
    for k, v in to_flax(model.state_dict()).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    want = JaxHybrid(input_hw=HW).apply(
        {"params": params, "batch_stats": batch_stats}, jnp.asarray(mel),
        jnp.asarray(text), method=JaxHybrid.latent)
    np.testing.assert_allclose(
        np.load(runs["results"] / "Convolutional_VAE"
                / "hybrid_latent_features.npy"),
        np.asarray(want), rtol=1e-4, atol=1e-5)
    # trained: BatchNorm statistics have left their initial values
    assert not np.allclose(flat["batch_stats/audio_encoder/BatchNorm_0/var"], 1.0)


def test_rows_recomputed_by_the_jax_functions_on_the_written_latents(runs):
    from tpuvae.cluster import agglomerative_k_sweep as jax_agg
    from tpuvae.cluster import centers_from_labels as jax_centers
    from tpuvae.cluster import dbscan_eps_sweep as jax_dbscan
    from tpuvae.metrics import (
        adjusted_rand_score,
        compact_labels,
        davies_bouldin_score,
        self_distances,
        silhouette_from_distances,
    )

    from tpuvae_torch.cluster import kmeans, kmeans_k_sweep
    from tpuvae_torch.config import ClusterConfig

    ccfg = ClusterConfig()
    lat = np.load(runs["results"] / "Convolutional_VAE"
                  / "hybrid_latent_features.npy")
    k_range = range(2, 15)
    # the k-means rows: the port's labels (its RNG is not jax.random's),
    # recomputed here on the CPU as the pipeline drew them
    km = kmeans_k_sweep(torch.from_numpy(lat), k_range, n_init=10, seed=42)
    lang = kmeans(torch.from_numpy(lat), 2, n_init=10, seed=42)
    agg = jax_agg(lat, k_range)
    db = jax_dbscan(lat, np.arange(3.0, 19.0 + 1e-9, 1.0), min_samples=5,
                    fallback_eps=10.0)
    want_names = [f"K-Means-Main (k={int(km.best_param)})",
                  "K-Means-Language (k=2)",
                  f"Agglomerative (k={int(agg.best_param)})",
                  f"DBSCAN (eps={float(db.best_param):.1f})"]
    df = runs["df"]
    assert df["Algorithm"].tolist() == want_names
    dist = self_distances(jnp.asarray(lat))
    y = runs["genres"].astype(np.int32)
    for (_, row), labels in zip(df.iterrows(), (
            km.best_labels, lang.labels, agg.best_labels, db.best_labels)):
        n_found = len(set(np.asarray(labels).tolist()) - {-1})
        assert row["n_clusters"] == n_found
        if n_found < 2:
            assert (row["Silhouette"], row["Davies-Bouldin"], row["ARI"]) == (
                -1, -1, -1)
            continue
        lab, k = compact_labels(np.asarray(labels))
        want = (float(silhouette_from_distances(dist, jnp.asarray(lab), k)),
                float(davies_bouldin_score(jnp.asarray(lat), jnp.asarray(lab),
                                           k)),
                float(adjusted_rand_score(jnp.asarray(y), jnp.asarray(lab), 3,
                                          k)))
        np.testing.assert_allclose(
            [row["Silhouette"], row["Davies-Bouldin"], row["ARI"]], want,
            rtol=0, atol=1e-5, err_msg=row["Algorithm"])
    centers = np.load(runs["results"] / "Convolutional_VAE" / "serving"
                      / "kmeans_centers.npy")
    np.testing.assert_allclose(centers, jax_centers(lat, km.best_labels),
                               rtol=1e-6, atol=1e-6)
    assert ccfg.hybrid_k_min == 2 and ccfg.hybrid_k_max == 14


@pytest.mark.parametrize("source", ["array", "memmap_rowview"])
def test_host_stream_gives_the_resident_epochs_losses(tmp_path, source):
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.train.loop import FitConfig, fit, train_val_split
    from tpuvae_torch.train.objectives import hybrid_objective
    from tpuvae_torch.train.state import create_state
    from tpuvae_torch.utils.batching import RowView

    rng = np.random.default_rng(4)
    n = 11
    mel = rng.normal(size=(n, *HW)).astype(np.float32)
    text = rng.normal(size=(n, 768)).astype(np.float32)
    tr, va = train_val_split(n, 0.3, 5)      # 7 train (4 + ragged 3), 4 val

    def run(stream: bool):
        model = HybridVAE(input_hw=HW,
                          generator=torch.Generator().manual_seed(0))
        cfg = FitConfig(epochs=2, batch_size=4, monitor="val",
                        loss_normalizer="per_dataset", log_every=1,
                        host_stream=stream, seed=3)
        if not stream:
            data = [tuple(torch.from_numpy(a[r]) for a in
                          (mel[..., None], text)) for r in (tr, va)]
        elif source == "array":
            data = [(mel[r][..., None], text[r]) for r in (tr, va)]
        else:
            np.save(tmp_path / "mel.npy", mel)
            mm = np.load(tmp_path / "mel.npy", mmap_mode="r")
            data = [(RowView(mm, r, add_channel=True), text[r])
                    for r in (tr, va)]
        res = fit(create_state(model, 1e-4), hybrid_objective(), data[0], cfg,
                  val_data=data[1])
        return res.history, model.state_dict()

    hist_r, sd_r = run(False)
    hist_s, sd_s = run(True)
    assert hist_s["train_loss"] == hist_r["train_loss"]
    assert hist_s["val_loss"] == hist_r["val_loss"]
    for k in sd_r:
        assert torch.equal(sd_r[k], sd_s[k]), k


def test_cli_train_hybrid_on_cpu_with_host_stream(runs, capsys):
    from tpuvae_torch import cli

    results = runs["root"] / "results_cli"
    rc = cli.main(["train-hybrid", "--device=cpu", f"--epochs={EPOCHS}",
                   "--batch_size=8", "--host_stream=true",
                   f"--data2_dir={runs['data']}", "--data_dir=ignored",
                   f"--results_dir={results}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "K-Means-Main" in out and "DBSCAN" in out
    # the same seeds, batches and noise as the resident run of the fixture
    np.testing.assert_array_equal(
        np.load(results / "Convolutional_VAE" / "hybrid_latent_features.npy"),
        np.load(runs["results"] / "Convolutional_VAE"
                / "hybrid_latent_features.npy"))
    csv = pd.read_csv(results / "clustering_metrics.csv")
    want = runs["df"]
    assert csv["Algorithm"].tolist() == want["Algorithm"].tolist()
    np.testing.assert_allclose(
        csv[["Silhouette", "Davies-Bouldin", "ARI", "n_clusters"]].to_numpy(),
        want[["Silhouette", "Davies-Bouldin", "ARI", "n_clusters"]].to_numpy(),
        atol=1e-6)
    assert cli.main(["train-hybrid", "--device=cpu", "--bogus=1"]) == 2


@pytest.mark.parametrize("what", ["make_plots", "bfloat16", "checkpoint_every"])
def test_what_waits_raises_naming_its_roadmap_item(runs, what, tmp_path):
    """Once waiting, now ported.  ``bfloat16``: a 1-epoch run in bf16
    writes ``compute_dtype: "bfloat16"`` in the bundle's meta, finite rows
    and a latents file of raw bf16 bits (``'<V2'``, as the JAX
    pipeline's).  ``make_plots`` draws the loss curve and the t-SNE
    triptych; ``checkpoint_every`` writes rotating checkpoints under
    ``Convolutional_VAE/checkpoints``."""
    from tpuvae_torch.config import HybridVAEConfig
    from tpuvae_torch.io.artifacts import load_latents
    from tpuvae_torch.pipelines import run_hybrid_vae
    from tpuvae_torch.train.checkpoint import load_checkpoint
    from tpuvae_torch.utils.logging import RunLogger

    out = tmp_path / "r" / "Convolutional_VAE"
    if what == "bfloat16":
        df = run_hybrid_vae(str(runs["data"]), str(tmp_path / "r"),
                            HybridVAEConfig(epochs=1, batch_size=8,
                                            compute_dtype="bfloat16"),
                            logger=RunLogger(echo=False), make_plots=False,
                            device="cpu")
        _, meta = load_checkpoint(out / "serving" / "model")
        assert meta["compute_dtype"] == "bfloat16"
        vals = df[["Silhouette", "Davies-Bouldin", "ARI"]].to_numpy()
        assert len(df) == 4 and np.isfinite(vals).all()
        path = out / "hybrid_latent_features.npy"
        assert b"'descr': '<V2'" in path.read_bytes()[:128]
        lat = load_latents(path)
        f32 = np.load(runs["results"] / "Convolutional_VAE"
                      / "hybrid_latent_features.npy")
        assert lat.shape == f32.shape and np.isfinite(lat).all()
        return
    plots = what == "make_plots"
    run_hybrid_vae(str(runs["data"]), str(tmp_path / "r"),
                   HybridVAEConfig(epochs=2, batch_size=8,
                                   checkpoint_every=0 if plots else 1),
                   logger=RunLogger(echo=False), make_plots=plots,
                   device="cpu")
    if plots:
        for png in ("training_loss.png", "tsne_clusters_v2.png"):
            assert (out / png).stat().st_size > 0, png
        assert not (out / "checkpoints").exists()
    else:
        ck = out / "checkpoints"
        assert sorted(p.name for p in ck.iterdir()) == ["latest",
                                                        "step_00000001"]
        assert (ck / "step_00000001" / "train_state.pt").exists()
        meta = json.loads((ck / "latest" / "metadata.json").read_text())
        assert meta["epoch"] == 1 and len(meta["history"]["val_loss"]) == 2
        assert not list(out.glob("*.png"))
