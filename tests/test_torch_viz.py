"""t-SNE, the report plots and the EDA report of the port against the JAX
package, on the CPU.

Tolerances: the calibrated P of a seeded 64 x 16 within rtol 1e-5 (fp32
exp / log sums in two libraries); 20 optimizer steps from one shared init
within rtol 1e-4 / atol 1e-6, at lr 1 across both momentum phases — at the
pipelines' lr 50 from a 1e-4-scale init the trajectory is chaotic (the
port alone in fp32 and in fp64 part by 0.1 after 20 steps), so a whole
1,000-step ``tsne`` at N = 60 is held by the overlap of each point's 10
nearest neighbours with the JAX embedding's (>= 0.9; 0.967 measured on
a helix).  Figures: the same inputs through the six plot functions and
through ``run_eda`` give the same files, their pixels equal
(``matplotlib.image.imread``); ``feature_summary.csv`` within 1e-5.
"""

import importlib
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from test_torch_cvae_pipeline import _write_processed_data2

torch.set_num_threads(2)

jax_tsne = importlib.import_module("tpuvae.viz.tsne")
port_tsne = importlib.import_module("tpuvae_torch.viz.tsne")


def _blobs(n, d, groups, seed):
    rng = np.random.default_rng(seed)
    g = np.arange(n) % groups
    return (rng.normal(0, 4, (groups, d))[g]
            + rng.normal(size=(n, d))).astype(np.float32), g


def _jax_d2(x):
    from tpuvae.metrics.pairwise import squared_distances

    return np.asarray(squared_distances(jnp.asarray(x), jnp.asarray(x)))


def test_calibrated_p_matches_jax():
    x = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    d2 = _jax_d2(x)
    want = np.asarray(jax_tsne._calibrated_p(jnp.asarray(d2), 10.0))
    got = port_tsne._calibrated_p(torch.tensor(d2), 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-4)


def test_tsne_optimize_matches_jax_for_20_steps():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    p = np.asarray(jax_tsne._calibrated_p(jnp.asarray(_jax_d2(x)), 10.0))
    y0 = rng.normal(size=(64, 2)).astype(np.float32)
    want = np.asarray(jax_tsne._tsne_optimize(
        jnp.asarray(p), jnp.asarray(y0), jnp.float32(1.0), n_iter=20,
        exaggeration_iters=10))
    got = port_tsne._tsne_optimize(torch.tensor(p), torch.from_numpy(y0),
                                   1.0, n_iter=20, exaggeration_iters=10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def _knn(e, k=10):
    d = ((e[:, None] - e[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1)[:, :k]


def _overlap(a, b):
    return np.mean([len(set(a[i]) & set(b[i])) / 10 for i in range(len(a))])


def test_tsne_matches_jax_by_neighbours():
    # 60 points evenly along a helix in 16-d: neighbourhoods the embedding
    # must keep.  (Inside a Gaussian blob they are weakly determined: there
    # the JAX package against itself on a 1e-5-perturbed input overlaps
    # only 0.62, as much as the port does against it.)
    t = np.linspace(0, 4 * np.pi, 60)
    basis = np.linalg.qr(np.random.default_rng(0).normal(size=(16, 3)))[0]
    x = ((np.stack([np.cos(t), np.sin(t), t / 3], 1) * 3)
         @ basis.T).astype(np.float32)
    want = jax_tsne.tsne(x)
    got = port_tsne.tsne(x, device="cpu")
    assert got.shape == want.shape == (60, 2) and got.dtype == np.float32
    assert np.isfinite(got).all()
    overlap = _overlap(_knn(want), _knn(got))
    assert overlap >= 0.9, overlap           # 0.967 measured
    # the seed is ignored, as in the JAX package (a deterministic PCA init)
    np.testing.assert_array_equal(port_tsne.tsne(x, seed=7, device="cpu"), got)


def test_tsne_keeps_planted_groups_together():
    x, g = _blobs(60, 16, 4, seed=0)
    nn = _knn(port_tsne.tsne(x, device="cpu"))
    # each point's 10 neighbours share its group (15 points a group)
    assert np.mean(g[nn] == g[:, None]) >= 0.95


def test_tsne_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        port_tsne.tsne(np.zeros((8, 3), np.float32))


# -- the six figures ------------------------------------------------------------

def _plot_inputs():
    rng = np.random.default_rng(3)
    xy = rng.normal(size=(40, 2)).astype(np.float32)
    clusters = np.arange(40) % 3
    return {
        "tsne_cluster_language": (xy, clusters,
                                  np.where(np.arange(40) % 2, "bn", "en"), 3),
        "reconstruction_pair": (rng.normal(size=(16, 32)),
                                rng.normal(size=(16, 32))),
        "tsne_by_genre": (xy, clusters, ["classical", "pop", "rock"]),
        "cluster_language_bar": (clusters, np.arange(40) % 2,
                                 ["bangla", "english"]),
        "loss_curve": ([5.0, 3.0, 2.5, 2.2],),
        "tsne_triptych": (xy, clusters, np.arange(40) % 2, clusters[::-1], 3),
    }


@pytest.mark.parametrize("name", list(_plot_inputs()))
def test_plot_functions_match_jax(name, tmp_path):
    from matplotlib.image import imread

    import tpuvae.viz.plots as jax_plots
    import tpuvae_torch.viz.plots as port_plots

    args = _plot_inputs()[name]
    want = getattr(jax_plots, name)(*args, tmp_path / "jax" / f"{name}.png")
    got = getattr(port_plots, name)(*args, tmp_path / "port" / f"{name}.png")
    assert got == tmp_path / "port" / f"{name}.png"
    np.testing.assert_array_equal(imread(got), imread(want))


def test_triptych_without_true_labels_matches_jax(tmp_path):
    from matplotlib.image import imread

    import tpuvae.viz.plots as jax_plots
    import tpuvae_torch.viz.plots as port_plots

    xy, main, lang, _, k = _plot_inputs()["tsne_triptych"]
    want = jax_plots.tsne_triptych(xy, main, lang, None, k, tmp_path / "a.png")
    got = port_plots.tsne_triptych(xy, main, lang, None, k, tmp_path / "b.png")
    np.testing.assert_array_equal(imread(got), imread(want))


# -- the EDA report -------------------------------------------------------------

EDA_FILES = {"distributions.png", "sample_spectrograms.png",
             "tsne_raw_features.png", "feature_correlation.png",
             "feature_summary.csv"}


@pytest.fixture(scope="module")
def eda_runs(tmp_path_factory):
    from tpuvae.viz.eda import run_eda as jax_eda

    from tpuvae_torch.viz.eda import run_eda

    root = tmp_path_factory.mktemp("eda")
    _write_processed_data2(root / "pd2")
    port = run_eda(str(root / "pd2"), str(root / "port"), device="cpu")
    jax = jax_eda(str(root / "pd2"), str(root / "jax"))
    return root, port, jax


def test_run_eda_matches_jax(eda_runs):
    from matplotlib.image import imread

    root, port, jax = eda_runs
    assert port == jax
    assert port["flat_shape"] == [24, 290] and port["text_shape"] == [24, 768]
    for out in ("port", "jax"):
        assert {p.name for p in (root / out).iterdir()} == EDA_FILES
    got = pd.read_csv(root / "port" / "feature_summary.csv", index_col=0)
    want = pd.read_csv(root / "jax" / "feature_summary.csv", index_col=0)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-5,
                               atol=1e-5)
    # every figure without a t-SNE is the same picture
    for png in EDA_FILES - {"tsne_raw_features.png", "feature_summary.csv"}:
        np.testing.assert_array_equal(imread(root / "port" / png),
                                      imread(root / "jax" / png))


def test_run_eda_tsne_figure_matches_jax_on_shared_embeddings(eda_runs,
                                                              monkeypatch):
    """The t-SNE figure from the same embeddings is the same picture (both
    packages' ``tsne`` replaced by one function of the input)."""
    from matplotlib.image import imread

    import tpuvae.viz.eda as jax_eda
    import tpuvae_torch.viz.eda as port_eda

    def shared(x, **kwargs):
        return np.asarray(x, np.float32)[:, :2] * 3.0

    monkeypatch.setattr(jax_eda, "tsne", shared)
    monkeypatch.setattr(port_eda, "tsne", shared)
    root, _, _ = eda_runs
    port_eda.run_eda(str(root / "pd2"), str(root / "port2"), device="cpu")
    jax_eda.run_eda(str(root / "pd2"), str(root / "jax2"))
    np.testing.assert_array_equal(
        imread(root / "port2" / "tsne_raw_features.png"),
        imread(root / "jax2" / "tsne_raw_features.png"))


@pytest.mark.parametrize("entry", ["run_simple_vae", "run_conditional_vae",
                                   "run_hybrid_vae", "run_eda"])
def test_without_matplotlib_plots_are_refused_before_any_work(entry, tmp_path,
                                                              monkeypatch):
    from tpuvae_torch import pipelines
    from tpuvae_torch.viz import eda

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        if entry == "run_eda":
            # no data: the refusal comes before the directory is read
            eda.run_eda(str(tmp_path / "absent"), str(tmp_path / "out"),
                        device="cpu")
        else:
            getattr(pipelines, entry)(str(tmp_path / "absent"),
                                      str(tmp_path / "out"), make_plots=True,
                                      device="cpu")
    assert not (tmp_path / "out").exists()
