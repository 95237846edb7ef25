"""The parity and quality gates of the port, on the CPU, against the JAX
package's (``tpuvae/parity.py``).

``compare_metrics_csv`` returns the JAX function's problem list on crafted
CSV pairs; the floors are the JAX package's values.  The port's
``run_parity`` and ``run_quality`` run on the JAX tests' tiny corpus
(``tests/test_pipelines.py``: 3 clips per genre and language with jazz,
2 s, seed 1; mel 128 x 64), preprocessed here by the port on the CPU, with
that file's cluster settings and overrides; ``run_quality`` with the floors
of ``tests/test_pipelines.py:280-281``.  Its training-free values are held
within 0.02 of the JAX package's functions on the same artifacts.
"""

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)

BASE = pd.DataFrame({
    "Architecture": ["Simple VAE", "Simple VAE", "Conditional VAE"],
    "Method": ["VAE + KMeans", "PCA + KMeans", "CVAE (Multi-Modal)"],
    "Silhouette": [0.5, 0.6, 0.25],
    "ARI": [np.nan, np.nan, 0.4],
})


def _variant(case):
    df = BASE.copy()
    if case == "identical":
        pass
    elif case == "within_tol":
        df.loc[0, "Silhouette"] = 0.505
    elif case == "out_of_tol":
        df.loc[1, "Silhouette"] = 0.7
        df.loc[2, "ARI"] = 0.2
    elif case == "row_count":
        df = df.iloc[:2]
    elif case == "missing_column":
        df = df.drop(columns=["ARI"])
    elif case == "string_differs":
        df.loc[2, "Method"] = "CVAE (other)"
    elif case == "nan_one_side":
        df.loc[0, "ARI"] = 0.3
    elif case == "row_order":
        df = df.iloc[::-1]
    return df


CASES = ["identical", "within_tol", "out_of_tol", "row_count",
         "missing_column", "string_differs", "nan_one_side", "row_order"]


@pytest.mark.parametrize("case", CASES)
def test_compare_metrics_csv_matches_jax(case, tmp_path):
    from tpuvae.parity import compare_metrics_csv as jax_compare

    from tpuvae_torch.parity import compare_metrics_csv

    BASE.to_csv(tmp_path / "a.csv", index=False)
    _variant(case).to_csv(tmp_path / "b.csv", index=False)
    for tol in (0.2, 0.01):
        want = jax_compare(tmp_path / "a.csv", tmp_path / "b.csv", tol=tol)
        got = compare_metrics_csv(tmp_path / "a.csv", tmp_path / "b.csv",
                                  tol=tol)
        assert got == want
    if case in ("identical", "within_tol", "row_order"):
        assert got == []
    elif case != "nan_one_side":     # a NaN against a number is not flagged
        assert got


@pytest.mark.parametrize("separation", [1.0, 0.96, 0.95, 0.75])
def test_quality_floors_match_jax(separation):
    import tpuvae.parity as jp

    import tpuvae_torch.parity as pp

    assert pp.QUALITY_FLOORS == jp.QUALITY_FLOORS
    assert pp.QUALITY_FLOORS_HARD == jp.QUALITY_FLOORS_HARD
    assert pp.quality_floors(separation) == jp.quality_floors(separation)
    floors = pp.quality_floors(separation)
    floors["silhouette"] = 9.0       # a copy: the module's set is untouched
    assert pp.QUALITY_FLOORS["silhouette"] == 0.0


def test_deterministic_algorithms_restores_the_settings(monkeypatch):
    from tpuvae_torch.parity import deterministic_algorithms

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = torch.are_deterministic_algorithms_enabled()
    with deterministic_algorithms() as seen:
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        assert not torch.backends.cudnn.benchmark
        import os

        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert seen == []
    assert torch.are_deterministic_algorithms_enabled() == before
    import os

    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tpuvae_torch.config import AdvancedPreprocessConfig, PreprocessConfig
    from tpuvae_torch.io.synthetic import generate_dataset
    from tpuvae_torch.pipelines import preprocess_advanced, preprocess_basic
    from tpuvae_torch.utils.logging import RunLogger

    root = tmp_path_factory.mktemp("data")
    generate_dataset(root / "Datasets", clips_per_genre_lang=3, duration=2.0,
                     include_jazz=True, seed=1)
    common = dict(duration=2.0, dataset_root=str(root / "Datasets"),
                  metadata_csv=str(root / "Datasets" / "updated_metadata.csv"),
                  extract_batch=8)
    logger = RunLogger(echo=False)
    preprocess_basic(PreprocessConfig(
        output_dir=str(root / "processed_data1"), **common),
        device="cpu", logger=logger)
    preprocess_advanced(AdvancedPreprocessConfig(
        fixed_time_steps=64, output_dir=str(root / "processed_data2"),
        **common), device="cpu", logger=logger)
    return root


@pytest.fixture(scope="module")
def small_cluster_cfg():
    from tpuvae_torch.config import ClusterConfig

    return ClusterConfig(
        simple_k_sweep=(2, 3), hybrid_k_min=2, hybrid_k_max=4,
        dbscan_eps_min=1.0, dbscan_eps_max=12.0, dbscan_eps_step=2.0,
        tsne_perplexity=5.0)


def test_run_parity_on_the_tiny_corpus(corpus, small_cluster_cfg, tmp_path):
    from tpuvae_torch.parity import run_parity

    res = run_parity(str(corpus / "processed_data1"),
                     str(corpus / "processed_data2"),
                     work_dir=str(tmp_path / "parity"),
                     cluster_cfg=small_cluster_cfg,
                     overrides={"epochs": 2, "batch_size": 8}, device="cpu")
    assert res["ok"], res["problems"]
    a = pd.read_csv(tmp_path / "parity" / "run_a" / "clustering_metrics.csv")
    b = pd.read_csv(tmp_path / "parity" / "run_b" / "clustering_metrics.csv")
    assert set(a["Architecture"]) == {
        "Simple VAE", "Conditional VAE", "Convolutional VAE"}
    # on the CPU the two runs are the same float operations: equal
    pd.testing.assert_frame_equal(a, b)


def _training_free_inputs(corpus):
    """(features, true codes, k) of the gate's two training-free checks:
    the 370-d features of ``processed_data1`` (``direct370_*``) and the
    290-d flats of ``processed_data2`` ("Direct Spectral", ``direct_*``)."""
    from tpuvae_torch.metrics.labels import encode_labels

    d1, d2 = corpus / "processed_data1", corpus / "processed_data2"
    y = np.load(d1 / "labels.npy", allow_pickle=True)
    codes, names = encode_labels(y)
    meta = pd.read_csv(d2 / "metadata.csv")
    g, gnames = encode_labels(meta["genre"].values)
    return {"direct370": (np.load(d1 / "features_normalized.npy"), codes,
                          len(names)),
            "direct": (np.load(d2 / "features_normalized.npy"), g,
                       len(gnames))}


def _best_of_seeds(kmeans, x, k, seeds=range(8)):
    """The lowest-inertia k-means solution over ``seeds`` (n_init 10)."""
    runs = [kmeans(x, k, n_init=10, seed=s) for s in seeds]
    return min(runs, key=lambda r: float(r.inertia))


def test_run_quality_on_the_tiny_corpus(corpus, small_cluster_cfg, tmp_path):
    from tpuvae_torch.parity import run_quality

    res = run_quality(
        data1=str(corpus / "processed_data1"),
        data2=str(corpus / "processed_data2"),
        results_dir=str(tmp_path / "quality"), cluster_cfg=small_cluster_cfg,
        overrides={"epochs": 3, "batch_size": 8},
        floors={"hybrid_ari": 0.0, "cvae_purity_margin": 0.10,
                "direct370_ari": 0.3, "direct370_purity": 0.6},
        device="cpu")
    assert res["ok"], res["problems"]
    values = res["values"]
    for key in ("direct370_ari", "direct_ari", "cvae_purity", "hybrid_ari",
                "simple_silhouette"):
        assert key in values, values
    # the same numbers as the training-free functions themselves
    from tpuvae_torch.parity import direct370_scores

    ari370, pur370 = direct370_scores(str(corpus / "processed_data1"), "cpu")
    assert (values["direct370_ari"], values["direct370_purity"]) == (
        ari370, pur370)


@pytest.mark.parametrize("which", ["direct370", "direct"])
def test_training_free_values_match_jax_at_the_same_optimum(corpus, which):
    """The gate's training-free values against the JAX package's functions
    on the same artifacts.  At the gate's one seed the two packages' k-means
    draw other k-means++ seeds (other RNGs) and on this 24-clip corpus may
    stop in other local optima (seed 42 on the 370-d features: inertia
    4,487.6 / ARI 0.626 in the port, 4,438.8 / 0.376 in the JAX package),
    so each package's lowest-inertia solution over 8 seeds is compared:
    the same optimum, ARI and purity within 0.02."""
    from tpuvae.cluster import kmeans as jax_kmeans
    from tpuvae.metrics import adjusted_rand_score as jax_ari
    from tpuvae.metrics import purity_score as jax_purity

    from tpuvae_torch.cluster.kmeans import kmeans
    from tpuvae_torch.metrics.external import (
        adjusted_rand_score,
        purity_score,
    )

    x, y, k = _training_free_inputs(corpus)[which]
    x = x.astype(np.float32)
    port = _best_of_seeds(kmeans, torch.from_numpy(x), k)
    jax = _best_of_seeds(jax_kmeans, x, k)
    np.testing.assert_allclose(port.inertia, float(jax.inertia), rtol=1e-4)
    jl = np.asarray(jax.labels)
    assert abs(adjusted_rand_score(y, port.labels, k, k)
               - float(jax_ari(y, jl, k, k))) <= 0.02
    assert abs(purity_score(y, port.labels, k, k)
               - float(jax_purity(y, jl, k, k))) <= 0.02


def test_run_quality_reports_what_misses_its_floor(corpus, small_cluster_cfg,
                                                   tmp_path):
    """A floor above what the run reaches fails the gate with its line."""
    from tpuvae_torch.parity import run_quality

    res = run_quality(
        data1=str(corpus / "processed_data1"),
        data2=str(corpus / "processed_data2"),
        results_dir=str(tmp_path / "quality"), cluster_cfg=small_cluster_cfg,
        overrides={"epochs": 1, "batch_size": 8},
        floors={"direct370_ari": 1.01, "silhouette": 0.99}, device="cpu")
    assert not res["ok"]
    assert any("370-d direct K-Means ARI" in p for p in res["problems"])
    assert any("silhouette" in p for p in res["problems"])
