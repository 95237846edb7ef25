"""The rest of the port's clustering against the JAX package and sklearn,
on the CPU: Ward agglomerative (merges bit-equal, cuts equal), DBSCAN
(labels equal element by element), spectral clustering (the embedding's
subspace, ARI) and the agglomerative and DBSCAN sweeps.

Every input is made with numpy from a seed and given to both packages as
the same float32 array.  Tolerances: Ward merges and DBSCAN labels exact
(host float64 in both packages; DBSCAN a deterministic function of the
neighbour mask, which no pair within rounding of eps changes here);
silhouette scores 1e-5 (fp32 distance sums in two libraries); spectral
projectors 1e-4 (float64 eigenvectors of an fp32 affinity; the small
eigenvalues are degenerate on separated blobs, so single columns are not
compared).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sklearn import metrics as skm
from sklearn.cluster import DBSCAN as SkDBSCAN
from sklearn.cluster import AgglomerativeClustering, SpectralClustering

torch.set_num_threads(2)


def _blobs(seed=7, n=40, dim=3, sep=6.0, std=0.7):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.5, 0.5, 1]]) * sep
    if dim > 3:
        centers = np.concatenate(
            [centers, np.zeros((4, dim - 3))], axis=1) + rng.normal(
            0, sep / 4, (4, dim))
    x = np.concatenate([rng.normal(c, std, (n, dim)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(4), n)


def _duplicates():
    """Integer points on a small grid: many exact duplicates and equal
    distances, so every merge height ties with others."""
    rng = np.random.default_rng(11)
    return rng.integers(0, 3, (90, 2)).astype(np.float32)


def _latents():
    """Latent-like rows at the Hybrid's width, D = 128."""
    return _blobs(seed=5, n=30, dim=128, sep=12.0, std=0.5)[0]


WARD_CASES = {
    "blobs": lambda: _blobs()[0],
    "random": lambda: np.random.default_rng(3).normal(
        size=(100, 8)).astype(np.float32),
    "duplicates_and_ties": _duplicates,
    "latents_d128": _latents,
}


@pytest.fixture(scope="module", params=sorted(WARD_CASES))
def ward_case(request):
    from tpuvae.cluster.agglomerative import ward_linkage as jax_ward

    from tpuvae_torch.cluster import ward_linkage

    x = WARD_CASES[request.param]()
    return x, ward_linkage(x), jax_ward(x)


def test_ward_merges_are_bit_equal_to_jax(ward_case):
    x, got, want = ward_case
    assert got.dtype == want.dtype == np.float64
    assert got.shape == (x.shape[0] - 1, 3)
    np.testing.assert_array_equal(got, want)


def test_ward_takes_a_tensor_as_the_array(ward_case):
    from tpuvae_torch.cluster import ward_linkage

    x, got, _ = ward_case
    np.testing.assert_array_equal(ward_linkage(torch.from_numpy(x)), got)


def test_cut_tree_labels_equal_jax_for_k_2_to_14(ward_case):
    from tpuvae.cluster.agglomerative import cut_tree as jax_cut

    from tpuvae_torch.cluster import agglomerative, cut_tree

    x, merges, jmerges = ward_case
    n = x.shape[0]
    for k in range(2, 15):
        got = cut_tree(merges, n, k)
        assert got.dtype == np.int32 and len(set(got.tolist())) == k
        np.testing.assert_array_equal(got, jax_cut(jmerges, n, k), err_msg=k)
    np.testing.assert_array_equal(agglomerative(x, 5), cut_tree(merges, n, 5))


@pytest.mark.parametrize("k", [2, 4, 7])
def test_ward_matches_sklearn_on_separated_blobs(k):
    from tpuvae_torch.cluster import agglomerative

    x, _ = _blobs()
    sk = AgglomerativeClustering(n_clusters=k).fit(x)
    assert skm.adjusted_rand_score(agglomerative(x, k), sk.labels_) == 1.0


# -- DBSCAN ----------------------------------------------------------------

def _blobs_with_noise():
    x, _ = _blobs(seed=1)
    noise = np.random.default_rng(2).uniform(-4, 10, (25, 3))
    return np.concatenate([x, noise]).astype(np.float32), 1.0, 5


def _chain():
    """Two blobs and a chain of 400 points, far longer than log2(N)."""
    rng = np.random.default_rng(0)
    chain = (np.stack([np.linspace(0, 50, 400), np.zeros(400)], 1)
             + rng.normal(0, 0.05, (400, 2)))
    x = np.concatenate([rng.normal((10, 10), 0.3, (120, 2)),
                        rng.normal((-10, 10), 0.3, (120, 2)), chain])
    return x.astype(np.float32), 0.5, 5


def _border_tie():
    """Two clusters of five core points each on a line; the point midway
    between them lies within eps of one core of each and is a border point
    of both (two neighbours and itself: not a core at min_samples 4)."""
    left = np.array([[0, 0], [0.3, 0], [0.6, 0], [0.3, 0.3], [0.3, -0.3]])
    right = left + [3.0, 0]
    mid = np.array([[1.8, 0.0]])
    # listed right cluster first, so the smaller label is the right one
    x = np.concatenate([right, left, mid]).astype(np.float32)
    return x, 1.21, 4


DBSCAN_CASES = {
    "blobs_with_noise": _blobs_with_noise,
    "chain": _chain,
    "all_noise": lambda: (_blobs()[0], 1e-3, 5),
    "one_cluster": lambda: (_blobs()[0], 50.0, 5),
    "border_tie": _border_tie,
    "latents_d128": lambda: (_latents(), 9.0, 5),
}


@pytest.mark.parametrize("case", sorted(DBSCAN_CASES))
def test_dbscan_labels_equal_jax(case):
    from tpuvae.cluster import dbscan as jax_dbscan

    from tpuvae_torch.cluster import dbscan

    x, eps, min_samples = DBSCAN_CASES[case]()
    got = dbscan(x, eps, min_samples)
    want = np.asarray(jax_dbscan(jnp.asarray(x), eps, min_samples))
    assert got.dtype == np.int32 and got.shape == (x.shape[0],)
    np.testing.assert_array_equal(got, want)
    n_clusters = len(set(got.tolist()) - {-1})
    expect = {"all_noise": 0, "one_cluster": 1, "border_tie": 2,
              "chain": 3, "blobs_with_noise": 4, "latents_d128": 4}[case]
    assert n_clusters == expect
    # labels compacted 0..C-1 in order of each cluster's first point
    firsts = [int(np.flatnonzero(got == c)[0]) for c in range(n_clusters)]
    assert firsts == sorted(firsts)


@pytest.mark.parametrize("case", sorted(set(DBSCAN_CASES) - {"border_tie"}))
def test_dbscan_matches_sklearn_where_no_border_point_ties(case):
    from tpuvae_torch.cluster import dbscan

    x, eps, min_samples = DBSCAN_CASES[case]()
    got = dbscan(x, eps, min_samples)
    sk = SkDBSCAN(eps=eps, min_samples=min_samples).fit(x).labels_
    np.testing.assert_array_equal(got == -1, sk == -1)
    assert skm.adjusted_rand_score(sk, got) == 1.0


def test_dbscan_border_tie_goes_to_the_smaller_label():
    from tpuvae_torch.cluster import dbscan

    x, eps, min_samples = _border_tie()
    got = dbscan(x, eps, min_samples)
    np.testing.assert_array_equal(got, [0] * 5 + [1] * 5 + [0])
    sk = SkDBSCAN(eps=eps, min_samples=min_samples).fit(x).labels_
    np.testing.assert_array_equal(sk[:10], got[:10])    # the cores agree


# -- spectral ----------------------------------------------------------------

def _projector(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.float64)
    return u @ np.linalg.pinv(u)


def test_spectral_embedding_spans_the_jax_subspace():
    from tpuvae.cluster import spectral_embedding as jax_embed

    from tpuvae_torch.cluster import spectral_embedding

    x, _ = _blobs()
    got = spectral_embedding(torch.from_numpy(x), 4)
    want = jax_embed(x, 4)
    assert got.dtype == np.float32 and got.shape == (len(x), 4)
    np.testing.assert_allclose(_projector(got), _projector(want), atol=1e-4)
    # the same embedding at an explicit gamma
    np.testing.assert_allclose(
        _projector(spectral_embedding(x, 4, gamma=0.2)),
        _projector(jax_embed(x, 4, gamma=0.2)), atol=1e-4)


def test_spectral_clustering_agrees_with_jax_and_sklearn():
    from tpuvae.cluster import spectral_clustering as jax_spectral

    from tpuvae_torch.cluster import spectral_clustering

    x, y = _blobs()
    got = spectral_clustering(x, 4)
    assert skm.adjusted_rand_score(got, jax_spectral(x, 4)) == 1.0
    sk = SpectralClustering(n_clusters=4, affinity="rbf", gamma=1.0 / 3,
                            random_state=0).fit(x).labels_
    assert skm.adjusted_rand_score(got, sk) == 1.0
    assert skm.adjusted_rand_score(got, y) == 1.0


# -- sweeps ------------------------------------------------------------------

def _assert_sweeps_equal(got, want):
    assert got.best_param == want.best_param
    np.testing.assert_allclose(got.best_score, want.best_score, atol=1e-5)
    assert list(got.scores) == list(want.scores)
    for p, s in got.scores.items():
        w = want.scores[p]
        assert (s is None) == (w is None), p
        if s is not None:
            np.testing.assert_allclose(s, w, atol=1e-5, err_msg=str(p))
    np.testing.assert_array_equal(got.best_labels, np.asarray(want.best_labels))


@pytest.mark.parametrize("case", ["blobs", "random", "latents_d128"])
def test_agglomerative_k_sweep_matches_jax(case):
    from tpuvae.cluster import agglomerative_k_sweep as jax_sweep

    from tpuvae_torch.cluster import agglomerative_k_sweep

    x = WARD_CASES[case]()
    got = agglomerative_k_sweep(torch.from_numpy(x), range(2, 15))
    _assert_sweeps_equal(got, jax_sweep(x, range(2, 15)))
    if case == "blobs":
        assert got.best_param == 4


SWEEP_CASES = {
    "blobs": lambda: (_blobs()[0], np.arange(0.5, 3.0, 0.5)),
    # the pipeline's grid: eps 3..19 step 1 at D = 128 (small eps all noise)
    "latents_d128": lambda: (_latents(), np.arange(3.0, 19.0 + 1e-9, 1.0)),
    # no eps qualifies: the eps = 10 fallback (tests/test_cluster_metrics.py)
    "fallback": lambda: (_blobs()[0], [1e-6]),
}


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_dbscan_eps_sweep_matches_jax(case):
    from tpuvae.cluster import dbscan_eps_sweep as jax_sweep

    from tpuvae_torch.cluster import dbscan_eps_sweep

    x, eps_values = SWEEP_CASES[case]()
    got = dbscan_eps_sweep(torch.from_numpy(x), eps_values, min_samples=5,
                           fallback_eps=10.0)
    _assert_sweeps_equal(got, jax_sweep(x, eps_values, min_samples=5,
                                        fallback_eps=10.0))
    if case == "fallback":
        assert got.best_param == 10.0 and got.best_score == -1.0
        assert got.scores == {1e-6: None}
    else:
        assert got.best_score > 0
        assert any(s is None for s in got.scores.values()) == (
            case == "latents_d128")


def test_sweeps_launch_nothing_on_the_cpu_and_score_noise_as_a_cluster():
    from tpuvae.metrics import compact_labels as jax_compact
    from tpuvae.metrics import self_distances as jax_dist
    from tpuvae.metrics import silhouette_from_distances as jax_sil

    from tpuvae_torch import ops
    from tpuvae_torch.cluster import dbscan_eps_sweep

    x, _, _ = _blobs_with_noise()
    ops.reset_launch_counts()
    res = dbscan_eps_sweep(x, [1.0], min_samples=5)
    assert sum(ops.launch_counts().values()) == 0
    assert (res.best_labels == -1).any()
    lab, k = jax_compact(res.best_labels)
    want = float(jax_sil(jax_dist(jnp.asarray(x)), jnp.asarray(lab), k))
    np.testing.assert_allclose(res.best_score, want, atol=1e-5)
