"""The port's clustering stack against the JAX package's, on the CPU.

* Kernel 5's plain version against the Pallas kernel in interpret mode, at
  shapes that are not tile multiples: rtol 1e-5 / atol 1e-4 (fp32 with
  another summation order in the cross term); self-distances with an
  exactly-zero diagonal within rtol 1e-4 / atol 1e-4 of the JAX function
  (the square root of a squared distance near 0 amplifies its error).
* Silhouette, Davies-Bouldin, Calinski-Harabasz on seeded blobs, with a
  noise label: 1e-5 relative (fp32 reductions in another order).
* Lloyd from given centres: the same labels, centres within 1e-5.  Full
  k-means and the k-sweep draw from different RNGs in the two frameworks:
  ARI >= 0.99 on separated blobs, the same best k, inertia within 1e-3
  relative on random data.
* PCA within atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    centers = np.array([[0, 0, 0], [6, 0, 0], [0, 6, 0], [3, 3, 6]], float)
    x = np.concatenate(
        [rng.normal(c, 0.7, (40, 3)) for c in centers]).astype(np.float32)
    return x, np.repeat(np.arange(4), 40)


@pytest.fixture(scope="module")
def random_x():
    return np.random.default_rng(3).normal(size=(100, 8)).astype(np.float32)


# ------------------------------------------------------------- kernel 5 ---

@pytest.mark.parametrize("n,m,d", [(100, 77, 37), (130, 130, 8)])
def test_pairwise_plain_matches_pallas(n, m, d):
    from tpuvae.ops.pairwise import squared_distances_pallas

    from tpuvae_torch.ops.pairwise import (
        squared_distances,
        squared_distances_plain,
    )

    rng = np.random.default_rng(n * d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = x if n == m else rng.normal(size=(m, d)).astype(np.float32)
    want = np.asarray(squared_distances_pallas(x, y, tile_n=64, tile_m=64,
                                               interpret=True))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = squared_distances_plain(xt, yt).numpy()
    assert got.shape == (n, m) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(squared_distances(xt, yt),
                               squared_distances_plain(xt, yt), rtol=0, atol=0)


def test_self_distances_zero_diagonal_matches_jax():
    from tpuvae.metrics.pairwise import self_distances as jax_self
    from tpuvae.ops.pairwise import self_distances_pallas

    from tpuvae_torch.metrics.pairwise import distances, self_distances

    rng = np.random.default_rng(1)
    x = rng.normal(size=(130, 8)).astype(np.float32)
    x[5] = x[4] + 1e-4          # a near-duplicate row: the clamp at 0
    got = self_distances(x).numpy()
    assert (np.diag(got) == 0).all() and (got >= 0).all()
    np.testing.assert_allclose(got, np.asarray(jax_self(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(self_distances_pallas(x, tile_n=64, tile_m=64,
                                              interpret=True)),
        rtol=1e-4, atol=1e-4)
    off = ~np.eye(130, dtype=bool)
    np.testing.assert_allclose(got[off], distances(x, x).numpy()[off],
                               rtol=0, atol=0)


def test_pairwise_wrapper_rejects_what_the_kernel_does_not_take():
    from tpuvae_torch.ops.pairwise import self_distances, squared_distances

    with pytest.raises(ValueError, match="float32"):
        self_distances(torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="pair"):
        squared_distances(torch.zeros((4, 3)), torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="device"):
        self_distances(torch.zeros((4, 3), device="meta"))


# -------------------------------------------------------------- metrics ---

def _jax_metrics(x, labels, k, dist):
    from tpuvae.metrics import (
        calinski_harabasz_score,
        davies_bouldin_score,
        silhouette_from_distances,
    )

    lab = jnp.asarray(labels)
    return (float(silhouette_from_distances(jnp.asarray(dist), lab, k)),
            float(davies_bouldin_score(jnp.asarray(x), lab, k)),
            float(calinski_harabasz_score(jnp.asarray(x), lab, k)))


@pytest.mark.parametrize("noise", [False, True], ids=["clean", "noise-label"])
def test_internal_metrics_match_jax(blobs, noise):
    from tpuvae.metrics import compact_labels as jax_compact

    from tpuvae_torch.metrics.internal import (
        calinski_harabasz_score,
        davies_bouldin_score,
        silhouette_from_distances,
        silhouette_score,
    )
    from tpuvae_torch.metrics.labels import compact_labels, encode_labels
    from tpuvae_torch.metrics.pairwise import self_distances

    x, y = blobs
    raw = y.copy()
    if noise:
        raw[::9] = -1           # DBSCAN's noise label, a cluster of its own
    labels, k = compact_labels(raw)
    want_labels, want_k = jax_compact(raw)
    np.testing.assert_array_equal(labels, want_labels)
    assert k == want_k == (5 if noise else 4)
    xt = torch.from_numpy(x)
    dist = self_distances(xt)
    want = _jax_metrics(x, labels, k, dist.numpy())
    got = (float(silhouette_from_distances(dist, labels, k)),
           float(davies_bouldin_score(xt, labels, k)),
           float(calinski_harabasz_score(xt, labels, k)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(silhouette_score(xt, labels, k)) == got[0]
    codes, classes = encode_labels(np.array(["pop", "rock", "pop", "jazz"]))
    assert codes.tolist() == [1, 2, 1, 0] and classes == ["jazz", "pop", "rock"]


# ------------------------------------------------------------ clustering ---

def test_lloyd_from_given_centres_matches_jax(random_x):
    from tpuvae.cluster.kmeans import _lloyd

    from tpuvae_torch.cluster.kmeans import lloyd

    x = random_x
    c0 = x[[3, 17, 42, 77, 90]].copy()
    c0[4] = 100.0               # a centre no point picks: the empty reseed
    tol = 1e-4 * float(np.mean(np.var(x, axis=0)))
    want_labels, want_centers, want_inertia, want_iter = _lloyd(
        jnp.asarray(x), jnp.asarray(c0), 5, 300, tol)
    labels, centers, inertia, n_iter = lloyd(
        torch.from_numpy(x), torch.from_numpy(c0)[None], 300, tol)
    np.testing.assert_array_equal(labels[0].numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(centers[0].numpy(), np.asarray(want_centers),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(inertia[0]), float(want_inertia),
                               rtol=1e-5)
    assert int(n_iter[0]) == int(want_iter)


def test_kmeans_matches_jax_on_blobs(blobs):
    from sklearn.metrics import adjusted_rand_score

    from tpuvae.cluster import kmeans as jax_kmeans

    from tpuvae_torch.cluster.kmeans import centers_from_labels, kmeans

    x, y = blobs
    got = kmeans(torch.from_numpy(x), 4, n_init=10, seed=42)
    want = jax_kmeans(x, 4, n_init=10, seed=42)
    assert got.labels.dtype == np.int32 and got.centers.shape == (4, 3)
    assert adjusted_rand_score(got.labels, want.labels) >= 0.99
    assert adjusted_rand_score(got.labels, y) >= 0.99
    np.testing.assert_allclose(got.inertia, want.inertia, rtol=1e-3)
    np.testing.assert_allclose(
        centers_from_labels(x, got.labels)[got.labels],
        got.centers[got.labels], rtol=0, atol=1e-5)


def test_kmeans_inertia_matches_jax_on_random(random_x):
    """k = 2 and 3: on isotropic random data larger k has several optima a
    few tenths of a percent apart, which the two RNGs reach in turn."""
    from tpuvae.cluster import kmeans as jax_kmeans

    from tpuvae_torch.cluster.kmeans import kmeans, kmeans_dynamic

    x = torch.from_numpy(random_x)
    for k in (2, 3):
        want = jax_kmeans(random_x, k, n_init=10, seed=42).inertia
        got = kmeans(x, k, n_init=10, seed=42)
        np.testing.assert_allclose(got.inertia, want, rtol=1e-3, err_msg=k)
        assert got.n_iter >= 1
        dyn = kmeans_dynamic(x, k, 7, n_init=10, seed=42)
        assert dyn.n_iter == -1 and dyn.centers.shape == (k, 8)
        np.testing.assert_allclose(dyn.inertia, want, rtol=1e-3, err_msg=k)


def test_kmeans_k_sweep_matches_jax(blobs):
    from sklearn.metrics import adjusted_rand_score

    from tpuvae.cluster import kmeans_k_sweep as jax_sweep

    from tpuvae_torch.cluster.sweeps import kmeans_k_sweep

    x, _ = blobs
    ks = (2, 3, 4, 5, 7)
    got = kmeans_k_sweep(torch.from_numpy(x), ks, n_init=10, seed=42)
    want = jax_sweep(x, ks, n_init=10, seed=42)
    assert got.best_param == want.best_param == 4
    assert adjusted_rand_score(got.best_labels, want.best_labels) >= 0.99
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=1e-5)
    assert sorted(got.scores) == list(ks)


def test_pca_matches_jax(blobs):
    from tpuvae.cluster import pca_fit as jax_pca

    from tpuvae_torch.cluster.pca import pca_fit, pca_transform

    x, _ = blobs
    got = pca_fit(torch.from_numpy(x), 2)
    want = jax_pca(x, 2)
    np.testing.assert_allclose(got.components, want.components, atol=1e-4)
    np.testing.assert_allclose(got.mean, want.mean, atol=1e-4)
    np.testing.assert_allclose(got.explained_variance,
                               want.explained_variance, rtol=1e-4)
    np.testing.assert_allclose(pca_transform(torch.from_numpy(x), 2).numpy(),
                               want.transform(x), atol=1e-4)
