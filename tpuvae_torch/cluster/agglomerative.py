"""Agglomerative (Ward) clustering: a float64 distance matrix and the
nearest-neighbour chain on the host (counterpart of
``tpuvae/cluster/agglomerative.py``).

Replaces sklearn's AgglomerativeClustering (``Convolutional_VAE.py:330-344``).
Merge order inside dense blobs depends on rounding, so the initial matrix is
float64 (sklearn parity) and the code is the JAX package's numpy, operation
for operation: with the same float32 input the merges are bit-equal.  No
kernel runs here; the sweep's silhouette matrix comes from kernel 5
(``tpuvae_torch.cluster.sweeps``).  The dendrogram is built once and every k
of a sweep is cut from it.

NN-chain emits merges out of height order; each merge therefore records its
Ward height plus a representative point per side, and cuts replay merges in
height order with a union-find (equivalent to scipy/sklearn's sorted Z).
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):                     # a tensor, wherever it lies
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def ward_linkage(x) -> np.ndarray:
    """Ward dendrogram via the nearest-neighbour chain algorithm.

    Returns a float64 array (N-1, 3): [rep_point_a, rep_point_b, height],
    sorted by height — ``rep_point_*`` is the minimum original index in each
    merged side, which identifies the cluster order-independently.
    """
    xd = np.asarray(_host(x), dtype=np.float64)
    n = xd.shape[0]
    sq = np.sum(xd * xd, axis=1)
    d = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T), 0.0)
    np.fill_diagonal(d, np.inf)
    size = np.ones(n)
    active = np.ones(n, dtype=bool)
    rep = np.arange(n)                 # min original index per slot
    records = np.empty((n - 1, 3))
    chain: list[int] = []

    for t in range(n - 1):
        if not chain:
            chain.append(int(np.flatnonzero(active)[0]))
        while True:
            a = chain[-1]
            row = d[a].copy()
            row[~active] = np.inf
            row[a] = np.inf
            b = int(np.argmin(row))
            if len(chain) > 1 and b == chain[-2]:
                break
            chain.append(b)
        b = chain.pop()
        a = chain.pop()
        records[t] = (rep[a], rep[b], d[a, b])
        sa, sb = size[a], size[b]
        others = active.copy()
        others[[a, b]] = False
        so = size[others]
        d_new = (
            (sa + so) * d[a, others] + (sb + so) * d[b, others] - so * d[a, b]
        ) / (sa + sb + so)
        d[a, others] = d_new
        d[others, a] = d_new
        size[a] = sa + sb
        active[b] = False
        rep[a] = min(rep[a], rep[b])
    # stable sort by height => scipy/sklearn-equivalent merge order
    return records[np.argsort(records[:, 2], kind="stable")]


def cut_tree(merges: np.ndarray, n: int, k: int) -> np.ndarray:
    """Labels for k clusters: replay the n-k smallest merges (union-find),
    clusters labelled 0..k-1 by first point occurrence (sklearn convention)."""
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for t in range(n - k):
        a, b = int(merges[t, 0]), int(merges[t, 1])
        ra, rb = find(a), find(b)
        parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(n)])
    order: dict[int, int] = {}
    out = np.empty(n, dtype=np.int32)
    for i, r in enumerate(roots):
        if r not in order:
            order[r] = len(order)
        out[i] = order[r]
    return out


def agglomerative(x, k: int, merges: np.ndarray | None = None) -> np.ndarray:
    """Ward agglomerative labels for k clusters.  Pass precomputed ``merges``
    (from :func:`ward_linkage`) to amortize across a K-sweep."""
    x = _host(x)
    if merges is None:
        merges = ward_linkage(x)
    return cut_tree(merges, x.shape[0], k)
