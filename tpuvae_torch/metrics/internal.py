"""Internal clustering quality metrics (silhouette, Davies-Bouldin,
Calinski-Harabasz) on the device, in fp32 (counterpart of
``tpuvae/metrics/internal.py``).

Labels must be compacted to 0..n_clusters-1 (see
``tpuvae_torch.metrics.labels.compact_labels``; DBSCAN's noise label -1
becomes its own cluster, exactly as sklearn's silhouette treats it).  Each
function returns a 0-d tensor on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvae_torch.metrics.pairwise import distances, self_distances

_TINY = float(np.finfo(np.float32).tiny)


def _one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels.long(), k).float()


def _labels(labels, device) -> torch.Tensor:
    return torch.as_tensor(labels, device=device).long()


def silhouette_from_distances(dist: torch.Tensor, labels,
                              n_clusters: int) -> torch.Tensor:
    """Mean silhouette given a precomputed (N, N) distance matrix.

    The per-cluster distance sums are one (N, N) @ (N, k) matmul, so a
    k-sweep reuses ``dist``.
    """
    labels = _labels(labels, dist.device)
    onehot = _one_hot(labels, n_clusters)
    counts = onehot.sum(dim=0)                                    # (k,)
    sums = torch.matmul(dist, onehot)                             # (N, k)
    own = counts[labels]                                          # (N,)
    own_sum = torch.gather(sums, 1, labels[:, None])[:, 0]
    a = own_sum / torch.clamp_min(own - 1.0, 1.0)
    slot = torch.arange(n_clusters, device=dist.device)
    other = torch.where(
        (slot[None, :] == labels[:, None]) | (counts[None, :] == 0),
        torch.tensor(float("inf"), device=dist.device),
        sums / torch.clamp_min(counts[None, :], 1.0),
    )
    b = other.min(dim=1).values
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), _TINY)
    s = torch.where(own <= 1.0, torch.zeros_like(s), s)   # singleton clusters -> 0
    return s.mean()


def silhouette_score(x: torch.Tensor, labels, n_clusters: int) -> torch.Tensor:
    return silhouette_from_distances(self_distances(x), labels, n_clusters)


def _centroids(x: torch.Tensor, onehot: torch.Tensor):
    counts = torch.clamp_min(onehot.sum(dim=0), 1.0)
    return torch.matmul(onehot.T, x) / counts[:, None], counts


def davies_bouldin_score(x: torch.Tensor, labels,
                         n_clusters: int) -> torch.Tensor:
    labels = _labels(labels, x.device)
    onehot = _one_hot(labels, n_clusters)
    centroids, counts = _centroids(x, onehot)
    # intra-cluster mean distance to centroid
    d_to_centroid = torch.linalg.vector_norm(x - centroids[labels], dim=1)
    s = torch.matmul(onehot.T, d_to_centroid) / counts
    m = distances(centroids, centroids)
    r = (s[:, None] + s[None, :]) / torch.where(
        m > 0, m, torch.tensor(float("inf"), device=x.device))
    eye = torch.eye(n_clusters, dtype=torch.bool, device=x.device)
    r = torch.where(eye, torch.tensor(float("-inf"), device=x.device), r)
    return r.max(dim=1).values.mean()


def calinski_harabasz_score(x: torch.Tensor, labels,
                            n_clusters: int) -> torch.Tensor:
    n = x.shape[0]
    labels = _labels(labels, x.device)
    centroids, counts = _centroids(x, _one_hot(labels, n_clusters))
    mean = x.mean(dim=0)
    between = torch.sum(counts * torch.sum((centroids - mean) ** 2, dim=1))
    within = torch.sum((x - centroids[labels]) ** 2)
    return (between / (n_clusters - 1)) / (within / (n - n_clusters))
