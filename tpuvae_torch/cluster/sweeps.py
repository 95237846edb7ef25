"""Model-selection sweeps (counterpart of ``tpuvae/cluster/sweeps.py``).

  * ``kmeans_k_sweep``: the silhouette-maximizing K (Simple uses k in
    {3, 5, 7, 9}, ``Simple_VAE.py:239-252``; Hybrid uses k in 2..14,
    ``Convolutional_VAE.py:311-327``);
  * ``agglomerative_k_sweep``: k in 2..14 (``Convolutional_VAE.py:330-344``),
    the Ward dendrogram built once and every k cut from it;
  * ``dbscan_eps_sweep``: eps in 3..19 step 1, min_samples 5,
    silhouette-selected with the eps = 10 fallback
    (``Convolutional_VAE.py:347-374``).

The (N, N) distance matrix is computed ONCE per sweep (one launch of kernel
5 on the card) and reused for every silhouette and, in the DBSCAN sweep,
for every eps.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpuvae_torch.cluster.agglomerative import cut_tree, ward_linkage
from tpuvae_torch.cluster.dbscan import dbscan_from_distances
from tpuvae_torch.cluster.kmeans import kmeans_dynamic
from tpuvae_torch.metrics.internal import silhouette_from_distances
from tpuvae_torch.metrics.labels import compact_labels
from tpuvae_torch.metrics.pairwise import self_distances


@dataclasses.dataclass
class SweepResult:
    best_param: float
    best_score: float
    scores: dict          # param -> silhouette (or None if invalid)
    best_labels: np.ndarray | None


def _sil(dist: torch.Tensor, labels_np) -> float:
    labels, k = compact_labels(labels_np)
    return float(silhouette_from_distances(dist, labels, k))


def kmeans_k_sweep(x, k_values: Sequence[int], *, n_init: int = 10,
                   seed: int = 42) -> SweepResult:
    """Silhouette-maximizing K, where ``x`` lies.  Every k seeds with the
    trials of the largest k and scores over ``k_max`` label slots, as the
    JAX sweep does (empty slots contribute nothing to the score)."""
    xd = torch.as_tensor(x, dtype=torch.float32).contiguous()
    dist = self_distances(xd)
    k_values = list(k_values)
    k_max = max(k_values)
    best_k, best_s, best_labels, scores = None, -1.0, None, {}
    for k in k_values:
        labels = kmeans_dynamic(xd, k, k_max, n_init=n_init, seed=seed).labels
        s = float(silhouette_from_distances(dist, labels, k_max))
        scores[k] = s
        if s > best_s:
            best_k, best_s, best_labels = k, s, labels
    return SweepResult(best_k, best_s, scores, best_labels)


def agglomerative_k_sweep(x, k_values: Sequence[int]) -> SweepResult:
    """Silhouette-maximizing Ward cut; the silhouettes where ``x`` lies,
    the dendrogram on the host (``cluster.agglomerative``)."""
    xd = torch.as_tensor(x, dtype=torch.float32).contiguous()
    dist = self_distances(xd)
    xh = xd.cpu().numpy()
    merges = ward_linkage(xh)
    best_k, best_s, best_labels, scores = None, -1.0, None, {}
    for k in k_values:
        labels = cut_tree(merges, xh.shape[0], k)
        s = _sil(dist, labels)
        scores[k] = s
        if s > best_s:
            best_k, best_s, best_labels = k, s, labels
    return SweepResult(best_k, best_s, scores, best_labels)


def dbscan_eps_sweep(x, eps_values: Sequence[float], *, min_samples: int = 5,
                     fallback_eps: float = 10.0) -> SweepResult:
    """Silhouette-selected eps; entries with fewer than two real clusters
    score ``None``; silhouette counts noise −1 as a cluster of its own
    (sklearn's behaviour in the reference, ``Convolutional_VAE.py:361``).
    When no eps qualifies: ``fallback_eps`` with ``best_score`` −1."""
    xd = torch.as_tensor(x, dtype=torch.float32).contiguous()
    dist = self_distances(xd)
    best_eps, best_s, best_labels, scores = None, -1.0, None, {}
    for eps in eps_values:
        labels = dbscan_from_distances(dist, eps, min_samples)
        n_clusters = len(set(labels.tolist()) - {-1})
        if n_clusters >= 2:
            s = _sil(dist, labels)
            scores[eps] = s
            if s > best_s:
                best_eps, best_s, best_labels = eps, s, labels
        else:
            scores[eps] = None
    if best_eps is None:
        best_eps = fallback_eps    # ref Convolutional_VAE.py:370-372
        best_labels = dbscan_from_distances(dist, best_eps, min_samples)
        best_s = -1.0
    return SweepResult(best_eps, best_s, scores, best_labels)
