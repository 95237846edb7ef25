"""Model-selection sweeps (counterpart of ``tpuvae/cluster/sweeps.py``).

``kmeans_k_sweep``: the silhouette-maximizing K (Simple uses k in
{3, 5, 7, 9}, ``Simple_VAE.py:239-252``).  The (N, N) distance matrix is
computed ONCE per sweep (kernel 5 on the card) and reused for every
silhouette.  The agglomerative and DBSCAN sweeps wait for the clustering
slice (ROADMAP.md, queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpuvae_torch.cluster.kmeans import kmeans_dynamic
from tpuvae_torch.metrics.internal import silhouette_from_distances
from tpuvae_torch.metrics.pairwise import self_distances


@dataclasses.dataclass
class SweepResult:
    best_param: float
    best_score: float
    scores: dict          # param -> silhouette (or None if invalid)
    best_labels: np.ndarray | None


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
