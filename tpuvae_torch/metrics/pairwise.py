"""Pairwise distances — the O(N^2) core shared by silhouette, agglomerative
and DBSCAN (counterpart of ``tpuvae/metrics/pairwise.py``).

The (N, N) matrix is computed once per sweep and reused.  On a CUDA tensor
``squared_distances`` and ``self_distances`` launch kernel 5
(``tpuvae_torch.ops.pairwise``) at every N; on a CPU tensor they run its
plain version.  The JAX package's ``PALLAS_SELF_DIST_MIN_N = 4096``, which
chooses between a TPU einsum and the Pallas kernel, is TPU tuning and is
not carried over.
"""

from __future__ import annotations

import torch

from tpuvae_torch.ops.pairwise import self_distances as _self_distances
from tpuvae_torch.ops.pairwise import squared_distances as _squared_distances


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).contiguous()


def squared_distances(x, y) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) squared Euclidean distances (clamped >= 0),
    fp32 throughout: bf16 or TF32 flips borderline DBSCAN memberships and
    k-means assignments."""
    return _squared_distances(_f32(x), _f32(y))


def distances(x, y) -> torch.Tensor:
    return torch.sqrt(squared_distances(x, y))


def self_distances(x) -> torch.Tensor:
    """(N, N) Euclidean distances with an exactly-zero diagonal."""
    return _self_distances(_f32(x))
