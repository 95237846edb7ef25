"""DBSCAN by min-label propagation with pointer jumping, on the device
where ``x`` lies (counterpart of ``tpuvae/cluster/dbscan.py``).

Replaces sklearn's DBSCAN (``Convolutional_VAE.py:347-374``).  Fixed-shape
tensor operations on the (N, N) distance matrix (kernel 5's
``self_distances`` on the card): the neighbour mask ``d <= eps`` (self
included), the core mask from neighbour counts, connected components of the
core-core graph by min-label propagation (a masked (N, N) min per round)
interleaved with ⌈log₂N⌉ pointer jumps (``label <- label[label]``), so a
chain-shaped cluster converges in O(log N) rounds instead of O(diameter).
Each round reads one ``changed`` flag on the host.

Label semantics match sklearn: noise = −1; clusters numbered in sorted
order of the smallest core-point index they contain.  One documented
divergence, the JAX package's too: a BORDER point within eps of cores of
two clusters attaches to the cluster with the smaller label, where sklearn
attaches it to whichever cluster's expansion reaches it first — compare
such ties by ARI, not element by element.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuvae_torch.metrics.pairwise import self_distances


def _raw_labels(d: torch.Tensor, eps: float,
                min_samples: int) -> torch.Tensor:
    """Per point: the smallest core index of its component (cores), of its
    smallest-labelled core neighbour (borders), or -1 (noise)."""
    n = d.shape[0]
    neigh = d <= eps                                   # includes self
    core = neigh.sum(dim=1) >= min_samples
    core_adj = neigh & core[None, :] & core[:, None]
    inf = torch.tensor(n, dtype=torch.int32, device=d.device)
    idx = torch.arange(n, dtype=torch.int32, device=d.device)
    labels = torch.where(core, idx, inf)
    n_jumps = max(math.ceil(math.log2(max(n, 2))), 1)
    while True:
        # hook: the smallest label among core neighbours (a masked min)
        hooked = torch.where(core_adj, labels[None, :], inf).amin(dim=1)
        new = torch.minimum(labels, hooked)
        # compress: labels are core indices that decrease towards the
        # component's smallest, so each jump halves a pointer chain
        for _ in range(n_jumps):
            follow = new[new.clamp_max(n - 1).long()]
            new = torch.where(new < inf, torch.minimum(new, follow), new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    # border points: attach to the smallest-labelled core neighbour
    border = torch.where(neigh & core[None, :], labels[None, :], inf).amin(dim=1)
    final = torch.where(core, labels, border)
    return torch.where(final >= inf, torch.full_like(final, -1), final)


def _compact(raw: torch.Tensor) -> np.ndarray:
    """Noise -1, clusters 0..C-1 in sorted order of their raw label."""
    raw = raw.cpu().numpy()
    out = np.full(raw.shape, -1, np.int32)
    keep = raw >= 0
    out[keep] = np.unique(raw[keep], return_inverse=True)[1]
    return out


def dbscan_from_distances(d: torch.Tensor, eps: float,
                          min_samples: int = 5) -> np.ndarray:
    """:func:`dbscan` on a precomputed (N, N) distance matrix, where it
    lies (an eps sweep computes the matrix once)."""
    return _compact(_raw_labels(d, float(eps), int(min_samples)))


def dbscan(x, eps: float, min_samples: int = 5) -> np.ndarray:
    """DBSCAN labels (noise −1, clusters 0..C-1 compacted in sklearn order),
    computed where ``x`` lies (one launch of kernel 5 on the card)."""
    xd = torch.as_tensor(x, dtype=torch.float32).contiguous()
    return dbscan_from_distances(self_distances(xd), eps, min_samples)
