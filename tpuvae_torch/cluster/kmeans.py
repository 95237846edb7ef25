"""K-Means on the device: greedy k-means++ seeding and Lloyd iterations,
with the ``n_init`` restarts run together as one leading batch dimension
(counterpart of ``tpuvae/cluster/kmeans.py``, where ``vmap`` does this).

sklearn semantics, as the JAX package reproduces them:
  * ``n_init`` restarts, best inertia wins;
  * greedy k-means++ with ``2 + floor(log k)`` local trials;
  * Lloyd until centre shift^2 <= tol * mean(var(X)) or ``max_iter``, each
    restart stopping on its own;
  * empty clusters re-seeded at DISTINCT farthest points.
Randomness comes from a ``torch.Generator`` seeded with ``seed`` on the
data's device, so labels agree with the JAX package's only up to the RNG:
the tests hold them to ARI and inertia, and Lloyd from given centres to
equality.  Assignment distances stay fp32 ``torch.matmul`` (bf16 flips
memberships); everything runs where ``x`` lies.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class KMeansResult:
    labels: np.ndarray          # (N,) int32
    centers: np.ndarray         # (k, D)
    inertia: float
    n_iter: int


def _d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, D), (..., M, D) -> (..., N, M) squared distances, >= 0."""
    return (a.square().sum(-1)[..., :, None] + b.square().sum(-1)[..., None, :]
            - 2.0 * torch.matmul(a, b.transpose(-1, -2))).clamp_min(0.0)


def _kmeanspp_init(x: torch.Tensor, k: int, n_init: int, n_trials: int,
                   gen: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ seeding of ``n_init`` restarts -> (R, k, D)."""
    n, dim = x.shape
    rows = torch.arange(n_init, device=x.device)
    first = torch.randint(0, n, (n_init,), generator=gen, device=x.device)
    centers = torch.zeros((n_init, k, dim), dtype=x.dtype, device=x.device)
    centers[:, 0] = x[first]
    closest = _d2(x, x[first]).T                              # (R, N)
    for i in range(1, k):
        total = closest.sum(dim=1, keepdim=True)
        # every point sits on a chosen centre: no mass to sample from, so
        # draw uniformly
        probs = torch.where(total > 0, closest / total.clamp_min(1e-30),
                            torch.ones_like(closest))
        cand = torch.multinomial(probs, n_trials, replacement=True,
                                 generator=gen)               # (R, T)
        cand_d2 = _d2(x, x[cand])                             # (R, N, T)
        new_closest = torch.minimum(closest[:, :, None], cand_d2)
        best = new_closest.sum(dim=1).argmin(dim=1)           # (R,)
        centers[:, i] = x[cand[rows, best]]
        closest = new_closest[rows, :, best]
    return centers


def _assign(x: torch.Tensor, xsq: torch.Tensor, centers: torch.Tensor):
    d2 = (xsq[None, :, None] + centers.square().sum(-1)[:, None, :]
          - 2.0 * torch.matmul(x, centers.transpose(-1, -2)))
    min_d2, labels = d2.min(dim=2)
    return labels, min_d2.clamp_min(0.0)


def lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int,
          tol_scaled: float):
    """Lloyd iterations of each restart from ``centers (R, k, D)`` until its
    centre shift^2 is <= ``tol_scaled`` or ``max_iter``.  Returns
    ``(labels (R, N), centers (R, k, D), inertia (R,), n_iter (R,))``."""
    n = x.shape[0]
    r, k, _ = centers.shape
    xsq = x.square().sum(-1)
    n_top = min(k, n)
    shift2 = torch.full((r,), float("inf"), device=x.device)
    n_iter = torch.zeros((r,), dtype=torch.int64, device=x.device)
    while True:
        active = (shift2 > tol_scaled) & (n_iter < max_iter)
        if not bool(active.any()):
            break
        labels, min_d2 = _assign(x, xsq, centers)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # (R, N, k)
        counts = onehot.sum(dim=1)                                   # (R, k)
        new = (torch.matmul(onehot.transpose(1, 2), x)
               / counts.clamp_min(1.0)[..., None])
        # re-seed each empty cluster at a DISTINCT worst-fit point; with
        # k > n points distinctness is impossible and the ranks wrap around
        far = torch.topk(min_d2, n_top, dim=1).indices               # (R, n_top)
        rank = torch.cumsum((counts == 0).long(), dim=1) - 1
        pick = torch.gather(far, 1, rank.clamp(0, n_top - 1) % n_top)
        new = torch.where((counts > 0)[..., None], new, x[pick])
        step_shift = (new - centers).square().sum(dim=(1, 2))
        centers = torch.where(active[:, None, None], new, centers)
        shift2 = torch.where(active, step_shift, shift2)
        n_iter = n_iter + active.long()
    labels, min_d2 = _assign(x, xsq, centers)
    return labels, centers, min_d2.sum(dim=1), n_iter


def _fit(x, k: int, n_trials: int, n_init: int, max_iter: int, tol: float,
         seed: int) -> KMeansResult:
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    tol_scaled = tol * float(x.var(dim=0, unbiased=False).mean())
    gen = torch.Generator(device=x.device).manual_seed(seed)
    centers0 = _kmeanspp_init(x, k, n_init, n_trials, gen)
    labels, centers, inertia, n_iter = lloyd(x, centers0, max_iter, tol_scaled)
    best = int(inertia.argmin())
    return KMeansResult(
        labels=labels[best].to(torch.int32).cpu().numpy(),
        centers=centers[best].cpu().numpy(),
        inertia=float(inertia[best]),
        n_iter=int(n_iter[best]),
    )


def kmeans(x, k: int, *, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4, seed: int = 42) -> KMeansResult:
    """Fit K-Means where ``x`` lies; returns a host-side result."""
    n_trials = 2 + int(math.floor(math.log(k))) if k > 1 else 1
    return _fit(x, k, n_trials, n_init, max_iter, tol, seed)


def kmeans_dynamic(x, k: int, k_max: int, *, n_init: int = 10,
                   max_iter: int = 300, tol: float = 1e-4,
                   seed: int = 42) -> KMeansResult:
    """K-Means at ``k`` with the seeding trials of ``k_max``, as the JAX
    package's one-executable k-sweep draws them.  PyTorch runs eagerly, so
    the cluster slots past ``k`` that the JAX version masks are simply not
    allocated."""
    n_trials = 2 + int(math.floor(math.log(max(k_max, 2))))
    res = _fit(x, k, n_trials, n_init, max_iter, tol, seed)
    return dataclasses.replace(res, n_iter=-1)


def centers_from_labels(x, labels) -> np.ndarray:
    """Per-cluster means of a final partition, INDEXED by label id: row ``i``
    is the centroid of label ``i``, so serving cluster ids stay aligned with
    the training partition's ids even when some label slot ended up empty.
    Empty rows are NaN — ``tpuvae_torch.infer`` treats them as unreachable.
    Noise points (label -1, DBSCAN) are excluded.
    """
    x = np.asarray(x, np.float32)
    labels = np.asarray(labels)
    ids = np.unique(labels[labels >= 0])
    if ids.size == 0:
        raise ValueError("no non-noise labels — cannot form centroids")
    out = np.full((int(ids.max()) + 1, x.shape[1]), np.nan, np.float32)
    for i in ids:
        out[i] = x[labels == i].mean(axis=0)
    return out
