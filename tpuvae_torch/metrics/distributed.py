"""Mesh-sharded silhouette — the O(N²) metric split by rows over the data
axis (counterpart of ``tpuvae/metrics/distributed.py``).

Each rank computes the distances from its block of rows to all N points,
reduces them to per-cluster sums locally, makes its partial silhouette sum,
and one ``all_reduce`` combines the partial sums.  No (N, N) matrix
materialises anywhere: a rank holds (N / D, N) distances at a time.  The
block's distance product is an fp32 ``torch.matmul`` outside any kernel,
as the JAX package computes it outside any Pallas kernel; distances stay
fp32 (``metrics/pairwise.py:20-21``), with TF32 off on the card
(:func:`tpuvae_torch.device.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpuvae_torch.parallel.mesh import MeshContext, axis_size, mesh_device

_TINY = float(np.finfo(np.float32).tiny)


def silhouette_sharded(x: np.ndarray, labels: np.ndarray, n_clusters: int,
                       mesh, axis: str = "data") -> float:
    """Mean silhouette with row-sharded distance computation.

    ``x (N, D)`` and ``labels (N,)`` are the same on every rank; ``mesh``
    is a ``DeviceMesh`` (or a :class:`MeshContext`), whose device type
    says where the rows are computed.  Matches ``silhouette_from_distances``
    (same masking: singleton clusters give 0, padded rows give nothing) and
    returns the same float on every rank."""
    if isinstance(mesh, MeshContext):
        mesh, axis = mesh.mesh, mesh.axis
    dev = mesh_device(mesh)
    n = x.shape[0]
    n_dev = axis_size(mesh, axis)
    rows_per_dev = -(-n // n_dev)
    xs = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    lab = torch.as_tensor(np.asarray(labels), device=dev).long()
    onehot = torch.nn.functional.one_hot(lab, n_clusters).float()
    counts = onehot.sum(dim=0)

    start = mesh.get_local_rank(axis) * rows_per_dev
    x_blk = xs[start:start + rows_per_dev]        # short or empty at the end
    l_blk = lab[start:start + rows_per_dev]
    # (rows, N) distances from this block to all points
    d2 = ((x_blk * x_blk).sum(dim=1)[:, None] + (xs * xs).sum(dim=1)[None, :]
          - 2.0 * torch.matmul(x_blk, xs.T))
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    row_ids = start + torch.arange(x_blk.shape[0], device=dev)
    d = torch.where(row_ids[:, None] == torch.arange(n, device=dev)[None, :],
                    torch.zeros((), device=dev), d)   # zero self-distance
    sums = torch.matmul(d, onehot)                    # (rows, k)
    own = counts[l_blk]
    own_sum = torch.gather(sums, 1, l_blk[:, None])[:, 0]
    a = own_sum / torch.clamp_min(own - 1.0, 1.0)
    slot = torch.arange(n_clusters, device=dev)
    other = torch.where(
        (slot[None, :] == l_blk[:, None]) | (counts[None, :] == 0),
        torch.tensor(float("inf"), device=dev),
        sums / torch.clamp_min(counts[None, :], 1.0))
    b = other.min(dim=1).values
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), _TINY)
    s = torch.where(own <= 1.0, torch.zeros_like(s), s)
    total = s.sum().reshape(1)
    dist.all_reduce(total, group=mesh.get_group(axis))
    return float(total[0] / n)
