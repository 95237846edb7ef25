"""Data-parallel training over ``torch.distributed`` (counterpart of
``tpuvae/parallel/dp.py``).

Two granularities, as in the JAX package:

* :func:`make_dp_train_step` — one step with the parameters replicated on
  every rank and the batch split on dim 0 across the ``data`` axis: each
  rank computes its block's gradients and one all-reduce makes them the
  global batch's.
* :func:`make_dp_epoch` — a whole epoch on each rank's LOCAL block of the
  dataset (``n_local`` rows, shuffled by the rank's own generator) in
  micro-batches of ``batch_size / D`` rows; only the gradients and the
  BatchNorm running statistics cross ranks, so per-rank compute and memory
  scale 1/D.

The gradient reduction follows the objective's batch reduction: ``'sum'``
objectives (CVAE / Hybrid, ``Conditional_VAE.py:235``,
``Convolutional_VAE.py:188``) sum the ranks' gradients — the global batch
loss is the sum of the local sums — and ``'mean'`` objectives (Simple VAE /
AE, ``Simple_VAE.py:110``) average them.  ``ReduceOp.AVG`` is NCCL's only,
so an average is a sum divided by D; every rank receives the same sum and
divides it the same way, so the replicas stay bit-equal.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from tpuvae_torch.parallel.mesh import axis_size

if TYPE_CHECKING:
    from tpuvae_torch.train.state import TrainState

LOSS_REDUCTIONS = ("mean", "sum")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator for an epoch (or step) seeded
    with ``seed``: ``seed * 65537 + rank``, modulo 2^63."""
    return (int(seed) * 65537 + int(rank)) % (1 << 63)


def _check_reduction(loss_reduction: str) -> None:
    if loss_reduction not in LOSS_REDUCTIONS:
        raise ValueError(f"loss_reduction must be 'mean'|'sum': "
                         f"{loss_reduction}")


def _local(x):
    """This rank's block of a ``Shard(0)`` DTensor; a tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _all_reduce_flat(tensors, group, divide: int = 1) -> None:
    """Sum ``tensors`` (one dtype) over ``group`` in one all-reduce, in
    place, divided by ``divide``."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if divide > 1:
        flat /= divide
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def reduce_gradients(model: nn.Module, group, n_dev: int,
                     loss_reduction: str) -> None:
    """The global batch's gradients from every rank's: summed for a
    ``'sum'`` objective, averaged for a ``'mean'`` one.  A DTensor
    parameter's gradient is reduced on its local shard."""
    grads = [_local(p.grad) for p in model.parameters() if p.grad is not None]
    _all_reduce_flat(grads, group, n_dev if loss_reduction == "mean" else 1)


def sync_batch_norm(model: nn.Module, group, n_dev: int) -> None:
    """Average every BatchNorm's running mean and variance over the ranks
    (SyncBN-style state): each rank moved them with its local batch's
    statistics, so the average is the old value moved by the mean of the
    local statistics, and every rank holds the same bits after it."""
    bufs = [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var)]
    _all_reduce_flat(bufs, group, n_dev)


def _step(model, optimizer, loss_fn, batch, generator, group, n_dev,
          loss_reduction):
    optimizer.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch, generator, True)
    loss.backward()
    reduce_gradients(model, group, n_dev, loss_reduction)
    optimizer.step()
    sync_batch_norm(model, group, n_dev)
    return loss.detach()


def make_dp_train_step(loss_fn, mesh: DeviceMesh, axis: str = "data",
                       loss_reduction: str = "mean"):
    """Build ``step(state, batch, seed) -> (state, loss)``: the parameters
    replicated (every rank holds the same model), each batch array split
    on dim 0 into the ranks' contiguous blocks, the gradients and the loss
    those of the global batch (``loss_reduction`` names the objective's
    batch reduction, as :func:`make_dp_epoch`'s).  The batch's rows must
    divide over the axis.  BatchNorm normalises over the rank's rows and
    its running statistics are averaged after the step, as
    :func:`make_dp_epoch`'s; the noise comes from a generator seeded with
    :func:`rank_seed` ``(seed, rank)``."""
    _check_reduction(loss_reduction)
    n_dev = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)

    def step(state: TrainState, batch, seed: int):
        n = batch[0].shape[0]
        if n % n_dev:
            raise ValueError(f"batch of {n} rows must divide over the "
                             f"{n_dev}-device '{axis}' mesh axis")
        per = n // n_dev
        local = tuple(b[rank * per:(rank + 1) * per] for b in batch)
        state.model.train()
        gen = torch.Generator(device=local[0].device).manual_seed(
            rank_seed(seed, rank))
        loss = _step(state.model, state.optimizer, loss_fn, local, gen,
                     group, n_dev, loss_reduction)
        dist.all_reduce(loss, group=group)
        if loss_reduction == "mean":
            loss /= n_dev
        return state, loss

    return step


def make_dp_epoch(
    loss_fn,
    mesh: DeviceMesh,
    *,
    batch_size: int,
    n_local: int,
    n_train_arrays: int,
    n_val_arrays: int = 0,
    n_val_local: int = 0,
    loss_reduction: str = "mean",
    axis: str = "data",
):
    """Build ``epoch(state, seed, *data) -> (state, loss_sum, val_total)``.

    ``data`` are ``n_train_arrays`` training then ``n_val_arrays``
    validation arrays, each this rank's contiguous block of the dataset: a
    ``Shard(0)`` DTensor on ``axis`` (its local block) or the block itself,
    ``n_local`` (train) / ``n_val_local`` (val) rows on every rank.

    Each rank shuffles its block with its own ``torch.Generator`` on the
    data's device, seeded with :func:`rank_seed` ``(seed, rank)``; the same
    generator then draws the dropout masks and the noise of the epoch.  It
    trains on local micro-batches of ``batch_size / D`` rows, then one
    remainder step; a global batch therefore mixes one micro-batch from
    every rank.  After each backward the gradients are all-reduced (summed
    for ``'sum'``, averaged for ``'mean'``) before ``optimizer.step()``;
    BatchNorm normalises over the local micro-batch and its running
    statistics are averaged after every step, so every rank holds the same
    state.  Validation runs the same way on the validation blocks.  The
    train and validation totals are reduced once, at the end of the epoch:
    they are GLOBAL per-epoch sums of per-batch losses, as the
    single-device ``fit`` epoch's.
    """
    _check_reduction(loss_reduction)
    n_dev = axis_size(mesh, axis)
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size {batch_size} must divide over the {n_dev}-device "
            f"'{axis}' mesh axis"
        )
    local_bs = batch_size // n_dev
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)

    def batches(data):
        for i in range(0, data[0].shape[0], local_bs):
            yield tuple(d[i:i + local_bs] for d in data)

    def epoch(state: TrainState, seed: int, *data):
        model, optimizer = state.model, state.optimizer
        data = tuple(_local(d) for d in data)
        tdata = data[:n_train_arrays]
        vdata = data[n_train_arrays:n_train_arrays + n_val_arrays]
        for d, want in [(d, n_local) for d in tdata] + [
                (d, n_val_local) for d in vdata]:
            if d.shape[0] != want:
                raise ValueError(f"a rank's block has {d.shape[0]} rows, "
                                 f"{want} expected")
        dev = tdata[0].device
        gen = torch.Generator(device=dev).manual_seed(rank_seed(seed, rank))
        perm = torch.randperm(n_local, generator=gen, device=dev)
        model.train()
        totals = torch.zeros(2, device=dev)
        for batch in batches(tuple(d[perm] for d in tdata)):
            totals[0] += _step(model, optimizer, loss_fn, batch, gen, group,
                               n_dev, loss_reduction)
        if vdata:
            model.eval()
            with torch.no_grad():
                for batch in batches(vdata):
                    totals[1] += loss_fn(model, batch, gen, False)[0]
        # the reductions are linear: one at the end of the epoch equals
        # reducing every per-batch loss
        dist.all_reduce(totals, group=group)
        if loss_reduction == "mean":
            totals /= n_dev
        return state, totals[0], totals[1]

    return epoch
