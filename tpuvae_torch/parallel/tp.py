"""Tensor parallelism for the wide VAE layers over a 2-D ``("data",
"model")`` mesh (counterpart of ``tpuvae/parallel/tp.py``).

The rule is the JAX package's shape rule, applied to every parameter of
the model and so, through Adam's moments (made like their parameters),
to the whole train state:

* 2-D leaves with a dimension >= ``big``: shard one dimension on
  ``model``: the input dimension of a tall kernel (in >= out, a
  partial-sum product), the output dimension of a wide one;
* 1-D leaves >= ``big`` (the wide kernels' biases): shard on ``model``;
* everything else (conv kernels, BatchNorm scales): replicated.

torch's ``nn.Linear`` weight is ``(out, in)``, flax's ``kernel`` its
``(in, out)`` transpose, so the rule is written on the LOGICAL dimension:
the same one JAX shards on the flax leaf.  A literal rule on torch's shape
would agree on every non-square matrix and differ on a square one, where
flax shards the input dimension.

:func:`make_tp_dp_train_step` places the wide ``Dense`` layers with
PyTorch's tensor-parallel styles on the ``model`` axis: an input-sharded
kernel with ``RowwiseParallel`` (partial products, summed over ``model``),
an output-sharded one with ``ColwiseParallel`` (its outputs gathered).
Their weights and biases become DTensors, everything else stays a plain
tensor replicated on every rank, and the batch is split on ``data``.
Where the rule shards a row-wise layer's bias, ``RowwiseParallel`` keeps it
replicated and adds it once after the sum: the same function, placed
otherwise.  Tensor-parallel training runs in float32 only.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.parallel import (
    ColwiseParallel,
    RowwiseParallel,
    parallelize_module,
)

from tpuvae_torch.parallel.dp import make_dp_train_step
from tpuvae_torch.parallel.mesh import axis_size

if TYPE_CHECKING:
    from tpuvae_torch.train.state import TrainState

BIG_DIM = 8192   # only the 16384-wide Hybrid layers qualify at defaults


def tp_spec_for(x, axis: str = "model", big: int = BIG_DIM) -> tuple:
    """The spec of one parameter under the shape rule: a tuple with the
    axis name at the sharded dimension and None elsewhere, ``()`` for a
    replicated one (JAX's ``PartitionSpec`` entries).  A 2-D parameter is
    an ``nn.Linear`` weight, ``(out, in)``: the port has no other."""
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) == 2 and max(shape) >= big:
        out_dim, in_dim = shape
        # flax's kernel is (in, out): it shards dim 0 where in >= out
        return (None, axis) if in_dim >= out_dim else (axis, None)
    if len(shape) == 1 and shape[0] >= big:
        return (axis,)
    return ()


def _placements(mesh: DeviceMesh, spec: tuple, axis: str) -> list:
    dim = spec.index(axis) if axis in spec else None
    return [Shard(dim) if (name == axis and dim is not None) else Replicate()
            for name in mesh.mesh_dim_names]


def tp_state_sharding(state: TrainState, mesh: DeviceMesh,
                      axis: str = "model", big: int = BIG_DIM) -> dict:
    """``{parameter name: placements on mesh}`` for the whole train state
    under the rule (Adam's moments take their parameter's).  The ``model``
    axis must divide every sharded dimension: any power of two <= 1024
    does for the Hybrid VAE."""
    n_model = axis_size(mesh, axis)
    out = {}
    for name, p in state.model.named_parameters():
        spec = tp_spec_for(p, axis, big)
        for dim, entry in zip(p.shape, spec):
            if entry == axis and dim % n_model:
                raise ValueError(
                    f"tensor-parallel axis {axis!r} of size {n_model} does "
                    f"not divide sharded dimension {dim}")
        out[name] = _placements(mesh, spec, axis)
    return out


def _tp_plan(model: nn.Module, mesh: DeviceMesh, axis: str,
             big: int) -> dict:
    """The parallel style of every ``nn.Linear`` the rule shards."""
    plan = {}
    for name, m in model.named_modules():
        if not isinstance(m, nn.Linear):
            continue
        spec = tp_spec_for(m.weight, axis, big)
        if spec == (None, axis):
            plan[name] = RowwiseParallel(input_layouts=Replicate())
        elif spec == (axis, None):
            plan[name] = ColwiseParallel(output_layouts=Replicate())
    return plan


def make_tp_dp_train_step(loss_fn, mesh: DeviceMesh, data_axis: str = "data",
                          model_axis: str = "model", big: int = BIG_DIM,
                          loss_reduction: str = "mean"):
    """Build ``step(state, batch, seed) -> (state, loss)`` over a 2-D mesh:
    the batch split on ``data``, the wide ``Dense`` weights sharded on
    ``model``.

    The step's math is :func:`tpuvae_torch.parallel.dp.make_dp_train_step`'s:
    the model's wide layers are placed on the ``model`` axis at the first
    call (``tp_state_sharding``'s rule; the optimizer is built anew on the
    placed parameters, so its moments follow them), each data rank
    computes its block's gradients and one all-reduce over ``data`` makes
    them the global batch's.  The ranks of one ``model`` group see the
    same rows and draw the same noise (:func:`rank_seed` of the data
    rank).  A bfloat16 model raises ``ValueError``: tensor-parallel
    training runs in float32 only."""
    dp_step = make_dp_train_step(loss_fn, mesh, data_axis, loss_reduction)
    placed = set()

    def place(state: TrainState) -> None:
        model = state.model
        if any(getattr(m, "dtype", torch.float32) != torch.float32
               for m in model.modules()):
            raise ValueError("tensor-parallel training runs in float32 only")
        tp_state_sharding(state, mesh, model_axis, big)   # raises if indivisible
        parallelize_module(model, mesh[model_axis],
                           _tp_plan(model, mesh, model_axis, big))
        opt = state.optimizer
        state.optimizer = type(opt)(model.parameters(), **opt.defaults)
        placed.add(id(model))

    def step(state: TrainState, batch, seed: int):
        if id(state.model) not in placed:
            place(state)
        return dp_step(state, batch, seed)

    return step
