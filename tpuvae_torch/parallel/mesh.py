"""Device mesh construction and sharding rules over ``torch.distributed``
(counterpart of ``tpuvae/parallel/mesh.py``).

JAX runs one controller process that sees every device; PyTorch runs one
process per device.  So here:

* a **device** of the mesh is a **rank**, and each rank computes on
  ``cuda:(local rank % device_count)`` unless the caller asks for the CPU
  (two ranks on a one-card machine both take ``cuda:0``);
* the mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the
  JAX axis names, ``("data",)`` or ``("data", "model")``;
* a sharded array is a :class:`torch.distributed.tensor.DTensor`; its
  placements (``Shard(d)`` / ``Replicate()``) stand where JAX has
  ``PartitionSpec``s;
* the process group's backend is NCCL for CUDA tensors and gloo for CPU
  tensors.  A process group that already exists is used as it is (a
  caller that wants gloo for CUDA tensors starts one itself).  Without
  one, :func:`maybe_init_distributed` starts it when
  ``TPUVAE_DISTRIBUTED=1``; otherwise the process is a world of one rank,
  on an in-memory store: no network, no environment variables, no wait.

Every rank runs the same pipeline on the same inputs: host-side work runs
replicated and gives the same result on every rank; only rank 0 writes
files (:attr:`MeshContext.is_writer`), the others wait at
:meth:`MeshContext.barrier`.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpuvae_torch.device import resolve_device

# a collective that waits longer than this fails instead of hanging
TIMEOUT = timedelta(minutes=10)


def _backend() -> str:
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def maybe_init_distributed() -> bool:
    """Start the process group when ``TPUVAE_DISTRIBUTED=1``.

    With ``TPUVAE_COORDINATOR=host:port TPUVAE_NUM_PROCESSES=N
    TPUVAE_PROCESS_ID=i`` it initialises over ``tcp://host:port``;
    without them over ``env://``, the variables ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the
    counterpart of JAX's cluster auto-detection.  Idempotent: a group that
    already exists is left as it is.  Returns True when initialisation
    ran."""
    if os.environ.get("TPUVAE_DISTRIBUTED", "0") != "1":
        return False
    if dist.is_initialized():
        return False
    coord = os.environ.get("TPUVAE_COORDINATOR")
    if coord:
        dist.init_process_group(
            _backend(), init_method=f"tcp://{coord}",
            world_size=int(os.environ.get("TPUVAE_NUM_PROCESSES", "1")),
            rank=int(os.environ.get("TPUVAE_PROCESS_ID", "0")),
            timeout=TIMEOUT)
    else:
        dist.init_process_group(_backend(), init_method="env://",
                                timeout=TIMEOUT)
    return True


def _ensure_process_group() -> None:
    """The existing group, else :func:`maybe_init_distributed`'s, else a
    world of one rank on an in-memory store."""
    if dist.is_initialized() or maybe_init_distributed():
        return
    dist.init_process_group(_backend(), store=dist.HashStore(), rank=0,
                            world_size=1, timeout=TIMEOUT)


def local_rank() -> int:
    """``LOCAL_RANK`` (set by ``torchrun``), else the global rank."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:(local rank % device_count)``, made the
    current CUDA device, or the CPU when ``device`` names it.  Raises, as
    :func:`~tpuvae_torch.device.resolve_device`, for CUDA without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    idx = local_rank() % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def make_mesh(shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",),
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` ranks of the process group.

    ``shape`` may contain a single ``-1`` meaning "all remaining ranks".
    Every rank of the group calls this (the mesh's sub-groups are made
    collectively); a rank outside a smaller mesh gets no coordinate in it.
    """
    dev = rank_device(device)
    _ensure_process_group()
    n_ranks = dist.get_world_size()
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = n_ranks // known
    n = int(np.prod(shape))
    if n_ranks < n:
        raise ValueError(
            f"make_mesh: requested {n} devices (shape={tuple(shape)}), found "
            f"{n_ranks} (backend={dist.get_backend()!r}). A device of the "
            f"mesh is a rank: start {n} processes, e.g. TPUVAE_DISTRIBUTED=1 "
            f"torchrun --nproc-per-node={n} ...")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str = "data") -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: str = "data") -> list:
    """Placements that shard dim 0 on the data axis and replicate the rest
    (``ndim`` is the array's, kept for the JAX signature)."""
    del ndim
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def replicated_sharding(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` so its size divides ``multiple``.

    Returns (padded, original_size). Needed because sharded dims must divide
    the mesh axis size; callers slice back to ``original_size`` after gather.
    """
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, mode="constant"), n


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: the current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows(n_rows: int, mesh: DeviceMesh, axis: str) -> slice:
    """This rank's contiguous block of ``n_rows`` (a multiple of the axis
    size) rows."""
    per = n_rows // axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh: DeviceMesh, x, axis: str = "data"):
    """``(DTensor, n)``: host array ``x`` padded to a multiple of the data
    axis and placed ``Shard(0)`` on it, each rank holding its contiguous
    block of rows (every rank has the whole ``x``, so nothing is sent)."""
    x = np.asarray(x)
    padded, n = pad_to_multiple(x, axis_size(mesh, axis), axis=0)
    local = torch.from_numpy(np.ascontiguousarray(
        padded[_rows(len(padded), mesh, axis)])).to(mesh_device(mesh))
    return DTensor.from_local(local, mesh, batch_sharding(mesh, x.ndim, axis),
                              run_check=False, shape=torch.Size(padded.shape),
                              stride=torch.empty(padded.shape,
                                                 device="meta").stride()), n


def all_gather_latents(x, n: int) -> np.ndarray:
    """Fetch a batch-sharded array back to the host, dropping pad rows."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)[:n]


@dataclasses.dataclass
class MeshContext:
    """Carries the mesh, its data axis and this rank's device through the
    pipeline."""

    mesh: DeviceMesh
    axis: str = "data"
    device: torch.device | None = None     # default: the mesh's device

    def __post_init__(self):
        if self.device is None:
            self.device = mesh_device(self.mesh)

    @classmethod
    def create(cls, shape=(-1,), axis_names=("data",),
               device: str | torch.device = "cuda") -> "MeshContext":
        """A mesh over all ranks (:func:`make_mesh`), computing on
        ``device``'s type: the card by default, the CPU when asked."""
        maybe_init_distributed()
        mesh = make_mesh(shape, axis_names, device)
        return cls(mesh=mesh, axis=axis_names[0], device=rank_device(device))

    @property
    def n_devices(self) -> int:
        return self.mesh.size()

    @property
    def data_size(self) -> int:
        return axis_size(self.mesh, self.axis)

    @property
    def rank(self) -> int:
        """This rank's coordinate on the data axis."""
        return self.mesh.get_local_rank(self.axis)

    @property
    def is_writer(self) -> bool:
        """Rank 0 of the process group writes the files."""
        return dist.get_rank() == 0

    def barrier(self) -> None:
        """Wait for every rank of the group (a no-op in a world of one)."""
        if dist.get_world_size() > 1:
            dist.barrier()

    def shard(self, x):
        return shard_batch(self.mesh, x, self.axis)

    def replicate(self, tree):
        """Every tensor of ``tree`` (a tensor, or a dict / list / tuple of
        them) as a replicated DTensor of this rank's copy."""
        placements = replicated_sharding(self.mesh)

        def put(a):
            t = torch.as_tensor(a).to(self.device)
            return DTensor.from_local(t, self.mesh, placements,
                                      run_check=False)

        return torch.utils._pytree.tree_map(put, tree)

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The rows of every rank's equal-sized ``local`` block, in rank
        order along the data axis (one all-gather)."""
        d = self.data_size
        if d == 1:
            return local
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(d)]
        dist.all_gather(parts, local, group=self.mesh.get_group(self.axis))
        return torch.cat(parts)

    def apply_sharded(self, fn, *chunks):
        """``fn`` over one batch of host ``chunks`` split on the data axis:
        the batch is zero-padded to a multiple of the axis size, each rank
        runs ``fn`` on its contiguous block, and one all-gather returns
        the batch's rows in order (the pad rows dropped)."""
        if self.data_size == 1:
            return fn(*chunks)
        m = chunks[0].shape[0]
        blocks = []
        for c in chunks:
            padded, _ = pad_to_multiple(np.asarray(c), self.data_size)
            blocks.append(padded[_rows(len(padded), self.mesh, self.axis)])
        return self.gather_rows(fn(*blocks))[:m]
