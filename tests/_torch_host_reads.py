"""``no_host_reads()``: a ``TorchDispatchMode`` that fails on every
operation a CUDA graph cannot capture because it needs the host (imported
by ``tests/test_torch_graphs.py`` and its rank workers in
``tests/_torch_ranks.py``; pytest does not collect it).

It raises on a read of a tensor's value on the host
(``aten._local_scalar_dense``: ``.item()``, ``float()``, ``bool()``;
``aten.equal``), on an operation whose output shape depends on the data
(``nonzero``, ``masked_select``, ``unique``, indexing with a boolean mask)
and on a copy between two devices.  On the CPU the tests run the loop
bodies under it; on a card the same bodies are captured.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

HOST_READS = {aten._local_scalar_dense, aten.equal}
DATA_DEPENDENT = {aten.nonzero, aten.masked_select, aten._unique,
                  aten._unique2, aten.unique_dim, aten.unique_consecutive}


class HostRead(AssertionError):
    pass


def _devices(func, args, kwargs) -> set:
    devices = {t.device for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
    if func.overloadpacket is aten._to_copy and kwargs.get("device"):
        devices.add(torch.device(kwargs["device"]))
    return devices


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in HOST_READS:
            raise HostRead(f"{func} reads a tensor on the host")
        if packet in DATA_DEPENDENT or (
                packet in (aten.index, aten.index_put, aten.index_put_)
                and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in tree_leaves(args[1]))):
            raise HostRead(f"{func}: its output's shape depends on the data")
        if packet in (aten._to_copy, aten.copy_) \
                and len(_devices(func, args, kwargs)) > 1:
            raise HostRead(f"{func} copies between devices")
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_host_reads():
    with _NoHostReads():
        yield
