"""CUDA graphs of the port's compiled loops (counterpart of the JAX
package's ``jax.jit`` over ``lax.scan`` / ``lax.fori_loop``).

The JAX package runs each of its loops as one compiled program: the
resident epoch and the data-parallel epoch (``tpuvae/train/loop.py``,
``tpuvae/parallel/dp.py``), the host_stream step (``jax.jit(train_step)``)
and t-SNE's optimisation and perplexity search (``tpuvae/viz/tsne.py``).
The port writes each as a function of device tensors that reads nothing on
the host, and on a card runs it as a CUDA graph through
:class:`CapturedGraph`: one capture, then one replay per call, launching
the same kernels in the same order as the eager function.  On the CPU
:func:`runner` returns the function itself: the plain version of the graph.
"""

from __future__ import annotations

import ctypes
import functools
import os
import traceback

import torch

from tpuvae_torch.ops import _build, fusedconv
from tpuvae_torch.utils.logging import span


def _failed_at(exc: BaseException) -> str:
    """``file:line (source)`` of the innermost frame of ``exc``'s traceback
    outside torch: the operation that failed."""
    torch_dir = os.path.dirname(torch.__file__)
    frames = traceback.extract_tb(exc.__traceback__)
    for f in reversed(frames):
        if not f.filename.startswith(torch_dir):
            return f"{f.filename}:{f.lineno} ({f.line})"
    return "an unknown operation"


class CapturedGraph:
    """``fn`` (a function of device tensors that takes no argument and reads
    nothing on the host) as one CUDA graph.

    The first call runs ``fn`` eagerly on the graph's own stream: it is real
    work (an epoch, a step, a chunk of steps), and it sets up what a capture
    cannot (cuBLAS and cuDNN handles and algorithm choice, the kernels'
    libraries, Adam's state, NCCL's communicator, kernel 6's ticket buffer
    for the stream, reserved for ``reserve_batch`` images where the caller
    trains).  With ``warmup`` the first call runs ``warmup`` eagerly instead
    (work whose result the caller discards, for a loop that runs once) and
    then captures and replays ``fn``.  The second call captures ``fn`` (a
    capture runs nothing) and replays it; every call from then on is one
    replay on that stream, which the caller's stream waits for, and returns
    the tensors the capture returned, which the next replay overwrites.
    ``generator`` is registered with the graph, so each replay draws new
    numbers from where the generator stands (also after ``manual_seed``)
    and leaves it where the eager run would have.  Kernel launches recorded
    at the capture count once per replay (``ops._build.capture_tally``).  A
    capture that fails raises with the failing operation named; nothing
    runs ``fn`` eagerly in its place.  The graph allocates from a memory
    pool of its own, which :meth:`close` hands back to the card with the
    graph.

    Each step is a span (:func:`tpuvae_torch.utils.logging.span`, ``what``
    its attribute): ``graph.warm`` the first call's eager ``fn`` or
    ``warmup``, ``graph.drain`` the wait for the card before the capture,
    ``graph.capture`` the capture and the graph's instantiation (with
    ``kernels``, the kernel nodes of the captured graph,
    :func:`kernel_nodes`), and ``graph.replay`` one replay's launch with
    the two streams' waits.
    """

    def __init__(self, fn, device: torch.device, *,
                 generator: torch.Generator | None = None,
                 reserve_batch: int | None = None, warmup=None,
                 what: str = "the epoch"):
        self.fn = fn
        self.device = torch.device(device)
        self.generator = generator
        self.reserve_batch = reserve_batch
        self.warmup = warmup
        self.what = what
        self.stream = capture_stream(self.device)
        self.warm = False
        self.graph = None
        self.pool = None
        self.out = None
        self.tally: dict = {}

    def __call__(self):
        if not self.warm:
            self.warm = True
            with span("graph.warm", self.what):
                out = self._on_stream(self._eager)
            if self.warmup is None:
                return out
        if self.graph is None:
            self._capture()
        with span("graph.replay", self.what):
            self._on_stream(self.graph.replay)
        _build.count_replay(self.tally)
        return self.out

    def _on_stream(self, fn):
        """``fn()`` on the graph's stream after the caller's work, and the
        caller's stream after it."""
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = fn()
        caller.wait_stream(self.stream)
        return out

    def _eager(self):
        if self.reserve_batch is not None:
            fusedconv.reserve_tickets(self.device, self.reserve_batch)
        return (self.fn if self.warmup is None else self.warmup)()

    def close(self) -> None:
        """Drop the graph and the tensors it returned, then its memory pool:
        the pool's cached blocks go back to the card (tensors of the pool
        that the caller still holds keep theirs)."""
        self.graph = self.out = None
        self.pool = None

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        pool = torch.cuda.MemPool()
        with span("graph.drain", self.what):
            torch.cuda.synchronize(self.device)
        with span("graph.capture", self.what) as attrs, \
                torch.cuda.stream(self.stream), \
                _build.capture_tally() as tally:
            graph.capture_begin(pool=pool.id)
            try:
                out = self.fn()
            except Exception as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass            # the capture was invalidated by exc
                raise RuntimeError(
                    f"capturing {self.what} as a CUDA graph failed at "
                    f"{_failed_at(exc)}: {exc}") from exc
            graph.capture_end()
            graph.instantiate()
        if attrs is not None:
            attrs["kernels"] = kernel_nodes(graph)
        self.graph, self.pool, self.out = graph, pool, out
        self.tally = dict(tally)


# CUgraphNodeType (cuda.h): CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY
KERNEL_NODE, MEMCPY_NODE = 0, 1


@functools.cache
def _driver() -> ctypes.CDLL:
    """The CUDA driver library every CUDA process has loaded."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p
    cu.cuGraphGetNodes.argtypes = [ptr, ctypes.POINTER(ptr),
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphGetNodes.restype = cu.cuGraphNodeGetType.restype = ctypes.c_int
    return cu


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The kernel nodes of ``graph``'s captured CUDA graph (kept with
    ``keep_graph=True``): the kernels one replay launches."""
    return node_counts(graph).get(KERNEL_NODE, 0)


def node_counts(graph: torch.cuda.CUDAGraph) -> dict[int, int]:
    """The nodes of ``graph``'s captured CUDA graph by ``CUgraphNodeType``."""
    return _count_nodes(_driver(), ctypes.c_void_p(graph.raw_cuda_graph()))


def _count_nodes(cu, raw: ctypes.c_void_p) -> dict[int, int]:
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int()
    counts: dict[int, int] = {}
    for node in nodes[:n.value]:
        status = cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind))
        _check(status, "cuGraphNodeGetType")
        counts[kind.value] = counts.get(kind.value, 0) + 1
    return counts


def _check(status: int, call: str) -> None:
    if status != 0:
        raise RuntimeError(f"{call} returned CUresult {status}")


# one stream per device for every capture: cuBLAS keeps a workspace for
# each stream it has run on, for the life of the process
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.device(device).index or 0
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def runner(fn, device: torch.device, **kw):
    """``fn`` as a :class:`CapturedGraph` on a card (``kw`` its options), as
    it is on the CPU."""
    if torch.device(device).type == "cuda":
        return CapturedGraph(fn, device, **kw)
    return fn


def close(run) -> None:
    """Close ``run`` if it is a graph (:func:`runner`'s result)."""
    if isinstance(run, CapturedGraph):
        run.close()
