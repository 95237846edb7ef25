"""Training-mode BatchNorm2d + LeakyReLU(0.01) of the conv trunks, as four
hand-written kernels (``csrc/bn_leaky.cu``) and their plain versions.

The trunks' layers 1-5 of the encoder and 0-4 of the decoder normalise a
convolution's output with the batch's statistics in flax's op order
(``models.layers._flax_batch_norm``: the fast variance
``max(mean(x^2) - mean(x)^2, 0)``, ``(x - mean) * (rsqrt(var + eps) * gamma)
+ beta``) and apply ``F.leaky_relu(·, 0.01)``.  Op by op that is ~35
strided ATen passes a layer, forward and backward; here it is

* :func:`bn_leaky` — statistics computed in the op: kernel A (one read of
  ``x``: the sums, ``mean``, ``var``, the running statistics moved) and
  kernel B (``y`` from a second read);
* :func:`bn_leaky_given` — statistics passed in (encoder layer 1, whose
  ``(mean, var)`` kernel 6 gathered): kernel B alone, the running
  statistics moved by :func:`move_running_stats` (as for layer 0); the
  backward also returns ``d mean`` and ``d var``;

and backward, for both, kernel C (reads ``g`` and ``x``, recomputes the
LeakyReLU mask from ``x``: the per-channel sums, ``d gamma``, ``d beta``)
and kernel D (``dx``).  The gradient is the exact gradient of the forward,
clamp included: no variance gradient where ``mean(x^2) - mean^2 < 0``
(:func:`bn_leaky_backward_plain` writes C and D out in PyTorch).

The kernels take any strides and write the output (and ``dx``) in the
input's memory format: channels-last when the channel axis is contiguous
(the trunks' activations and the decoder's cut view), NCHW otherwise.  They
replace no Pallas kernel (the JAX package leaves these passes to XLA); each
is bound by bytes (``plan`` fills the card at every trunk layer).  A CUDA
tensor goes through the kernels or the call raises; a CPU tensor through
the plain versions (``*_plain``).  The trunks call the kernels only where
:func:`takes_kernels` says so: a CUDA float32 tensor, a float32 BatchNorm
in training mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tpuvae_torch.ops import _build
from tpuvae_torch.ops.fusedconv import LEAKY_SLOPE

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float
STATS = _build.Kernel(
    "bn_leaky_stats", "bn_leaky", "tpuvae_bn_leaky_stats",
    [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _F32, _F32,
     _PTR])
NORM = _build.Kernel(
    "bn_leaky_norm", "bn_leaky", "tpuvae_bn_leaky_norm",
    [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _F32, _PTR])
GRAD_SUMS = _build.Kernel(
    "bn_leaky_grad_sums", "bn_leaky", "tpuvae_bn_leaky_grad_sums",
    [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _F32,
     _INT, _PTR, _PTR, _PTR, _PTR])
GRAD_INPUT = _build.Kernel(
    "bn_leaky_grad_input", "bn_leaky", "tpuvae_bn_leaky_grad_input",
    [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
     _F32, _PTR, _PTR])

THREADS = 256          # a CTA of csrc/bn_leaky.cu
CTAS_PER_SM = 4        # csrc/bn_leaky.cu kCtasPerSm: all resident at once
_DIMS = (0, 2, 3)      # the statistics run over N, H, W


# -- the plain versions (flax's op order) -----------------------------------------

def batch_stats_plain(x: torch.Tensor, dims=_DIMS):
    """flax's batch statistics of ``x`` over ``dims``: the mean and the fast
    variance ``max(mean(x^2) - mean(x)^2, 0)``."""
    mean = x.mean(dim=dims)
    var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
    return mean, var


def normalize_plain(x: torch.Tensor, mean, var, weight, bias,
                    eps: float) -> torch.Tensor:
    """``(x - mean) * (rsqrt(var + eps) * weight) + bias`` over dim 1, in
    flax's order."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean.view(shape))
            * (torch.rsqrt(var + eps) * weight).view(shape)
            + bias.view(shape))


def move_running_stats(bn, mean: torch.Tensor, var: torch.Tensor) -> None:
    """flax's running statistics: ``0.99 * old + 0.01 * batch`` (torch's
    ``momentum`` 0.01) with the biased variance."""
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)


def bn_leaky_plain(x: torch.Tensor, bn) -> torch.Tensor:
    """Plain version of :func:`bn_leaky`."""
    mean, var = batch_stats_plain(x)
    move_running_stats(bn, mean, var)
    return F.leaky_relu(normalize_plain(x, mean, var, bn.weight, bn.bias,
                                        bn.eps), LEAKY_SLOPE)


def bn_leaky_given_plain(x: torch.Tensor, mean, var, bn) -> torch.Tensor:
    """Plain version of :func:`bn_leaky_given`."""
    move_running_stats(bn, mean, var)
    return F.leaky_relu(normalize_plain(x, mean, var, bn.weight, bn.bias,
                                        bn.eps), LEAKY_SLOPE)


def bn_leaky_backward_plain(g, x, mean, var, weight, bias, eps: float,
                            given: bool):
    """The backward that kernels C and D compute, in closed form:
    ``(dx, d weight, d bias, d mean, d var)``.  ``d mean`` and ``d var`` are
    the derivatives through the normalisation alone (what
    :func:`bn_leaky_given` returns); with the batch's statistics
    (``given=False``) they reach ``dx`` through ``mean = sum(x) / n`` and
    ``raw = sum(x^2) / n - mean^2``, and ``d var`` only where the clamp
    ``var = max(raw, 0)`` lets it (``raw >= 0``, as ``clamp_min``'s
    gradient):

        g'  = g * (pre > 0 ? 1 : 0.01),  pre = (x - mean) * scale + bias
        S0  = sum(g'),  S1 = sum(g' (x - mean)),  scale = rsqrt(var+eps) w
        d bias = S0,  d weight = S1 rsqrt(var + eps)
        d mean = -scale S0,  d var = -S1 scale rsqrt(var + eps)^2 / 2
        dx  = scale g' + (2 d var / n) (x - mean) + d mean / n
    """
    shape = (1, -1, 1, 1)
    rstd = 1.0 / torch.sqrt(var + eps)
    scale = rstd * weight
    xm = x - mean.view(shape)
    pre = xm * scale.view(shape) + bias.view(shape)
    gp = torch.where(pre > 0, g, g * LEAKY_SLOPE)
    s0 = gp.sum(dim=_DIMS)
    s1 = (gp * xm).sum(dim=_DIMS)
    d_mean = -(scale * s0)
    d_var = -0.5 * s1 * (scale * (rstd * rstd))
    dx = scale.view(shape) * gp
    if not given:
        n = x.numel() // x.shape[1]
        raw = (x * x).mean(dim=_DIMS) - mean * mean
        gv = torch.where(raw >= 0, d_var, torch.zeros_like(d_var))
        dx = dx + (2.0 * gv / n).view(shape) * xm + (d_mean / n).view(shape)
    return dx, s1 * rstd, s0, d_mean, d_var


# -- which path ---------------------------------------------------------------

def takes_kernels(x: torch.Tensor, bn) -> bool:
    """Whether a trunk layer normalises ``x`` through the kernels: a CUDA
    float32 tensor and a float32 BatchNorm in training mode.  The CPU, a
    bfloat16 trunk and eval mode run ``models.layers``' op-by-op code."""
    return (bool(bn.training) and x.device.type == "cuda"
            and x.dtype == torch.float32 and bn.dtype == torch.float32)


# -- the launch plan ------------------------------------------------------------

def _dense_strides(t: torch.Tensor) -> list[int]:
    """``t``'s strides, 0 along a dimension of size 1 (any stride there
    addresses the same element)."""
    return [s if n > 1 else 0 for n, s in zip(t.shape, t.stride())]


def vector_width(*tensors: torch.Tensor) -> int:
    """4 (16-byte loads and stores) where every tensor's channel axis is
    contiguous, its pixel strides are multiples of 4 and its data starts on
    a 16-byte boundary; else 1."""
    c = tensors[0].shape[1]
    for t in tensors:
        sn, sc, sh, sw = _dense_strides(t)
        if c % 4 or sc != 1 or sn % 4 or sh % 4 or sw % 4 or t.data_ptr() % 16:
            return 1
    return 4


def plan(shape, vec: int, sms: int) -> tuple[int, int, int, int, int]:
    """``(vec, lanes, groups, ctas, chunk)`` of a launch over ``shape``
    ``(N, C, H, W)``: a CTA is ``lanes`` channel vectors of ``vec`` by
    ``THREADS / lanes`` pixel rows; ``groups`` CTAs across the channels
    (``gridDim.x``) and ``ctas`` along the pixels (``gridDim.y``), each
    over ``chunk`` contiguous pixels.  About ``CTAS_PER_SM`` CTAs an SM
    where the pixels allow, at least one pixel a thread."""
    n, c, h, w = shape
    pixels = n * h * w
    nvec = -(-c // vec)
    lanes = min(32, 1 << max(nvec - 1, 0).bit_length())
    rows = THREADS // lanes
    groups = -(-nvec // lanes)
    want = max(1, -(-CTAS_PER_SM * sms // groups))
    ctas = max(1, min(want, -(-pixels // rows), 65535))
    chunk = -(-pixels // ctas)
    return vec, lanes, groups, -(-pixels // chunk), chunk


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _layout_out(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``x``'s shape in its memory format: channels-last
    where ``x``'s channel axis is contiguous, NCHW otherwise."""
    cl = x.shape[1] == 1 or x.stride(1) == 1
    fmt = torch.channels_last if cl else torch.contiguous_format
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=fmt)


def _i64(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


class _Launch:
    """What every launch over one tensor shape needs: its dims, plan, the
    host arrays the C interface reads, the stream and its ticket buffer."""

    def __init__(self, x: torch.Tensor, *others: torch.Tensor):
        if x.dim() != 4:
            raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
        if x.numel() == 0:
            raise ValueError(f"empty batch {tuple(x.shape)}: no statistics")
        if x.numel() // x.shape[1] > 2 ** 31 - 1:
            raise ValueError(f"{tuple(x.shape)}: more than 2^31 - 1 pixels")
        for t in (x, *others):
            if t.dtype != torch.float32:
                raise ValueError(f"the kernels take float32, got {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"tensors on {x.device} and {t.device}")
            if t.shape != x.shape:
                raise ValueError(f"shapes {tuple(x.shape)}, {tuple(t.shape)}")
        dev = x.device
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        self.vec = vector_width(x, *others)
        self.plan = plan(tuple(x.shape), self.vec, _sm_count(index))
        self.dims = _i64(x.shape)
        self.plan_arg = (ctypes.c_int * 5)(*self.plan)
        self.stream = _build.stream_ptr(dev)
        self.tickets = _build.ptr(_build.reserve_tickets(dev, self.plan[2]))

    def part(self, x: torch.Tensor) -> torch.Tensor:
        """Scratch for the partial rows: (2, ctas, C)."""
        return torch.empty((2, self.plan[3], x.shape[1]), dtype=torch.float32,
                           device=x.device)


def _channel_vec(t: torch.Tensor, c: int, name: str) -> torch.Tensor:
    if t.shape != (c,) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 of shape ({c},), got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _running(bn, c: int):
    """``bn``'s running statistics as kernel A's arguments; A moves them in
    place."""
    for name in ("running_mean", "running_var"):
        t = getattr(bn, name)
        if _channel_vec(t, c, name).data_ptr() != t.data_ptr():
            raise ValueError(f"{name} must be contiguous")
    nbt = bn.num_batches_tracked
    return (_build.ptr(bn.running_mean), _build.ptr(bn.running_var),
            _PTR(None) if nbt is None else _build.ptr(nbt),
            _F32(1.0 - bn.momentum), _F32(bn.momentum))


def _stats(x: torch.Tensor, bn, launch: _Launch) -> torch.Tensor:
    """Kernel A: ``(3, C)`` mean, var, raw; moves ``bn``'s running
    statistics."""
    c = x.shape[1]
    stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
    part = launch.part(x)
    STATS(_build.ptr(x), _i64(_dense_strides(x)), launch.dims,
          launch.plan_arg, _build.ptr(part), launch.tickets,
          _build.ptr(stats), *_running(bn, c), launch.stream)
    return stats


def _norm(x, mean, var, weight, bias, eps, launch: _Launch):
    """Kernel B: ``y``."""
    y = _layout_out(x)
    NORM(_build.ptr(x), _i64(_dense_strides(x)), _build.ptr(y),
         _i64(_dense_strides(y)), launch.dims, launch.plan_arg,
         _build.ptr(mean), _build.ptr(var), _build.ptr(weight),
         _build.ptr(bias), _F32(eps), launch.stream)
    return y


def _backward(g, x, mean, var, raw, weight, bias, eps: float):
    """Kernels C and D: ``(dx, back)``, ``back`` (6, C) = d weight, d bias,
    D's two coefficients, d mean, d var; ``raw`` None for given
    statistics."""
    c = x.shape[1]
    launch = _Launch(x, g)
    back = torch.empty((6, c), dtype=torch.float32, device=x.device)
    part = launch.part(x)
    sg, sx = _i64(_dense_strides(g)), _i64(_dense_strides(x))
    given = raw is None
    GRAD_SUMS(_build.ptr(g), sg, _build.ptr(x), sx, launch.dims,
              launch.plan_arg, _build.ptr(mean), _build.ptr(var),
              _PTR(None) if given else _build.ptr(raw), _build.ptr(weight),
              _build.ptr(bias), _F32(eps), int(given), _build.ptr(part),
              launch.tickets, _build.ptr(back), launch.stream)
    dx = _layout_out(x)
    GRAD_INPUT(_build.ptr(g), sg, _build.ptr(x), sx, _build.ptr(dx),
               _i64(_dense_strides(dx)), launch.dims, launch.plan_arg,
               _build.ptr(mean), _build.ptr(var), _build.ptr(weight),
               _build.ptr(bias), _F32(eps), _build.ptr(back), launch.stream)
    return dx, back


def _params(bn, c: int):
    return (_channel_vec(bn.weight.detach(), c, "weight"),
            _channel_vec(bn.bias.detach(), c, "bias"))


class _BnLeaky(torch.autograd.Function):
    """``leaky(bn(x))`` with the batch's statistics: kernels A and B
    forward, C and D backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        c = x.shape[1]
        w, b = _params(bn, c)
        launch = _Launch(x)
        stats = _stats(x, bn, launch)
        y = _norm(x, stats[0], stats[1], w, b, bn.eps, launch)
        ctx.eps = bn.eps
        ctx.save_for_backward(x, w, b, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b, stats = ctx.saved_tensors
        dx, back = _backward(g, x, stats[0], stats[1], stats[2], w, b, ctx.eps)
        return dx, back[0], back[1], None


class _BnLeakyGiven(torch.autograd.Function):
    """``leaky(bn(x))`` with given statistics: kernel B forward, C and D
    backward, gradients to ``mean`` and ``var`` too."""

    @staticmethod
    def forward(ctx, x, mean, var, weight, bias, bn):
        c = x.shape[1]
        w, b = _params(bn, c)
        mean = _channel_vec(mean.detach(), c, "mean")
        var = _channel_vec(var.detach(), c, "var")
        y = _norm(x, mean, var, w, b, bn.eps, _Launch(x))
        move_running_stats(bn, mean, var)
        ctx.eps = bn.eps
        ctx.save_for_backward(x, mean, var, w, b)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mean, var, w, b = ctx.saved_tensors
        dx, back = _backward(g, x, mean, var, None, w, b, ctx.eps)
        return dx, back[4], back[5], back[0], back[1], None


def bn_leaky(x: torch.Tensor, bn) -> torch.Tensor:
    """``F.leaky_relu(bn(x), 0.01)`` for a BatchNorm ``bn`` in training mode
    (``models.layers.BatchNorm2d``: flax's statistics and op order), with
    the batch's statistics of ``x (N, C, H, W)``; moves ``bn``'s running
    statistics.  Differentiable in ``x``, ``bn.weight`` and ``bn.bias``.
    A CUDA tensor goes through the kernels (or raises); a CPU tensor
    through :func:`bn_leaky_plain`."""
    if x.device.type == "cpu":
        return bn_leaky_plain(x, bn)
    return _BnLeaky.apply(x, bn.weight, bn.bias, bn)


def bn_leaky_given(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   bn) -> torch.Tensor:
    """:func:`bn_leaky` with the statistics ``(mean, var)`` given, and
    differentiable in them too; moves ``bn``'s running statistics by them.
    A CPU tensor goes through :func:`bn_leaky_given_plain`."""
    if x.device.type == "cpu":
        return bn_leaky_given_plain(x, mean, var, bn)
    return _BnLeakyGiven.apply(x, mean, var, bn.weight, bn.bias, bn)
