"""The conv trunks' stride-2 3x3 transposed convolution at the narrow layers,
as a hand-written kernel (``csrc/s2_dgrad.cu``) and its plain version.

In the port's SAME convention a stride-2 transposed convolution maps ``x
(B, C, h, w)`` and ``weight (C, F, 3, 3)`` to ``(B, F, 2h, 2w)``::

    out[:, f, 2m + pr, 2n + ps] = bias[f] + sum over c and the taps (p, q)
        of that output phase of x[:, c, m', n'] * weight[c, f, p, q]

with p = 1 for an odd output row (m' = m) and p in {0, 2} for an even one
(m' = m and m - 1), and likewise q for the columns: the first 2h x 2w
outputs of ``F.conv_transpose2d(x, weight, bias, stride=2)``.  The same map
is the data gradient of the trunks' stride-2 SAME convolution
(``layers.Stride2Conv``, pads (0, 1)), its ``(F_out, C_in, 3, 3)`` weight
read as a transposed convolution's.  Four calls of a float32 Hybrid or
Conditional VAE step take it:

* decoder layers 3 and 4 forward (:class:`S2ConvTranspose`, NCHW), whose
  backward stays autograd's: ``aten.convolution_backward(transposed=True)``
  on the gradient padded back to the (2h + 1) x (2w + 1) result;
* the data gradient of encoder layer 2 (:class:`Stride2ConvFn`,
  channels-last), whose forward and weight gradient stay cuDNN's;
* the data gradient of encoder layer 1 in kernel 6's backward
  (``fusedconv._FusedTrunk2``, channels-last).

:func:`takes_kernel` is the one rule that picks the kernel: a float32 CUDA
tensor, F in {32, 64} output channels, at most 128 input channels (a
CTA's slice of the weights fits in shared memory).  Every other call --
the wider layers, the decoder's 1-channel last layer, bfloat16 -- runs
cuDNN as before.  The kernel replaces no Pallas kernel (the JAX package
leaves these convolutions to XLA); it was written because cuDNN's only
float32 engine for them (TF32 off), the legacy stride-2 ``dgrad_engine``,
took ~25% of a Hybrid epoch's device time.  It multiplies in three TF32
products on the tensor cores, where it is bound by bytes and operations
alike, writes no atomics (two calls give the same bits) and reads x
channels-last or NCHW, writing the output in the same layout.  A CPU
tensor runs :func:`s2_conv_transpose_plain`, the same phase-split
arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tpuvae_torch.ops import _build

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
S2_DGRAD = _build.Kernel(
    "s2_dgrad", "s2_dgrad", "tpuvae_s2_dgrad",
    [_PTR, _INT, _INT, _INT, _INT, _LL, _LL, _LL, _LL, _INT, _PTR, _INT, _LL,
     _LL, _LL, _LL, _PTR, _PTR, _PTR])

KERNEL_FEATURES = (32, 64)     # output channels the kernel is built for
MAX_CHANNELS = 128             # input channels whose weights fit a CTA


def takes_kernel(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether :func:`s2_conv_transpose` of ``x`` with ``weight (C, F, 3,
    3)`` runs the CUDA kernel: float32 on a CUDA device, F in
    :data:`KERNEL_FEATURES`, C at most :data:`MAX_CHANNELS`."""
    return (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32
            and weight.shape[1] in KERNEL_FEATURES
            and weight.shape[0] <= MAX_CHANNELS)


# -- the plain version --------------------------------------------------------

def s2_conv_transpose_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor | None = None) -> torch.Tensor:
    """The phase-split arithmetic in PyTorch: each tap (p, q) multiplies the
    input shifted by (p == 2, q == 2) and adds into output phase (p == 1,
    q == 1); then the bias."""
    b, _, h, w = x.shape
    out = x.new_zeros((b, weight.shape[1], 2 * h, 2 * w))
    xp = F.pad(x, (1, 0, 1, 0))          # xp[..., i + 1, j + 1] = x[..., i, j]
    for p in range(3):
        for q in range(3):
            r0, c0 = 1 - (p == 2), 1 - (q == 2)
            term = torch.einsum("bchw,cf->bfhw",
                                xp[:, :, r0:r0 + h, c0:c0 + w],
                                weight[:, :, p, q])
            out[:, :, int(p == 1)::2, int(q == 1)::2] += term
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


# -- the wrapper -----------------------------------------------------------------

def _check(x: torch.Tensor, weight: torch.Tensor, bias) -> None:
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"x must be (B, C, h, w) and weight (C, F, 3, 3), "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    if weight.shape[0] != x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, weight "
                         f"{weight.shape[0]}")
    if bias is not None and tuple(bias.shape) != (weight.shape[1],):
        raise ValueError(f"bias must be ({weight.shape[1]},), got "
                         f"{tuple(bias.shape)}")


def _aligned(x: torch.Tensor, inner: int) -> bool:
    """Whether the kernel reads ``x`` as it lies: stride 1 along dim
    ``inner`` (1: channels-last, 3: NCHW), every other stride a multiple
    of 4 floats, the start on a 16-byte boundary."""
    s = x.stride()
    return (s[inner] == 1 and x.data_ptr() % 16 == 0
            and all(s[d] % 4 == 0 for d in range(4) if d != inner))


def _kernel_input(x: torch.Tensor):
    """``(x, nhwc)``: ``x`` as the kernel reads it, or a channels-last copy
    whose pixel vectors are padded to 16 bytes."""
    if _aligned(x, 1):
        return x, True
    if _aligned(x, 3):
        return x, False
    b, c, h, w = x.shape
    buf = x.new_empty((b, h, w, -(-c // 4) * 4))[..., :c]
    buf.copy_(x.permute(0, 2, 3, 1))
    return buf.permute(0, 3, 1, 2), True


def _launch(x, weight, bias):
    x, nhwc = _kernel_input(x)
    b, c, h, w = x.shape
    f = weight.shape[1]
    if nhwc:
        out = x.new_empty((b, 2 * h, 2 * w, f)).permute(0, 3, 1, 2)
    else:
        out = x.new_empty((b, f, 2 * h, 2 * w))
    if bias is not None:
        bias = bias.contiguous()
        if bias.dtype != torch.float32 or bias.device != x.device:
            raise ValueError("bias must be float32 on x's device")
    if weight.device != x.device:
        raise ValueError(f"x on {x.device}, weight on {weight.device}")
    if out.numel():
        S2_DGRAD(_build.ptr(x), b, c, h, w, *x.stride(), int(nhwc),
                 _build.ptr(weight), f, *weight.stride(),
                 None if bias is None else _build.ptr(bias), _build.ptr(out),
                 _build.stream_ptr(x.device))
    return out


def s2_conv_transpose(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x (B, C, h, w)``, ``weight (C, F, 3, 3)``, ``bias (F,)`` or None ->
    ``(B, F, 2h, 2w)``, the stride-2 SAME transposed convolution.  A CUDA
    tensor goes through the kernel (or raises where :func:`takes_kernel`
    says no), its output channels-last when ``x`` is, NCHW otherwise; a
    CPU tensor through :func:`s2_conv_transpose_plain`."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return s2_conv_transpose_plain(x, weight, bias)
    if not takes_kernel(x, weight):
        raise ValueError(
            f"the s2_dgrad kernel takes float32, F in {KERNEL_FEATURES} and "
            f"C <= {MAX_CHANNELS}; got {x.dtype}, weight "
            f"{tuple(weight.shape)} {weight.dtype}")
    return _launch(x, weight, bias)


# -- the trunks' two differentiable calls ------------------------------------------

def _conv_backward(g, x, weight, bias_sizes, transposed: bool, mask):
    """``aten.convolution_backward`` of a stride-2, unpadded 3x3 call."""
    return torch.ops.aten.convolution_backward(
        g, x, weight, bias_sizes, [2, 2], [0, 0], [1, 1], transposed, [0, 0],
        1, mask)


class S2ConvTranspose(torch.autograd.Function):
    """``F.conv_transpose2d(x, weight, bias, stride=2)[..., :2h, :2w]``
    through :func:`s2_conv_transpose`.  The backward is autograd's of that
    composition: the gradient padded back to (2h + 1) x (2w + 1), then one
    ``convolution_backward(transposed=True)``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return s2_conv_transpose(x, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        mask = list(ctx.needs_input_grad[:2]) + [ctx.has_bias
                                                 and ctx.needs_input_grad[2]]
        return _conv_backward(
            F.pad(g, (0, 1, 0, 1)), x, weight,
            [weight.shape[1]] if ctx.has_bias else None, True, mask)


class Stride2ConvFn(torch.autograd.Function):
    """``F.conv2d(F.pad(x, (0, 1, 0, 1)), weight, bias, stride=2)``, the
    trunks' stride-2 SAME convolution, whose data gradient runs
    :func:`s2_conv_transpose` (``weight (F_out, C_in, 3, 3)`` read as a
    transposed convolution's, written H x W with no cut); the weight and
    bias gradients stay one ``convolution_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xp = F.pad(x, (0, 1, 0, 1))
        ctx.save_for_backward(xp, weight)
        ctx.has_bias = bias is not None
        return F.conv2d(xp, weight, bias, stride=2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xp, weight = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = s2_conv_transpose(g, weight)
        mask = [False, ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        if any(mask):
            _, gw, gb = _conv_backward(
                g, xp, weight, [weight.shape[0]] if ctx.has_bias else None,
                False, mask)
        return gx, gw, gb
