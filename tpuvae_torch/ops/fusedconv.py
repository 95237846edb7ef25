"""Fused conv + BatchNorm statistics for the conv trunk's first two layers
(kernel 6 and its plain version).

Counterpart of ``tpuvae/ops/fusedconv.py``.  Layers 0 and 1 of
``ConvEncoderTrunk`` are 3x3 stride-2 SAME convolutions (pads (0, 1) on
even dims), each followed by BatchNorm and LeakyReLU(0.01).  The pair
writes each raw activation once and gathers its BatchNorm statistics while
it is written; layer 1 normalises layer 0's output on load:

* :func:`conv0_stats` — ``x (B, H, W)``, ``w0 (3, 3, F0)``, ``b0`` ->
  raw ``y0 (B, H/2, W/2, F0)`` and per-image sums / sums of squares
  ``(B, 1, F0)``;
* :func:`conv1_norm_stats` — raw ``y0``, folded BatchNorm ``scale`` /
  ``shift``, ``w1 (3, 3, C, F1)``, ``b1`` -> raw ``y1 (B, H/4, W/4, F1)``
  and its sums; the zero padding applies after the affine;
* :func:`fused_trunk2_forward` — both, with the ``(C,)`` finalisation in
  the JAX op order (``tpuvae/ops/fusedconv.py:141-145``);
* :func:`fused_trunk2` — the same function for a model: differentiable
  (:class:`torch.autograd.Function`), with batch statistics in training or
  given running statistics in eval mode.

On a CUDA tensor the two kernels of ``csrc/fusedconv.cu`` run, fp32, at the
trunk's widths (F0 = C = 32, F1 = 64), or the call raises; on a CPU tensor
the plain PyTorch versions (``*_plain``) run.  The kernels add each image's
partial statistics themselves (the last CTA or warpgroup to finish an
image, found by an integer ticket) and finalise the batch statistics, so a
wrapper makes one launch and no reduction; :func:`conv0_stats` and
:func:`conv1_norm_stats` run the same kernels and drop the batch
statistics.  The JAX package has no backward kernel for the pair, so the
gradient goes through PyTorch's convolution gradients and the trunks'
BatchNorm kernels (``ops.bn_leaky``), from the saved input, the raw ``y0``
and ``y1`` and the statistics.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpuvae_torch.ops import _build

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
CONV0 = _build.Kernel(
    "fusedconv_conv0", "fusedconv", "tpuvae_fusedconv_conv0",
    [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR,
     _PTR, _PTR, ctypes.c_float, _PTR, _PTR])
CONV1 = _build.Kernel(
    "fusedconv_conv1", "fusedconv", "tpuvae_fusedconv_conv1",
    [_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR,
     _PTR, _PTR, _PTR, _PTR, _PTR])

LEAKY_SLOPE = 0.01
# output pixels per tile (rows, columns) of the two kernels in
# csrc/fusedconv.cu: conv0 one CTA a tile, conv1 one wgmma tile (64 rows);
# the statistics scratch holds one partial row per tile
_TILE0 = (8, 32)
_TILE1 = (8, 8)
_KERNEL_WIDTHS = (32, 32, 64)       # F0, C, F1 the CUDA kernels are built for
# per device: gamma = 1, beta = 0 for conv0_stats, whose fold is dropped
_IDENTITY_BN: dict = {}


# -- plain versions -----------------------------------------------------------

def _conv_s2_same(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 SAME conv on even dims, NHWC in and out: the padding is
    (0, 1) on both axes (``lax.conv_general_dilated(..., "SAME")``)."""
    xp = F.pad(x_nhwc.permute(0, 3, 1, 2), (0, 1, 0, 1))
    y = F.conv2d(xp, w_hwio.permute(3, 2, 0, 1), b, stride=2)
    return y.permute(0, 2, 3, 1).contiguous()


def _image_sums(y: torch.Tensor):
    return (y.sum(dim=(1, 2))[:, None, :], (y * y).sum(dim=(1, 2))[:, None, :])


def conv0_stats_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor):
    """Plain version of kernel 6's first half (``_conv0_kernel``)."""
    y0 = _conv_s2_same(x[..., None], w0[:, :, None, :], b0)
    return (y0, *_image_sums(y0))


def conv1_norm_stats_plain(y0: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor):
    """Plain version of kernel 6's second half (``_conv1_kernel``): the
    affine and LeakyReLU first, then the zero padding of the convolution."""
    z = F.leaky_relu(y0 * scale + shift, LEAKY_SLOPE)
    y1 = _conv_s2_same(z, w1, b1)
    return (y1, *_image_sums(y1))


def _finalize_raw(s: torch.Tensor, ss: torch.Tensor, n: int):
    """Batch mean, biased variance and the variance before its clamp at 0
    (``raw``, whose sign is the clamp's gradient mask) from the partial
    sums, in the op order of ``tpuvae/ops/fusedconv.py:142-143``."""
    mean = s.sum(dim=(0, 1)) / n
    raw = ss.sum(dim=(0, 1)) / n - mean * mean
    return mean, torch.clamp_min(raw, 0.0), raw


def _finalize(s: torch.Tensor, ss: torch.Tensor, n: int):
    """Batch mean and biased variance from the partial sums."""
    return _finalize_raw(s, ss, n)[:2]


def _fold(mean, var, gamma, beta, eps: float):
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _conv0_bn_plain(x, w0, b0, gamma0, beta0, eps):
    y0, s0, ss0 = conv0_stats_plain(x, w0, b0)
    stats = _finalize_raw(s0, ss0, y0.shape[0] * y0.shape[1] * y0.shape[2])
    return y0, stats, _fold(*stats[:2], gamma0, beta0, eps)


def _conv1_bn_plain(y0, scale, shift, w1, b1):
    y1, s1, ss1 = conv1_norm_stats_plain(y0, scale, shift, w1, b1)
    return y1, _finalize_raw(s1, ss1, y1.shape[0] * y1.shape[1] * y1.shape[2])


def fused_trunk2_forward_plain(x, w0, b0, gamma0, beta0, w1, b1,
                               eps: float = 1e-5):
    """Plain version of :func:`fused_trunk2_forward`."""
    return _pair_forward(_conv0_bn_plain, _conv1_bn_plain,
                         x, w0, b0, gamma0, beta0, w1, b1, eps, None)[:3]


# -- wrappers -------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, shape) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2 or h <= 0 or w <= 0:
        raise ValueError(f"H and W must be even and positive, got {h} x {w} "
                         f"(SAME pads (0, 1) only on even dims)")


def _check_conv0(x, w0, b0) -> None:
    _check(x, "x", (None, None, None))
    f0 = w0.shape[-1]
    _check(w0, "w0", (3, 3, f0))
    _check(b0, "b0", (f0,))
    _check_even(x.shape[1], x.shape[2])


def _check_conv1(y0, scale, shift, w1, b1) -> None:
    _check(y0, "y0", (None, None, None, None))
    c, f1 = y0.shape[-1], w1.shape[-1]
    _check(scale, "scale", (c,))
    _check(shift, "shift", (c,))
    _check(w1, "w1", (3, 3, c, f1))
    _check(b1, "b1", (f1,))
    _check_even(y0.shape[1], y0.shape[2])


def _tiles(h2: int, w2: int, tile) -> int:
    return -(-h2 // tile[0]) * -(-w2 // tile[1])


def _tickets_and_stream(device: torch.device, batch: int):
    """``(tickets, stream)`` as kernel arguments: the current stream's
    ticket buffer (:func:`_build.reserve_tickets`) and that stream."""
    t = _build.reserve_tickets(device, batch)
    stream = torch.cuda.current_stream(device).cuda_stream
    return _build.ptr(t), ctypes.c_void_p(stream)


def _launch_args(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device} do not pair")
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
    return [_build.ptr(t) for t in tensors], dev


def _conv0(x, w0, b0, gamma, beta, eps):
    """Kernel 6's first half on the card: ``(y0, s, ss, stats)``, its last
    reducer finalising the batch ``stats = (mean, var, scale, shift,
    raw)``, ``raw`` the variance before its clamp."""
    f0 = w0.shape[-1]
    if f0 != _KERNEL_WIDTHS[0]:
        raise ValueError(f"the conv0 kernel is built for F0 = "
                         f"{_KERNEL_WIDTHS[0]}, got {f0}")
    x, w0, b0 = x.contiguous(), w0.contiguous(), b0.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    _check(gamma, "gamma0", (f0,))
    _check(beta, "beta0", (f0,))
    b, h, w = x.shape
    h2, w2 = h // 2, w // 2
    tiles = _tiles(h2, w2, _TILE0)
    y0 = torch.empty((b, h2, w2, f0), dtype=torch.float32, device=x.device)
    part = torch.empty((b * tiles, 2, f0), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((2, b, 1, f0), dtype=torch.float32, device=x.device)
    stats = torch.empty((5, f0), dtype=torch.float32, device=x.device)
    if b:
        (px, pw, pb, py, pp, ps, pg, pbe, pst), dev = _launch_args(
            x, w0, b0, y0, part, sums, gamma, beta, stats)
        tickets, stream = _tickets_and_stream(dev, b)
        CONV0(px, pw, pb, b, h, w, f0, tiles, py, pp, ps, tickets, pg, pbe,
              float(eps), pst, stream)
    return y0, sums[0], sums[1], stats


def conv0_stats(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor):
    """``x (B, H, W)``, ``w0 (3, 3, F0)``, ``b0 (F0,)`` ->
    ``(y0 (B, H/2, W/2, F0) raw, s (B, 1, F0), ss (B, 1, F0))``.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`conv0_stats_plain`.  The kernel replaces
    ``tpuvae/ops/fusedconv.py:67`` (``_conv0_kernel``); it is bound by the
    bytes of ``y0``.
    """
    _check_conv0(x, w0, b0)
    if x.device.type == "cpu":
        return conv0_stats_plain(x, w0, b0)
    key = (x.device.index, w0.shape[-1])
    if key not in _IDENTITY_BN:
        _IDENTITY_BN[key] = (torch.ones(key[1], device=x.device),
                             torch.zeros(key[1], device=x.device))
    return _conv0(x, w0, b0, *_IDENTITY_BN[key], 1e-5)[:3]


def _conv1(y0, scale, shift, w1, b1):
    """Kernel 6's second half on the card: ``(y1, s, ss, stats)``, its last
    reducer finalising the batch ``stats = (mean, var, raw)``, (3, F1)."""
    b, h, w, c = y0.shape
    f1 = w1.shape[-1]
    if (c, f1) != _KERNEL_WIDTHS[1:]:
        raise ValueError(f"the conv1 kernel is built for C, F1 = "
                         f"{_KERNEL_WIDTHS[1:]}, got {(c, f1)}")
    y0, scale, shift, w1, b1 = (t.contiguous()
                                for t in (y0, scale, shift, w1, b1))
    if y0.data_ptr() % 16:
        raise ValueError("y0 must start on a 16-byte boundary (the kernel "
                         "copies it in 16-byte chunks)")
    h2, w2 = h // 2, w // 2
    tiles = _tiles(h2, w2, _TILE1)
    y1 = torch.empty((b, h2, w2, f1), dtype=torch.float32, device=y0.device)
    part = torch.empty((b * tiles, 2, f1), dtype=torch.float32,
                       device=y0.device)
    sums = torch.empty((2, b, 1, f1), dtype=torch.float32, device=y0.device)
    stats = torch.empty((3, f1), dtype=torch.float32, device=y0.device)
    if b:
        (py0, psc, psh, pw, pb, py1, pp, ps, pst), dev = _launch_args(
            y0, scale, shift, w1, b1, y1, part, sums, stats)
        tickets, stream = _tickets_and_stream(dev, b)
        CONV1(py0, psc, psh, pw, pb, b, h, w, c, f1, tiles, py1, pp, ps,
              tickets, pst, stream)
    return y1, sums[0], sums[1], stats


def conv1_norm_stats(y0: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor):
    """Raw ``y0 (B, H, W, C)``, folded BatchNorm ``scale`` / ``shift (C,)``,
    ``w1 (3, 3, C, F1)``, ``b1 (F1,)`` ->
    ``(y1 (B, H/2, W/2, F1) raw, s (B, 1, F1), ss (B, 1, F1))``.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`conv1_norm_stats_plain`.  The kernel replaces
    ``tpuvae/ops/fusedconv.py:88`` (``_conv1_kernel``); it multiplies on the
    tensor cores in three TF32 products, where it is bound by bytes and
    operations alike.
    """
    _check_conv1(y0, scale, shift, w1, b1)
    if y0.device.type == "cpu":
        return conv1_norm_stats_plain(y0, scale, shift, w1, b1)
    return _conv1(y0, scale, shift, w1, b1)[:3]


def _conv0_bn(x, w0, b0, gamma0, beta0, eps):
    """conv0 with layer 0's batch statistics and their BatchNorm fold:
    ``(y0, (mean0, var0, raw0), (scale0, shift0))``.  On the card one
    launch, the kernel finalising; on a CPU tensor the plain version."""
    _check_conv0(x, w0, b0)
    if x.device.type == "cpu":
        return _conv0_bn_plain(x, w0, b0, gamma0, beta0, eps)
    y0, _, _, st = _conv0(x, w0, b0, gamma0, beta0, eps)
    return y0, (st[0], st[1], st[4]), (st[2], st[3])


def _conv1_bn(y0, scale, shift, w1, b1):
    """conv1 with layer 1's batch statistics: ``(y1, (mean1, var1,
    raw1))``; on the card one launch, on a CPU tensor the plain version."""
    _check_conv1(y0, scale, shift, w1, b1)
    if y0.device.type == "cpu":
        return _conv1_bn_plain(y0, scale, shift, w1, b1)
    y1, _, _, st = _conv1(y0, scale, shift, w1, b1)
    return y1, (st[0], st[1], st[2])


def _pair_forward(conv0_bn, conv1_bn, x, w0, b0, gamma0, beta0, w1, b1, eps,
                  running0):
    """The pair through ``conv0_bn`` / ``conv1_bn`` (:func:`_conv0_bn`,
    :func:`_conv1_bn` or their plain versions); layer 0 is normalised with
    its batch statistics, or with ``running0 = (mean, var)`` when given.
    Returns ``(y1, (mean0, var0), (mean1, var1), y0, (raw0, raw1))`` with
    the batch statistics of both raw outputs and their variances before
    the clamp."""
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f"x must be (B, H, W, 1), got {tuple(x.shape)}")
    y0, (mean0, var0, raw0), (scale0, shift0) = conv0_bn(
        x[..., 0], w0[:, :, 0, :], b0, gamma0, beta0, eps)
    if running0 is not None:
        scale0, shift0 = _fold(*running0, gamma0, beta0, eps)
    y1, (mean1, var1, raw1) = conv1_bn(y0, scale0, shift0, w1, b1)
    return y1, (mean0, var0), (mean1, var1), y0, (raw0, raw1)


def fused_trunk2_forward(x, w0, b0, gamma0, beta0, w1, b1, eps: float = 1e-5):
    """Forward of trunk layers 0-1 with single-write activations
    (``tpuvae/ops/fusedconv.py:176``): ``x (B, H, W, 1)``,
    ``w0 (3, 3, 1, F0)``, ``w1 (3, 3, F0, F1)`` ->
    ``(y1_raw, (mean0, var0), (mean1, var1))``, the second conv's pre-BN
    output and the BatchNorm batch statistics of each conv output.  Not
    differentiable: models call :func:`fused_trunk2`."""
    with torch.no_grad():
        return _pair_forward(_conv0_bn, _conv1_bn, x, w0, b0,
                             gamma0, beta0, w1, b1, eps, None)[:3]


# -- the differentiable pair -------------------------------------------------------

def _stats_grad(g_y1, y1, mean1, raw1, g_mean1, g_var1):
    """The gradient reaching the raw ``y1`` from its own use and from its
    batch statistics ``mean1 = mean(y1)``, ``var1 = max(raw1, 0)``,
    ``raw1 = mean(y1^2) - mean1^2`` over (B, H, W): ``g_y1 + g_mean1 / n
    + 2 g_var1 (y1 - mean1) / n``, no variance gradient where the forward's
    clamp cut (``raw1 < 0``, as ``clamp_min``'s)."""
    n = y1.shape[0] * y1.shape[1] * y1.shape[2]
    g = g_y1 if g_y1 is not None else torch.zeros_like(y1)
    if g_mean1 is not None:
        g = g + g_mean1 / n
    if g_var1 is not None:
        g_var1 = torch.where(raw1 >= 0, g_var1, torch.zeros_like(g_var1))
        g = g + (y1 - mean1) * (2.0 * g_var1 / n)
    return g


class _FusedTrunk2(torch.autograd.Function):
    """``(y1, mean0, var0, mean1, var1)`` of the pair.  ``forward`` runs the
    wrappers (the kernels on the card).  ``backward`` (the JAX package has
    no backward kernel) takes layer 1's statistics into its gradient from
    the saved raw ``y1`` (the clamps' masks from the forward's own
    unclamped variances), rebuilds layer 1's normalised input ``z`` from
    the saved raw ``y0`` with one pass of PyTorch operations, takes
    layer 1's convolution gradients from one ``convolution_backward``
    call, layer 0's normalisation backward in training from the BatchNorm
    kernels (``ops.bn_leaky``, C and D) and layer 0's weight gradient from
    PyTorch."""

    @staticmethod
    def forward(ctx, x, w0, b0, gamma0, beta0, w1, b1, eps, run_mean, run_var):
        running0 = None if run_mean is None else (run_mean, run_var)
        y1, (mean0, var0), (mean1, var1), y0, (raw0, raw1) = _pair_forward(
            _conv0_bn, _conv1_bn, x, w0, b0, gamma0, beta0, w1, b1,
            eps, running0)
        ctx.eps = eps
        ctx.batch_stats = running0 is None
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w0, gamma0, beta0, w1, y0, y1, mean1, raw1,
                              raw0, *((mean0, var0) if running0 is None
                                      else running0))
        ctx.mark_non_differentiable(mean0, var0)
        return y1, mean0, var0, mean1, var1

    @staticmethod
    def backward(ctx, g_y1, _g_mean0, _g_var0, g_mean1, g_var1):
        # imported here: ops.bn_leaky imports this module
        from tpuvae_torch.ops import bn_leaky as bnl

        (x, w0, gamma0, beta0, w1, y0, y1, mean1, raw1, raw0, mean0,
         var0) = ctx.saved_tensors
        g = _stats_grad(g_y1, y1, mean1, raw1, g_mean1, g_var1)
        # layer 1: y1 = conv(pad(z), w1) + b1, z = leaky(y0 scale0 + shift0)
        scale0, shift0 = _fold(mean0, var0, gamma0, beta0, ctx.eps)
        z = F.leaky_relu(y0 * scale0 + shift0, LEAKY_SLOPE)
        zp = F.pad(z.permute(0, 3, 1, 2), (0, 1, 0, 1))
        g_zp, g_w1, g_b1 = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), zp, w1.permute(3, 2, 0, 1),
            [w1.shape[-1]], [2, 2], [0, 0], [1, 1], False, [0, 0], 1,
            [True, True, True])
        g_z = g_zp[:, :, :z.shape[1], :z.shape[2]]
        y0c = y0.permute(0, 3, 1, 2)
        if ctx.batch_stats:
            g_y0, g_g0, g_be0 = bnl.bn_leaky_backward(
                g_z, y0c, mean0, var0, raw0, gamma0, beta0, ctx.eps)
        else:       # eval mode, as the trunks' other layers: no kernels
            g_y0, g_g0, g_be0, _, _ = bnl.bn_leaky_backward_plain(
                g_z, y0c, mean0, var0, gamma0, beta0, ctx.eps, True)
        # layer 0: y0 = conv(pad(x), w0) + b0; g_y0 is (B, F0, H0, W0)
        xp = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
        w0_oihw = w0.permute(3, 2, 0, 1)
        g_w0 = torch.nn.grad.conv2d_weight(
            xp, w0_oihw.shape, g_y0, stride=2).permute(2, 3, 1, 0)
        g_b0 = g_y0.sum(dim=(0, 2, 3))
        g_x = None
        if ctx.needs_input_grad[0]:
            g_xp = torch.nn.grad.conv2d_input(
                xp.shape, w0_oihw, g_y0, stride=2)
            g_x = g_xp[:, :, :x.shape[1], :x.shape[2]].permute(0, 2, 3, 1)
        return (g_x, g_w0, g_b0, g_g0, g_be0, g_w1.permute(2, 3, 1, 0), g_b1,
                None, None, None)


def fused_trunk2(x, w0, b0, gamma0, beta0, w1, b1, eps: float = 1e-5,
                 running0=None):
    """Differentiable trunk layers 0-1 through kernel 6:
    ``(y1_raw, (mean0, var0), (mean1, var1))`` as
    :func:`fused_trunk2_forward`.  With ``running0 = (mean, var)`` layer 0
    is normalised with those statistics (eval mode) and not with the
    batch's.  Gradients flow through ``y1``, ``mean1`` and ``var1``."""
    run_mean, run_var = (None, None) if running0 is None else running0
    y1, mean0, var0, mean1, var1 = _FusedTrunk2.apply(
        x, w0, b0, gamma0, beta0, w1, b1, eps, run_mean, run_var)
    return y1, (mean0, var0), (mean1, var1)
