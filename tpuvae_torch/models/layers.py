"""Shared building blocks (counterpart of ``tpuvae/models/layers.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuvae_torch.ops import bn_leaky as bnl
from tpuvae_torch.ops.fusedconv import LEAKY_SLOPE, fused_trunk2

# flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# divides by its standard deviation (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` of a compute dtype given by name (a config's
    ``compute_dtype``) or as a dtype: float32 or bfloat16."""
    if isinstance(dtype, torch.dtype) and dtype in COMPUTE_DTYPES.values():
        return dtype
    if dtype in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[dtype]
    raise ValueError(f"compute dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                     f"got {dtype!r}")


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar) (ref ``Simple_VAE.py:91-93``); the
    noise ``eps`` is an argument so callers own the randomness.  It is
    taken in ``mu``'s dtype, where the JAX package draws it."""
    return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)


def lecun_init_(module: nn.Module,
                generator: torch.Generator | None = None) -> nn.Module:
    """flax's default initialisation, in place: every ``nn.Linear`` and
    3x3 conv weight from ``lecun_normal`` (a truncated normal of variance
    1/fan_in; fan_in = 9 x input channels for a conv kernel) drawn from
    ``generator``, zero biases; BatchNorm scale 1, bias 0, running mean 0
    and variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, Stride2Conv, Stride2ConvTranspose)):
                fan_in = (m.in_features if isinstance(m, nn.Linear)
                          else 9 * m.in_channels)
                std = fan_in ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.reset_parameters()
    return module


def _flax_batch_norm(bn, x: torch.Tensor, dims, stats=None) -> torch.Tensor:
    """Training-mode ``flax.linen.BatchNorm`` of ``x`` over ``dims`` for the
    torch BatchNorm module ``bn``: normalise with the batch's biased
    statistics (flax's fast variance, or ``stats = (mean, var)`` where a
    kernel has gathered them already) and move the running statistics by
    ``0.99 * old + 0.01 * batch`` with that biased variance.  A bfloat16
    ``x`` is widened first: the statistics and the affine map are float32
    (flax's ``force_float32_reductions``), the result ``bn.dtype``."""
    x = x.float()
    mean, var = bnl.batch_stats_plain(x, dims) if stats is None else stats
    bnl.move_running_stats(bn, mean, var)
    return _flax_normalize(bn, x, mean, var)


def _flax_normalize(bn, x: torch.Tensor, mean, var) -> torch.Tensor:
    """``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, flax's
    order, rounded once to ``bn.dtype``."""
    return bnl.normalize_plain(x.float(), mean, var, bn.weight, bn.bias,
                               bn.eps).to(bn.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """``flax.linen.BatchNorm`` with its defaults (eps 1e-5, momentum 0.99).

    Training normalises with the batch's biased statistics in flax's op
    order (its fast variance ``mean(x^2) - mean(x)^2``, which also takes a
    batch of one row), then moves the running statistics by
    ``0.99 * old + 0.01 * batch`` with that **biased** variance — what flax
    stores, where ``torch.nn.BatchNorm1d`` would store the unbiased one.
    ``momentum`` is 0.01 in torch's convention.  Eval mode uses the stored
    statistics as they are.

    ``dtype`` is flax's: the output's dtype.  Parameters and running
    statistics stay float32; under bfloat16 both modes compute in float32
    from the widened input and round the output once.
    """

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.01)
        self.dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _eval_batch_norm(self, x)
        return _flax_batch_norm(self, x, (0,))


def _eval_batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    """Eval mode: the stored statistics; torch's own BatchNorm in float32,
    flax's float32 arithmetic under bfloat16."""
    if bn.dtype == torch.float32:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    return _flax_normalize(bn, x, bn.running_mean, bn.running_var)


class BatchNorm2d(nn.BatchNorm2d):
    """:class:`BatchNorm1d`'s semantics for an ``(N, C, H, W)`` tensor: the
    statistics run over (N, H, W).  ``forward(x, stats=(mean, var))``
    normalises with batch statistics gathered elsewhere (kernel 6 returns
    them with the raw convolution output)."""

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.01)
        self.dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        if not self.training:
            return _eval_batch_norm(self, x)
        return _flax_batch_norm(self, x, (0, 2, 3), stats)

    def leaky(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        """``F.leaky_relu(self(x, stats), 0.01)``: a trunk layer's
        normalisation and activation.  Where :func:`bn_leaky.takes_kernels`
        holds (a CUDA float32 tensor in training) through the kernels of
        ``ops/bn_leaky.py``, else op by op."""
        if bnl.takes_kernels(x, self):
            if stats is None:
                return bnl.bn_leaky(x, self)
            return bnl.bn_leaky_given(x, *stats, self)
        return F.leaky_relu(self(x, stats), LEAKY_SLOPE)


def apply_dropout(x: torch.Tensor, rate: float, training: bool,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """``flax.linen.Dropout``: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; the mask is drawn from
    ``generator`` (``torch.nn.Dropout`` cannot take one)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    # the uniforms are float32 whatever x's dtype, as flax's bernoulli
    mask = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def narrow_product(op, x: torch.Tensor, weight: torch.Tensor, dtype,
                   **kwargs) -> torch.Tensor:
    """``op(x, weight, **kwargs)`` (a linear map or a convolution) on
    operands rounded to ``dtype``, its result rounded once to ``dtype``.
    On a card the library's bfloat16 product sums in float32.  On the CPU
    the product runs in float32 on the rounded operands (exact products,
    float32 sums): the same arithmetic, where torch's CPU bfloat16
    convolution returns wrong values at some shapes (an input two pixels
    wide, as trunk layer 5 sees at ``input_hw = (128, 64)``: errors as
    large as the outputs, or ~1e36)."""
    x, weight = x.to(dtype), weight.to(dtype)
    if x.device.type == "cpu":
        return op(x.float(), weight.float(), **kwargs).to(dtype)
    return op(x, weight, **kwargs)


class Dense(nn.Linear):
    """``flax.linen.Dense`` with its ``dtype``: the float32 weight and bias
    stay as they are; under bfloat16 the input and the weight are cast,
    the product is rounded to bfloat16 and the bias, cast too, is added
    after it: two roundings, as flax's ``y = dot(x, w); y += b``.  A
    product with the bias in its epilogue would round once."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        return (narrow_product(F.linear, x, self.weight, self.dtype)
                + self.bias.to(self.dtype))


class MLPBlock(nn.Module):
    """Linear -> BatchNorm -> ReLU -> Dropout stack (ref ``Simple_VAE.py:56-85``)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 dropout: float = 0.2, dtype=torch.float32):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        self.dense = nn.ModuleList(
            Dense(a, b, dtype) for a, b in zip(dims[:-1], dims[1:]))
        self.norm = nn.ModuleList(BatchNorm1d(h, dtype) for h in hidden_dims)
        self.rate = float(dropout)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for dense, norm in zip(self.dense, self.norm):
            x = apply_dropout(torch.relu(norm(dense(x))), self.rate,
                              self.training, generator)
        return x


class Stride2Conv(nn.Module):
    """3x3 stride-2 SAME convolution (``tpuvae/models/layers.py:95``) on an
    ``(N, C, H, W)`` tensor with even H and W: XLA's SAME padding is (0, 1)
    there, one zero row and column at the high edge only.  ``weight`` is
    ``(F, C, 3, 3)``; flax's ``kernel`` is its (3, 3, C, F) transpose.
    ``dtype`` as :class:`Dense`'s: under bfloat16 the bias is added after
    the rounded convolution."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.features = features
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % 2 or x.shape[3] % 2:
            raise ValueError(f"H and W must be even, got {tuple(x.shape)}")
        if self.dtype == torch.float32:
            return F.conv2d(F.pad(x, (0, 1, 0, 1)), self.weight, self.bias,
                            stride=2)
        y = narrow_product(F.conv2d, F.pad(x.to(self.dtype), (0, 1, 0, 1)),
                           self.weight, self.dtype, stride=2)
        return _add_channel_bias(y, self.bias)


def _add_channel_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y + bias`` over dim 1 in ``y``'s dtype: flax's second rounding."""
    return y + bias.to(y.dtype).view(1, -1, 1, 1)


class Stride2ConvTranspose(nn.Module):
    """3x3 stride-2 SAME transposed convolution
    (``tpuvae/models/layers.py:124``) on ``(N, C, H, W)`` ->
    ``(N, F, 2H, 2W)``.  ``lax.conv_transpose(..., "SAME")`` dilates the
    input by 2, pads (2, 1) and does not flip the kernel; that map is
    ``conv_transpose2d(stride=2, padding=0)`` with the kernel flipped on
    both spatial axes, cut to the first 2H x 2W outputs.  ``weight`` holds
    the flipped kernel as ``(C, F, 3, 3)`` (``convert.py`` flips flax's).
    ``dtype`` as :class:`Stride2Conv`'s."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.features = features
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(in_channels, features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        if self.dtype == torch.float32:
            y = F.conv_transpose2d(x, self.weight, self.bias, stride=2)
            return y[:, :, :2 * h, :2 * w]
        y = narrow_product(F.conv_transpose2d, x, self.weight, self.dtype,
                           stride=2)
        return _add_channel_bias(y[:, :, :2 * h, :2 * w], self.bias)


class ConvEncoderTrunk(nn.Module):
    """6x stride-2 Conv(3x3) + BN + LeakyReLU, 1->32->64->128->256->512->512
    (``tpuvae/models/layers.py:179``).  Input ``(B, H, W, 1)`` NHWC, as the
    JAX package's; output ``(B, 512 * H/64 * W/64)`` flattened in (H, W, C)
    order, which the Linear layers after it depend on.

    In float32, layers 0-1 run through kernel 6 (:func:`fused_trunk2`): in
    training with the batch statistics it gathers, which also move the
    running averages of BatchNorm 0 and 1; in eval mode with layer 0
    folded from its running statistics.  Layers 2-5 are library
    convolutions on the channels-last view of the kernel's NHWC output.

    Under ``dtype=bfloat16`` the input is cast on entry and all six
    layers are :class:`Stride2Conv` + :class:`BatchNorm2d` at that dtype,
    as the JAX trunk's: kernel 6 computes in float32 only, like the JAX
    package's fused pair, which its trunk never calls."""

    def __init__(self, features: Sequence[int] = (32, 64, 128, 256, 512, 512),
                 dtype=torch.float32):
        super().__init__()
        chans = [1, *features]
        self.dtype = compute_dtype(dtype)
        self.conv = nn.ModuleList(
            Stride2Conv(a, b, dtype) for a, b in zip(chans[:-1], chans[1:]))
        self.norm = nn.ModuleList(BatchNorm2d(f, dtype) for f in features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.dtype == torch.float32:
            h = self._fused_layers(x)
            layers = zip(self.conv[2:], self.norm[2:])
        else:
            h = x.permute(0, 3, 1, 2)         # (B, 1, H, W) view, no copy
            layers = zip(self.conv, self.norm)
        for conv, norm in layers:
            h = norm.leaky(conv(h))
        return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)

    def _fused_layers(self, x: torch.Tensor) -> torch.Tensor:
        """Layers 0-1 through kernel 6; NCHW view of its NHWC output."""
        c0, c1 = self.conv[0], self.conv[1]
        n0, n1 = self.norm[0], self.norm[1]
        running0 = None if self.training else (n0.running_mean, n0.running_var)
        y1, stats0, stats1 = fused_trunk2(
            x, c0.weight.permute(2, 3, 1, 0), c0.bias, n0.weight, n0.bias,
            c1.weight.permute(2, 3, 1, 0), c1.bias, n0.eps, running0)
        if self.training:
            bnl.move_running_stats(n0, *stats0)
        h = y1.permute(0, 3, 1, 2)            # channels-last view, no copy
        return n1.leaky(h, stats1)


class ConvDecoderTrunk(nn.Module):
    """6x stride-2 ConvTranspose(3x3) mirror, 512->512->256->128->64->32->1
    (``tpuvae/models/layers.py:206``).  Input ``(B, 512 * fh * fw)`` in
    (H, W, C) order -> ``(B, 64 fh, 64 fw, 1)`` NHWC; no BatchNorm or
    activation after the last layer.  The input is cast to ``dtype`` on
    entry and every layer computes there, on NCHW activations (each
    convolution's output follows its input's layout)."""

    def __init__(self, features: Sequence[int] = (512, 256, 128, 64, 32),
                 feature_hw: tuple = (2, 16), dtype=torch.float32):
        super().__init__()
        chans = [512, *features, 1]
        self.feature_hw = tuple(feature_hw)
        self.dtype = compute_dtype(dtype)
        self.conv = nn.ModuleList(
            Stride2ConvTranspose(a, b, dtype)
            for a, b in zip(chans[:-1], chans[1:]))
        self.norm = nn.ModuleList(BatchNorm2d(f, dtype) for f in features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fh, fw = self.feature_hw
        h = x.to(self.dtype).reshape(x.shape[0], fh, fw, 512).permute(0, 3, 1, 2)
        # NCHW from here on (a copy of 16 K values a row): cuDNN's float32
        # engines without TF32 compute in NCHW and wrap every channels-last
        # call in layout transposes; bfloat16's training pass is faster
        # NCHW too
        h = h.contiguous()
        for conv, norm in zip(self.conv[:-1], self.norm):
            h = norm.leaky(conv(h))
        return self.conv[-1](h).permute(0, 2, 3, 1)
