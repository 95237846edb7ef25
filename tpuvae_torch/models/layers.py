"""Shared building blocks (counterpart of ``tpuvae/models/layers.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# divides by its standard deviation (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar) (ref ``Simple_VAE.py:91-93``); the
    noise ``eps`` is an argument so callers own the randomness."""
    return mu + eps * torch.exp(0.5 * logvar)


def lecun_init_(module: nn.Module,
                generator: torch.Generator | None = None) -> nn.Module:
    """flax's default initialisation, in place: every ``nn.Linear`` weight
    from ``lecun_normal`` (a truncated normal of variance 1/fan_in) drawn
    from ``generator``, zero biases; BatchNorm scale 1, bias 0, running
    mean 0 and variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = m.in_features ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
    return module


class BatchNorm1d(nn.BatchNorm1d):
    """``flax.linen.BatchNorm`` with its defaults (eps 1e-5, momentum 0.99).

    Training normalises with the batch's biased statistics in flax's op
    order (its fast variance ``mean(x^2) - mean(x)^2``, which also takes a
    batch of one row), then moves the running statistics by
    ``0.99 * old + 0.01 * batch`` with that **biased** variance — what flax
    stores, where ``torch.nn.BatchNorm1d`` would store the unbiased one.
    ``momentum`` is 0.01 in torch's convention.  Eval mode uses the stored
    statistics as they are.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def apply_dropout(x: torch.Tensor, rate: float, training: bool,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """``flax.linen.Dropout``: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; the mask is drawn from
    ``generator`` (``torch.nn.Dropout`` cannot take one)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MLPBlock(nn.Module):
    """Linear -> BatchNorm -> ReLU -> Dropout stack (ref ``Simple_VAE.py:56-85``)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 dropout: float = 0.2):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.norm = nn.ModuleList(BatchNorm1d(h) for h in hidden_dims)
        self.rate = float(dropout)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for dense, norm in zip(self.dense, self.norm):
            x = apply_dropout(torch.relu(norm(dense(x))), self.rate,
                              self.training, generator)
        return x
