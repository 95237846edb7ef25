"""Shared building blocks (counterpart of ``tpuvae/models/layers.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar) (ref ``Simple_VAE.py:91-93``); the
    noise ``eps`` is an argument so callers own the randomness."""
    return mu + eps * torch.exp(0.5 * logvar)


class MLPBlock(nn.Module):
    """Linear -> BatchNorm1d -> ReLU -> Dropout stack (ref ``Simple_VAE.py:56-85``).

    BatchNorm matches flax's defaults: eps 1e-5, and momentum 0.01 in
    torch's convention (flax's 0.99 weights the running average, torch's
    weights the new batch).  The running variance is the biased one, as
    flax stores it.
    """

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 dropout: float = 0.2):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.norm = nn.ModuleList(
            nn.BatchNorm1d(h, eps=1e-5, momentum=0.01) for h in hidden_dims)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, norm in zip(self.dense, self.norm):
            x = self.drop(torch.relu(norm(dense(x))))
        return x
