"""Simple (MLP) VAE (counterpart of ``tpuvae/models/simple_vae.py``).

Encoder [input -> 128 -> 64 -> 32] with BN + ReLU + Dropout(0.2), mu / logvar
heads of 32, mirrored decoder ending in a plain Linear back to the input
dim.  ``train()`` / ``eval()`` select batch or running BatchNorm statistics
and dropout, as flax's ``train=`` flag does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpuvae_torch.models.layers import MLPBlock, reparameterize


class SimpleVAE(nn.Module):
    def __init__(self, input_dim: int = 370,
                 hidden_dims: Sequence[int] = (128, 64, 32),
                 latent_dim: int = 32, dropout: float = 0.2):
        super().__init__()
        hidden_dims = tuple(hidden_dims)
        self.encoder = MLPBlock(input_dim, hidden_dims, dropout)
        self.fc_mu = nn.Linear(hidden_dims[-1], latent_dim)
        self.fc_logvar = nn.Linear(hidden_dims[-1], latent_dim)
        self.decoder = MLPBlock(latent_dim, tuple(reversed(hidden_dims)),
                                dropout)
        self.out = nn.Linear(hidden_dims[0], input_dim)

    def encode(self, x: torch.Tensor):
        h = self.encoder(x)
        return self.fc_mu(h), self.fc_logvar(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.out(self.decoder(z))

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """``(recon, mu, logvar, z)``.  The reparameterisation noise is
        ``eps`` when given, else drawn from ``generator``."""
        mu, logvar = self.encode(x)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                              device=mu.device)
        z = reparameterize(mu, logvar, eps)
        return self.decode(z), mu, logvar, z

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder mean (ref ``get_latent_features``, :103-105); call on a
        model in ``eval()`` mode for serving."""
        return self.encode(x)[0]
