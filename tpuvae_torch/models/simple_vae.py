"""Simple (MLP) VAE (counterpart of ``tpuvae/models/simple_vae.py``).

Encoder [input -> 128 -> 64 -> 32] with BN + ReLU + Dropout(0.2), mu / logvar
heads of 32, mirrored decoder ending in a plain Linear back to the input
dim.  ``train()`` / ``eval()`` select batch or running BatchNorm statistics
and dropout, as flax's ``train=`` flag does.  Weights start from flax's
initialisation (``layers.lecun_init_``), drawn from the ``generator`` given
to the constructor.  ``dtype`` is the compute dtype (float32 or bfloat16),
as the JAX model's: the weights stay float32 and each layer computes in
``dtype`` (``layers.Dense``, ``layers.BatchNorm1d``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpuvae_torch.models.layers import (
    Dense,
    MLPBlock,
    lecun_init_,
    reparameterize,
)


class SimpleVAE(nn.Module):
    def __init__(self, input_dim: int = 370,
                 hidden_dims: Sequence[int] = (128, 64, 32),
                 latent_dim: int = 32, dropout: float = 0.2,
                 generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        hidden_dims = tuple(hidden_dims)
        self.encoder = MLPBlock(input_dim, hidden_dims, dropout, dtype)
        self.fc_mu = Dense(hidden_dims[-1], latent_dim, dtype)
        self.fc_logvar = Dense(hidden_dims[-1], latent_dim, dtype)
        self.decoder = MLPBlock(latent_dim, tuple(reversed(hidden_dims)),
                                dropout, dtype)
        self.out = Dense(hidden_dims[0], input_dim, dtype)
        lecun_init_(self, generator)

    def encode(self, x: torch.Tensor,
               generator: torch.Generator | None = None):
        h = self.encoder(x, generator)
        return self.fc_mu(h), self.fc_logvar(h)

    def decode(self, z: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        return self.out(self.decoder(z, generator))

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """``(recon, mu, logvar, z)``.  The reparameterisation noise is
        ``eps`` when given, else drawn from ``generator``, which also draws
        the dropout masks in training mode."""
        mu, logvar = self.encode(x, generator)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                              device=mu.device)
        z = reparameterize(mu, logvar, eps)
        return self.decode(z, generator), mu, logvar, z

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder mean (ref ``get_latent_features``, :103-105); call on a
        model in ``eval()`` mode for serving."""
        return self.encode(x)[0]


def simple_vae_loss(recon, x, mu, logvar, beta: float = 0.8):
    """mean-MSE + beta * mean-KL (ref ``vae_loss``, ``Simple_VAE.py:108-114``),
    accumulated in float32 whatever the compute dtype.  Returns
    ``(loss, recon_loss, kl)``."""
    recon = recon.float()
    mu = mu.float()
    logvar = logvar.float()
    recon_loss = torch.mean((recon - x.float()) ** 2)
    kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return recon_loss + beta * kl, recon_loss, kl
