"""Plain autoencoder baseline (counterpart of
``tpuvae/models/autoencoder.py``; ref ``Conditional_VAE.py:252-273``).

Encoder input -> 1024 -> 256 -> latent with ReLU between Linears; mirrored
decoder.  ``dense`` holds the six Linears in flax's ``Dense_0`` ..
``Dense_5`` order.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuvae_torch.models.layers import lecun_init_


class SimpleAutoencoder(nn.Module):
    def __init__(self, input_dim: int = 290, latent_dim: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [input_dim, 1024, 256, latent_dim, 256, 1024, input_dim]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        lecun_init_(self, generator)

    def forward(self, x: torch.Tensor):
        """``(recon, z)``."""
        z = self.dense[2](torch.relu(self.dense[1](torch.relu(self.dense[0](x)))))
        h = torch.relu(self.dense[4](torch.relu(self.dense[3](z))))
        return self.dense[5](h), z


def ae_loss(recon: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """mean-MSE (ref inline loop, ``Conditional_VAE.py:441``)."""
    return torch.mean((recon - x) ** 2)
