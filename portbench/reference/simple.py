"""Plain float32 reference of the Simple VAE (``Simple_VAE.py``).

Encoder: input -> 128 -> 64 -> 32, each Linear followed by BatchNorm, ReLU
and Dropout; mu and logvar heads of the latent size; decoder: latent -> 32
-> 64 -> 128 the same way, then a Linear back to the input.  Loss: the
mean squared error plus ``beta`` times the mean KL divergence.  Draws, in
order: a dropout mask after each encoder layer (training only), the noise
of the reparameterisation, a mask after each decoder layer.  No split: the
fit monitors the training loss and restores the best weights.

Parameter names follow the port's module tree.  Imports nothing of the
program.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.common import (  # noqa: F401 (precision_of)
    BN,
    DTYPES,
    Lin,
    Products,
    dropout,
    noise,
    precision_of,
)


class Block(nn.Module):
    def __init__(self, n_in: int, dims, rate: float, prod: Products):
        super().__init__()
        d = [n_in, *dims]
        self.dense = nn.ModuleList(Lin(a, b, prod) for a, b in zip(d[:-1], d[1:]))
        self.norm = nn.ModuleList(BN(h) for h in dims)
        self.rate = rate

    def forward(self, x, gen):
        for dense, norm in zip(self.dense, self.norm):
            x = dropout(torch.relu(norm(dense(x))), self.rate, self.training,
                        gen)
        return x


class SimpleVAE(nn.Module):
    def __init__(self, cfg: dict, precision: str = "fp32"):
        super().__init__()
        prod = Products(precision)
        dims = list(cfg["hidden_dims"])
        n_in, latent, rate = cfg["input_dim"], cfg["latent_dim"], cfg["dropout"]
        self.encoder = Block(n_in, dims, rate, prod)
        self.fc_mu = Lin(dims[-1], latent, prod)
        self.fc_logvar = Lin(dims[-1], latent, prod)
        self.decoder = Block(latent, dims[::-1], rate, prod)
        self.out = Lin(dims[0], n_in, prod)

    def forward(self, x, gen):
        h = self.encoder(x, gen)
        mu, logvar = self.fc_mu(h), self.fc_logvar(h)
        eps = noise(mu.shape, mu, gen)
        z = mu + eps * torch.exp(0.5 * logvar)
        return self.out(self.decoder(z, gen)), mu, logvar


def make_model(cfg: dict, device, precision: str = "fp32") -> SimpleVAE:
    with torch.device("meta"):
        model = SimpleVAE(cfg, precision)
    return model.to_empty(device=device).to(DTYPES[precision])


def objective(cfg: dict):
    beta = float(cfg["beta"])

    def loss_fn(model, batch, gen, train):
        (x,) = batch
        recon, mu, logvar = model(x, gen)
        rec = torch.mean((recon - x) ** 2)
        kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
        return rec + beta * kl

    return loss_fn


def splits(cfg: dict, data: dict, seed: int):
    """Every row trains; there is no validation set."""
    return (data["features"],), None


def fit_settings(cfg: dict) -> dict:
    return {"batch_size": cfg["batch_size"],
            "learning_rate": cfg["learning_rate"], "loss_reduction": "mean",
            "loss_normalizer": cfg["loss_normalizer"]}
