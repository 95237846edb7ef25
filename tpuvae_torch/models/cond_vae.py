"""Conditional multi-modal VAE (counterpart of ``tpuvae/models/cond_vae.py``).

Audio conv trunk -> 16384; text MLP 768 -> 256 (+BN+LeakyReLU); fusion is
the concat [audio | text | one-hot genre] feeding mu / logvar(latent).  The
decoder concatenates [z | condition], projects to 16384 + 256, splits, and
runs the transposed-conv audio decoder and a 256 -> 512 -> 768 text decoder.
Audio is ``(B, H, W, 1)`` NHWC as in the JAX package; ``train()`` /
``eval()`` select batch or running BatchNorm statistics.  The trunk's
first two layers run through kernel 6 (``ops/fusedconv.py``) in float32.

``dtype="bfloat16"`` computes as the JAX model's ``dtype=jnp.bfloat16``:
the weights stay float32, every layer casts its input and weight to
bfloat16 (``layers.Dense``, ``Stride2Conv``, ``BatchNorm*``), and the
one-hot condition, float32, promotes the concatenations it joins to
float32, which the next layer casts back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuvae_torch.models.layers import (
    BatchNorm1d,
    ConvDecoderTrunk,
    ConvEncoderTrunk,
    Dense,
    lecun_init_,
    reparameterize,
)
from tpuvae_torch.ops.fusedconv import LEAKY_SLOPE


def check_input_hw(input_hw) -> tuple[int, int]:
    h, w = (int(v) for v in input_hw)
    if h <= 0 or w <= 0 or h % 64 or w % 64:
        raise ValueError(f"input_hw must be positive multiples of 64 (six "
                         f"stride-2 layers), got {tuple(input_hw)}")
    return h, w


def draw_eps(mu: torch.Tensor, eps, generator) -> torch.Tensor:
    """The reparameterisation noise: ``eps`` when given, else drawn from
    ``generator`` on ``mu``'s device, in ``mu``'s dtype."""
    if eps is not None:
        return eps
    return torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                       device=mu.device)


class ConditionalVAE(nn.Module):
    def __init__(self, latent_dim: int = 64, text_dim: int = 768,
                 num_classes: int = 10, input_hw: tuple = (128, 1024),
                 generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        h, w = check_input_hw(input_hw)
        self.input_hw = (h, w)
        self.audio_flat = 512 * (h // 64) * (w // 64)
        self.audio_encoder = ConvEncoderTrunk(dtype=dtype)
        self.text_fc = Dense(text_dim, 256, dtype)
        self.text_bn = BatchNorm1d(256, dtype)
        fused = self.audio_flat + 256 + num_classes
        self.fc_mu = Dense(fused, latent_dim, dtype)
        self.fc_logvar = Dense(fused, latent_dim, dtype)
        self.decoder_fc = Dense(latent_dim + num_classes,
                                self.audio_flat + 256, dtype)
        self.audio_decoder = ConvDecoderTrunk(feature_hw=(h // 64, w // 64),
                                              dtype=dtype)
        self.text_dec_fc1 = Dense(256, 512, dtype)
        self.text_dec_bn = BatchNorm1d(512, dtype)
        self.text_dec_fc2 = Dense(512, text_dim, dtype)
        lecun_init_(self, generator)

    def encode(self, audio, text, condition):
        """audio (B, H, W, 1) NHWC, text (B, text_dim), condition
        (B, num_classes) -> (mu, logvar)."""
        a = self.audio_encoder(audio)
        t = F.leaky_relu(self.text_bn(self.text_fc(text)), LEAKY_SLOPE)
        h = torch.cat([a, t, condition], dim=-1)
        return self.fc_mu(h), self.fc_logvar(h)

    def decode(self, z, condition):
        h = self.decoder_fc(torch.cat([z, condition], dim=-1))
        a_hidden, t_hidden = h[:, :self.audio_flat], h[:, self.audio_flat:]
        recon_audio = self.audio_decoder(a_hidden)
        t = F.leaky_relu(self.text_dec_bn(self.text_dec_fc1(t_hidden)),
                         LEAKY_SLOPE)
        return recon_audio, self.text_dec_fc2(t)

    def forward(self, audio, text, condition, eps=None, generator=None):
        """``(recon_audio, recon_text, mu, logvar)``; the noise is ``eps``
        when given, else drawn from ``generator``."""
        mu, logvar = self.encode(audio, text, condition)
        z = reparameterize(mu, logvar, draw_eps(mu, eps, generator))
        recon_audio, recon_text = self.decode(z, condition)
        return recon_audio, recon_text, mu, logvar

    def latent(self, audio, text, condition):
        """Encoder mean; call on a model in ``eval()`` mode."""
        return self.encode(audio, text, condition)[0]


def multimodal_loss(recon_audio, audio, recon_text, text, mu, logvar,
                    beta: float, text_weight: float):
    """sum-MSE(audio) + text_weight * sum-MSE(text) + beta * sum-KL, summed
    in float32 over ~131k audio dims per clip.  Returns
    ``(total, mse_audio, mse_text, kl)``."""
    mu = mu.float()
    logvar = logvar.float()
    mse_audio = torch.sum((recon_audio.float() - audio.float()) ** 2)
    mse_text = torch.sum((recon_text.float() - text.float()) ** 2)
    kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
    return mse_audio + text_weight * mse_text + beta * kl, mse_audio, mse_text, kl


def cvae_loss(recon_audio, audio, recon_text, text, mu, logvar,
              beta: float = 4.0, text_weight: float = 200.0):
    """sum-MSE(audio) + 200 * sum-MSE(text) + beta * sum-KL (ref
    ``cvae_loss_function``, ``Conditional_VAE.py:233-246``; the 200x
    balances ~130k audio dims against 768 text dims)."""
    return multimodal_loss(recon_audio, audio, recon_text, text, mu, logvar,
                           beta, text_weight)
