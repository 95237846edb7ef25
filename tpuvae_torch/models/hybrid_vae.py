"""Hybrid conv+MLP VAE (counterpart of ``tpuvae/models/hybrid_vae.py``).

Audio trunk -> 16384 -> Linear 1024; text MLP 768 -> 256 -> 128
(+BN+LeakyReLU); fusion Linear(1152 -> 512)+ReLU -> mu / logvar(128).
Decoder: z -> 512(+ReLU) -> split-Linear 1024 + 128(+ReLU); audio
1024 -> 16384(+ReLU) -> transposed convs; text 128 -> 256(+BN+LeakyReLU)
-> 768.  Trained by ``pipelines.run_hybrid_vae`` and served by
``infer.ClipEncoder`` (``arch="hybrid"``).  ``dtype`` is the compute dtype,
as ``ConditionalVAE``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuvae_torch.models.cond_vae import (
    check_input_hw,
    draw_eps,
    multimodal_loss,
)
from tpuvae_torch.models.layers import (
    BatchNorm1d,
    ConvDecoderTrunk,
    ConvEncoderTrunk,
    Dense,
    lecun_init_,
    reparameterize,
)
from tpuvae_torch.ops.fusedconv import LEAKY_SLOPE


class HybridVAE(nn.Module):
    def __init__(self, latent_dim: int = 128, text_dim: int = 768,
                 input_hw: tuple = (128, 1024),
                 generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        h, w = check_input_hw(input_hw)
        self.input_hw = (h, w)
        self.audio_flat = 512 * (h // 64) * (w // 64)
        self.audio_encoder = ConvEncoderTrunk(dtype=dtype)
        self.audio_fc = Dense(self.audio_flat, 1024, dtype)
        self.text_fc1 = Dense(text_dim, 256, dtype)
        self.text_bn1 = BatchNorm1d(256, dtype)
        self.text_fc2 = Dense(256, 128, dtype)
        self.text_bn2 = BatchNorm1d(128, dtype)
        self.fc_fusion = Dense(1024 + 128, 512, dtype)
        self.fc_mu = Dense(512, latent_dim, dtype)
        self.fc_logvar = Dense(512, latent_dim, dtype)
        self.decoder_input = Dense(latent_dim, 512, dtype)
        self.decoder_split = Dense(512, 1024 + 128, dtype)
        self.audio_decoder_fc = Dense(1024, self.audio_flat, dtype)
        self.audio_decoder = ConvDecoderTrunk(feature_hw=(h // 64, w // 64),
                                              dtype=dtype)
        self.text_dec_fc1 = Dense(128, 256, dtype)
        self.text_dec_bn = BatchNorm1d(256, dtype)
        self.text_dec_fc2 = Dense(256, text_dim, dtype)
        lecun_init_(self, generator)

    def encode(self, audio, text):
        a = self.audio_fc(self.audio_encoder(audio))
        t = F.leaky_relu(self.text_bn1(self.text_fc1(text)), LEAKY_SLOPE)
        t = F.leaky_relu(self.text_bn2(self.text_fc2(t)), LEAKY_SLOPE)
        h = torch.relu(self.fc_fusion(torch.cat([a, t], dim=-1)))
        return self.fc_mu(h), self.fc_logvar(h)

    def decode(self, z):
        h = torch.relu(self.decoder_input(z))
        splits = torch.relu(self.decoder_split(h))
        a_hidden, t_hidden = splits[:, :1024], splits[:, 1024:]
        a = torch.relu(self.audio_decoder_fc(a_hidden))
        recon_audio = self.audio_decoder(a)
        t = F.leaky_relu(self.text_dec_bn(self.text_dec_fc1(t_hidden)),
                         LEAKY_SLOPE)
        return recon_audio, self.text_dec_fc2(t)

    def forward(self, audio, text, eps=None, generator=None):
        """``(recon_audio, recon_text, mu, logvar)``."""
        mu, logvar = self.encode(audio, text)
        z = reparameterize(mu, logvar, draw_eps(mu, eps, generator))
        recon_audio, recon_text = self.decode(z)
        return recon_audio, recon_text, mu, logvar

    def latent(self, audio, text):
        """Encoder mean; call on a model in ``eval()`` mode."""
        return self.encode(audio, text)[0]


def hybrid_loss(recon_audio, audio, recon_text, text, mu, logvar,
                alpha: float = 1.0, beta: float = 1.0,
                text_weight: float = 350.0):
    """sum-MSE(audio) + 350 * sum-MSE(text) + beta * sum-KL (ref
    ``loss_function``, ``Convolutional_VAE.py:187-194``; ``alpha`` is
    accepted and unused there, kept for the same signature)."""
    del alpha
    return multimodal_loss(recon_audio, audio, recon_text, text, mu, logvar,
                           beta, text_weight)
