"""Plain float32 reference of the Hybrid VAE (``Convolutional_VAE.py``).

Audio: six 3x3 stride-2 convolutions with SAME padding (one zero row and
column at the high edge), 1 -> 32 -> 64 -> 128 -> 256 -> 512 -> 512, each
followed by BatchNorm and LeakyReLU(0.01), flattened in (H, W, C) order,
then a Linear to 1,024.  Text: 768 -> 256 -> 128, each Linear followed by
BatchNorm and LeakyReLU.  Fusion: Linear(1,152 -> 512) + ReLU, then the mu
and logvar heads of the latent size.  Decoder: z -> 512 (ReLU) -> 1,152
(ReLU), split into 1,024 for the audio and 128 for the text; audio 1,024
-> 512 x (H/64) x (W/64) (ReLU) -> five 3x3 stride-2 transposed
convolutions with BatchNorm and LeakyReLU, 512 -> 512 -> 256 -> 128 -> 64
-> 32, and a last one to 1 channel (SAME: the first 2H x 2W outputs);
text 128 -> 256 (BatchNorm, LeakyReLU) -> 768.  Loss: summed squared
error of the audio, plus ``text_loss_weight`` times that of the text,
plus ``beta`` times the summed KL divergence.  The noise of the
reparameterisation is drawn in every forward pass, in eval mode too.

Parameter names follow the port's module tree, so that one dict of
initial weights loads into both.  Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import (  # noqa: F401 (precision_of)
    BN,
    DTYPES,
    LEAKY_SLOPE,
    Lin,
    Products,
    noise,
    precision_of,
    split_rows,
)


class Conv(nn.Module):
    """3x3 stride-2 SAME convolution; ``weight`` is (F, C, 3, 3)."""

    def __init__(self, c: int, f: int, prod: Products):
        super().__init__()
        self.prod = prod
        self.fan_in = 9 * c
        self.weight = nn.Parameter(torch.empty(f, c, 3, 3))
        self.bias = nn.Parameter(torch.empty(f))

    def forward(self, x):
        return self.prod.conv2d(F.pad(x, (0, 1, 0, 1)), self.weight,
                                self.bias, 2)


class ConvT(nn.Module):
    """3x3 stride-2 SAME transposed convolution (input dilated by 2, padded
    (2, 1), kernel not flipped): ``conv_transpose2d`` with ``weight`` (C, F,
    3, 3) holding the flipped kernel, cut to the first 2H x 2W outputs."""

    def __init__(self, c: int, f: int, prod: Products):
        super().__init__()
        self.prod = prod
        self.fan_in = 9 * c
        self.weight = nn.Parameter(torch.empty(c, f, 3, 3))
        self.bias = nn.Parameter(torch.empty(f))

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        y = self.prod.conv_transpose2d(x, self.weight, self.bias, 2)
        return y[:, :, :2 * h, :2 * w]


class Encoder(nn.Module):
    def __init__(self, feats, prod):
        super().__init__()
        chans = [1, *feats]
        self.conv = nn.ModuleList(Conv(a, b, prod)
                                  for a, b in zip(chans[:-1], chans[1:]))
        self.norm = nn.ModuleList(BN(f) for f in feats)

    def forward(self, x):                 # (B, H, W, 1) -> (B, H*W*C / 4096)
        h = x.permute(0, 3, 1, 2)
        for conv, norm in zip(self.conv, self.norm):
            h = F.leaky_relu(norm(conv(h)), LEAKY_SLOPE)
        return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class Decoder(nn.Module):
    def __init__(self, feats, fhw, prod):
        super().__init__()
        chans = [feats[0], *feats[1:], 1]
        self.top = feats[0]
        self.fhw = fhw
        self.conv = nn.ModuleList(ConvT(a, b, prod)
                                  for a, b in zip(chans[:-1], chans[1:]))
        self.norm = nn.ModuleList(BN(f) for f in feats[1:])

    def forward(self, x):
        fh, fw = self.fhw
        h = x.reshape(x.shape[0], fh, fw, self.top).permute(0, 3, 1, 2)
        for conv, norm in zip(self.conv[:-1], self.norm):
            h = F.leaky_relu(norm(conv(h)), LEAKY_SLOPE)
        return self.conv[-1](h).permute(0, 2, 3, 1)


class HybridVAE(nn.Module):
    def __init__(self, cfg: dict, precision: str = "fp32"):
        super().__init__()
        prod = Products(precision)
        h, w = cfg["input_hw"]
        feats = list(cfg["trunk_features"])
        fhw = (h // 64, w // 64)
        flat = feats[-1] * fhw[0] * fhw[1]
        audio, text = cfg["audio_dense"], cfg["text_dim"]
        t1, t2 = cfg["text_hidden"]
        fusion, latent = cfg["fusion_dim"], cfg["latent_dim"]
        self.audio_dense = audio
        self.audio_encoder = Encoder(feats, prod)
        self.audio_fc = Lin(flat, audio, prod)
        self.text_fc1 = Lin(text, t1, prod)
        self.text_bn1 = BN(t1)
        self.text_fc2 = Lin(t1, t2, prod)
        self.text_bn2 = BN(t2)
        self.fc_fusion = Lin(audio + t2, fusion, prod)
        self.fc_mu = Lin(fusion, latent, prod)
        self.fc_logvar = Lin(fusion, latent, prod)
        self.decoder_input = Lin(latent, fusion, prod)
        self.decoder_split = Lin(fusion, audio + t2, prod)
        self.audio_decoder_fc = Lin(audio, flat, prod)
        self.audio_decoder = Decoder(feats[::-1], fhw, prod)
        self.text_dec_fc1 = Lin(t2, t1, prod)
        self.text_dec_bn = BN(t1)
        self.text_dec_fc2 = Lin(t1, text, prod)

    def forward(self, audio, text, gen):
        a = self.audio_fc(self.audio_encoder(audio))
        t = F.leaky_relu(self.text_bn1(self.text_fc1(text)), LEAKY_SLOPE)
        t = F.leaky_relu(self.text_bn2(self.text_fc2(t)), LEAKY_SLOPE)
        hid = torch.relu(self.fc_fusion(torch.cat([a, t], dim=-1)))
        mu, logvar = self.fc_mu(hid), self.fc_logvar(hid)
        eps = noise(mu.shape, mu, gen)
        z = mu + eps * torch.exp(0.5 * logvar)
        d = torch.relu(self.decoder_input(z))
        d = torch.relu(self.decoder_split(d))
        a_hid, t_hid = d[:, :self.audio_dense], d[:, self.audio_dense:]
        ra = self.audio_decoder(torch.relu(self.audio_decoder_fc(a_hid)))
        rt = F.leaky_relu(self.text_dec_bn(self.text_dec_fc1(t_hid)),
                          LEAKY_SLOPE)
        return ra, self.text_dec_fc2(rt), mu, logvar


def make_model(cfg: dict, device, precision: str = "fp32") -> HybridVAE:
    with torch.device("meta"):
        model = HybridVAE(cfg, precision)
    return model.to_empty(device=device).to(DTYPES[precision])


def objective(cfg: dict):
    beta, tw = float(cfg["beta"]), float(cfg["text_loss_weight"])

    def loss_fn(model, batch, gen, train):
        audio, text = batch
        ra, rt, mu, logvar = model(audio, text, gen)
        mse_a = torch.sum((ra - audio) ** 2)
        mse_t = torch.sum((rt - text) ** 2)
        kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
        return mse_a + tw * mse_t + beta * kl

    return loss_fn


def splits(cfg: dict, data: dict, seed: int):
    """``(train, val)`` arrays: the seeded 85/15 split of the rows."""
    tr, va = split_rows(data["mel"].shape[0], cfg["val_fraction"], seed)
    dev = data["mel"].device
    tr, va = torch.from_numpy(tr).to(dev), torch.from_numpy(va).to(dev)
    return ((data["mel"][tr], data["text"][tr]),
            (data["mel"][va], data["text"][va]))


def fit_settings(cfg: dict) -> dict:
    return {"batch_size": cfg["batch_size"],
            "learning_rate": cfg["learning_rate"], "loss_reduction": "sum",
            "loss_normalizer": cfg["loss_normalizer"]}
