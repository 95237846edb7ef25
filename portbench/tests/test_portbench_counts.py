"""The work counters, against counts made another way: taps counted by
running the convolution on ones, multiply-adds written out by hand, the
port's own parameter count, and the kernel table's 151.0 + 201.4 MB (a
bound of 0.1052 ms) for kernel 6 at 32 x 128 x 1024."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from portbench.models import hybrid, simple
from portbench.peaks import H100_SXM

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
HYBRID = json.loads((CONFIGS / "hybrid_vae.json").read_text())
SIMPLE = json.loads((CONFIGS / "simple_vae.json").read_text())


@pytest.mark.parametrize("ho, wo", [(1, 1), (2, 16), (3, 5), (32, 256)])
def test_conv_taps_counted_by_running_ones(ho, wo):
    x = torch.ones(1, 1, 2 * ho, 2 * wo, dtype=torch.float64)
    k = torch.ones(1, 1, 3, 3, dtype=torch.float64)
    conv = F.conv2d(F.pad(x, (0, 1, 0, 1)), k, stride=2).sum()
    z = torch.ones(1, 1, ho, wo, dtype=torch.float64)
    convt = F.conv_transpose2d(z, k, stride=2)[:, :, :2 * ho, :2 * wo].sum()
    assert conv == convt == hybrid._taps(ho, wo)


def test_hybrid_layers_by_hand_at_a_tiny_shape():
    cfg = dict(HYBRID, input_hw=[64, 64])
    macs = dict((n, m) for n, m, _ in hybrid.layers(cfg))
    # encoder outputs 32, 16, 8, 4, 2, 1 pixels a side: (3 s - 1)^2 taps
    assert macs["enc_conv0"] == 95 * 95 * 1 * 32
    assert macs["enc_conv1"] == 47 * 47 * 32 * 64
    assert macs["enc_conv5"] == 2 * 2 * 512 * 512
    # decoder inputs 1, 2, ..., 32 pixels a side
    assert macs["dec_conv0"] == 2 * 2 * 512 * 512
    assert macs["dec_conv5"] == 95 * 95 * 32 * 1
    assert macs["audio_fc"] == 512 * 1024          # 512 x 1 x 1 flattened
    assert macs["text_dec_fc2"] == 256 * 768
    w = hybrid.work(cfg, 40, 8)
    total = sum(macs.values())
    no_input_grad = macs["enc_conv0"] + macs["text_fc1"]
    assert w["eval_flops_per_row"] == 2 * total
    assert w["train_flops_per_row"] == 2 * (3 * total - no_input_grad)
    assert w["steps_per_epoch"] == 2
    assert w["epoch_flops"] == (40 * w["train_flops_per_row"]
                                + 8 * w["eval_flops_per_row"]
                                + 2 * 12 * w["n_params"])


def test_simple_layers_by_hand():
    # 370-128-64-32, heads 32-32 twice, 32-32-64-128, 128-370
    macs = (370 * 128 + 128 * 64 + 64 * 32 + 2 * 32 * 32
            + 32 * 32 + 32 * 64 + 64 * 128 + 128 * 370)
    assert macs == 118_272
    assert sum(m for _, m, _ in simple.layers(SIMPLE)) == macs
    w = simple.work(SIMPLE, 1336, 0)
    assert w["train_flops_per_row"] == 2 * (3 * macs - 370 * 128)
    assert w["steps_per_epoch"] == 42


@pytest.mark.parametrize("family, cfg", [("hybrid", HYBRID), ("simple", SIMPLE)])
def test_parameter_count_is_the_ports(family, cfg):
    from tpuvae_torch.models import HybridVAE, SimpleVAE

    with torch.device("meta"):
        model = (HybridVAE(latent_dim=cfg["latent_dim"], text_dim=cfg["text_dim"],
                           input_hw=tuple(cfg["input_hw"]))
                 if family == "hybrid" else
                 SimpleVAE(cfg["input_dim"], tuple(cfg["hidden_dims"]),
                           cfg["latent_dim"], cfg["dropout"]))
    counter = hybrid if family == "hybrid" else simple
    assert counter.n_params(cfg) == sum(p.numel() for p in model.parameters())


def test_kernel6_bytes_match_the_kernel_table():
    pw = hybrid.pair_work(32, 128, 1024)
    assert round(pw["conv0_bytes"] / 1e6, 1) == 151.0
    assert round(pw["conv1_bytes"] / 1e6, 1) == 201.4
    bound = hybrid.pair_bound_s(32, 128, 1024, H100_SXM)
    assert round(bound["conv0"] * 1e3, 4) == 0.0451
    assert round(bound["conv1"] * 1e3, 4) == 0.0601
    # both halves bound by their bytes: the products are far under them
    assert pw["conv1_flops"] / H100_SXM["tf32_flops_per_s"] < bound["conv1"]


def test_kernel6_by_hand_at_a_tiny_shape():
    pw = hybrid.pair_work(2, 64, 64)
    # conv0: 2 images of 64 x 64 in, 2 x 32 x 32 x 32 out, 3x3x32 + 32
    # weights, 2 x 32 statistics
    assert pw["conv0_bytes"] == 4 * (2 * 4096 + 288 + 32 + 2 * 32768 + 64)
    assert pw["conv1_bytes"] == 4 * (2 * 32768 + 64 + 18432 + 64
                                     + 2 * 16 * 16 * 64 + 128)
    assert pw["conv0_flops"] == 2 * 2 * 95 * 95 * 32
    assert pw["conv1_flops"] == 2 * 2 * 47 * 47 * 32 * 64


def test_kernel6_calls_an_epoch():
    per = hybrid.pair_epoch(HYBRID, 1135, 201, H100_SXM)
    assert per["calls"] == 36 + 7
    full = hybrid.pair_bound_s(32, 128, 1024, H100_SXM)
    # 35 + 6 full batches, a ragged one of 15 and one of 9
    part = sum(hybrid.pair_bound_s(b, 128, 1024, H100_SXM)["conv1"]
               for b in (15, 9))
    assert per["bound_s"]["conv1"] == pytest.approx(41 * full["conv1"] + part)
