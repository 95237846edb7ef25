"""The conv layers, trunks and the three models built on them against flax,
with weights carried through ``tpuvae_torch.convert``.

Small size: ``input_hw = (64, 128)`` (one 1 x 2 feature map after six
stride-2 layers), batch 4, full channel widths (the flax models fix them).
flax variables get seeded non-trivial BatchNorm statistics, go through
``from_flax`` and both models take the same inputs and the same
reparameterisation noise ``jax.random.normal(rng, (B, latent))``.

Tolerances.  One conv layer on a one-hot image: equal sums of at most 9
terms, atol 1e-6.  Eval-mode forward: rtol 1e-4 / atol 1e-5 (twelve fp32
conv layers in two libraries).  Train-mode forward: rtol 1e-3 / atol 1e-4 —
BatchNorm over a batch of 4 with a 1 x 2 feature map divides by standard
deviations of 8 samples, which amplifies rounding.  BatchNorm running
statistics after one training step: rtol 1e-6 as ``test_torch_train.py``,
with atol 1e-7 for means near 0 (0.01 x a batch mean ~1e-3 whose fp32
rounding no relative bound covers).  Gradient of the summed CVAE loss
(~1e6): each tensor within 2e-2 of its largest entry and 5e-3 in relative
L2 norm.  Both packages agree with an fp64 run of the port to ~2e-6 except
where a LeakyReLU pre-activation lies within fp32 rounding of zero and
takes the other slope (0.01 against 1) in one of them: with these seeds
one element of ~400 k in the decoder does, which moves single entries of
the decoder's weight gradients by up to 0.8% of the largest and their L2
norm by 0.1-0.2%; every other tensor agrees to 1e-4.  A wrong padding,
kernel flip or BatchNorm rule is an error of order 1.  The pre-BatchNorm
biases, whose gradient is 0 in exact arithmetic, are held to those bounds
at the scale of their layer's weight gradient.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax import lax

torch.set_num_threads(2)

HW = (64, 128)
B = 4
_DIMNUMS = ("NHWC", "HWIO", "NHWC")


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def _unflat(flat: dict):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _seed_stats(flat: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        if k.startswith("batch_stats/"):
            out[k] = (rng.uniform(0.5, 1.5, v.shape) if k.endswith("/var")
                      else rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
        elif k.endswith("/bias") or k.endswith("/scale"):
            out[k] = (v + rng.normal(0.0, 0.05, v.shape)).astype(np.float32)
    return out


def _data(seed=0, n_classes=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, *HW, 1)).astype(np.float32),
            rng.standard_normal((B, 768)).astype(np.float32),
            np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, B)])


# -- single layers on one-hot images ------------------------------------------

@pytest.mark.parametrize("corner", [(0, 0), (0, 5), (3, 0), (3, 5)])
@pytest.mark.parametrize("layer", ["conv", "conv_transpose"])
def test_stride2_layers_match_lax_on_one_hot_corners(layer, corner):
    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.models.layers import Stride2Conv, Stride2ConvTranspose

    rng = np.random.default_rng(5)
    x = np.zeros((1, 4, 6, 3), np.float32)
    x[0, corner[0], corner[1], 1] = 1.0
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    if layer == "conv":
        want = lax.conv_general_dilated(x, w, (2, 2), "SAME",
                                        dimension_numbers=_DIMNUMS) + b
        mod, name = Stride2Conv(3, 5), "Conv_0"
    else:
        want = lax.conv_transpose(x, w, strides=(2, 2), padding="SAME",
                                  dimension_numbers=_DIMNUMS) + b
        mod, name = Stride2ConvTranspose(3, 5), "ConvTranspose_0"
    sd = from_flax({f"params/audio_decoder/{name}/kernel": w,
                    f"params/audio_decoder/{name}/bias": b})
    mod.load_state_dict({k.rsplit(".", 1)[1]: v for k, v in sd.items()})
    got = mod(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)


def test_lecun_init_draws_flax_variance_for_conv_kernels():
    from tpuvae_torch.models.layers import ConvDecoderTrunk, ConvEncoderTrunk, lecun_init_

    gen = torch.Generator().manual_seed(0)
    enc = lecun_init_(ConvEncoderTrunk(), gen)
    dec = lecun_init_(ConvDecoderTrunk(), gen)
    for conv in (enc.conv[4], enc.conv[5], dec.conv[0], dec.conv[1]):
        std = float(conv.weight.detach().std())
        want = (9 * conv.in_channels) ** -0.5        # variance 1 / fan_in
        assert abs(std / want - 1.0) < 0.02, (std, want)
        assert float(conv.weight.detach().abs().max()) <= 2.0 * want / 0.87962566 + 1e-6
        assert float(conv.bias.detach().abs().max()) == 0.0
    assert float(enc.norm[0].running_var.min()) == 1.0


# -- models ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _build(kind: str):
    """(flax model, seeded flax variables (flat), port model, inputs); built
    once per kind — callers that train copy the port model first."""
    from tpuvae.models import ConditionalVAE as JC
    from tpuvae.models import HybridVAE as JH

    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.models import ConditionalVAE, HybridVAE

    key = jax.random.PRNGKey(0)
    audio, text, cond = _data()
    if kind == "cvae":
        jm = JC(num_classes=3, input_hw=HW)
        inputs = (audio, text, cond)
        model = ConditionalVAE(num_classes=3, input_hw=HW)
    else:
        jm = JH(input_hw=HW)
        inputs = (audio, text)
        model = HybridVAE(input_hw=HW)
    v = jm.init({"params": key, "dropout": key},
                *[jnp.asarray(a[:1]) for a in inputs], key, train=False)
    flat = _seed_stats(_flat(v), seed=1)
    model.load_state_dict(from_flax(flat))
    return jm, flat, model, inputs


@pytest.fixture(scope="module", params=["cvae", "hybrid"])
def pair(request):
    jm, flat, model, inputs = _build(request.param)
    rk = jax.random.PRNGKey(5)
    latent = 64 if request.param == "cvae" else 128
    eps = np.asarray(jax.random.normal(rk, (B, latent)))
    jin = [jnp.asarray(a) for a in inputs]
    variables = _unflat(flat)
    ev = jm.apply(variables, *jin, rk, train=False)
    tr, mutated = jm.apply(variables, *jin, rk, train=True,
                           mutable=["batch_stats"])
    return {"kind": request.param, "flat": flat, "model": model,
            "inputs": inputs, "eps": eps,
            "eval": [np.asarray(o) for o in ev],
            "train": [np.asarray(o) for o in tr],
            "stats1": _flat(mutated)}


def test_model_round_trips_through_convert(pair):
    from tpuvae_torch.convert import from_flax, to_flax

    flat = pair["flat"]
    back = to_flax(from_flax(flat))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sd = pair["model"].state_dict()
    assert set(from_flax(flat)) == set(sd)


def test_model_eval_forward_matches_flax(pair):
    model = copy.deepcopy(pair["model"]).eval()
    with torch.no_grad():
        got = model(*[torch.tensor(a) for a in pair["inputs"]],
                    torch.tensor(pair["eps"]))
        mu = model.latent(*[torch.tensor(a) for a in pair["inputs"]])
    for name, g, w in zip(("recon_audio", "recon_text", "mu", "logvar"), got,
                          pair["eval"]):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(mu.numpy(), pair["eval"][2], rtol=1e-4, atol=1e-5)


def test_model_train_forward_and_running_stats_match_flax(pair):
    from tpuvae_torch.convert import to_flax

    model = copy.deepcopy(pair["model"]).train()
    got = model(*[torch.tensor(a) for a in pair["inputs"]],
                torch.tensor(pair["eps"]))
    for name, g, w in zip(("recon_audio", "recon_text", "mu", "logvar"), got,
                          pair["train"]):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    new = to_flax(model.state_dict())
    for k, want in pair["stats1"].items():
        np.testing.assert_allclose(new[k], want, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # every BatchNorm moved, the kernel-fed ones of trunk layers 0-1 included
    for k, before in pair["flat"].items():
        if k.startswith("batch_stats/"):
            assert not np.array_equal(new[k], before), k


@pytest.mark.parametrize("module", ["encoder", "decoder"])
def test_trunks_match_flax_in_both_modes(module):
    from tpuvae.models.layers import ConvDecoderTrunk as JD
    from tpuvae.models.layers import ConvEncoderTrunk as JE

    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.models.layers import ConvDecoderTrunk, ConvEncoderTrunk

    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(1)
    if module == "encoder":
        jm, prefix = JE(), "audio_encoder"
        x = rng.standard_normal((B, *HW, 1)).astype(np.float32)
        port = ConvEncoderTrunk()
    else:
        jm, prefix = JD(feature_hw=(1, 2)), "audio_decoder"
        x = rng.standard_normal((B, 512 * 2)).astype(np.float32)
        port = ConvDecoderTrunk(feature_hw=(1, 2))
    flat = _seed_stats(_flat(jm.init(key, jnp.asarray(x[:1]), train=False)), 3)
    named = {k.replace("/", f"/{prefix}/", 1): v for k, v in flat.items()}
    port.load_state_dict({k.split(".", 1)[1]: v
                          for k, v in from_flax(named).items()})
    variables = _unflat(flat)
    want_eval = jm.apply(variables, jnp.asarray(x), train=False)
    want_train, _ = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = port.eval()(torch.tensor(x))
        got_train = port.train()(torch.tensor(x))
    assert tuple(got_eval.shape) == want_eval.shape
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train),
                               rtol=1e-3, atol=1e-4)


def test_autoencoder_matches_flax_and_round_trips():
    from tpuvae.models import SimpleAutoencoder as JA
    from tpuvae.models import ae_loss as jax_ae_loss

    from tpuvae_torch.convert import from_flax, to_flax
    from tpuvae_torch.models import SimpleAutoencoder, ae_loss

    x = np.random.default_rng(4).standard_normal((6, 290)).astype(np.float32)
    jm = JA(input_dim=290, latent_dim=64)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x[:1]))
    flat = _flat(v)
    model = SimpleAutoencoder(290, 64)
    model.load_state_dict(from_flax(flat))
    back = to_flax(model.state_dict())
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    wr, wz = jm.apply(v, jnp.asarray(x))
    gr, gz = model(torch.tensor(x))
    np.testing.assert_allclose(gr.detach().numpy(), np.asarray(wr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gz.detach().numpy(), np.asarray(wz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ae_loss(gr, torch.tensor(x)).detach()),
                               float(jax_ae_loss(wr, jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["cvae", "hybrid"])
def test_loss_matches_jax(kind):
    from tpuvae.models import cvae_loss as jc
    from tpuvae.models import hybrid_loss as jh

    from tpuvae_torch.models import cvae_loss, hybrid_loss

    rng = np.random.default_rng(8)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((3, 64, 128, 1), (3, 64, 128, 1), (3, 768), (3, 768), (3, 64),
             (3, 64))]
    want = (jc if kind == "cvae" else jh)(*[jnp.asarray(a) for a in arrs])
    got = (cvae_loss if kind == "cvae" else hybrid_loss)(
        *[torch.tensor(a) for a in arrs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_cvae_loss_gradient_through_the_fused_function_matches_jax_grad():
    """The gradient of the summed CVAE loss through the trunk's fused
    ``autograd.Function`` against ``jax.grad`` of the flax model on the
    same weights and noise."""
    from tpuvae.models import cvae_loss as jax_loss

    from tpuvae_torch.convert import to_flax
    from tpuvae_torch.models import cvae_loss

    jm, flat, model, inputs = _build("cvae")
    model = copy.deepcopy(model)
    rk = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(rk, (B, 64)))
    variables = _unflat(flat)
    jin = [jnp.asarray(a) for a in inputs]

    def loss_of(params):
        (ra, rt, mu, lv), _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *jin, rk, train=True, mutable=["batch_stats"])
        return jax_loss(ra, jin[0], rt, jin[1], mu, lv)[0]

    want_loss, want = jax.value_and_grad(loss_of)(variables["params"])
    want = _flat({"params": want})

    tin = [torch.tensor(a) for a in inputs]
    model.train()
    ra, rt, mu, lv = model(*tin, torch.tensor(eps))
    loss = cvae_loss(ra, tin[0], rt, tin[1], mu, lv)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = to_flax({n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if k.endswith("/bias") and (k.replace("/bias", "/kernel") in want) and (
                "Conv" in k or k.split("/")[1] in ("text_fc", "text_dec_fc1")):
            # followed by BatchNorm: 0 in exact arithmetic, noise on both sides
            scale = float(np.abs(want[k.replace("/bias", "/kernel")]).max())
            if k.endswith("ConvTranspose_5/bias"):
                scale = float(np.abs(w).max())   # the last layer has no BN
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-2 * scale,
                                   err_msg=k)
        l2 = float(np.linalg.norm(got[k] - w))
        ref = max(float(np.linalg.norm(w)), scale)
        assert l2 <= 5e-3 * ref, (k, l2, ref)
