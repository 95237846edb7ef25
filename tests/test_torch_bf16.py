"""bfloat16 compute (``compute_dtype="bfloat16"``) of the port against the
JAX package's flax models at ``dtype=jnp.bfloat16``, on the CPU.

Weights stay float32 in both; each layer casts its input and weight to
bfloat16 and rounds its output there: a Dense or conv layer twice (the
product, then ``+ bias`` in bf16), BatchNorm once (float32 statistics and
affine map from the widened input).  flax's bf16 layers, measured here,
round exactly so (``round(round(conv) + bias)`` matched every element).

The contract, written from the measured spread of flax bf16 against flax
fp32 on the same inputs, weights and noise (seeded BatchNorm statistics,
``input_hw = (64, 128)``, batch 4; the Simple VAE at 370 wide, batch 16).
The measured numbers below are ``tools/bf16_contract.py``'s on these
inputs:

* Single layers, against flax bf16 on the same bf16 values: within one
  bf16 ulp at each rounding point: ``ulp(product) + ulp(output)`` for Dense
  and the convs, ``ulp(output)`` for BatchNorm in training and eval mode
  (ulps at the larger magnitude of the two sides).  Measured: Dense bit
  equal at 768->256, 2048->64 and 512->1152; the convs equal but for at
  most 6e-5 of the elements, where the two libraries' float32 sums of one
  product round to neighbouring bf16 values and the bias add's ties then
  part them by up to 2 ulps of the output (0.89-1.0 of the bound).
  Running statistics after a training step within the fp32 tolerance
  (rtol 1e-6 / atol 1e-7).
* Trunks and models: each output's relative L2 error against flax bf16 at
  most flax fp32's (``SPREAD_L2``: the port sits closer to flax bf16 than
  flax fp32 does), and its largest element error at most 3 x flax fp32's
  largest (``SPREAD_MAX``).  Measured ratios, L2 / max: Simple VAE 0 / 0
  (bit equal); CVAE eval 0.36-0.77 / 0.49-1.13, train 0.47-0.79 /
  0.55-0.88; Hybrid eval 0.59-0.86 / 0.43-1.26, train 0.53-0.85 /
  0.42-0.97; the card against the CPU (``chip_smoke.py`` phase 19, full
  width) 0.36-0.90 / 0.44-1.87.  The largest of a few hundred rounding
  differences is an extreme value whose ratio scatters between pairs of
  bf16 implementations; 3x still flags a local fault, which shows at
  order one.  The loss: the JAX loss function of the port's own outputs
  (rtol 1e-6), and against flax bf16's within flax fp32's distance plus
  ``LOSS_RTOL`` = 1e-4 of the loss (measured: Simple 1.3e-7 against
  4.4e-4, CVAE 1.1e-4 against 9.1e-4, Hybrid 3.7e-5 against 2.2e-5).  A
  sum of ~131k squared errors whose roundings partly cancel: both
  distances are random walks, not ordered one against the other.
* Gradients of the loss: the whole gradient's relative L2 error at most
  flax fp32's (measured ratios 0.06, 0.79, 0.61 for Simple, CVAE,
  Hybrid), and each tensor's at most 1.5 x flax fp32's on that tensor
  (measured up to 1.15, 1.29, 1.25): where a tensor's true gradient
  cancels, as ``fc_mu``'s bias in the CVAE, its bf16 gradient is
  rounding noise in both implementations, the LeakyReLU-at-zero caveat
  of the fp32 tests many times over.  Pre-BatchNorm biases (0 in exact
  arithmetic) are measured at the scale of their layer's weight
  gradient, as in ``test_torch_conv_models.py``.

flax runs op by op here: under ``jit`` XLA's CPU backend keeps float32
between bf16 ops, which puts the jitted bf16 model farther from op-by-op
flax than flax fp32 is.
The fp32 tolerances of the other test files are unchanged.  Bundles
written by the JAX bf16 pipelines are served by the port's
``ClipEncoder`` within the same forward contract (spread: the JAX encoder
on the same bundle at fp32), with equal cluster ids.
"""

import copy
import functools
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_conv_models import B, HW, _data, _flat, _seed_stats, _unflat

torch.set_num_threads(2)

SPREAD_L2 = 1.0     # port's relative L2 error <= this x flax fp32's
# port's largest element error <= this x flax fp32's.  3.0, not the 1.5
# first written: on the card the Hybrid's training-mode logvar measures
# 1.87 against the CPU (chip_smoke.py phase 19; tools/bf16_op_trace.py on
# an H100).  Op by op, each fed the CPU's input: every Dense (fc_fusion
# and fc_logvar bit-equal) and BatchNorm stays within one bf16 ulp per
# rounding point, while cuDNN's bf16 convolutions differ by up to 13x
# that (their sums are not float32 sums of exact products; the port calls
# them in flax's op order, product then bias).  The trunk carries those
# differences into audio_fc's 16,384 inputs, fc_fusion and fc_logvar mix
# them into every output, and training-mode logvar's yardstick is the
# forward's smallest (0.24% of its largest value): one element reads 1.87
# while its L2 ratio is 0.56.
SPREAD_MAX = 3.0
GRAD_TENSOR = 1.5   # each gradient tensor's relative L2 <= this x flax's
LOSS_RTOL = 1e-4    # the loss: flax fp32's distance + this x the loss


def _ulp(x: np.ndarray) -> np.ndarray:
    """bfloat16's spacing at |x|: 2^(floor(log2 |x|) - 7)."""
    a = np.abs(np.asarray(x, np.float32))
    _, e = np.frexp(a)
    return np.ldexp(1.0, np.where(a == 0, -125, e) - 8)


def _bf16(x) -> np.ndarray:
    """float32 array of ``x`` rounded to bfloat16 (nearest even)."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _rel(a, b, ref) -> tuple[float, float]:
    """(largest element error, L2 error), both relative to ``ref``."""
    a, b, ref = (np.asarray(v, np.float64) for v in (a, b, ref))
    return (float(np.abs(a - b).max() / np.abs(ref).max()),
            float(np.linalg.norm(a - b) / np.linalg.norm(ref)))


def _within_spread(name, got, want16, want32):
    """The forward contract: ``got`` (port bf16) against ``want16`` (flax
    bf16), flax fp32's distance ``want32`` as the yardstick."""
    p_max, p_l2 = _rel(got, want16, want32)
    s_max, s_l2 = _rel(want16, want32, want32)
    assert p_l2 <= SPREAD_L2 * s_l2, (name, p_l2, s_l2)
    assert p_max <= SPREAD_MAX * s_max, (name, p_max, s_max)


# -- single layers ------------------------------------------------------------

def _conv_case(kind, cin, cout, hw, rng):
    from tpuvae.models.layers import Stride2Conv as JConv
    from tpuvae.models.layers import Stride2ConvTranspose as JConvT

    from tpuvae_torch.models.layers import Stride2Conv, Stride2ConvTranspose

    x = _bf16(rng.standard_normal((4, *hw, cin)))
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    v = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    jm = (JConv if kind == "conv" else JConvT)(cout, dtype=jnp.bfloat16)
    want = np.asarray(jm.apply(v, jnp.asarray(x)).astype(jnp.float32))
    if kind == "conv":
        mod = Stride2Conv(cin, cout, torch.bfloat16)
        mod.weight.data = torch.tensor(w).permute(3, 2, 0, 1).contiguous()
    else:
        mod = Stride2ConvTranspose(cin, cout, torch.bfloat16)
        mod.weight.data = torch.tensor(w[::-1, ::-1].copy()).permute(
            2, 3, 0, 1).contiguous()
    mod.bias.data = torch.tensor(b)
    got = mod(torch.tensor(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    return got.permute(0, 2, 3, 1).float().detach().numpy(), want, _bf16(b)


def _dense_case(fin, fout, rng):
    from flax import linen as nn

    from tpuvae_torch.models.layers import Dense

    x = _bf16(rng.standard_normal((8, fin)))
    w = (rng.standard_normal((fin, fout)) / np.sqrt(fin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(fout)).astype(np.float32)
    v = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    want = np.asarray(nn.Dense(fout, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x)).astype(jnp.float32))
    mod = Dense(fin, fout, torch.bfloat16)
    mod.weight.data = torch.tensor(w.T.copy())
    mod.bias.data = torch.tensor(b)
    got = mod(torch.tensor(x))
    assert got.dtype == torch.bfloat16
    return got.float().detach().numpy(), want, _bf16(b)


@pytest.mark.parametrize("layer", ["dense", "conv", "conv_transpose"])
def test_product_layers_round_twice_within_one_ulp_each(layer):
    rng = np.random.default_rng(0)
    if layer == "dense":
        cases = [_dense_case(a, b, rng) for a, b in
                 ((768, 256), (2048, 64), (512, 1152))]
    else:
        kind = "conv" if layer == "conv" else "convT"
        cases = [_conv_case(kind, *c, rng) for c in
                 ((1, 32, (64, 128)), (32, 64, (32, 64)), (256, 512, (4, 8)))]
    for got, want, bias in cases:
        assert got.shape == want.shape
        big = np.maximum(np.abs(got), np.abs(want))
        product = np.maximum(big, np.abs(want - bias))
        err = np.abs(got - want)
        assert (err <= _ulp(product) + _ulp(big)).all(), float(err.max())
        assert np.mean(err > 0) <= 1e-3


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("rank", [2, 4], ids=["1d", "2d"])
def test_batch_norm_rounds_once_within_one_ulp(rank, mode):
    from flax import linen as nn

    from tpuvae_torch.models.layers import BatchNorm1d, BatchNorm2d

    rng = np.random.default_rng(1)
    shape = (8, 256) if rank == 2 else (4, 16, 32, 64)
    c = shape[-1]
    x = _bf16(3.0 * rng.standard_normal(shape) + 1.0)
    scale, bias = (rng.uniform(0.5, 1.5, c).astype(np.float32),
                   rng.normal(0, 0.1, c).astype(np.float32))
    mean, var = (rng.normal(0, 0.1, c).astype(np.float32),
                 rng.uniform(0.5, 1.5, c).astype(np.float32))
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    jm = nn.BatchNorm(use_running_average=mode == "eval", dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    if mode == "train":
        want, mutated = jm.apply(v, xj, mutable=["batch_stats"])
    else:
        want = jm.apply(v, xj)
    bn = (BatchNorm1d if rank == 2 else BatchNorm2d)(c, torch.bfloat16)
    for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                 (bn.running_var, var)):
        t.data = torch.tensor(a)
    bn.train(mode == "train")
    xt = torch.tensor(x).bfloat16()
    got = bn(xt if rank == 2 else xt.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = (got if rank == 2 else got.permute(0, 2, 3, 1)).float().detach().numpy()
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got - want)
    # one rounding, of the float32 sum normalized + shift: its ulp at the
    # larger of its terms (the statistics' float32 sums run in other orders)
    big = np.maximum(np.abs(got), np.abs(want))
    terms = np.maximum(big, np.abs(want - bias))
    bad = err > _ulp(terms)
    assert not bad.any(), (float((err / _ulp(big)).max()), want[bad][:4],
                           got[bad][:4])
    assert bn.running_mean.dtype == torch.float32
    if mode == "train":
        for t, k in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(t.numpy(), np.asarray(
                mutated["batch_stats"][k]), rtol=1e-6, atol=1e-7, err_msg=k)


# -- trunks -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("module", ["encoder", "decoder"])
def test_trunks_within_the_bf16_contract(module, mode, monkeypatch):
    from tpuvae.models.layers import ConvDecoderTrunk as JD
    from tpuvae.models.layers import ConvEncoderTrunk as JE

    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.models import layers

    def no_kernel6(*args, **kwargs):
        raise AssertionError("kernel 6 called under bfloat16")

    monkeypatch.setattr(layers, "fused_trunk2", no_kernel6)
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(1)
    if module == "encoder":
        make, prefix = (lambda d: JE(dtype=d)), "audio_encoder"
        x = rng.standard_normal((B, *HW, 1)).astype(np.float32)
        port = layers.ConvEncoderTrunk(dtype=torch.bfloat16)
    else:
        make, prefix = (lambda d: JD(feature_hw=(1, 2), dtype=d)), "audio_decoder"
        x = rng.standard_normal((B, 512 * 2)).astype(np.float32)
        port = layers.ConvDecoderTrunk(feature_hw=(1, 2), dtype=torch.bfloat16)
    j32, j16 = make(jnp.float32), make(jnp.bfloat16)
    flat = _seed_stats(_flat(j32.init(key, jnp.asarray(x[:1]), train=False)), 3)
    named = {k.replace("/", f"/{prefix}/", 1): v for k, v in flat.items()}
    port.load_state_dict({k.split(".", 1)[1]: v
                          for k, v in from_flax(named).items()})
    variables = _unflat(flat)
    train = mode == "train"
    outs = []
    for jm in (j16, j32):
        o = jm.apply(variables, jnp.asarray(x), train=train,
                     mutable=["batch_stats"] if train else False)
        outs.append(np.asarray((o[0] if train else o).astype(jnp.float32)))
    with torch.no_grad():
        got = port.train(train)(torch.tensor(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == outs[0].shape
    _within_spread(f"{module} {mode}", got.float().numpy(), *outs)


# -- the three models: forward, loss, gradient ---------------------------------

_LATENT = {"simple": 32, "cvae": 64, "hybrid": 128}


@functools.lru_cache(maxsize=None)
def _models(kind: str):
    """flax fp32 and bf16 models, seeded flax variables (flat), the port's
    bf16 model on them, the inputs and the bf16 noise shared by all."""
    from tpuvae.models import ConditionalVAE as JC
    from tpuvae.models import HybridVAE as JH
    from tpuvae.models import SimpleVAE as JS

    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.models import ConditionalVAE, HybridVAE, SimpleVAE

    audio, text, cond = _data()
    if kind == "simple":
        x = np.random.default_rng(3).standard_normal((16, 370)).astype(np.float32)
        # dropout off: the two packages' masks come from different generators
        make, inputs = (lambda d: JS(dropout=0.0, dtype=d)), (x,)
        port = SimpleVAE(dropout=0.0, dtype=torch.bfloat16)
    elif kind == "cvae":
        make, inputs = (lambda d: JC(num_classes=3, input_hw=HW, dtype=d),
                        (audio, text, cond))
        port = ConditionalVAE(num_classes=3, input_hw=HW, dtype=torch.bfloat16)
    else:
        make, inputs = (lambda d: JH(input_hw=HW, dtype=d)), (audio, text)
        port = HybridVAE(input_hw=HW, dtype=torch.bfloat16)
    key = jax.random.PRNGKey(0)
    j32 = make(jnp.float32)
    v = j32.init({"params": key, "dropout": key},
                 *[jnp.asarray(a[:1]) for a in inputs], key, train=False)
    flat = _seed_stats(_flat(v), seed=1)
    port.load_state_dict(from_flax(flat))
    eps = _bf16(jax.random.normal(jax.random.PRNGKey(5),
                                  (inputs[0].shape[0], _LATENT[kind])))
    return j32, make(jnp.bfloat16), flat, port, inputs, eps


def _loss(kind, outs, inputs, mod):
    if kind == "simple":
        return mod.simple_vae_loss(outs[0], inputs[0], outs[1], outs[2])[0]
    fn = mod.cvae_loss if kind == "cvae" else mod.hybrid_loss
    return fn(outs[0], inputs[0], outs[1], inputs[1], outs[2], outs[3])[0]


@pytest.fixture(scope="module", params=["simple", "cvae", "hybrid"])
def flax_runs(request):
    return request.param, flax_outputs(request.param)


def flax_outputs(kind: str) -> dict:
    """flax's eval and train outputs, loss and gradient of model ``kind``
    at fp32 and at bf16, with the shared noise in place of flax's draw
    (its ``reparameterize`` formula, ``eps`` in ``mu``'s dtype)."""
    import tpuvae.models as jmodels
    from tpuvae.models import cond_vae, hybrid_vae, simple_vae

    j32, j16, flat, _, inputs, eps = _models(kind)
    variables = _unflat(flat)
    jin = [jnp.asarray(a) for a in inputs]
    key = jax.random.PRNGKey(0)

    def fixed(rng, mu, logvar):
        e = jnp.asarray(eps) if eps.shape == mu.shape else jnp.zeros(mu.shape)
        return mu + e.astype(mu.dtype) * jnp.exp(0.5 * logvar)

    patch = pytest.MonkeyPatch()
    for mod in (cond_vae, hybrid_vae, simple_vae):
        patch.setattr(mod, "reparameterize", fixed)
    try:
        out = {}
        for tag, jm in (("f32", j32), ("bf16", j16)):
            ev = jm.apply(variables, *jin, key, train=False)

            def loss_of(params, jm=jm):
                o, mut = jm.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]},
                                  *jin, key, train=True, mutable=["batch_stats"])
                return _loss(kind, o, jin, jmodels), (o, mut)

            (loss, (tr, mut)), grad = jax.value_and_grad(
                loss_of, has_aux=True)(variables["params"])
            out[tag] = {
                "eval": [np.asarray(t.astype(jnp.float32)) for t in ev],
                "train": [np.asarray(t.astype(jnp.float32)) for t in tr],
                "loss": float(loss), "grad": _flat({"params": grad}),
                "stats": _flat(mut)}
    finally:
        patch.undo()
    return out


def _port_forward(kind, train: bool):
    _, _, _, port, inputs, eps = _models(kind)
    model = copy.deepcopy(port).train(train)
    tin = [torch.tensor(a) for a in inputs]
    outs = model(*tin, torch.tensor(eps).bfloat16())
    return model, tin, outs


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_model_forward_within_the_bf16_contract(flax_runs, mode):
    from tpuvae_torch.convert import to_flax

    kind, ref = flax_runs
    model, _, outs = _port_forward(kind, mode == "train")
    for i, got in enumerate(outs):
        assert got.dtype == torch.bfloat16, i
        _within_spread(f"{kind} {mode} output {i}",
                       got.detach().float().numpy(), ref["bf16"][mode][i],
                       ref["f32"][mode][i])
    if mode == "train":
        # the running statistics' step, float32, taken from bf16
        # activations that agree within the contract
        old, new = _models(kind)[2], to_flax(model.state_dict())
        for k, want in ref["bf16"]["stats"].items():
            _within_spread(k, new[k] - old[k], want - old[k],
                           ref["f32"]["stats"][k] - old[k])


def test_model_loss_and_gradient_within_the_bf16_contract(flax_runs):
    import tpuvae_torch.models as pmodels
    from tpuvae_torch.convert import to_flax

    kind, ref = flax_runs
    model, tin, outs = _port_forward(kind, True)
    loss = _loss(kind, outs, tin, pmodels)
    assert loss.dtype == torch.float32
    loss.backward()
    import tpuvae.models as jmodels

    # the loss function: the JAX one on the port's own outputs
    own = _loss(kind, [jnp.asarray(o.detach().float().numpy()) for o in outs],
                [jnp.asarray(t.numpy()) for t in tin], jmodels)
    np.testing.assert_allclose(float(loss.detach()), float(own), rtol=1e-6)
    l16 = ref["bf16"]["loss"]
    l32 = ref["f32"]["loss"]
    assert (abs(float(loss.detach()) - l16)
            <= abs(l16 - l32) + LOSS_RTOL * abs(l16)), (float(loss), l16, l32)
    got = to_flax({n: p.grad for n, p in model.named_parameters()})
    w16, w32 = ref["bf16"]["grad"], ref["f32"]["grad"]
    assert set(got) == set(w32)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    sq = lambda d: sum(float(np.sum(np.square(v, dtype=np.float64)))  # noqa: E731
                       for v in d.values())
    diff = lambda a, b: {k: a[k].astype(np.float64) - b[k] for k in a}  # noqa: E731
    p_l2, s_l2 = sq(diff(got, w16)) ** 0.5, sq(diff(w16, w32)) ** 0.5
    assert p_l2 <= s_l2, (p_l2, s_l2)
    for k, want in w32.items():
        ref_t = want
        if k.endswith("/bias") and _pre_batch_norm(k):
            ref_t = w32[k.replace("/bias", "/kernel")]
        scale = max(float(np.linalg.norm(ref_t)), float(np.abs(ref_t).max()))
        p = float(np.linalg.norm(got[k] - w16[k])) / scale
        s = float(np.linalg.norm(w16[k] - want)) / scale
        assert p <= GRAD_TENSOR * s + 1e-6, (k, p, s)


def _pre_batch_norm(k: str) -> bool:
    """A bias followed by BatchNorm: its gradient is 0 in exact arithmetic."""
    parts = k.split("/")
    return (("Dense" in k and parts[1] in ("encoder", "decoder"))
            or "/Conv_" in k
            or ("ConvTranspose" in k and not k.endswith("ConvTranspose_5/bias"))
            or parts[1] in ("text_fc", "text_dec_fc1", "text_fc1", "text_fc2"))


@pytest.mark.parametrize("kind", ["simple", "cvae", "hybrid"])
def test_bf16_models_keep_float32_weights_and_convert_unchanged(kind):
    """Params stay float32 under bf16 (flax's ``param_dtype``), so
    ``convert`` carries a bf16 model's weights as an fp32 one's."""
    from tpuvae_torch.convert import from_flax, to_flax

    _, _, flat, port, _, _ = _models(kind)
    sd = port.state_dict()
    assert all(t.dtype in (torch.float32, torch.int64) for t in sd.values())
    back = to_flax(sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    assert set(from_flax(flat)) == set(sd)


# -- bundles the JAX pipelines wrote in bf16, served by the port ------------------

@pytest.fixture(scope="module")
def bf16_bundles(tmp_path_factory):
    """The serving corpus, its JAX ``processed_data2`` and bf16 bundles of
    both JAX pipelines; a copy of the results whose meta says float32 (the
    JAX encoder there is the spread's yardstick)."""
    from test_torch_conv_serving import write_jax_bundles

    root = tmp_path_factory.mktemp("bf16_bundles")
    b = write_jax_bundles(root, compute_dtype="bfloat16")
    f32 = root / "results_as_f32"
    shutil.copytree(b["results"], f32)
    for meta in f32.glob("*/serving/model/metadata.json"):
        m = json.loads(meta.read_text())
        assert m["compute_dtype"] == "bfloat16"
        meta.write_text(json.dumps({**m, "compute_dtype": "float32"}))
    b["results_f32"] = f32
    return b


@pytest.mark.parametrize("arch", ["hybrid", "cvae"])
def test_port_serves_jax_bf16_bundles(bf16_bundles, arch):
    from tpuvae.infer import ClipEncoder as JaxEncoder

    from tpuvae_torch.infer import ClipEncoder

    b = bf16_bundles
    kw = {"lyrics": b["lyrics"]}
    if arch == "cvae":
        kw["genres"] = b["genres"]
    enc = ClipEncoder.load(arch, results_dir=str(b["results"]), device="cpu")
    assert enc.meta["compute_dtype"] == "bfloat16"
    assert enc.model.audio_encoder.dtype == torch.bfloat16
    got = enc.encode_paths(b["paths"], **kw)
    want16 = JaxEncoder.load(arch, results_dir=str(b["results"])).encode_paths(
        b["paths"], **kw)
    want32 = JaxEncoder.load(arch, results_dir=str(b["results_f32"])
                             ).encode_paths(b["paths"], **kw)
    assert got.latents.dtype == np.float32 and np.isfinite(got.latents).all()
    # bf16 values, widened: the JAX encoder's .astype(np.float32)
    np.testing.assert_array_equal(_bf16(got.latents), got.latents)
    _within_spread(f"{arch} latents", got.latents, want16.latents,
                   want32.latents)
    np.testing.assert_array_equal(got.clusters, want16.clusters)


def test_hybrid_latents_file_matches_the_jax_pipelines(bf16_bundles, tmp_path):
    """The port's bf16 ``hybrid_latent_features.npy``: the JAX pipeline's
    ``.npy`` header byte for byte (``'<V2'``, raw bf16 bits) and dtype."""
    from tpuvae_torch.config import HybridVAEConfig
    from tpuvae_torch.io.artifacts import load_latents
    from tpuvae_torch.pipelines import run_hybrid_vae
    from tpuvae_torch.utils.logging import RunLogger

    b = bf16_bundles
    run_hybrid_vae(str(b["data"]), str(tmp_path),
                   HybridVAEConfig(epochs=1, batch_size=8,
                                   compute_dtype="bfloat16"),
                   logger=RunLogger(echo=False), make_plots=False,
                   device="cpu")
    name = "Convolutional_VAE/hybrid_latent_features.npy"
    ours, theirs = tmp_path / name, b["results"] / name
    header = lambda p: p.read_bytes()[:128]  # noqa: E731
    assert header(ours) == header(theirs)
    assert b"'descr': '<V2'" in header(ours)
    assert ours.stat().st_size == theirs.stat().st_size
    assert np.load(ours).dtype == np.load(theirs).dtype
    lat = load_latents(ours)
    assert lat.shape == (len(b["paths"]), 128) and np.isfinite(lat).all()
    np.testing.assert_array_equal(_bf16(lat), lat)
    # the JAX file reads back as the same kind of values
    assert np.isfinite(load_latents(theirs)).all()


def test_bf16_resume_equals_an_uninterrupted_run(tmp_path):
    """A bf16 Conditional VAE run of 2 epochs resumed from its 1-epoch
    checkpoint ends where an uninterrupted one does: the generator state,
    float32 weights and optimizer carry across."""
    from test_torch_cvae_pipeline import _write_processed_data2

    from tpuvae_torch.config import ConditionalVAEConfig
    from tpuvae_torch.pipelines import run_conditional_vae
    from tpuvae_torch.train.checkpoint import load_checkpoint
    from tpuvae_torch.utils.logging import RunLogger

    _write_processed_data2(tmp_path / "pd2")

    def run(results, epochs, every):
        return run_conditional_vae(
            str(tmp_path / "pd2"), str(results),
            ConditionalVAEConfig(epochs=epochs, batch_size=8,
                                 checkpoint_every=every,
                                 compute_dtype="bfloat16"),
            logger=RunLogger(echo=False), make_plots=False, device="cpu")

    whole = run(tmp_path / "whole", 2, 0)
    run(tmp_path / "cut", 1, 1)
    resumed = run(tmp_path / "cut", 2, 1)
    cols = ["Silhouette", "NMI", "ARI", "Purity"]
    np.testing.assert_array_equal(resumed[cols].to_numpy(),
                                  whole[cols].to_numpy())
    a, meta = load_checkpoint(tmp_path / "whole" / "Conditional_VAE"
                              / "serving" / "model")
    b, _ = load_checkpoint(tmp_path / "cut" / "Conditional_VAE" / "serving"
                           / "model")
    assert meta["compute_dtype"] == "bfloat16"
    for k in a:
        assert a[k].dtype == np.float32, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_cli_train_cvae_in_bf16(tmp_path, capsys):
    from test_torch_cvae_pipeline import _write_processed_data2

    from tpuvae_torch import cli
    from tpuvae_torch.train.checkpoint import load_checkpoint

    _write_processed_data2(tmp_path / "pd2")
    rc = cli.main(["train-cvae", "--device=cpu", "--epochs=1",
                   "--batch_size=8", "--compute_dtype=bfloat16",
                   f"--data_dir={tmp_path / 'pd2'}",
                   f"--results_dir={tmp_path / 'r'}"])
    assert rc == 0
    assert "CVAE (Multi-Modal)" in capsys.readouterr().out
    _, meta = load_checkpoint(tmp_path / "r" / "Conditional_VAE" / "serving"
                              / "model")
    assert meta["compute_dtype"] == "bfloat16"
    assert cli.main(["train-cvae", "--device=cpu",
                     "--compute_dtype=float16"]) == 2
