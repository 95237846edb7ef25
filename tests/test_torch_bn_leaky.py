"""The trunks' training BatchNorm + LeakyReLU (``ops/bn_leaky.py``) on the
CPU: its plain versions against the op-by-op code the trunks ran before
(a literal copy below), forward and autograd backward, bit for bit; the
closed-form backward that kernels C and D compute against autograd; the
dispatch rule (only a CUDA float32 BatchNorm in training reaches the
kernels; the CPU, bfloat16 and eval paths run the op-by-op code); the
launch plan and the layouts the kernels take.  The kernels themselves run
in ``tests/test_torch_cuda.py`` (``-k bn_leaky``).

Tolerances: the plain versions are the same ops in the same order, so
equal.  The closed form in float64: within 1e-12 of the largest entry of
each autograd gradient.  In float32: within 2e-5 of the largest entry (and
1e-4 for ``d var`` and ``d weight``, whose sums over ~n x (x - mean) terms
cancel): both sides round ~n terms once each, in other orders.
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from tpuvae_torch.models import layers
from tpuvae_torch.ops import bn_leaky as bnl

SLOPE = 0.01


# -- what the trunks ran before, op by op -------------------------------------

def _today_batch_norm(bn, x, stats=None):
    dims = (0, 2, 3)
    x = x.float()
    if stats is None:
        mean = x.mean(dim=dims)
        var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
    else:
        mean, var = stats
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)
    shape = (1, -1, 1, 1)
    y = ((x.float() - mean.view(shape))
         * (torch.rsqrt(var + bn.eps) * bn.weight).view(shape)
         + bn.bias.view(shape))
    return y.to(bn.dtype)


def _today(bn, x, stats=None):
    return F.leaky_relu(_today_batch_norm(bn, x, stats), SLOPE)


# -- inputs ----------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _layout(kind, n, c, h, w, g, dtype=torch.float32):
    """An (n, c, h, w) tensor in the trunks' layouts: channels-last, NCHW,
    or the decoder's cut ``y[:, :, :h, :w]`` of a channels-last (h + 1) x
    (w + 1) output."""
    if kind == "channels_last":
        base = torch.randn((n, h, w, c), generator=g, dtype=dtype)
        return (base * 1.5 + 0.3).permute(0, 3, 1, 2)
    if kind == "nchw":
        return torch.randn((n, c, h, w), generator=g, dtype=dtype) * 1.5 + 0.3
    full = torch.randn((n, h + 1, w + 1, c), generator=g, dtype=dtype)
    x = (full * 1.5 + 0.3).permute(0, 3, 1, 2)[:, :, :h, :w]
    assert not x.is_contiguous(memory_format=torch.channels_last)
    return x


def _bn(c, seed, dtype=torch.float32):
    g = _gen(seed)
    bn = layers.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand((c,), generator=g) + 0.5)
        bn.bias.copy_(torch.randn((c,), generator=g) * 0.2)
        bn.running_mean.copy_(torch.randn((c,), generator=g))
        bn.running_var.copy_(torch.rand((c,), generator=g) + 0.5)
    return bn.to(dtype)


def _twin(bn):
    other = _bn(bn.num_features, 0, bn.weight.dtype)
    other.load_state_dict(bn.state_dict())
    return other


def _given_stats(x):
    return (x.mean(dim=(0, 2, 3)).detach() + 0.01,
            x.var(dim=(0, 2, 3), unbiased=False).detach() * 1.1)


LAYOUTS = ["channels_last", "nchw", "cut"]


# -- the plain versions equal the op-by-op code --------------------------------------

@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("given", [False, True], ids=["batch", "given"])
def test_plain_forward_equals_todays_code(kind, given):
    x = _layout(kind, 4, 8, 6, 10, _gen(1))
    bn = _bn(8, 2)
    ref = _twin(bn)
    stats = _given_stats(x) if given else None
    got = (bnl.bn_leaky_given_plain(x, *stats, bn) if given
           else bnl.bn_leaky_plain(x, bn))
    want = _today(ref, x, stats)
    assert torch.equal(got, want)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, name), getattr(ref, name)), name
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("given", [False, True], ids=["batch", "given"])
def test_plain_backward_equals_todays_autograd(kind, given):
    x0 = _layout(kind, 4, 8, 6, 10, _gen(3))
    g = torch.randn(x0.shape, generator=_gen(4))
    grads = []
    for fn in ("plain", "today"):
        bn = _bn(8, 5)
        x = x0.detach().requires_grad_(True)    # x0's strides, the cut's too
        leaves = [x, bn.weight, bn.bias]
        stats = None
        if given:
            stats = [t.requires_grad_(True) for t in _given_stats(x0)]
            leaves += stats
        if fn == "plain":
            y = (bnl.bn_leaky_given_plain(x, *stats, bn) if given
                 else bnl.bn_leaky_plain(x, bn))
        else:
            y = _today(bn, x, stats)
        grads.append(torch.autograd.grad(y, leaves, g))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _with_clamped_channel(x):
    """``x`` with channel 1 constant, at a value whose fast variance comes
    out below 0 in ``x``'s dtype."""
    x = x.detach().clone()
    for k in range(1, 5000):
        x[:, 1] = 0.1 + 0.0137 * k
        mean = x.mean(dim=(0, 2, 3))
        if (x * x).mean(dim=(0, 2, 3))[1] - mean[1] * mean[1] < 0:
            return x
    raise AssertionError("no constant clamps")


def test_a_clamped_channel_forward_and_backward_equal_todays_code():
    x0 = _with_clamped_channel(_layout("channels_last", 4, 6, 4, 4, _gen(6)))
    raw = (x0 * x0).mean(dim=(0, 2, 3)) - x0.mean(dim=(0, 2, 3)) ** 2
    assert raw[1] < 0                      # the clamp bites in channel 1
    g = torch.randn(x0.shape, generator=_gen(7))
    outs = []
    for fn in (bnl.bn_leaky_plain, _today):
        bn = _bn(6, 8)
        x = x0.clone().requires_grad_(True)
        y = fn(bn, x) if fn is _today else fn(x, bn)
        outs.append((y, *torch.autograd.grad(y, [x, bn.weight, bn.bias], g),
                     bn.running_var.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[0][-1][1] == pytest.approx(0.99 * _bn(6, 8).running_var[1].item())


def test_a_clamped_channel_gets_no_variance_gradient():
    """Where the clamp bites the closed form folds no ``d var`` into
    ``dx`` (float64, within 1e-12 of autograd)."""
    x = _with_clamped_channel(_layout("nchw", 3, 5, 4, 6, _gen(9),
                                      torch.float64))
    bn = _bn(5, 10, torch.float64)
    mean, var = bnl.batch_stats_plain(x)
    raw = (x * x).mean(dim=(0, 2, 3)) - mean * mean
    assert raw[1] < 0 and var[1] == 0
    g = torch.randn(x.shape, generator=_gen(11), dtype=torch.float64)
    xl = x.clone().requires_grad_(True)
    want = torch.autograd.grad(bnl.bn_leaky_plain(xl, bn), xl, g)[0]
    got = bnl.bn_leaky_backward_plain(g, x, mean, var, bn.weight.detach(),
                                      bn.bias.detach(), bn.eps, given=False)[0]
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


# -- the closed-form backward of kernels C and D -------------------------------------

def _autograd_and_closed_form(kind, given, dtype, seed, shape=(4, 8, 6, 10)):
    n, c, h, w = shape
    x = _layout(kind, n, c, h, w, _gen(seed), dtype)
    g = torch.randn(x.shape, generator=_gen(seed + 1), dtype=dtype)
    bn = _bn(c, seed + 2, dtype)
    xl = x.detach().clone().requires_grad_(True)
    leaves = [xl, bn.weight, bn.bias]
    if given:
        mean, var = (t.requires_grad_(True) for t in _given_stats(x))
        leaves += [mean, var]
        y = bnl.bn_leaky_given_plain(xl, mean, var, bn)
    else:
        y = bnl.bn_leaky_plain(xl, bn)
        mean, var = bnl.batch_stats_plain(x)
    want = list(torch.autograd.grad(y, leaves, g))
    got = bnl.bn_leaky_backward_plain(
        g, x, mean.detach(), var.detach(), bn.weight.detach(),
        bn.bias.detach(), bn.eps, given)
    return list(got[:3]) + (list(got[3:]) if given else []), want


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("given", [False, True], ids=["batch", "given"])
def test_closed_form_backward_equals_autograd_in_float64(kind, given):
    got, want = _autograd_and_closed_form(kind, given, torch.float64, 20)
    for name, a, b in zip(("dx", "dweight", "dbias", "dmean", "dvar"),
                          got, want):
        assert (a - b).abs().max() <= 1e-12 * b.abs().max(), name


@pytest.mark.parametrize("given", [False, True], ids=["batch", "given"])
def test_closed_form_backward_is_close_to_autograd_in_float32(given):
    got, want = _autograd_and_closed_form("cut", given, torch.float32, 30,
                                          (8, 16, 16, 24))
    for name, a, b in zip(("dx", "dweight", "dbias", "dmean", "dvar"),
                          got, want):
        tol = 1e-4 if name in ("dweight", "dvar") else 2e-5
        assert (a - b).abs().max() <= tol * b.abs().max(), name


# -- the dispatch rule ---------------------------------------------------------------

def _fake(device, dtype):
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("device,dtype,training,bn_dtype,want", [
    ("cuda", torch.float32, True, torch.float32, True),
    ("cpu", torch.float32, True, torch.float32, False),
    ("cuda", torch.bfloat16, True, torch.bfloat16, False),
    ("cuda", torch.float32, True, torch.bfloat16, False),
    ("cuda", torch.float32, False, torch.float32, False),
], ids=["cuda_fp32_train", "cpu", "cuda_bf16", "bf16_norm", "cuda_eval"])
def test_only_cuda_float32_training_takes_the_kernels(device, dtype, training,
                                                      bn_dtype, want):
    bn = SimpleNamespace(training=training, dtype=bn_dtype)
    assert bnl.takes_kernels(_fake(device, dtype), bn) is want


def _trunks(dtype, seed=40):
    torch.manual_seed(seed)
    enc = layers.ConvEncoderTrunk(dtype=dtype)
    dec = layers.ConvDecoderTrunk(feature_hw=(1, 2), dtype=dtype)
    layers.lecun_init_(enc, _gen(seed))
    layers.lecun_init_(dec, _gen(seed + 1))
    return enc, dec


def _today_trunks(enc, dec, x):
    """Both trunks' forward as the parent ran it (layers 1-5 and 0-4 op by
    op), through the modules' own convolutions and kernel 6's wrapper."""
    if enc.dtype == torch.float32:
        c0, c1, n0, n1 = enc.conv[0], enc.conv[1], enc.norm[0], enc.norm[1]
        running0 = None if enc.training else (n0.running_mean, n0.running_var)
        y1, stats0, stats1 = layers.fused_trunk2(
            x, c0.weight.permute(2, 3, 1, 0), c0.bias, n0.weight, n0.bias,
            c1.weight.permute(2, 3, 1, 0), c1.bias, n0.eps, running0)
        if enc.training:
            bnl.move_running_stats(n0, *stats0)
        h = F.leaky_relu(n1(y1.permute(0, 3, 1, 2), stats1), SLOPE)
        rest = zip(enc.conv[2:], enc.norm[2:])
    else:
        h = x.to(enc.dtype).permute(0, 3, 1, 2)
        rest = zip(enc.conv, enc.norm)
    for conv, norm in rest:
        h = F.leaky_relu(norm(conv(h)), SLOPE)
    z = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = z.to(dec.dtype).reshape(z.shape[0], 1, 2, 512).permute(0, 3, 1, 2)
    for conv, norm in zip(dec.conv[:-1], dec.norm):
        h = F.leaky_relu(norm(conv(h)), SLOPE)
    return z, dec.conv[-1](h).permute(0, 2, 3, 1)


def _run_trunks(enc, dec, x, fn):
    out = fn(enc, dec, x)
    loss = out[0].square().mean() + out[1].float().square().mean()
    params = [p for m in (enc, dec) for p in m.parameters()]
    grads = torch.autograd.grad(loss, params) if loss.requires_grad else []
    bufs = [b.clone() for m in (enc, dec) for b in m.buffers()]
    return [*out, *grads, *bufs]


def _ported(enc, dec, x):
    z = enc(x)
    return z, dec(z)


@pytest.fixture
def stubbed(monkeypatch):
    """The kernel ops replaced by stubs that record each call and run the
    plain version."""
    calls = []

    def stub(name, plain):
        def run(*args):
            calls.append((name, tuple(args[0].shape)))
            return plain(*args)
        return run

    monkeypatch.setattr(bnl, "bn_leaky", stub("bn_leaky", bnl.bn_leaky_plain))
    monkeypatch.setattr(bnl, "bn_leaky_given",
                        stub("bn_leaky_given", bnl.bn_leaky_given_plain))
    return calls


@pytest.mark.parametrize("dtype,training", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True),
    (torch.bfloat16, False)], ids=["fp32_train", "fp32_eval", "bf16_train",
                                   "bf16_eval"])
def test_cpu_bf16_and_eval_trunks_run_todays_code_bit_for_bit(stubbed, dtype,
                                                              training):
    x = torch.randn((2, 64, 128, 1), generator=_gen(41))
    runs = []
    for fn in (_ported, _today_trunks):
        enc, dec = _trunks(dtype)
        enc.train(training)
        dec.train(training)
        runs.append(_run_trunks(enc, dec, x, fn))
    assert stubbed == []                      # the kernels' ops never called
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cuda_float32_training_sends_all_ten_layers_to_the_kernels(
        stubbed, monkeypatch):
    """With the rule holding (as it does for a CUDA float32 tensor in
    training), encoder layers 2-5 and decoder layers 0-4 call
    ``bn_leaky`` and encoder layer 1 ``bn_leaky_given``, in that order;
    the stubs' plain versions give the op-by-op results bit for bit."""
    x = torch.randn((2, 64, 128, 1), generator=_gen(42))
    enc, dec = _trunks(torch.float32)
    want = _run_trunks(enc, dec, x, _today_trunks)
    assert stubbed == []
    monkeypatch.setattr(bnl, "takes_kernels", lambda x, bn: True)
    enc, dec = _trunks(torch.float32)
    got = _run_trunks(enc, dec, x, _ported)
    names = [name for name, _ in stubbed]
    assert names == ["bn_leaky_given"] + 9 * ["bn_leaky"]
    assert [s for _, s in stubbed[:5]] == [
        (2, 64, 16, 32), (2, 128, 8, 16), (2, 256, 4, 8), (2, 512, 2, 4),
        (2, 512, 1, 2)]
    assert [s for _, s in stubbed[5:]] == [
        (2, 512, 2, 4), (2, 256, 4, 8), (2, 128, 8, 16), (2, 64, 16, 32),
        (2, 32, 32, 64)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the launch plan and the layouts --------------------------------------------------

# the ten layers of the trunks at batch 32 on 128 x 1024 mel images
TRAINING_SHAPES = [
    (32, 64, 32, 256), (32, 128, 16, 128), (32, 256, 8, 64), (32, 512, 4, 32),
    (32, 512, 2, 16),
    (32, 512, 4, 32), (32, 256, 8, 64), (32, 128, 16, 128), (32, 64, 32, 256),
    (32, 32, 64, 512)]
SHAPE_IDS = ["enc1", "enc2", "enc3", "enc4", "enc5",
             "dec0", "dec1", "dec2", "dec3", "dec4"]


@pytest.mark.parametrize("shape", TRAINING_SHAPES, ids=SHAPE_IDS)
def test_plan_fills_the_card_and_covers_every_pixel(shape):
    sms = 132
    vec, lanes, groups, ctas, chunk = bnl.plan(shape, 4, sms)
    n, c, h, w = shape
    pixels = n * h * w
    rows = bnl.THREADS // lanes
    assert lanes * rows == bnl.THREADS and lanes & (lanes - 1) == 0
    assert groups * lanes * vec == c                # no idle lane
    assert ctas * chunk >= pixels > (ctas - 1) * chunk
    assert groups * ctas >= 3 * sms                 # three CTAs an SM or more
    assert groups * ctas <= bnl.CTAS_PER_SM * sms + groups
    assert chunk >= rows                            # a pixel for every row
    # a warp reads 512 contiguous bytes of a pixel's channels, or 4 pixels
    assert lanes * vec * 4 >= min(c * 4, 128)


def _vector_case(kind):
    g = _gen(50)
    if kind == "odd_channels":
        return _layout("channels_last", 2, 6, 3, 5, g)
    if kind == "misaligned":
        flat = torch.randn(2 * 3 * 5 * 8 + 1, generator=g)
        return flat[1:].view(2, 3, 5, 8).permute(0, 3, 1, 2)
    return _layout(kind, 2, 8, 3, 5, g)


@pytest.mark.parametrize("kind,want", [
    ("channels_last", 4), ("cut", 4), ("nchw", 1), ("odd_channels", 1),
    ("misaligned", 1)])
def test_vector_width(kind, want):
    assert bnl.vector_width(_vector_case(kind)) == want


@pytest.mark.parametrize("kind,channels_last", [
    ("channels_last", True), ("cut", True), ("nchw", False)])
def test_output_keeps_the_inputs_memory_format(kind, channels_last):
    x = _layout(kind, 2, 8, 3, 5, _gen(51))
    y = bnl._layout_out(x)
    assert y.shape == x.shape
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert y.is_contiguous(memory_format=fmt)
    if channels_last:
        assert bnl.vector_width(x, y) == 4
