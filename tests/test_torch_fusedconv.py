"""Kernel 6's plain version and the differentiable pair against the JAX
package (``tpuvae/ops/fusedconv.py``, Pallas in interpret mode on the CPU).

Tolerances are those of ``tests/test_fusedconv.py``: means rtol/atol 1e-5,
var0 rtol 1e-4 / atol 1e-5, y1 and mean1 rtol/atol 1e-4, var1 rtol 1e-3 /
atol 1e-4 (fp32 sums of up to 288 products in two orders; var1 inherits
var0's error through the folded scale).  The gradient of the
``autograd.Function`` is held to PyTorch's own gradient of the plain
composition at rtol 1e-4 / atol 1e-5 x the largest entry (the backward
takes the forward's statistics and raw outputs and sums the statistics'
gradients in closed form: the same numbers in another summation order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax import lax

torch.set_num_threads(1)

_DIMNUMS = ("NHWC", "HWIO", "NHWC")


def _inputs(b, h, w, seed=7, f0=32, f1=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    w0 = (rng.standard_normal((3, 3, 1, f0)) * 0.3).astype(np.float32)
    b0 = rng.standard_normal(f0).astype(np.float32) * 0.1
    g0 = (1.0 + 0.2 * rng.standard_normal(f0)).astype(np.float32)
    be0 = rng.standard_normal(f0).astype(np.float32) * 0.1
    w1 = (rng.standard_normal((3, 3, f0, f1)) * 0.1).astype(np.float32)
    b1 = rng.standard_normal(f1).astype(np.float32) * 0.1
    return [x, w0, b0, g0, be0, w1, b1]


def _assert_pair_close(got, want):
    y1, (m0, v0), (m1, v1) = got
    ry1, (rm0, rv0), (rm1, rv1) = want
    np.testing.assert_allclose(np.asarray(m0), np.asarray(rm0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(rv0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(ry1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(rm1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(rv1), rtol=1e-3, atol=1e-4)


def _numpy(tree):
    y1, s0, s1 = tree
    return y1.numpy(), tuple(t.numpy() for t in s0), tuple(t.numpy() for t in s1)


@pytest.mark.parametrize("b,h,w", [(2, 16, 32), (3, 8, 64)])
@pytest.mark.parametrize("entry", ["wrapper", "plain"])
def test_fused_trunk2_forward_matches_pallas(b, h, w, entry):
    from tpuvae.ops.fusedconv import fused_trunk2_forward as jax_pair

    from tpuvae_torch.ops import fusedconv as fc

    args = _inputs(b, h, w)
    fn = (fc.fused_trunk2_forward if entry == "wrapper"
          else fc.fused_trunk2_forward_plain)
    got = _numpy(fn(*[torch.tensor(a) for a in args]))
    _assert_pair_close(got, jax_pair(*args))


def test_fused_trunk2_forward_corner_pixel_matches_pallas():
    """SAME zero padding at the borders (``tests/test_fusedconv.py``'s
    corner case): y1 at that test's rtol 1e-4 / atol 1e-5."""
    from tpuvae.ops.fusedconv import fused_trunk2_forward as jax_pair

    from tpuvae_torch.ops.fusedconv import fused_trunk2_forward

    x = np.zeros((1, 8, 8, 1), np.float32)
    x[0, 0, 0, 0] = 1.0
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((3, 3, 1, 32)).astype(np.float32)
    zeros32, ones32 = np.zeros(32, np.float32), np.ones(32, np.float32)
    w1 = rng.standard_normal((3, 3, 32, 64)).astype(np.float32) * 0.1
    args = [x, w0, zeros32, ones32, zeros32, w1, np.zeros(64, np.float32)]
    y1, _, _ = fused_trunk2_forward(*[torch.tensor(a) for a in args])
    ry1, _, _ = jax_pair(*args)
    np.testing.assert_allclose(y1.numpy(), np.asarray(ry1), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("corner", [(0, 0), (0, 7), (7, 0), (7, 7)])
def test_halves_pad_zero_after_the_affine(corner):
    """Each half against ``lax.conv_general_dilated(..., 'SAME')`` on a
    one-hot image: pads (0, 1), and a padded pixel of layer 1 is 0, not
    ``shift`` (fp32 sums of <= 288 terms: atol 1e-5)."""
    from tpuvae_torch.ops.fusedconv import conv0_stats, conv1_norm_stats

    _, w0, b0, _, _, w1, b1 = _inputs(1, 8, 8, seed=3)
    x = np.zeros((1, 8, 8), np.float32)
    x[0, corner[0], corner[1]] = 1.0
    y0, s, ss = conv0_stats(torch.tensor(x), torch.tensor(w0[:, :, 0]),
                            torch.tensor(b0))
    ry0 = lax.conv_general_dilated(x[..., None], w0, (2, 2), "SAME",
                                   dimension_numbers=_DIMNUMS) + b0
    np.testing.assert_allclose(y0.numpy(), np.asarray(ry0), atol=1e-6)
    np.testing.assert_allclose(s.numpy()[0, 0], np.asarray(ry0).sum((0, 1, 2)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ss.numpy()[0, 0],
                               (np.asarray(ry0) ** 2).sum((0, 1, 2)), rtol=1e-5)
    scale = np.full(32, 0.7, np.float32)
    shift = np.full(32, 0.9, np.float32)       # a padded pixel must stay 0
    y1, _, _ = conv1_norm_stats(y0, torch.tensor(scale), torch.tensor(shift),
                                torch.tensor(w1), torch.tensor(b1))
    z = np.asarray(ry0) * scale + shift
    z = np.where(z > 0, z, 0.01 * z)
    ry1 = lax.conv_general_dilated(z, w1, (2, 2), "SAME",
                                   dimension_numbers=_DIMNUMS) + b1
    np.testing.assert_allclose(y1.numpy(), np.asarray(ry1), atol=1e-5)


def _plain_composition(x, w0, b0, g0, be0, w1, b1, running0=None, eps=1e-5):
    """Layers 0-1 with PyTorch operations only, differentiable."""
    def conv(t, w, b):
        t = F.pad(t.permute(0, 3, 1, 2), (0, 1, 0, 1))
        return F.conv2d(t, w.permute(3, 2, 0, 1), b, stride=2).permute(0, 2, 3, 1)

    def stats(y):
        m = y.mean((0, 1, 2))
        return m, torch.clamp_min((y * y).mean((0, 1, 2)) - m * m, 0.0)

    y0 = conv(x, w0, b0)
    m0, v0 = stats(y0)
    um, uv = (m0, v0) if running0 is None else running0
    scale = g0 * torch.rsqrt(uv + eps)
    z = F.leaky_relu(y0 * scale + (be0 - um * scale), 0.01)
    y1 = conv(z, w1, b1)
    return y1, (m0, v0), stats(y1)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_fused_trunk2_gradient_matches_autograd_of_plain(mode):
    from tpuvae_torch.ops.fusedconv import fused_trunk2

    rng = np.random.default_rng(11)
    running0 = None
    if mode == "eval":
        running0 = (torch.tensor(rng.normal(0, 0.1, 32).astype(np.float32)),
                    torch.tensor(rng.uniform(0.5, 1.5, 32).astype(np.float32)))
    cot = [torch.tensor(rng.standard_normal(s).astype(np.float32))
           for s in ((2, 4, 8, 64), (64,), (64,))]

    def run(fn):
        args = [torch.tensor(a, requires_grad=True) for a in _inputs(2, 16, 32)]
        y1, _, (m1, v1) = fn(*args, running0=running0)
        ((y1 * cot[0]).sum() + (m1 * cot[1]).sum() + (v1 * cot[2]).sum()).backward()
        return [y1.detach(), m1.detach(), v1.detach()], [a.grad for a in args]

    outs, grads = run(fused_trunk2)
    routs, rgrads = run(_plain_composition)
    for o, r in zip(outs, routs):
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5)
    names = "x w0 b0 gamma0 beta0 w1 b1".split()
    for name, g, r in zip(names, grads, rgrads):
        assert g is not None and g.shape == r.shape, name
        scale = float(r.abs().max())
        if name == "b0" and mode == "train":
            # a bias before BatchNorm has a gradient that is 0 in exact
            # arithmetic: both sides hold the rounding noise of a sum that
            # cancels, whose terms have the scale of beta0's gradient
            scale = float(rgrads[names.index("beta0")].abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5 * scale,
                                   msg=name)


@pytest.mark.parametrize("which", ["all", "y1_only", "stats_only"])
def test_stats_grad_is_autograd_through_the_batch_statistics(which):
    """Layer 1's statistics gradient in closed form against autograd of
    ``mean = mean(y1)``, ``var = max(mean(y1^2) - mean^2, 0)`` over
    (B, H, W) in float64, a constant channel (variance clamped) included;
    a gradient left out (None) counts as 0."""
    from tpuvae_torch.ops.fusedconv import _stats_grad

    g = torch.Generator().manual_seed(3)
    y1 = torch.randn((2, 3, 4, 5), generator=g, dtype=torch.float64)
    y1[..., 2] = 0.1
    cot = [torch.randn(s, generator=g, dtype=torch.float64)
           for s in (y1.shape, (5,), (5,))]
    if which == "y1_only":
        cot[1] = cot[2] = None
    elif which == "stats_only":
        cot[0] = None
    leaf = y1.clone().requires_grad_(True)
    mean = leaf.mean(dim=(0, 1, 2))
    var = torch.clamp_min((leaf * leaf).mean(dim=(0, 1, 2)) - mean * mean, 0)
    terms = [(o * c).sum() for o, c in zip((leaf, mean, var), cot)
             if c is not None]
    (want,) = torch.autograd.grad(sum(terms), [leaf])
    m = mean.detach()
    raw = (y1 * y1).mean(dim=(0, 1, 2)) - m * m
    got = _stats_grad(cot[0], y1, m, raw, cot[1], cot[2])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shift", [0.0, 1e4], ids=["centred", "offset"])
def test_pair_hands_its_backward_the_unclamped_variances(shift):
    """The pair's forward returns, for its backward's clamp masks, each
    layer's variance before the clamp: ``var = max(raw, 0)`` bit for bit,
    and ``raw`` the finalisation's own ``mean(y^2) - mean^2`` (an input
    far off zero makes it cancel, so the sign it gives is the forward's
    and not one recomputed in another order)."""
    from tpuvae_torch.ops import fusedconv as fc

    args = [torch.tensor(a) for a in _inputs(2, 8, 16)]
    args[2] = args[2] + shift                       # b0: y0 far off zero
    y1, (m0, v0), (m1, v1), y0, (raw0, raw1) = fc._pair_forward(
        fc._conv0_bn, fc._conv1_bn, *args, 1e-5, None)
    assert torch.equal(torch.clamp_min(raw0, 0.0), v0)
    assert torch.equal(torch.clamp_min(raw1, 0.0), v1)
    for y, m, raw in ((y0, m0, raw0), (y1, m1, raw1)):
        n = y.shape[0] * y.shape[1] * y.shape[2]
        s, ss = y.sum(dim=(1, 2))[:, None], (y * y).sum(dim=(1, 2))[:, None]
        assert torch.equal(raw, ss.sum(dim=(0, 1)) / n - m * m)
        assert torch.equal(m, s.sum(dim=(0, 1)) / n)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_fused_trunk2_backward_runs_no_forward_convolution(mode):
    """The backward takes layer 1 from the saved raw y1 and rebuilds only
    its input: no forward convolution, one convolution backward for
    layer 1 and one for layer 0's weight gradient."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpuvae_torch.ops.fusedconv import fused_trunk2

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    x, *params = [torch.tensor(a) for a in _inputs(2, 8, 16)]
    for p in params:
        p.requires_grad_(True)
    running0 = None
    if mode == "eval":
        running0 = (torch.full((32,), 0.05), torch.full((32,), 1.3))
    y1, _, (m1, v1) = fused_trunk2(x, *params, running0=running0)
    loss = y1.square().sum() + m1.sum() + v1.sum()
    with Ops() as ops:
        loss.backward()
    assert "aten.convolution" not in ops.seen
    assert ops.seen.count("aten.convolution_backward") == 2   # x is data
    assert all(p.grad is not None for p in params)


def test_fused_trunk2_eval_uses_running_statistics():
    from tpuvae_torch.ops.fusedconv import fused_trunk2

    args = [torch.tensor(a) for a in _inputs(2, 8, 16, seed=5)]
    running0 = (torch.full((32,), 0.05), torch.full((32,), 1.3))
    got = fused_trunk2(*args, running0=running0)
    want = _plain_composition(*args, running0=running0)
    batch = fused_trunk2(*args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    # the returned statistics stay the batch's
    torch.testing.assert_close(got[1][1], batch[1][1])
    assert not torch.allclose(got[0], batch[0], atol=1e-3)


@pytest.mark.parametrize("case", ["odd_height", "odd_width", "float64",
                                  "channels", "rank"])
def test_wrappers_raise_on_what_the_kernel_does_not_take(case):
    from tpuvae_torch.ops.fusedconv import conv0_stats, fused_trunk2_forward

    x, w0, b0, g0, be0, w1, b1 = [torch.tensor(a) for a in _inputs(1, 8, 8)]
    with pytest.raises(ValueError):
        if case == "odd_height":
            conv0_stats(x[0:1, :7, :, 0], w0[:, :, 0], b0)
        elif case == "odd_width":
            conv0_stats(x[0:1, :, :7, 0], w0[:, :, 0], b0)
        elif case == "float64":
            conv0_stats(x[..., 0].double(), w0[:, :, 0], b0)
        elif case == "channels":
            fused_trunk2_forward(x, w0, b0, g0, be0, w1[:, :, :16], b1)
        else:
            fused_trunk2_forward(x[..., 0], w0, b0, g0, be0, w1, b1)
