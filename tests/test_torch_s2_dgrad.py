"""The trunks' stride-2 transposed convolution at the narrow layers
(``ops/s2_dgrad.py``) on the CPU: the plain phase-split version against
the library's transposed convolution (cut to 2h x 2w) and against the data
gradient of the padded stride-2 convolution; the dispatch rule (only a
float32 CUDA call with F in {32, 64} and C <= 128 reaches the kernel, and
of a Hybrid step's trunk convolutions exactly decoder layers 3 and 4 and
the data gradients of encoder layers 1 and 2); the two autograd Functions
against autograd of the compositions the layers ran before; the layouts
the kernel reads.  The kernel itself runs in ``tests/test_torch_cuda.py``
(``-k s2_dgrad``).

Tolerances: in float64 the phase-split sums and the library's agree
within 1e-12 of the largest entry (both round each of at most 9 C terms
once, in other orders); the backward pieces that call the same library
function as before are equal.
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from tpuvae_torch.models import layers
from tpuvae_torch.ops import s2_dgrad as s2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _case(b, c, f, h, w, seed, dtype=torch.float64):
    g = _gen(seed)
    x = torch.randn((b, c, h, w), generator=g, dtype=dtype)
    weight = torch.randn((c, f, 3, 3), generator=g, dtype=dtype)
    bias = torch.randn((f,), generator=g, dtype=dtype)
    return x, weight, bias


def _close(got, want, share=1e-12):
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= share * max(want.abs().max().item(), 1e-30), err


SIZES = [(3, 5), (4, 4), (5, 2), (1, 1), (2, 7)]


@pytest.mark.parametrize("c", [1, 8, 32])
@pytest.mark.parametrize("f", [1, 8, 32])
@pytest.mark.parametrize("h,w", SIZES)
def test_plain_matches_the_cut_transposed_convolution(c, f, h, w):
    x, weight, bias = _case(2, c, f, h, w, 11 + c + f + h * w)
    want = F.conv_transpose2d(x, weight, bias, stride=2)[..., :2 * h, :2 * w]
    _close(s2.s2_conv_transpose_plain(x, weight, bias), want)
    _close(s2.s2_conv_transpose(x, weight, bias), want)


@pytest.mark.parametrize("c", [1, 8, 32])
@pytest.mark.parametrize("f", [1, 8, 32])
@pytest.mark.parametrize("h,w", SIZES)
def test_plain_is_the_padded_stride2_convolutions_data_gradient(c, f, h, w):
    """``weight (F_out, C_in, 3, 3)`` of a stride-2 SAME convolution on a
    2h x 2w input (pads (0, 1)): its data gradient is the transposed
    convolution of the output gradient, cut to 2h x 2w."""
    g, weight, _ = _case(2, c, f, h, w, 23 + c + f + h * w)
    want = torch.nn.grad.conv2d_input(
        (2, f, 2 * h + 1, 2 * w + 1), weight, g, stride=2)[..., :2 * h, :2 * w]
    _close(s2.s2_conv_transpose_plain(g, weight), want)


# -- the dispatch rule ----------------------------------------------------------------

def _seen(dtype=torch.float32, cuda=True):
    """What the rule reads of a tensor: its device kind and dtype."""
    return SimpleNamespace(is_cuda=cuda, dtype=dtype)


@pytest.mark.parametrize("dtype,cuda,c,f,takes", [
    (torch.float32, True, 128, 64, True),       # decoder 3, encoder 2's dx
    (torch.float32, True, 64, 32, True),        # decoder 4, kernel 6's dx
    (torch.float32, True, 64, 64, True),
    (torch.float32, True, 1, 32, True),
    (torch.float32, True, 128, 32, True),
    (torch.float32, True, 256, 128, False),     # wider layers: cuDNN
    (torch.float32, True, 512, 256, False),
    (torch.float32, True, 32, 1, False),        # decoder 5
    (torch.float32, True, 256, 64, False),      # weights past a CTA's room
    (torch.float32, True, 64, 16, False),
    (torch.bfloat16, True, 128, 64, False),     # bfloat16: cuDNN
    (torch.float64, True, 64, 32, False),
    (torch.float32, False, 128, 64, False),     # the CPU: plain or library
])
def test_takes_kernel_rule(dtype, cuda, c, f, takes):
    weight = torch.empty((c, f, 3, 3), dtype=torch.float32)
    assert s2.takes_kernel(_seen(dtype, cuda), weight) is takes
    assert s2.takes_kernel(_seen(dtype, cuda),
                           weight.to(torch.bfloat16)) is False


def test_a_float32_hybrid_step_sends_four_calls_to_the_kernel():
    """Of the Hybrid VAE's trunk convolutions, on a float32 CUDA tensor the
    rule picks decoder layers 3 and 4 (forward), encoder layer 2's data
    gradient and kernel 6's conv1's (the layer-1 weight read as a
    transposed convolution's); under bfloat16 none."""
    from tpuvae_torch.models import HybridVAE

    for dtype, want in ((torch.float32, 4), (torch.bfloat16, 0)):
        with torch.device("meta"):
            model = HybridVAE(latent_dim=128, text_dim=768,
                              input_hw=(128, 1024), dtype=dtype)
        seen = _seen(layers.compute_dtype(dtype))
        enc, dec = model.audio_encoder, model.audio_decoder
        dec_takes = [i for i, conv in enumerate(dec.conv)
                     if s2.takes_kernel(seen, conv.weight)]
        enc_takes = [i for i, conv in enumerate(enc.conv)
                     if i >= 2 and s2.takes_kernel(seen, conv.weight)]
        w1 = enc.conv[1].weight.permute(2, 3, 1, 0)        # as kernel 6's w1
        k6 = s2.takes_kernel(seen, w1.permute(3, 2, 0, 1))
        got = len(dec_takes) + len(enc_takes) + int(k6)
        assert got == want
        if want:
            assert dec_takes == [3, 4] and enc_takes == [2] and k6


# -- the autograd Functions ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c,f,h,w", [(8, 32, 3, 5), (32, 8, 4, 4),
                                     (16, 64, 2, 6)])
def test_s2_conv_transpose_function_matches_autograd_of_the_library(dtype, c,
                                                                    f, h, w):
    x, weight, bias = _case(3, c, f, h, w, 41 + c, dtype)
    cot = torch.randn((3, f, 2 * h, 2 * w), generator=_gen(5), dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y = s2.S2ConvTranspose.apply(*leaves)
    got = torch.autograd.grad(y, leaves, cot)
    ref = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y_ref = F.conv_transpose2d(*ref, stride=2)[..., :2 * h, :2 * w]
    want = torch.autograd.grad(y_ref, ref, cot)
    _close(y.detach(), y_ref.detach(),
           1e-12 if dtype == torch.float64 else 1e-5)
    for a, b in zip(got, want):       # the same convolution_backward call
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cin,cout,hh,ww", [(32, 8, 6, 10), (8, 32, 4, 4),
                                            (64, 16, 2, 8)])
def test_stride2_conv_function_matches_autograd_of_the_library(dtype, cin,
                                                               cout, hh, ww):
    g = _gen(61 + cin)
    x = torch.randn((2, cin, hh, ww), generator=g, dtype=dtype)
    weight = torch.randn((cout, cin, 3, 3), generator=g, dtype=dtype)
    bias = torch.randn((cout,), generator=g, dtype=dtype)
    cot = torch.randn((2, cout, hh // 2, ww // 2), generator=g, dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y = s2.Stride2ConvFn.apply(*leaves)
    got = torch.autograd.grad(y, leaves, cot)
    ref = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y_ref = F.conv2d(F.pad(ref[0], (0, 1, 0, 1)), ref[1], ref[2], stride=2)
    want = torch.autograd.grad(y_ref, ref, cot)
    assert torch.equal(y.detach(), y_ref.detach())      # the same forward
    _close(got[0], want[0], 1e-12 if dtype == torch.float64 else 1e-5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("which", ["x", "weight", "bias"])
def test_functions_compute_only_the_gradients_asked_for(which):
    x, weight, bias = _case(2, 8, 32, 3, 4, 7, torch.float32)
    idx = ("x", "weight", "bias").index(which)
    conv_args = (x.repeat(1, 1, 2, 2), weight.permute(1, 0, 2, 3).contiguous(),
                 bias)
    for fn, args in ((s2.S2ConvTranspose, (x, weight, bias)),
                     (s2.Stride2ConvFn, conv_args)):
        args = [t.clone().requires_grad_(i == idx) for i, t in enumerate(args)]
        y = fn.apply(*args)
        (grad,) = torch.autograd.grad(y.sum(), [args[idx]])
        assert grad.shape == args[idx].shape


def test_layers_on_the_cpu_run_the_library_composition():
    """On the CPU the layers keep their library calls, bit for bit."""
    g = _gen(3)
    dec = layers.Stride2ConvTranspose(64, 32)
    enc = layers.Stride2Conv(64, 128)
    with torch.no_grad():
        for m in (dec, enc):
            m.weight.normal_(generator=g)
            m.bias.normal_(generator=g)
    x = torch.randn((2, 64, 4, 6), generator=g)
    assert torch.equal(dec(x), F.conv_transpose2d(
        x, dec.weight, dec.bias, stride=2)[..., :8, :12])
    assert torch.equal(enc(x), F.conv2d(F.pad(x, (0, 1, 0, 1)), enc.weight,
                                        enc.bias, stride=2))


# -- the layouts the kernel reads -------------------------------------------------------

@pytest.mark.parametrize("kind,nhwc,copied", [
    ("channels_last", True, False),
    ("nchw", False, False),
    ("nchw_w5", True, True),       # rows not 16-byte aligned: a copy
    ("channels_last_c6", True, True),  # pixel vectors not 16-byte aligned
    ("cut_nchw", True, True),      # a (2h + 1) x (2w + 1) result's cut view
])
def test_kernel_input_layouts(kind, nhwc, copied):
    g = _gen(9)
    c, w = (6, 8) if kind.endswith("c6") else (8, 5 if kind.endswith("w5")
                                                else 8)
    if kind.startswith("channels_last"):
        x = torch.randn((2, 4, w, c), generator=g).permute(0, 3, 1, 2)
    elif kind == "cut_nchw":
        x = torch.randn((2, c, 5, w + 1), generator=g)[:, :, :4, :w]
    else:
        x = torch.randn((2, c, 4, w), generator=g)
    got, got_nhwc = s2._kernel_input(x)
    assert got_nhwc is nhwc
    assert (got.data_ptr() != x.data_ptr()) is copied
    assert torch.equal(got, x)
    s = got.stride()
    inner = 1 if nhwc else 3
    assert s[inner] == 1 and all(s[d] % 4 == 0 for d in range(4) if d != inner)


def test_s2_conv_transpose_checks_its_arguments():
    x, weight, bias = _case(1, 8, 32, 2, 2, 1, torch.float32)
    with pytest.raises(ValueError, match="channels"):
        s2.s2_conv_transpose(x[:, :4], weight, bias)
    with pytest.raises(ValueError, match="bias"):
        s2.s2_conv_transpose(x, weight, bias[:4])
    with pytest.raises(ValueError, match="weight"):
        s2.s2_conv_transpose(x, weight[..., :2], bias)
