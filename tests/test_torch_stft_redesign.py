"""Host-side halves of the two STFT kernels' Hopper designs, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); what
they take from the host — tables, layouts, index maps and the arithmetic
scheme — is tested here:

* kernel 4 (``csrc/stft_dense.cu``) multiplies on the tensor cores in
  3xTF32: the TF32 split of the bases, their K-major interleaved layout,
  and an emulation of the three-product sum against the plain version at
  the kernel's tolerance (rtol 1e-4 / atol 1e-6 x max power), which a
  one-product emulation must miss; and, with the tensor cores' truncating
  accumulator modelled, its error bound (max within 1e-5 of the max power,
  signed mean over the bins above 1e-3 of it within 1e-6), which the
  promoted 32-sample partial sums meet and one long sum misses;
* kernel 1 (``csrc/stft_features.cu``) runs a radix-32 x 32 FFT in
  registers: an emulation of its decomposition, lane by lane and register
  by register, with the kernel's twiddle tables and bit-reversed register
  order, against ``torch.fft`` (1e-5 of the peak), and the compressed mel
  filterbank against the dense one.
"""

import numpy as np
import pytest
import torch

from tpuvae_torch.dsp import primitives as prim
from tpuvae_torch.ops import stft as ops_stft


def _noise(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- kernel 4: the TF32 split and the interleaved K-major bases ---------------

def _round_tf32_torch(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on a torch tensor, by integer arithmetic on the
    bit pattern (independent of the numpy helper under test)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("n_fft", [2048, 512])
def test_tf32_split_of_the_bases(n_fft):
    basis = ops_stft._interleaved_basis(n_fft)
    hi, lo = ops_stft._split_tf32(basis)
    assert hi.dtype == lo.dtype == np.float32
    # both halves are TF32 values: the 13 low mantissa bits are zero
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # hi is the nearest TF32 value, hi + lo reproduces the basis to 2^-21
    err_hi = np.abs(basis.astype(np.float64) - hi)
    assert (err_hi <= 2.0 ** -11 * np.abs(basis)).all()
    err = np.abs(basis.astype(np.float64) - hi.astype(np.float64) - lo)
    assert (err <= 2.0 ** -21 * np.abs(basis)).all()
    assert err.max() > 0                       # a split, not a copy
    np.testing.assert_array_equal(
        hi, _round_tf32_torch(torch.from_numpy(basis)).numpy())


def test_round_tf32_ties_and_signs():
    one = np.float32(1.0).view(np.uint32)
    cases = np.array([one | 0x0FFF, one | 0x1000, one | 0x1001, one | 0x3000],
                     np.uint32).view(np.float32)
    want = np.array([one, one + 0x2000, one + 0x2000, one + 0x4000],
                    np.uint32).view(np.float32)
    np.testing.assert_array_equal(ops_stft._round_tf32(cases), want)
    np.testing.assert_array_equal(ops_stft._round_tf32(-cases), -want)
    np.testing.assert_array_equal(ops_stft._round_tf32(np.zeros(3, np.float32)),
                                  np.zeros(3, np.float32))


@pytest.mark.parametrize("n_fft", [2048, 512, 48])
def test_interleaved_basis_layout(n_fft):
    cos_w, sin_w = ops_stft._folded_basis(n_fft)
    basis = ops_stft._interleaved_basis(n_fft)
    n_half = n_fft // 2
    nb_pad, k_pad = basis.shape[0] // 2, basis.shape[1]
    assert nb_pad % 128 == 0 and nb_pad >= n_half
    assert k_pad % 32 == 0 and n_fft <= k_pad < n_fft + 32
    # rows 2 k / 2 k + 1 are cos / sin of packed bin k, K-major
    for k in (1, 2, n_half // 2, n_half - 1):
        np.testing.assert_array_equal(basis[2 * k, :n_fft], cos_w[:, k])
        np.testing.assert_array_equal(basis[2 * k + 1, :n_fft], sin_w[:, k])
    np.testing.assert_array_equal(basis[0, :n_fft], cos_w[:, 0])
    # bin 0's sin row (identically zero) carries the Nyquist cosine
    assert not sin_w[:, 0].any()
    np.testing.assert_array_equal(basis[1, :n_fft], cos_w[:, n_half])
    assert np.abs(sin_w[:, n_half]).max() < 1e-6 * np.abs(cos_w[:, n_half]).max()
    assert not basis[2 * n_half:].any() and not basis[:, n_fft:].any()


def _emulated_dense_power(y, n_fft, hop, passes):
    """Kernel 4's arithmetic in plain PyTorch: frames and bases rounded to
    TF32, ``passes`` products (3: lo x hi + hi x lo + hi x hi; 1: hi x hi)
    accumulated in fp32, unpacked as the kernel's epilogue does."""
    frames = prim.frame_signal(y, n_fft, hop)
    b_hi, b_lo, _, _ = ops_stft._packed_basis("cpu", n_fft)
    b_hi, b_lo = b_hi[:, :n_fft].T, b_lo[:, :n_fft].T
    a_hi = _round_tf32_torch(frames)
    a_lo = _round_tf32_torch(frames - a_hi)
    z = a_hi @ b_hi
    if passes == 3:
        z = (a_lo @ b_hi + a_hi @ b_lo) + z
    n_half = n_fft // 2
    re, im = z[..., 0:2 * n_half:2], z[..., 1:2 * n_half:2]
    power = torch.empty((y.shape[0], n_half + 1, frames.shape[1]))
    power[:, :n_half] = (re * re + im * im).transpose(1, 2)
    power[:, 0] = re[..., 0] ** 2
    power[:, n_half] = im[..., 0] ** 2
    return power


def _loud_and_faint_clips(n_samples, sr=22050):
    """Two clips whose power spans 80 dB: a loud tone plus one 1e-4 of its
    amplitude, and the same with noise."""
    t = np.arange(n_samples) / sr
    tone = np.sin(2 * np.pi * 440.0 * t) + 1e-4 * np.sin(2 * np.pi * 3000.0 * t)
    noisy = tone + 1e-3 * np.random.default_rng(7).normal(size=n_samples)
    return torch.from_numpy(np.stack([tone, noisy]).astype(np.float32))


def test_three_tf32_products_hold_the_kernel_tolerance_and_one_does_not():
    y = _loud_and_faint_clips(6000)
    want = ops_stft.stft_power_dense_plain(y, 512, 128)
    pmax = want.max().item()
    got3 = _emulated_dense_power(y, 512, 128, passes=3)
    torch.testing.assert_close(got3, want, rtol=1e-4, atol=1e-6 * pmax)
    got1 = _emulated_dense_power(y, 512, 128, passes=1)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got1, want, rtol=1e-4, atol=1e-6 * pmax)
    assert (got1 - want).abs().max().item() > 1e-5 * pmax


# -- kernel 4: the tensor cores' truncating accumulator ------------------------

# chip_smoke.py's bounds on kernel 4's error, as shares of the max power: the
# largest error, and the signed mean over the bins above 1e-3 of the max power
K4_MAX_ERR_SHARE = 1e-5
K4_MEAN_ERR_SHARE = 1e-6


def _round_toward_zero_f32(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x64.to(torch.float32)
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _truncating_dense_power(y, n_fft, hop, promote):
    """Kernel 4's three TF32 products with the tensor cores' accumulation
    modelled: each ``wgmma`` m64n64k8 adds its 8 exact products of TF32
    values to the fp32 accumulator, truncating.  ``promote`` (the kernel's
    scheme): the 12 products of each 32-sample stage (small terms first)
    build a partial sum whose first product overwrites it, and the partial
    is added into fp32 running sums, rounded to nearest.  Otherwise (the
    kernel's first design): all 3 x n_fft / 8 products of a frame in one
    accumulator."""
    frames = prim.frame_signal(y, n_fft, hop)
    b_hi, b_lo, _, _ = ops_stft._packed_basis("cpu", n_fft)
    n_half = n_fft // 2
    b_hi = b_hi[:2 * n_half, :n_fft].T.double()
    b_lo = b_lo[:2 * n_half, :n_fft].T.double()
    a_hi = _round_tf32_torch(frames)
    a_lo = _round_tf32_torch(frames - a_hi).double()
    a_hi = a_hi.double()
    acc = torch.zeros((*frames.shape[:-1], 2 * n_half))
    run = torch.zeros_like(acc)
    for stage in range(n_fft // 32):
        for i, (a, b) in enumerate(((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))):
            for kk in range(4):
                k0 = stage * 32 + kk * 8
                s = a[..., k0:k0 + 8] @ b[k0:k0 + 8]
                first = promote and i == 0 and kk == 0
                acc = _round_toward_zero_f32(s if first else acc.double() + s)
        if promote:
            run = run + acc
    z = run if promote else acc
    re, im = z[..., 0::2], z[..., 1::2]
    power = torch.empty((y.shape[0], n_half + 1, frames.shape[1]))
    power[:, :n_half] = (re * re + im * im).transpose(1, 2)
    power[:, 0] = re[..., 0] ** 2
    power[:, n_half] = im[..., 0] ** 2
    return power


def _error_shares(got, want):
    pmax = want.max().item()
    err = got - want
    sel = want > 1e-3 * pmax
    return err.abs().max().item() / pmax, err[sel].mean().item() / pmax


def _harmonic_clips(n_samples, sr=22050):
    rng = np.random.default_rng(21)
    t = np.arange(n_samples) / sr
    clips = []
    for i in range(2):
        f0 = 110 * 2 ** rng.uniform(0, 3)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(1 + 2 * i))
        clips.append(0.25 * sig + 0.03 * rng.normal(size=n_samples))
    return torch.from_numpy(np.stack(clips).astype(np.float32))


@pytest.mark.parametrize("clips", ["harmonic", "80dB"])
def test_one_truncating_sum_fails_the_error_bound_and_promoted_partials_pass(
        clips):
    """At n_fft 2048 one truncating accumulator per frame leaves the power
    biased low by more than ``K4_MEAN_ERR_SHARE`` of the max power (the
    kernel's first design measured 4.1e-5 at the max on the card) and fails; the
    kernel's promoted 32-sample partial sums pass both bounds."""
    y = (_harmonic_clips(2 * 22050) if clips == "harmonic"
         else _loud_and_faint_clips(2 * 22050))
    want = ops_stft.stft_power_dense_plain(y, 2048, 512)
    long_max, long_mean = _error_shares(
        _truncating_dense_power(y, 2048, 512, promote=False), want)
    assert long_max > K4_MAX_ERR_SHARE
    assert long_mean < -K4_MEAN_ERR_SHARE
    prom_max, prom_mean = _error_shares(
        _truncating_dense_power(y, 2048, 512, promote=True), want)
    assert prom_max <= K4_MAX_ERR_SHARE
    assert abs(prom_mean) <= K4_MEAN_ERR_SHARE
    assert abs(prom_mean) < abs(long_mean) / 20


# -- kernel 1: the radix-32 x 32 FFT in registers -----------------------------

def _brev5(k):
    return (((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2)
            | ((k & 16) >> 4))


def _fft32_registers(v):
    """The kernel's ``fft32``: five radix-2 decimation-in-frequency stages
    over the last axis (the 32 registers of a lane), fp32 complex; register
    ``i`` ends up holding ``X[brev5(i)]``."""
    v = v.clone()
    w32 = torch.polar(torch.ones(16, dtype=torch.float64),
                      -2 * torch.pi * torch.arange(16, dtype=torch.float64) / 32
                      ).to(torch.complex64)
    for s in range(5):
        half = 16 >> s
        for g in range(1 << s):
            for q in range(half):
                i0 = g * 2 * half + q
                i1 = i0 + half
                a, b = v[..., i0].clone(), v[..., i1].clone()
                v[..., i0] = a + b
                v[..., i1] = (a - b) * w32[q << s]
    return v


def _fft1024_as_the_kernel(z, xtw):
    """1024-point complex FFT of ``z (..., 1024)`` the way a warp of kernel 1
    runs it: lane ``l`` holds points ``l + 32 j``; 32-point FFTs over ``j``;
    the exchange twiddles ``xtw[k1, l]``; a transpose; 32-point FFTs over
    ``l``; lane ``c`` register ``brev5(k2)`` holds ``Z[c + 32 k2]``."""
    lanes = z.reshape(*z.shape[:-1], 32, 32).transpose(-1, -2)    # [l, j]
    a = _fft32_registers(lanes)
    nat = [_brev5(k) for k in range(32)]
    a = a[..., nat]                                               # [l, k1]
    a = a * xtw.transpose(0, 1)                                   # [k1, l].T
    b = _fft32_registers(a.transpose(-1, -2))                     # [c=k1, l]
    b = b[..., nat]                                               # [c, k2]
    return b.transpose(-1, -2).reshape(*z.shape[:-1], 1024)       # c + 32 k2


def _as_complex(t):
    return torch.complex(t[..., 0], t[..., 1])


def test_radix32_decomposition_with_the_kernel_tables_equals_fft():
    _, _, xtw = ops_stft._fft_tables(2048)
    assert xtw.shape == (32, 32, 2) and xtw.dtype == np.float32
    x = _noise((3, 1024, 2), 11)
    z = _as_complex(torch.from_numpy(x))
    got = _fft1024_as_the_kernel(z, _as_complex(torch.from_numpy(xtw)))
    want = torch.fft.fft(z.to(torch.complex128), dim=-1)
    peak = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * peak


def test_real_input_split_with_the_kernel_tables_equals_rfft():
    window, tw, xtw = ops_stft._fft_tables(2048)
    assert window.shape == (2048,) and tw.shape == (1025, 2)
    frame = torch.from_numpy(_noise((2, 2048), 12))
    zc = _fft1024_as_the_kernel(
        torch.complex(frame[:, 0::2], frame[:, 1::2]),
        _as_complex(torch.from_numpy(xtw)))
    k = torch.arange(1025)
    zk = zc[:, k % 1024]
    zm = zc[:, (1024 - k) % 1024]
    even = 0.5 * (zk + zm.conj())
    odd = -0.5j * (zk - zm.conj())
    got = even + _as_complex(torch.from_numpy(tw)) * odd
    want = torch.fft.rfft(frame.double(), dim=-1)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    # the Nyquist twiddle is exactly -1: the kernel's lane 0 relies on it
    np.testing.assert_array_equal(tw[1024], np.array([-1.0, 0.0], np.float32))


def test_partner_of_the_split_sits_in_lane_32_minus_c_register_31_minus_r():
    # bin k = c + 32 r pairs with M - k; the kernel fetches it by shuffle
    for c in range(32):
        for r in range(32):
            k = c + 32 * r
            partner = (1024 - k) % 1024
            if c:
                assert partner == (32 - c) + 32 * (31 - r)
            else:
                assert partner == 32 * ((32 - r) & 31)


@pytest.mark.parametrize("n_mels", [128, 40])
def test_compressed_mel_filterbank_equals_the_dense_one(n_mels):
    fb = prim.mel_filterbank(22050, 2048, n_mels)
    weights, meta = ops_stft._mel_csr(fb)
    assert meta.shape == (n_mels, 3) and meta.dtype == np.int32
    assert weights.dtype == np.float32 and len(weights) == (fb != 0).sum()
    power = np.abs(_noise((1025, 5), 13))
    got = np.stack([weights[off:off + last - first] @ power[first:last]
                    for first, last, off in meta])
    np.testing.assert_allclose(got, fb @ power, rtol=1e-5, atol=1e-6)
    # a run never skips a non-zero weight and never includes a zero one
    assert (weights != 0).all()
