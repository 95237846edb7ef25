"""The port's dense-DFT STFT (kernel 4) and ``stft_power`` method switch
against the JAX package.

``tpuvae_torch.ops.stft.stft_power_dense`` runs its plain PyTorch version
on a CPU tensor; the JAX ``stft_power_pallas`` runs its Pallas kernel in
interpret mode.  Both multiply the same fp32 frames by the same
window-folded fp32 bases and differ only in the order of the 2,048-term
sums, so the powers agree to rtol 1e-4 with an atol of 1e-6 x max power:
relative error is unbounded in a bin where ``re`` and ``im`` cancel, so
the absolute tolerance scales with the largest power (as
tests/test_ops.py states it for the TPU kernel, there with 1e-3 x max for
the MXU's pass structure).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

RTOL = 1e-4
ATOL_OF_MAX = 1e-6


def _noise(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(want.max()))


def test_dense_plain_matches_pallas_interpret():
    from tpuvae.ops.stft import stft_power_pallas

    from tpuvae_torch.ops.stft import stft_power_dense, stft_power_dense_plain

    y = _noise((3, 44100))              # the shape of tests/test_ops.py
    want = stft_power_pallas(jnp.asarray(y))
    got = stft_power_dense(torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1025, 87)
    _close(got.numpy(), want)
    torch.testing.assert_close(
        got, stft_power_dense_plain(torch.from_numpy(y)), rtol=0, atol=0)


def test_dense_plain_matches_jax_dft_path():
    from tpuvae.dsp import stft_power

    from tpuvae_torch.ops.stft import stft_power_dense

    y = _noise((3, 44100))
    want = stft_power(jnp.asarray(y), method="dft")
    _close(stft_power_dense(torch.from_numpy(y)).numpy(), want)


@pytest.mark.parametrize("n_fft,hop,n_samples", [
    (1024, 256, 30001), (512, 512, 5000), (2048, 1024, 4096), (256, 64, 999)])
def test_dense_other_geometries_match_pallas(n_fft, hop, n_samples):
    from tpuvae.ops.stft import stft_power_pallas

    from tpuvae_torch.ops.stft import stft_power_dense

    y = _noise((2, n_samples), seed=n_fft + hop)
    want = stft_power_pallas(jnp.asarray(y), n_fft, hop)
    got = stft_power_dense(torch.from_numpy(y), n_fft, hop)
    assert tuple(got.shape) == (2, n_fft // 2 + 1, 1 + n_samples // hop)
    _close(got.numpy(), want)


@pytest.mark.parametrize("pad_mode", ["constant", "edge", "reflect", "wrap"])
def test_dense_pad_modes_match_pallas(pad_mode):
    from tpuvae.ops.stft import stft_power_pallas

    from tpuvae_torch.ops.stft import stft_power_dense

    y = _noise((2, 6000), seed=7) + 0.5      # an offset makes the edges matter
    want = stft_power_pallas(jnp.asarray(y), 1024, 256, pad_mode=pad_mode)
    _close(stft_power_dense(torch.from_numpy(y), 1024, 256,
                            pad_mode=pad_mode).numpy(), want)


def test_dense_rejects_bad_hop_and_pad_mode():
    from tpuvae_torch.ops.stft import stft_power_dense, stft_power_dense_plain

    for fn in (stft_power_dense, stft_power_dense_plain):
        with pytest.raises(ValueError, match="hop"):
            fn(torch.zeros((1, 4096)), n_fft=2048, hop_length=500)
    with pytest.raises(ValueError, match="pad_mode"):
        stft_power_dense(torch.zeros((1, 4096)), pad_mode="symmetric")
    with pytest.raises(ValueError, match="batched"):
        stft_power_dense(torch.zeros(4096))
    with pytest.raises(ValueError, match="device"):
        stft_power_dense(torch.empty((1, 4096), device="meta"))


@pytest.mark.parametrize("n_fft", [2048, 512, 96])
def test_packed_basis_layout_reproduces_the_plain_version(n_fft):
    """The layout the CUDA kernel reads: K-major rows, cos and sin of packed
    bin ``k`` in rows ``2 k`` and ``2 k + 1``, ``n_fft // 2`` packed bins
    zero-padded to a multiple of 128 and the samples to a multiple of 32,
    the Nyquist bin's cosine in the sin row of bin 0; split into TF32 halves
    whose sum is the fp32 basis.  Multiplying the frames by it and unpacking
    as the kernel's epilogue does gives the plain version's power."""
    from tpuvae_torch.dsp import primitives as prim
    from tpuvae_torch.ops.stft import _packed_basis, stft_power_dense_plain

    hop = n_fft // 4
    y = torch.from_numpy(_noise((2, 5 * n_fft + 3), seed=n_fft))
    b_hi, b_lo, nb_pad, k_pad = _packed_basis("cpu", n_fft)
    n_half = n_fft // 2
    assert nb_pad % 128 == 0 and nb_pad >= n_half
    assert k_pad % 32 == 0 and k_pad >= n_fft
    assert b_hi.shape == b_lo.shape == (2 * nb_pad, k_pad)
    basis = b_hi + b_lo
    assert not basis[2 * n_half:].any() and not basis[:, n_fft:].any()
    frames = prim.frame_signal(y, n_fft, hop)
    z = frames @ basis[:, :n_fft].T
    re, im = z[..., 0::2], z[..., 1::2]
    power = torch.empty((2, n_half + 1, frames.shape[1]))
    power[:, :n_half] = (re * re + im * im)[..., :n_half].transpose(1, 2)
    power[:, 0] = re[..., 0] ** 2
    power[:, n_half] = im[..., 0] ** 2
    want = stft_power_dense_plain(y, n_fft, hop)
    torch.testing.assert_close(power, want, rtol=1e-5,
                               atol=1e-6 * want.max().item())


@pytest.mark.parametrize("method", ["auto", "ct_pallas", "pallas", "fft",
                                    "dft"])
def test_stft_power_methods_match_jax(method):
    """Each method of the port's ``stft_power`` against the JAX one of the
    same name (its Pallas kernels in interpret mode; 'auto' is the FFT on
    the JAX package's CPU backend and the fused kernel's plain version,
    also an FFT, in the port)."""
    from tpuvae.dsp import stft_power as jax_stft_power

    from tpuvae_torch.dsp.primitives import stft_power

    y = _noise((2, 22050 + 101), seed=3)
    want = jax_stft_power(jnp.asarray(y), method=method)
    got = stft_power(torch.from_numpy(y), method=method)
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(got.numpy(), want)


@pytest.mark.parametrize("method", ["fft", "dft"])
def test_stft_power_custom_window_and_pad_mode_match_jax(method):
    from tpuvae.dsp import stft_power as jax_stft_power

    from tpuvae_torch.dsp.primitives import stft_power

    y = _noise((2, 9000), seed=5) + 0.2
    window = np.hamming(1024).astype(np.float32)
    want = jax_stft_power(jnp.asarray(y), 1024, 256, window=window,
                          pad_mode="edge", method=method)
    got = stft_power(torch.from_numpy(y), 1024, 256, window=window,
                     pad_mode="edge", method=method)
    _close(got.numpy(), want)


def test_stft_power_refuses_what_it_does_not_run():
    from tpuvae_torch.dsp.primitives import frame_signal, stft_power

    y = torch.zeros((1, 4096))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stft_power(y, method="ct")
    with pytest.raises(ValueError, match="stft method"):
        stft_power(y, method="bogus")
    for method in ("pallas", "ct_pallas"):
        with pytest.raises(ValueError, match="window"):
            stft_power(y, window=np.ones(2048, np.float32), method=method)
    with pytest.raises(ValueError, match="pad_mode"):
        stft_power(y, pad_mode="edge", method="ct_pallas")
    with pytest.raises(ValueError, match="hop"):
        stft_power(y, 2048, 500, method="pallas")
    with pytest.raises(ValueError, match="pad_mode"):
        frame_signal(y, 2048, 512, pad_mode="symmetric")


def test_frame_signal_and_dft_basis_match_jax():
    from tpuvae.dsp import primitives as jprim

    from tpuvae_torch.dsp import primitives as prim

    for a, b in zip(prim._dft_basis(512), jprim._dft_basis(512)):
        np.testing.assert_array_equal(a, b)
    y = _noise((2, 3000), seed=9)
    for pad_mode in ("constant", "edge"):
        for frame, hop in ((512, 128), (500, 130)):
            np.testing.assert_array_equal(
                prim.frame_signal(torch.from_numpy(y), frame, hop,
                                  pad_mode=pad_mode).numpy(),
                np.asarray(jprim.frame_signal(jnp.asarray(y), frame, hop,
                                              pad_mode=pad_mode)))


def test_dense_wrapper_counts_no_launch_on_the_cpu():
    from tpuvae_torch.ops.stft import STFT_DENSE, stft_power_dense

    before = STFT_DENSE.launches
    stft_power_dense(torch.zeros((1, 4096)))
    assert STFT_DENSE.launches == before and STFT_DENSE._fn is None
