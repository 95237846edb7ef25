"""The port's kernel modules against the JAX package's Pallas kernels.

Each CUDA kernel of ``tpuvae_torch.ops`` has a plain PyTorch version that
its wrapper runs for a CPU tensor.  Here the plain versions take the same
numpy inputs as the JAX functions, whose Pallas kernels run in interpret
mode on the CPU, and must agree with them:

* kernel 1 (fused STFT + epilogue) to rtol 1e-4 / atol 1e-6 x max power in
  exact mode: fp32 FFT vs the kernel's fp32 Cooley-Tukey dots differ only
  in summation order.  Rolloff may move by one bin (sr / n_fft Hz) when
  the two prefix sums straddle the 85% threshold differently;
* kernels 2 and 3 (tuning, masked median) exactly: every step keeps the
  reference's float32 operation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

SR = 22050
N_FFT = 2048
HOP = 512


def _tones(n_clips: int, n_samples: int, seed: int) -> np.ndarray:
    """Harmonic tones at random pitch with noise (as tests/test_ops.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    clips = []
    for _ in range(n_clips):
        f0 = 220 * 2 ** rng.uniform(-0.5, 0.5)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(4))
        clips.append((sig + 0.1 * rng.normal(size=t.shape)).astype(np.float32))
    return np.stack(clips)


@pytest.fixture(scope="module")
def clips():
    # deliberately not a multiple of the hop
    return _tones(3, 2 * SR + 101, seed=11)


@pytest.fixture(scope="module")
def jax_front_end(clips):
    from tpuvae.ops.stft import stft_fused_features_ct_pallas

    return {exact: stft_fused_features_ct_pallas(
        jnp.asarray(clips), N_FFT, HOP, sr=SR, n_mels=16, exact=exact,
        interpret=True) for exact in (True, False)}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_stft_features_plain_matches_pallas(clips, jax_front_end, exact):
    from tpuvae_torch.ops.stft import stft_fused_features_plain

    want = jax_front_end[exact]
    got = stft_fused_features_plain(torch.from_numpy(clips), N_FFT, HOP,
                                    sr=SR, n_mels=16, exact=exact)
    assert got.power.dtype == (torch.float32 if exact else torch.bfloat16)
    pmax = float(np.max(np.asarray(want.power, np.float32)))
    for name in ("power", "mel_power", "centroid", "bandwidth", "zcr", "rms",
                 "colmax"):
        a = np.asarray(getattr(want, name), np.float32)
        b = getattr(got, name).float().numpy()
        assert a.shape == b.shape, name
        if name == "power" and not exact:
            # both round fp32 power to bf16; the fp32 values differ in
            # the last bits, so a value may land one bf16 step apart
            np.testing.assert_allclose(b, a, rtol=2.0 ** -7,
                                       atol=1e-6 * pmax, err_msg=name)
        elif name in ("power", "colmax", "mel_power"):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6 * pmax,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(got.rolloff.numpy(),
                               np.asarray(want.rolloff), rtol=0,
                               atol=SR / N_FFT * 1.0001)


def test_stft_zcr_is_edge_exact():
    """The zcr of the fused front end counts only sample pairs inside the
    clip (librosa's edge padding never adds a crossing) — same edge case
    as tests/test_ops.py::test_fused_kernel_zcr_is_edge_exact."""
    from tpuvae.dsp import features as jfeat

    from tpuvae_torch.ops.stft import stft_fused_features_plain

    rng = np.random.default_rng(23)
    y = rng.standard_normal((2, 2 * SR + 7)).astype(np.float32)
    y[0, :5] = -0.3          # negative edge: zero padding would add a crossing
    y[1, -5:] = -0.3
    got = stft_fused_features_plain(torch.from_numpy(y), N_FFT, HOP, sr=SR,
                                    n_mels=16)
    want = np.asarray(jfeat.zero_crossing_rate(jnp.asarray(y), N_FFT, HOP))
    np.testing.assert_array_equal(got.zcr.numpy(), want)


def test_stft_power_only_matches_pallas(clips):
    from tpuvae.ops.stft import stft_power_ct_pallas

    from tpuvae_torch.ops.stft import stft_power

    want = np.asarray(stft_power_ct_pallas(jnp.asarray(clips[:2]), N_FFT, HOP,
                                           exact=True, interpret=True))
    got = stft_power(torch.from_numpy(clips[:2]), N_FFT, HOP)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * want.max())


@pytest.mark.parametrize("exact", [True, False], ids=["f32", "bf16"])
def test_tuning_plain_matches_pallas(jax_front_end, exact):
    """Kernel 2's plain version equals estimate_tuning_pallas on the same
    power and colmax, bit for bit."""
    from tpuvae.ops.tuning import estimate_tuning_pallas

    from tpuvae_torch.ops.tuning import estimate_tuning, estimate_tuning_plain

    fe = jax_front_end[exact]
    want = np.asarray(estimate_tuning_pallas(fe.power, SR, N_FFT,
                                             colmax=fe.colmax, interpret=True))
    dtype = torch.float32 if exact else torch.bfloat16
    power = torch.from_numpy(np.array(fe.power, np.float32)).to(dtype)
    colmax = torch.from_numpy(np.array(fe.colmax, np.float32))
    got = estimate_tuning_plain(power, colmax, SR, N_FFT)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        estimate_tuning(power, colmax, SR, N_FFT).numpy(), want)


def test_tuning_plain_matches_pallas_on_silence_and_noise():
    """No candidates at all (silence: tuning 0) and a flat noise spectrum
    (many near-equal magnitudes around the median)."""
    from tpuvae.ops.stft import stft_fused_features_ct_pallas
    from tpuvae.ops.tuning import estimate_tuning_pallas

    from tpuvae_torch.ops.tuning import estimate_tuning_plain

    y = np.zeros((2, SR), np.float32)
    y[1] = np.random.default_rng(8).normal(size=SR).astype(np.float32)
    fe = stft_fused_features_ct_pallas(jnp.asarray(y), N_FFT, HOP, sr=SR,
                                       n_mels=16, exact=True, interpret=True)
    want = np.asarray(estimate_tuning_pallas(fe.power, SR, N_FFT,
                                             colmax=fe.colmax, interpret=True))
    got = estimate_tuning_plain(torch.from_numpy(np.array(fe.power)),
                                torch.from_numpy(np.array(fe.colmax)), SR,
                                N_FFT)
    assert want[0] == 0.0
    np.testing.assert_array_equal(got.numpy(), want)


def test_staged_tuning_route_matches_fused(jax_front_end):
    from tpuvae_torch.dsp.chroma import estimate_tuning_batch

    fe = jax_front_end[False]
    power = torch.from_numpy(np.array(fe.power, np.float32)).to(
        torch.bfloat16)
    colmax = torch.from_numpy(np.array(fe.colmax, np.float32))
    fused = estimate_tuning_batch(power, SR, N_FFT, colmax, route="fused")
    staged = estimate_tuning_batch(power, SR, N_FFT, colmax, route="staged")
    np.testing.assert_array_equal(staged.numpy(), fused.numpy())
    with pytest.raises(ValueError, match="route"):
        estimate_tuning_batch(power, SR, N_FFT, colmax, route="nope")


def _median_inputs():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(5, 1000)).astype(np.float32) * 100
    mask = rng.random((5, 1000)) < 0.3
    mask[3] = False           # empty mask -> 0.0
    mask[4, :1] = True        # single element
    mask[4, 1:] = False
    vals[2, :50] = 0.0        # ties and signed zeros
    vals[2, 50:60] = -0.0
    return vals, mask


def test_masked_median_matches_pallas():
    from tpuvae.ops.select import masked_median_batch as jax_median

    from tpuvae_torch.ops.select import masked_median_batch

    vals, mask = _median_inputs()
    want = np.asarray(jax_median(jnp.asarray(vals), jnp.asarray(mask),
                                 interpret=True))
    got = masked_median_batch(torch.from_numpy(vals), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (0, 1, 2):
        np.testing.assert_allclose(got[i].item(), np.median(vals[i][mask[i]]),
                                   rtol=1e-6)


def test_select_stats_match_pallas_kernel_outputs():
    """Kernel 3's plain version returns the Pallas kernel's four numbers
    per row, including the empty-mask and single-element rows."""
    import jax

    from tpuvae.dsp.chroma import _float_order_key
    from tpuvae.ops.select import _masked_median_stats

    from tpuvae_torch.ops.select import masked_keys, select_stats

    vals, mask = _median_inputs()
    packed = jnp.where(jnp.asarray(mask), _float_order_key(jnp.asarray(vals)),
                       jnp.uint32(0xFFFFFFFF))
    jkeys = jax.lax.bitcast_convert_type(packed ^ jnp.uint32(0x80000000),
                                         jnp.int32)
    keys = masked_keys(torch.from_numpy(vals), torch.from_numpy(mask))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    pad = (-vals.shape[1]) % 128
    jk = jnp.pad(jkeys, ((0, 0), (0, pad)), constant_values=2**31 - 1)
    want = np.asarray(_masked_median_stats(jk.reshape(5, -1, 128), True))[:, 0]
    got = select_stats(keys)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[:, [0, 1, 3]],
                                  want[:, [0, 1, 3]])
    # cnt_le of the Pallas kernel also counts the 128-lane pad keys when
    # key_lo is the sentinel (empty mask): compare without the pad there
    np.testing.assert_array_equal(got.numpy()[:3, 2], want[:3, 2])
    np.testing.assert_array_equal(got.numpy()[4, 2], want[4, 2])
    assert got[3, 2].item() == vals.shape[1]


def test_float_order_key_roundtrip_and_order():
    from tpuvae_torch.ops.select import float_order_key, key_to_float

    x = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf],
                     dtype=torch.float32)
    k = float_order_key(x)
    assert torch.all(k[1:] > k[:-1])
    back = key_to_float(k)
    np.testing.assert_array_equal(back.numpy().view(np.int32),
                                  x.numpy().view(np.int32))


def test_wrappers_run_plain_versions_on_cpu_without_launching(clips):
    from tpuvae_torch import ops
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
    )

    ops.reset_launch_counts()
    y = torch.from_numpy(clips[:1])
    a = stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=16, exact=True)
    b = stft_fused_features_plain(y, N_FFT, HOP, sr=SR, n_mels=16, exact=True)
    for x, z in zip(a, b):
        torch.testing.assert_close(x, z, rtol=0, atol=0)
    x = torch.from_numpy(clips[:1, :64].reshape(8, 8))
    torch.testing.assert_close(ops.pairwise.self_distances(x),
                               ops.pairwise.self_distances_plain(x),
                               rtol=0, atol=0)
    img = torch.from_numpy(clips[:1, :128].reshape(1, 8, 16, 1))
    args = [img, torch.ones((3, 3, 1, 32)), torch.zeros(32), torch.ones(32),
            torch.zeros(32), torch.ones((3, 3, 32, 64)) * 0.01, torch.zeros(64)]
    got = ops.fusedconv.fused_trunk2_forward(*args)
    want = ops.fusedconv.fused_trunk2_forward_plain(*args)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert set(ops.launch_counts().values()) == {0}
    assert set(ops.launch_counts()) == {"stft_features", "tuning",
                                        "masked_median_select", "pairwise",
                                        "stft_dense", "fusedconv_conv0",
                                        "fusedconv_conv1"}


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card is an error, never a silent
    plain run."""
    from tpuvae_torch.ops.select import select_stats
    from tpuvae_torch.ops.stft import stft_fused_features
    from tpuvae_torch.ops.tuning import estimate_tuning

    y = torch.empty((1, 4096), device="meta")
    with pytest.raises(ValueError, match="device"):
        stft_fused_features(y, sr=SR, n_mels=16)
    with pytest.raises(ValueError, match="device"):
        estimate_tuning(torch.empty((1, 1025, 9), device="meta"),
                        torch.empty((1, 9), device="meta"), SR, N_FFT)
    with pytest.raises(ValueError, match="device"):
        select_stats(torch.empty((1, 9), dtype=torch.int32, device="meta"))
