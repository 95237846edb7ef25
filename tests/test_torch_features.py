"""The port's 370-d feature extraction against the JAX package's.

``tpuvae_torch.dsp.features.extract_basic_features`` (plain kernel
versions on the CPU) and ``tpuvae.dsp.features.extract_basic_features``
(XLA on the CPU) take the same clips.  In exact mode both keep the power
spectrogram in fp32 and every statistic in fp32; they differ only in
summation order (FFT, matmuls, reductions over 87 frames), so the vector
agrees to rtol 1e-4 / atol 1e-3 — the atol covers the near-zero MFCC and
chroma entries whose absolute rounding is ~1e-5 of the dB scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

SR = 22050


def _tones(n_clips: int, n_samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    clips = []
    for _ in range(n_clips):
        f0 = 220 * 2 ** rng.uniform(-0.5, 0.5)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(4))
        clips.append((0.3 * sig + 0.05 * rng.normal(size=t.shape))
                     .astype(np.float32))
    return np.stack(clips)


@pytest.fixture(scope="module")
def clips():
    return _tones(3, 2 * SR, seed=3)


def _jax_features(clips, mode):
    from tpuvae.config import PreprocessConfig as JaxConfig
    from tpuvae.dsp.features import extract_basic_features

    cfg = JaxConfig(duration=2.0, precision_mode=mode)
    return np.asarray(jax.jit(lambda y: extract_basic_features(y, cfg))(
        jnp.asarray(clips)))


def test_extract_basic_features_matches_jax_exact(clips):
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features

    want = _jax_features(clips, "exact")
    got = extract_basic_features(
        torch.from_numpy(clips),
        PreprocessConfig(duration=2.0, precision_mode="exact")).numpy()
    assert got.shape == (3, 370)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_fast_mode_within_the_fast_contract(clips):
    """Fast mode stores the spectrogram as bf16 (chroma and tuning read it);
    held to the JAX package's fast-mode contract against exact mode: 2%
    rtol / 1.0 atol (tpuvae/dsp/features.py:75-76)."""
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features

    exact = _jax_features(clips, "exact")
    fast = extract_basic_features(
        torch.from_numpy(clips),
        PreprocessConfig(duration=2.0, precision_mode="fast")).numpy()
    np.testing.assert_allclose(fast, exact, rtol=0.02, atol=1.0)


@pytest.mark.parametrize("route", ["fused", "staged"])
def test_tuning_routes_give_one_feature_vector(clips, route):
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features

    cfg = PreprocessConfig(duration=2.0)
    y = torch.from_numpy(clips[:2])
    ref = extract_basic_features(y, cfg)
    got = extract_basic_features(y, cfg, tuning_route=route)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_extractor_widens_int16_exactly(clips):
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import (
        extract_basic_features,
        make_extractor,
        resolve_transfer_dtype,
    )

    cfg = PreprocessConfig(duration=2.0)
    assert resolve_transfer_dtype(cfg) == np.int16
    assert resolve_transfer_dtype(
        PreprocessConfig(precision_mode="exact")) == np.float32
    pcm = np.round(clips[:1] * 16000).astype(np.int16)
    fn = make_extractor(extract_basic_features, cfg, torch.device("cpu"))
    a = fn(pcm)
    b = fn(pcm.astype(np.float32) / 32768.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="batched"):
        fn(clips[0])


def test_primitives_match_jax():
    from tpuvae.dsp import primitives as jprim

    from tpuvae_torch.dsp import primitives as prim

    np.testing.assert_array_equal(prim.mel_filterbank(SR, 2048, 128),
                                  jprim.mel_filterbank(SR, 2048, 128))
    np.testing.assert_array_equal(prim._dct_ii_ortho_matrix(128),
                                  jprim._dct_ii_ortho_matrix(128))
    np.testing.assert_array_equal(prim.hann_window(2048),
                                  jprim.hann_window(2048))
    rng = np.random.default_rng(0)
    s = rng.random((2, 16, 9)).astype(np.float32) * 10.0
    s[0, 0, 0] = 0.0
    for ref in (1.0, "max"):
        np.testing.assert_allclose(
            prim.power_to_db(torch.from_numpy(s), ref=ref).numpy(),
            np.asarray(jprim.power_to_db(jnp.asarray(s), ref=ref)),
            rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        prim.dct_ii_ortho(torch.from_numpy(s), 8, dim=-2).numpy(),
        np.asarray(jprim.dct_ii_ortho(jnp.asarray(s), 8, axis=-2)),
        rtol=1e-5, atol=1e-5)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    x[:, 1] = 0.0
    np.testing.assert_allclose(
        prim.normalize_inf(torch.from_numpy(x), dim=0).numpy(),
        np.asarray(jprim.normalize_inf(jnp.asarray(x), axis=0)), rtol=1e-7)
