"""Kernel 1 at every STFT geometry of the JAX kernel, the ``ct`` method and
what ``auto`` resolves to, against the JAX package.

* The port's predicate ``stft_kernel_supports`` takes every ``(n_fft,
  hop)`` that ``tpuvae.ops.stft.ct_pallas_supports`` takes for n_fft up to
  8,192 (the JAX kernel's VMEM model stops at 5,888) and nothing its
  factorisation refuses (256 | n_fft, hop | n_fft).
* Kernel 1's plain version against ``stft_fused_features_ct_pallas`` in
  interpret mode at six geometries, both modes, with the tolerances of
  ``tests/test_torch_ops.py``: rtol 1e-4 / atol 1e-6 x max power in exact
  mode (an FFT against fp32 Cooley-Tukey dots, sums in another order),
  bf16 power within one bf16 step, and rolloff within one bin, sr / n_fft
  (two prefix sums may straddle the 85% threshold differently).
* The kernel's mixed-radix plan (every size but 2048), emulated in float64
  on the host tables the kernel reads, equals ``numpy.fft``: the digit
  reversal, the in-place stages, the twiddle strides and the real-input
  split.
* ``ct`` against the JAX ``ct`` (fp32 matmuls both; rtol 1e-4 / atol 1e-6
  x max power), with a custom window and edge padding.
* ``ct_pallas`` with a non-constant ``pad_mode`` against the JAX kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

SR = 22050
GEOMETRIES = [(256, 64), (768, 192), (1280, 320), (3072, 768), (4096, 1024),
              (5632, 512)]


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


def _hold_front_end(got, want, n_fft: int, exact: bool) -> None:
    """Kernel 1's outputs against the JAX kernel's, the tolerances of
    tests/test_torch_ops.py with the rolloff's bin at this n_fft."""
    pmax = float(np.max(np.asarray(want.power, np.float32)))
    for name in ("power", "mel_power", "centroid", "bandwidth", "zcr", "rms",
                 "colmax"):
        a = np.asarray(getattr(want, name), np.float32)
        b = getattr(got, name).float().numpy()
        assert a.shape == b.shape, name
        if name == "power" and not exact:
            np.testing.assert_allclose(b, a, rtol=2.0 ** -7,
                                       atol=1e-6 * pmax, err_msg=name)
        elif name in ("power", "colmax", "mel_power"):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6 * pmax,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(got.rolloff.numpy(), np.asarray(want.rolloff),
                               rtol=0, atol=SR / n_fft * 1.0001)


# -- the predicate -----------------------------------------------------------

def test_predicate_is_a_superset_of_ct_pallas_supports():
    from tpuvae.ops.stft import ct_pallas_supports

    from tpuvae_torch.ops.stft import KERNEL_MAX_N_FFT, stft_kernel_supports

    jax_domain, port_domain = set(), set()
    for n_fft in range(256, 8193):
        for hop in range(1, n_fft + 1):
            if n_fft % hop:
                continue
            if n_fft % 256 == 0 and ct_pallas_supports(n_fft, hop):
                jax_domain.add((n_fft, hop))
            if stft_kernel_supports(n_fft, hop):
                port_domain.add((n_fft, hop))
    assert jax_domain <= port_domain
    # nothing the JAX kernel's factorisation refuses
    assert all(n % 256 == 0 and n % h == 0 for n, h in port_domain)
    assert max(n for n, _ in jax_domain) == KERNEL_MAX_N_FFT == 5888
    assert {n for n, _ in port_domain} == set(range(256, 5889, 256))
    assert not stft_kernel_supports(1000, 250)
    assert not stft_kernel_supports(2048, 500)
    assert not stft_kernel_supports(2048, 0)


def test_explicit_ct_pallas_raises_the_jax_words_off_the_domain():
    from tpuvae.dsp import stft_power as jax_stft_power

    from tpuvae_torch.dsp.primitives import stft_power
    from tpuvae_torch.ops.stft import stft_fused_features

    y = np.zeros((1, 4096), np.float32)
    for n_fft, hop in ((1000, 250), (2048, 500), (6144, 512)):
        with pytest.raises(ValueError) as jax_err:
            jax_stft_power(jnp.asarray(y), n_fft, hop, method="ct_pallas")
        with pytest.raises(ValueError) as port_err:
            stft_power(torch.from_numpy(y), n_fft, hop, method="ct_pallas")
        assert str(port_err.value) == str(jax_err.value)
        with pytest.raises(ValueError, match=r"256 \| n_fft and hop \| n_fft"):
            stft_fused_features(torch.from_numpy(y), n_fft, hop, sr=SR,
                                n_mels=16)


# -- the resolver ------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,window,pad_mode,want", [
    (2048, 512, None, "constant", "ct_pallas"),
    (256, 64, None, "constant", "ct_pallas"),
    (768, 192, None, "constant", "ct_pallas"),
    (3072, 768, None, "constant", "ct_pallas"),
    (5632, 512, None, "constant", "ct_pallas"),
    (5632, 5632, None, "constant", "ct_pallas"),
    (1024, 256, "hamming", "constant", "fft"),
    (1024, 256, None, "edge", "fft"),
    (1000, 250, None, "constant", "fft"),
    (2048, 500, None, "constant", "fft"),
    (5888, 8, None, "constant", "ct_pallas"),
    (6144, 512, None, "constant", "fft"),
    (8192, 2048, None, "constant", "fft"),
])
def test_auto_resolves_to_kernel_1_only_where_it_takes_the_geometry(
        n_fft, hop, window, pad_mode, want):
    from tpuvae_torch.dsp.primitives import resolve_stft_method

    w = None if window is None else np.hamming(n_fft).astype(np.float32)
    assert resolve_stft_method("auto", n_fft, hop, window=w,
                               pad_mode=pad_mode) == want
    for explicit in ("ct_pallas", "pallas", "fft", "dft", "ct"):
        assert resolve_stft_method(explicit, n_fft, hop) == explicit


def test_auto_never_raises_for_a_valid_geometry():
    from tpuvae_torch.config import AdvancedPreprocessConfig, PreprocessConfig
    from tpuvae_torch.dsp.features import resolve_numerics
    from tpuvae_torch.dsp.primitives import resolve_stft_method

    rng = np.random.default_rng(0)
    for n_fft in list(rng.integers(2, 9000, 300)) + [256 * q for q in
                                                     range(1, 36)]:
        for hop in (1, 7, int(n_fft) // 4 or 1, int(n_fft), 500):
            for pad_mode in ("constant", "edge", "reflect"):
                got = resolve_stft_method("auto", int(n_fft), hop,
                                          pad_mode=pad_mode)
                assert got in ("ct_pallas", "fft")
    assert resolve_numerics(PreprocessConfig()) == (False, "ct_pallas")
    assert resolve_numerics(PreprocessConfig(
        n_fft=1000, hop_length=250)) == (False, "fft")
    assert resolve_numerics(AdvancedPreprocessConfig(
        n_fft=3072, hop_length=768, precision_mode="exact")) == (
        True, "ct_pallas")
    assert resolve_numerics(PreprocessConfig(n_fft=1000, hop_length=250),
                            "dft") == (False, "dft")


def test_auto_off_the_domain_runs_the_fft_route_end_to_end():
    """``extract_basic_features`` at n_fft 1000 under ``auto``: the staged
    FFT route, equal to ``stft_method='fft'``; explicit ``ct_pallas``
    raises there."""
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features

    y = torch.from_numpy(_tones(2, SR, 4))
    kw = dict(duration=1.0, n_fft=1000, hop_length=250)
    auto = extract_basic_features(y, PreprocessConfig(**kw))
    fft = extract_basic_features(y, PreprocessConfig(stft_method="fft", **kw))
    torch.testing.assert_close(auto, fft, rtol=0, atol=0)
    assert torch.isfinite(auto).all()
    with pytest.raises(ValueError, match="ct_pallas requires"):
        extract_basic_features(y, PreprocessConfig(stft_method="ct_pallas",
                                                   **kw))


# -- kernel 1's plain version against the JAX kernel ---------------------------

@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("n_fft,hop", GEOMETRIES,
                         ids=[f"{n}-{h}" for n, h in GEOMETRIES])
def test_stft_features_plain_matches_pallas_at_each_geometry(n_fft, hop,
                                                             exact):
    from tpuvae.ops.stft import stft_fused_features_ct_pallas

    from tpuvae_torch.ops.stft import stft_fused_features

    # about 1 s, not a multiple of the hop
    clips = _tones(2, SR + 101, seed=n_fft)
    want = stft_fused_features_ct_pallas(
        jnp.asarray(clips), n_fft, hop, sr=SR, n_mels=32, exact=exact,
        interpret=True)
    got = stft_fused_features(torch.from_numpy(clips), n_fft, hop, sr=SR,
                              n_mels=32, exact=exact)
    assert got.power.dtype == (torch.float32 if exact else torch.bfloat16)
    _hold_front_end(got, want, n_fft, exact)


@pytest.mark.parametrize("pad_mode", ["edge", "reflect"])
def test_ct_pallas_takes_the_pad_modes_of_the_jax_kernel(pad_mode):
    """Power-only and fused wrappers pad as the JAX ones do (the power and
    rms from the padded frames); zcr keeps librosa's edge semantics."""
    from tpuvae.dsp import stft_power as jax_stft_power
    from tpuvae.ops.stft import stft_fused_features_ct_pallas

    from tpuvae_torch.dsp.primitives import stft_power
    from tpuvae_torch.ops.stft import stft_fused_features

    y = _tones(2, 9000, seed=3) + 0.2        # an offset: the edges matter
    want = np.asarray(jax_stft_power(jnp.asarray(y), 1024, 256,
                                     pad_mode=pad_mode, method="ct_pallas"))
    got = stft_power(torch.from_numpy(y), 1024, 256, pad_mode=pad_mode,
                     method="ct_pallas")
    assert tuple(got.shape) == want.shape == (2, 513, 36)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * want.max())
    fe = stft_fused_features_ct_pallas(jnp.asarray(y), 1024, 256, sr=SR,
                                       n_mels=16, pad_mode=pad_mode,
                                       exact=True, interpret=True)
    _hold_front_end(stft_fused_features(torch.from_numpy(y), 1024, 256,
                                        sr=SR, n_mels=16, exact=True,
                                        pad_mode=pad_mode), fe, 1024, True)


# -- the mixed-radix plan the kernel runs -------------------------------------

def _emulate_general_plan(x: np.ndarray, n_fft: int) -> np.ndarray:
    """``csrc/stft_features.cu``'s general plan in float64 on its own
    tables: window, scatter point n to iperm[n], the in-place radix stages
    (butterfly j of a stage of radix R after L points: block j // L, k1 =
    j % L, points base + r L, twiddles tw_m[r k1 m / (L R)]), then the
    real-input split of each bin from Z[k] and Z[m - k]."""
    from tpuvae_torch.ops.stft import _general_tables

    window, split_tw, tw_m, iperm, code = _general_tables(n_fft)
    m = n_fft // 2
    plan = []
    while code:
        plan.append(code & 63)
        code >>= 6
    tw_m = tw_m[:, 0].astype(np.float64) + 1j * tw_m[:, 1]
    split_tw = split_tw[:, 0].astype(np.float64) + 1j * split_tw[:, 1]
    xw = x * window
    buf = np.empty(m, complex)
    buf[iperm] = xw[0::2] + 1j * xw[1::2]
    span = 1
    for radix in plan:
        block = span * radix
        dft = tw_m[(np.outer(np.arange(radix), np.arange(radix)) % radix)
                   * (m // radix)]
        j = np.arange(m // radix)
        base = (j // span) * block + j % span
        idx = base[:, None] + span * np.arange(radix)[None, :]
        v = buf[idx] * tw_m[np.outer(j % span, np.arange(radix))
                            * (m // block)]
        buf[idx] = v @ dft
        span = block
    k = np.arange(m + 1)
    zk, zm = buf[k % m], buf[(m - k) % m]
    even = 0.5 * (zk + np.conj(zm))
    odd = -0.5j * (zk - np.conj(zm))
    return np.abs(even + split_tw * odd) ** 2


@pytest.mark.parametrize("q", [q for q in range(1, 24) if q != 8])
def test_mixed_radix_plan_with_the_kernel_tables_equals_rfft(q):
    from tpuvae_torch.ops.stft import _radix_plan

    n_fft = 256 * q
    plan = _radix_plan(n_fft // 2)
    assert int(np.prod(plan)) == n_fft // 2
    assert all(r in (2, 4, 8, 16, 3, 5, 7, 11, 13, 17, 19, 23) for r in plan)
    # every stage has a butterfly for each of the warp's 32 lanes
    assert all(n_fft // 2 // r >= 32 for r in plan)
    x = np.random.default_rng(q).standard_normal(n_fft)
    from tpuvae_torch.dsp.primitives import hann_window

    want = np.abs(np.fft.rfft(x * hann_window(n_fft))) ** 2
    # float64 arithmetic on the kernel's fp32 tables: ~1e-7 of the largest
    # power; a wrong index or twiddle would be off by its order
    np.testing.assert_allclose(_emulate_general_plan(x, n_fft), want,
                               rtol=1e-5, atol=1e-6 * want.max())


# -- the ct method ------------------------------------------------------------

@pytest.mark.parametrize("n_fft", [256, 2048, 3072])
def test_ct_matches_jax_ct_with_a_custom_window_and_edge_padding(n_fft):
    from tpuvae.dsp import stft_power as jax_stft_power

    from tpuvae_torch.dsp.primitives import stft_power

    y = _tones(2, 9000, seed=n_fft) + 0.2
    window = np.hamming(n_fft).astype(np.float32)
    want = np.asarray(jax_stft_power(jnp.asarray(y), n_fft, n_fft // 4,
                                     window=window, pad_mode="edge",
                                     method="ct"))
    got = stft_power(torch.from_numpy(y), n_fft, n_fft // 4, window=window,
                     pad_mode="edge", method="ct")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * want.max())
    with pytest.raises(ValueError, match="multiple of 256"):
        stft_power(torch.from_numpy(y), 1000, 250, method="ct")


def test_ct_runs_the_staged_route_of_every_extractor():
    """``stft_method='ct'`` is a staged front end: fp32 power, kernel 3's
    tuning route (its plain version here), the same features as the JAX
    package's ``ct`` route."""
    import jax

    from tpuvae.config import AdvancedPreprocessConfig as JaxAdv
    from tpuvae.dsp import features as jfeat

    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.dsp import features as tfeat

    y = _tones(2, 2 * SR, seed=5)
    kw = dict(duration=2.0, fixed_time_steps=64, precision_mode="exact",
              stft_method="ct")
    cfg = AdvancedPreprocessConfig(**kw)
    fe = tfeat._spectral_front_end(torch.from_numpy(y), cfg,
                                   *tfeat.resolve_numerics(cfg))
    assert fe.power.dtype == torch.float32 and fe.colmax is None
    want = jax.jit(lambda a: jfeat.extract_flat_features(a, JaxAdv(**kw)))(
        jnp.asarray(y))
    got = tfeat.extract_flat_features(torch.from_numpy(y), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    img = tfeat.extract_mel_image(torch.from_numpy(y), cfg)
    want_img = jax.jit(lambda a: jfeat.extract_mel_image(a, JaxAdv(**kw)))(
        jnp.asarray(y))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=1e-5,
                               atol=2e-3)


# -- the single-clip chroma functions of the dsp namespace ----------------------

def test_single_clip_chroma_functions_match_jax():
    from tpuvae.dsp import chroma as jchroma

    from tpuvae_torch.dsp import chroma as tchroma
    from tpuvae_torch.ops.stft import stft_power_plain

    y = _tones(1, SR, seed=9)
    power = stft_power_plain(torch.from_numpy(y), 2048, 512)[0]
    want_t = float(jchroma.estimate_tuning_from_power(
        jnp.asarray(power.numpy()), SR, 2048))
    got_t = float(tchroma.estimate_tuning_from_power(power, SR, 2048))
    assert got_t == want_t
    for tuning in (0.0, -0.27, want_t):
        np.testing.assert_allclose(
            tchroma.chroma_filterbank(SR, 2048, tuning).numpy(),
            np.asarray(jchroma.chroma_filterbank(SR, 2048, tuning)),
            rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        tchroma.chroma_from_power(power, SR, 2048).numpy(),
        np.asarray(jchroma.chroma_from_power(jnp.asarray(power.numpy()), SR,
                                             2048)),
        rtol=1e-4, atol=1e-5)
