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
* Its radix-32 x 32 register plan of n_fft 2048 (``csrc/stft_features.cu``),
  emulated in float64 on its host tables and the literal roots of its
  source, equals ``numpy.fft``: the lanes' points, the two 32-point FFTs in
  bit-reversed register order, the W_1024 twiddles, the exchange and the
  partners of the split; ``_fft_consts`` hands each size the tables of the
  plan ``kernel_plan`` names, in the shapes its C entry reads.
* Its register plan of n_fft 256 .. 1,792 (``csrc/stft_small.cu``),
  emulated in float64 on its host tables and the literal roots of its
  source, equals ``numpy.fft``: the lanes' points, the r-point DFT, the
  W_m twiddles, the five lane stages, the partners of the split and the
  placement in the shared power row; ``kernel_plan`` routes each size.
* Its group register plan of n_fft 2,304 .. 5,888
  (``csrc/stft_large.cuh``), emulated the same way: the threads' points,
  the q-point DFT, the W_m twiddles, the plane's rows, pass B's 4-point
  DFT, W_128 twiddles and lane stages, the bins in natural order and the
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


# -- the radix-32 x 32 register plan of n_fft 2048 ----------------------------

def _source_roots(name: str = "stft_small.cu") -> dict:
    """The literal roots ``cos, sin (2 pi e / R)`` of ``csrc/<name>`` (its
    DFTs' twiddles and odd factors), by R, as fp32."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "tpuvae_torch" / "csrc"
           / name).read_text()
    roots = {}
    for kind, size, body in re.findall(
            r"constexpr float (kC|kS)\[(\d+)\] = \{([^}]*)\};", src):
        vals = np.array([float(v.strip().rstrip("f")) for v in body.split(",")],
                        np.float32)
        assert vals.size == int(size)
        roots.setdefault(int(size), {})[kind] = vals
    return {r: (v["kC"], v["kS"]) for r, v in roots.items()}


def _brev(k: int, bits: int) -> int:
    return int(f"{k:0{bits}b}"[::-1], 2) if bits else 0


def _emulate_radix32_plan(x: np.ndarray) -> np.ndarray:
    """``csrc/stft_features.cu`` in float64 on its own tables: lane l takes
    points l + 32 j into register j; the 32-point FFT over the registers
    (five radix-2 decimation-in-frequency stages on the source's literal
    W_32 roots, register i ending with output brev5(i)); output k1 times
    xtw[k1, l]; the exchange (lane c takes output c of every lane l into
    register l); the second 32-point FFT, after which register brev5(k2) of
    lane c holds Z[c + 32 k2]; the split of bin k = c + 32 r with its
    partner from register brev5(31 - r) of lane 32 - c (lane 0: its own
    register brev5((32 - r) & 31)); the Nyquist bin from lane 0's
    register 0."""
    from tpuvae_torch.ops.stft import _fft_tables

    window, split_tw, xtw = _fft_tables(2048)
    cos_t, sin_t = (t.astype(np.float64) for t in
                    _source_roots("stft_features.cu")[16])
    cplx = lambda t: t[..., 0].astype(np.float64) + 1j * t[..., 1]  # noqa: E731
    split_tw, xtw = cplx(split_tw), cplx(xtw)

    def fft32(v):                              # v[register, lane]
        v = v.copy()
        for s in range(5):
            half = 16 >> s
            for g in range(1 << s):
                for q in range(half):
                    i0 = g * 2 * half + q
                    a, b = v[i0].copy(), v[i0 + half].copy()
                    t = q << s
                    v[i0] = a + b
                    v[i0 + half] = (a - b) * (cos_t[t] - 1j * sin_t[t])
        return v

    br = np.array([_brev(i, 5) for i in range(32)])
    xw = x * window
    z = xw[0::2] + 1j * xw[1::2]
    y = fft32(z.reshape(32, 32))[br] * xtw     # y[k1, l] = Y_l[k1] W^(l k1)
    out = fft32(y.T)                           # out[brev5(k2), c]
    lane = np.arange(32)
    power = np.empty(1025)
    for r in range(32):
        zk = out[br[r], lane]
        zm = out[br[31 - r], (32 - lane) & 31]
        zm[0] = out[br[(32 - r) & 31], 0]
        k = lane + 32 * r
        even = 0.5 * (zk + np.conj(zm))
        odd = -0.5j * (zk - np.conj(zm))
        power[k] = np.abs(even + split_tw[k] * odd) ** 2
    z0 = out[0, 0]                             # the Nyquist bin from Z[0]
    power[1024] = np.abs(z0.real + split_tw[1024] * z0.imag) ** 2
    return power


def test_radix32_plan_with_the_kernel_tables_equals_rfft():
    from tpuvae_torch.dsp.primitives import hann_window

    roots = _source_roots("stft_features.cu")
    assert sorted(roots) == [16]
    ang = 2.0 * np.pi * np.arange(16) / 32
    np.testing.assert_allclose(roots[16][0], np.cos(ang), rtol=0, atol=6e-8)
    np.testing.assert_allclose(roots[16][1], np.sin(ang), rtol=0, atol=6e-8)
    x = np.random.default_rng(8).standard_normal(2048)
    want = np.abs(np.fft.rfft(x * hann_window(2048))) ** 2
    # float64 arithmetic on the kernel's fp32 tables and roots: ~1e-7 of
    # the largest power; a wrong index or twiddle would be off by its order
    np.testing.assert_allclose(_emulate_radix32_plan(x), want, rtol=1e-5,
                               atol=1e-6 * want.max())


@pytest.mark.parametrize("q", range(1, 24))
def test_fft_consts_are_the_tables_of_the_plan_that_runs(q):
    from tpuvae_torch.dsp.primitives import hann_window
    from tpuvae_torch.ops.stft import (
        _fft_consts,
        _fft_tables,
        _group_tables,
        _register_tables,
        kernel_plan,
    )

    n_fft = 256 * q
    m = n_fft // 2
    plan = kernel_plan(n_fft)
    tables = {"register32x32": _fft_tables, "register_r": _register_tables,
              "register_w": _group_tables}[plan](n_fft)
    window, twiddle, xtw = _fft_consts("cpu", n_fft)
    # the shapes the C entries document for xtw
    assert tuple(xtw.shape) == {"register32x32": (32, 32, 2),
                                "register_r": (m // 32 + 5, 32, 2),
                                "register_w": (m + 288, 2)}[plan]
    assert tuple(window.shape) == (n_fft,)
    assert tuple(twiddle.shape) == (m + 1, 2)
    for got, want in zip((window, twiddle, xtw), tables):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(window.numpy(), hann_window(n_fft))


# -- the register plan of n_fft 256 .. 1,792 -----------------------------------

def _emulate_register_plan(x: np.ndarray, n_fft: int) -> np.ndarray:
    """``csrc/stft_small.cu`` in float64 on its own tables: lane l takes
    points l + 32 j (j < r); the r-point DFT as the kernel factors it (r =
    P S, P-point DFTs over j = S jp + js, twiddles W_r^(js kp) and the
    paired S-point DFT from the source's roots, output k1 = kp + P ks); the
    W_m^(l k1) twiddle from the host table; the five lane stages (lane l
    with l ^ d: the lower keeps p + v, the upper takes (p - v) times its
    lane twiddle); the split with each partner where the kernel shuffles it
    from (register r - k1 of lane l ^ 31, or register 0 of lane
    brev5((32 - brev5(l)) & 31)); the powers at pad32(k) of the warp's
    row, read back in bin order."""
    from tpuvae_torch.ops.stft import _register_tables

    window, split_tw, xtw = _register_tables(n_fft)
    m = n_fft // 2
    r = m // 32
    big_p = r & -r
    big_s = r // big_p
    cplx = lambda t: t[..., 0].astype(np.float64) + 1j * t[..., 1]  # noqa: E731
    split_tw, xtw = cplx(split_tw), cplx(xtw)
    xw = x * window
    z = xw[0::2] + 1j * xw[1::2]
    v = z.reshape(r, 32)                       # v[j, l] = z[l + 32 j]
    # P-point DFTs over jp for each js: a[kp, js, l]
    a = np.einsum("pk,psl->ksl",
                  np.exp(-2j * np.pi * np.outer(np.arange(big_p),
                                                np.arange(big_p)) / big_p),
                  v.reshape(big_p, big_s, 32))
    y = np.empty((r, 32), complex)
    if big_s == 1:
        y[:] = a[:, 0]
    else:
        cos_t, sin_t = (t.astype(np.float64) for t in _source_roots()[r])
        root = lambda e: cos_t[e % r] - 1j * sin_t[e % r]  # noqa: E731
        for kp in range(big_p):
            b = np.stack([a[kp, js] * root(js * kp) for js in range(big_s)])
            for ks in range(big_s):
                y[kp + big_p * ks] = sum(
                    b[t] * root(((t * ks) % big_s) * (r // big_s))
                    for t in range(big_s))
    y *= xtw[:r]                               # W_m^(l k1), row k1 = 0 is 1
    lane = np.arange(32)
    for s in range(5):
        d = 16 >> s
        partner = y[:, lane ^ d]
        sign = np.where(lane & d, -1.0, 1.0)
        y = (partner + sign * y) * xtw[r + s]
    brl = np.array([_brev(int(q), 5) for q in lane])
    src0 = np.array([_brev(int((32 - b) & 31), 5) for b in brl])
    pad32 = lambda i: i + (i >> 5)             # noqa: E731
    row = np.full(pad32(m) + 1, np.nan)
    for k1 in range(r):
        zm = y[0, src0] if k1 == 0 else y[r - k1, lane ^ 31]
        k = k1 + r * brl
        zk = y[k1]
        even = 0.5 * (zk + np.conj(zm))
        odd = -0.5j * (zk - np.conj(zm))
        assert np.isnan(row[pad32(k)]).all()  # each bin written once
        row[pad32(k)] = np.abs(even + split_tw[k] * odd) ** 2
    zn = y[0, 0]                               # the Nyquist bin from Z[0]
    row[pad32(m)] = np.abs(0.5 * (zn + np.conj(zn)) + split_tw[m] * (
        -0.5j * (zn - np.conj(zn)))) ** 2
    return row[pad32(np.arange(m + 1))]


@pytest.mark.parametrize("q", range(1, 8))
def test_register_plan_with_the_kernel_tables_equals_rfft(q):
    from tpuvae_torch.dsp.primitives import hann_window
    from tpuvae_torch.ops.stft import _register_tables

    n_fft = 256 * q
    _, _, xtw = _register_tables(n_fft)
    assert xtw.shape == (4 * q + 5, 32, 2) and xtw.dtype == np.float32
    x = np.random.default_rng(100 + q).standard_normal(n_fft)
    want = np.abs(np.fft.rfft(x * hann_window(n_fft))) ** 2
    # float64 arithmetic on fp32 tables and roots, as the 2048 test
    np.testing.assert_allclose(_emulate_register_plan(x, n_fft), want,
                               rtol=1e-5, atol=1e-6 * want.max())


def test_register_plan_roots_are_cos_and_sin_in_fp32():
    roots = _source_roots()
    assert sorted(roots) == [12, 20, 24, 28]
    for r, (cos_t, sin_t) in roots.items():
        ang = 2.0 * np.pi * np.arange(r) / r
        np.testing.assert_allclose(cos_t, np.cos(ang), rtol=0, atol=6e-8)
        np.testing.assert_allclose(sin_t, np.sin(ang), rtol=0, atol=6e-8)


@pytest.mark.parametrize("q", range(1, 24))
def test_kernel_plan_routes_each_size(q):
    from tpuvae_torch.ops.stft import (
        STFT_FEATURES,
        STFT_LARGE,
        STFT_SMALL,
        kernel_plan,
        plan_kernel,
    )

    want = "register_r" if q <= 7 else (
        "register32x32" if q == 8 else "register_w")
    assert kernel_plan(256 * q) == want
    # every library counts as kernel 1; each register plan has its own
    assert STFT_SMALL.name == STFT_FEATURES.name == "stft_features"
    assert STFT_SMALL.library == "stft_small"
    lib = plan_kernel(256 * q)
    assert lib.name == "stft_features"
    assert lib.library == ("stft_small" if q <= 7 else "stft_features"
                           if q == 8 else "stft_large_" + "abc"[(q - 9) // 5])
    assert lib in (STFT_FEATURES, STFT_SMALL, *STFT_LARGE.values())
    for bad in (0, 128, 1000, 6144):
        with pytest.raises(ValueError, match="no plan"):
            kernel_plan(bad)


# -- the group register plan of n_fft 2,304 .. 5,888 ---------------------------

def _emulate_group_plan(x: np.ndarray, n_fft: int) -> np.ndarray:
    """``csrc/stft_large.cuh`` in float64 on its own tables: thread t of
    the group takes points t + 128 j (j < q); pass A's q-point DFT as the
    kernel factors it (q = P S, P-point DFTs over j = S jp + js, twiddles
    W_q^(js kp) and the paired S-point DFT from the source's roots, output
    k1 = kp + P ks), times W_m^(t k1) from the host table, to row k1,
    column t of the plane; pass B over each row: lane l takes t = l + 32 a,
    the 4-point DFT over a, W_128^(l c) from the table, the five lane
    stages (lane l with l ^ d: the lower keeps p + v, the upper takes (p -
    v) times its lane twiddle), and lane l's register c to bin k1 + q (c +
    4 brev5(l)) in natural order; then the split of bin k with its partner
    m - k and the Nyquist bin from Z[0]."""
    from tpuvae_torch.ops.stft import _group_tables

    window, split_tw, xtw = _group_tables(n_fft)
    m = n_fft // 2
    q = m // 128
    big_p = q & -q
    big_s = q // big_p
    cplx = lambda t: t[..., 0].astype(np.float64) + 1j * t[..., 1]  # noqa: E731
    split_tw, xtw = cplx(split_tw), cplx(xtw)
    tw_a = xtw[:128 * q].reshape(q, 128)
    tw_b = xtw[128 * q:128 * q + 128].reshape(4, 32)
    tw_lane = xtw[128 * q + 128:].reshape(5, 32)
    xw = x * window
    z = xw[0::2] + 1j * xw[1::2]
    v = z.reshape(q, 128)                      # v[j, t] = z[t + 128 j]
    a = np.einsum("pk,psl->ksl",
                  np.exp(-2j * np.pi * np.outer(np.arange(big_p),
                                                np.arange(big_p)) / big_p),
                  v.reshape(big_p, big_s, 128))
    y = np.empty((q, 128), complex)
    if big_s == 1:
        y[:] = a[:, 0]
    else:
        cos_t, sin_t = (t.astype(np.float64)
                        for t in _source_roots("stft_large.cuh")[q])
        root = lambda e: cos_t[e % q] - 1j * sin_t[e % q]  # noqa: E731
        for kp in range(big_p):
            b = np.stack([a[kp, js] * root(js * kp) for js in range(big_s)])
            for ks in range(big_s):
                y[kp + big_p * ks] = sum(
                    b[t] * root(((t * ks) % big_s) * (q // big_s))
                    for t in range(big_s))
    y *= tw_a                                  # W_m^(t k1), row k1 = 0 is 1
    lane = np.arange(32)
    brl = np.array([_brev(int(v_), 5) for v_ in lane])
    plane = np.full(m, np.nan + 0j)
    for k1 in range(q):
        pts = y[k1].reshape(4, 32)             # pts[a, l] = row[l + 32 a]
        four = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(4)) / 4)
        w = (four @ pts) * tw_b                # w[c, l], W_128^(l c)
        for s in range(5):
            d = 16 >> s
            sign = np.where(lane & d, -1.0, 1.0)
            w = (w[:, lane ^ d] + sign * w) * tw_lane[s]
        for c in range(4):
            k = k1 + q * (c + 4 * brl)
            assert np.isnan(plane[k]).all()    # each bin written once
            plane[k] = w[c]
    k = np.arange(m // 2 + 1)
    zk, zm = plane[k], plane[(m - k) % m]
    power = np.empty(m + 1)
    for kk, zz, mm in ((k, zk, zm), (m - k[1:], zm[1:], zk[1:])):
        even = 0.5 * (zz + np.conj(mm))
        odd = -0.5j * (zz - np.conj(mm))
        power[kk] = np.abs(even + split_tw[kk] * odd) ** 2
    zn = plane[0]                              # the Nyquist bin from Z[0]
    power[m] = np.abs(0.5 * (zn + np.conj(zn)) + split_tw[m] * (
        -0.5j * (zn - np.conj(zn)))) ** 2
    return power


@pytest.mark.parametrize("q", range(9, 24))
def test_group_register_plan_with_the_kernel_tables_equals_rfft(q):
    from tpuvae_torch.dsp.primitives import hann_window
    from tpuvae_torch.ops.stft import _group_tables

    n_fft = 256 * q
    _, _, xtw = _group_tables(n_fft)
    assert xtw.shape == (128 * q + 288, 2) and xtw.dtype == np.float32
    x = np.random.default_rng(200 + q).standard_normal(n_fft)
    want = np.abs(np.fft.rfft(x * hann_window(n_fft))) ** 2
    # float64 arithmetic on fp32 tables and roots, as the 2048 test
    np.testing.assert_allclose(_emulate_group_plan(x, n_fft), want,
                               rtol=1e-5, atol=1e-6 * want.max())


def test_group_register_plan_roots_are_cos_and_sin_in_fp32():
    roots = _source_roots("stft_large.cuh")
    assert sorted(roots) == [q for q in range(9, 24) if q != 16]
    for q, (cos_t, sin_t) in roots.items():
        ang = 2.0 * np.pi * np.arange(q) / q
        np.testing.assert_allclose(cos_t, np.cos(ang), rtol=0, atol=6e-8)
        np.testing.assert_allclose(sin_t, np.sin(ang), rtol=0, atol=6e-8)


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
