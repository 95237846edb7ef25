"""The frame-sharded STFT (``tpuvae_torch.dsp.long``) at world size 2
against the JAX package's on a 2-device mesh and the port's unsharded
``stft_power``, mirroring ``tests/test_spectral_long.py``.

The port's two ranks are fresh interpreters joined by gloo on the CPU
(``tests/_torch_ranks.py``), started once for the file.  Each rank holds
its own block of frames; the test gathers the blocks and cuts them to
``n_frames``.  Geometries: 2048 / 512 (``hop | n_fft``: the reshape
framing) and 1024 / 300 (the gather framing), on a 2 s clip whose frames
span both ranks' blocks, under ``fft`` and ``dft``.  Tolerance: every
element within 1e-5 of the largest power (fp32 transforms in two
libraries, or a DFT against an FFT).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_ranks import run_ranks

WS = 2
SR = 22050
GEOMETRIES = [(2048, 512), (1024, 300)]
N_MELS = 32


def _clip():
    rng = np.random.default_rng(2)
    t = np.arange(2 * SR) / SR
    y = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(2 * SR)).astype(np.float32)
    return np.stack([y, 0.2 * rng.standard_normal(2 * SR).astype(np.float32)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    y = _clip()
    res = run_ranks(tmp_path_factory.mktemp("long_ranks"), WS, [
        ("framesharded", {"y": y, "geometries": GEOMETRIES, "sr": SR})])
    return y, [r["framesharded"] for r in res]


def _close(got, want):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("method", ["fft", "dft"])
@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
def test_framesharded_power_matches_jax_and_the_unsharded_stft(
        ranks, n_fft, hop, method):
    from tpuvae.dsp.long import stft_power_framesharded as jax_sharded
    from tpuvae.parallel import make_mesh

    from tpuvae_torch.dsp import stft_power

    y, res = ranks
    plain = stft_power(torch.from_numpy(y), n_fft, hop, method="fft").numpy()
    jpow, jn = jax_sharded(jnp.asarray(y), make_mesh((WS,), ("data",)), n_fft,
                           hop, method=method)
    jpow = np.asarray(jpow)[..., :jn]
    per_rank = -(-plain.shape[-1] // WS)
    for r in res:
        out = r[(n_fft, hop, method)]
        assert out["n"] == jn == plain.shape[-1]
        assert out["global"] == (2, n_fft // 2 + 1, per_rank * WS)
        assert out["local"] == (2, n_fft // 2 + 1, per_rank)
        assert out["placements"] == "(Shard(dim=2),)"
        _close(out["power"], plain)
        _close(out["power"], jpow)
    np.testing.assert_array_equal(res[0][(n_fft, hop, method)]["power"],
                                  res[1][(n_fft, hop, method)]["power"])


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
def test_framesharded_mel_matches_jax(ranks, n_fft, hop):
    from tpuvae.dsp.long import mel_image_framesharded as jax_mel
    from tpuvae.parallel import make_mesh

    from tpuvae_torch.dsp import mel_power_from_stft, stft_power

    y, res = ranks
    jm, jn = jax_mel(jnp.asarray(y), make_mesh((WS,), ("data",)), SR, n_fft,
                     hop, N_MELS)
    jm = np.asarray(jm)[..., :jn]
    plain = mel_power_from_stft(stft_power(torch.from_numpy(y), n_fft, hop,
                                           method="fft"),
                                SR, n_fft, N_MELS).numpy()
    for r in res:
        out = r[(n_fft, hop, "mel")]
        assert out["n"] == jn and out["placements"] == "(Shard(dim=2),)"
        _close(out["mel"], jm)
        _close(out["mel"], plain)


def test_one_rank_holds_the_whole_clip():
    """World size 1: one block, equal to the unsharded STFT."""
    from tpuvae_torch.dsp import stft_power, stft_power_framesharded
    from tpuvae_torch.parallel import MeshContext

    y = torch.from_numpy(_clip())
    ctx = MeshContext.create(device="cpu")
    assert ctx.n_devices == 1
    for n_fft, hop in GEOMETRIES:
        s, n = stft_power_framesharded(y, ctx, n_fft, hop)
        assert s.to_local().shape == s.shape
        torch.testing.assert_close(s.to_local()[..., :n],
                                   stft_power(y, n_fft, hop, method="fft"),
                                   rtol=0, atol=0)
