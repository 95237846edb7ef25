"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the ``cuda`` fixture, never at
import) when no card is present.  Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: kernel 1 computes an fp32 radix-2 FFT where the plain version
calls cuFFT — rtol 1e-4 / atol 1e-6 x max power, rolloff within one bin
(sr / n_fft); bf16 power within one bf16 step.  Kernels 2 and 3 equal.
Kernel 5: squared distances within 1e-5 x (max|x|^2 + max|y|^2) of its
plain version (fp32 FMAs against cuBLAS's fp32 product), self-distances
within the square root of that bound, with an exactly-zero diagonal.
Kernel 4 (dense-DFT STFT power): rtol 1e-4 with an atol of 1e-6 x max
power against its plain version — fp32 FMAs in sample order against
cuBLAS's fp32 product, 2,048-term sums in two orders; relative error is
unbounded where ``re`` and ``im`` cancel, so the atol scales with the
maximum power.  The preprocess pipelines run on the card through their
entry points and must launch each kernel once per device batch.
"""

import numpy as np
import pytest
import torch

SR = 22050
N_FFT = 2048
HOP = 512

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from tpuvae_torch.device import resolve_device

    return resolve_device("cuda")


def _tones(n_clips, n_samples, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    out = []
    for _ in range(n_clips):
        f0 = 220 * 2 ** rng.uniform(-0.5, 0.5)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(4))
        out.append((sig + 0.1 * rng.normal(size=t.shape)).astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_stft_features_kernel_matches_plain(cuda, exact):
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
    )

    y = torch.from_numpy(_tones(3, 2 * SR + 101, 1)).to(cuda)
    got = stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=128, exact=exact)
    want = stft_fused_features_plain(y, N_FFT, HOP, sr=SR, n_mels=128,
                                     exact=exact)
    torch.cuda.synchronize()
    pmax = want.power.float().max().item()
    for name in ("power", "mel_power", "colmax"):
        rtol = 2.0 ** -7 if (name == "power" and not exact) else 1e-4
        torch.testing.assert_close(getattr(got, name).float(),
                                   getattr(want, name).float(), rtol=rtol,
                                   atol=1e-6 * pmax)
    for name in ("centroid", "bandwidth", "rms", "zcr"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-6)
    assert (got.rolloff - want.rolloff).abs().max().item() <= SR / N_FFT * 1.0001


def test_stft_power_only_kernel_matches_plain(cuda):
    from tpuvae_torch.ops.stft import stft_power, stft_power_plain

    y = torch.from_numpy(_tones(2, SR, 2)).to(cuda)
    got = stft_power(y, N_FFT, HOP)
    want = stft_power_plain(y, N_FFT, HOP)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * want.max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tuning_kernel_equals_plain(cuda, dtype):
    from tpuvae_torch.ops.stft import stft_fused_features_plain
    from tpuvae_torch.ops.tuning import estimate_tuning, estimate_tuning_plain

    y = _tones(4, 2 * SR, 3)
    y[2] = 0.0                                    # silence: no candidates
    y[3] = np.random.default_rng(5).normal(size=2 * SR)   # flat spectrum
    fe = stft_fused_features_plain(torch.from_numpy(y).to(cuda), N_FFT, HOP,
                                   sr=SR, n_mels=128, exact=True)
    power = fe.power.to(dtype).contiguous()
    got = estimate_tuning(power, fe.colmax.contiguous(), SR, N_FFT)
    want = estimate_tuning_plain(power, fe.colmax, SR, N_FFT)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_select_kernel_equals_plain(cuda):
    from tpuvae_torch.ops.select import (
        masked_keys,
        select_stats,
        select_stats_plain,
    )

    rng = np.random.default_rng(4)
    vals = rng.normal(size=(5, 4099)).astype(np.float32) * 100
    mask = rng.random((5, 4099)) < 0.3
    mask[3] = False
    mask[4, 1:] = False
    mask[4, 0] = True
    keys = masked_keys(torch.from_numpy(vals), torch.from_numpy(mask)).to(cuda)
    torch.testing.assert_close(select_stats(keys), select_stats_plain(keys),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,m,d", [(100, 77, 37), (130, 130, 8),
                                   (1336, 1336, 32), (65, 4097, 3)])
def test_pairwise_kernel_matches_plain(cuda, n, m, d):
    from tpuvae_torch.ops.pairwise import (
        self_distances,
        self_distances_plain,
        squared_distances,
        squared_distances_plain,
    )

    rng = np.random.default_rng(n + m + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[1] = x[0] + 1e-4                            # near-duplicate rows
    y = x if n == m else rng.normal(size=(m, d)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    got = squared_distances(xt, yt)
    want = squared_distances_plain(xt, yt)
    torch.cuda.synchronize()
    tol = 1e-5 * ((x * x).sum(1).max() + (y * y).sum(1).max())
    assert (got - want).abs().max().item() <= tol
    assert got.min().item() >= 0.0
    if n == m:
        dk = self_distances(xt)
        torch.cuda.synchronize()
        assert (dk.diagonal() == 0).all()
        assert (dk - self_distances_plain(xt)).abs().max().item() <= tol ** 0.5
        torch.testing.assert_close(dk, torch.sqrt(got).fill_diagonal_(0.0),
                                   rtol=1e-6, atol=0)


def test_pairwise_kernel_counts_launches_and_raises(cuda):
    from tpuvae_torch.ops.pairwise import PAIRWISE, self_distances

    x = torch.ones((5, 4), device=cuda)
    before = PAIRWISE.launches
    self_distances(x)
    assert PAIRWISE.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        self_distances(torch.ones((4, 5), device=cuda).T)
    assert self_distances(torch.ones((0, 4), device=cuda)).shape == (0, 0)
    assert PAIRWISE.launches == before + 1


def test_run_simple_vae_on_the_card(cuda, tmp_path):
    import pandas as pd

    from tpuvae_torch import ops
    from tpuvae_torch.config import (
        ClusterConfig,
        PreprocessConfig,
        SimpleVAEConfig,
    )
    from tpuvae_torch.io.artifacts import save_basic
    from tpuvae_torch.io.normalize import impute_and_scale
    from tpuvae_torch.pipelines import run_simple_vae
    from tpuvae_torch.utils.logging import RunLogger

    rng = np.random.default_rng(0)
    groups = np.arange(96) % 4
    raw = (rng.normal(0, 3, (4, 370))[groups]
           + rng.normal(size=(96, 370))).astype(np.float32)
    normed, imputer, scaler = impute_and_scale(raw)
    save_basic(tmp_path / "data", features_raw=raw, features_normalized=normed,
               labels=groups, metadata=pd.DataFrame({"language": groups % 2}),
               scaler=scaler, imputer=imputer, config=PreprocessConfig())
    ops.reset_launch_counts()
    df = run_simple_vae(str(tmp_path / "data"), str(tmp_path / "results"),
                        SimpleVAEConfig(epochs=2, batch_size=16),
                        ClusterConfig(simple_k_sweep=(2, 3, 4)),
                        logger=RunLogger(echo=False))
    assert ops.launch_counts()["pairwise"] == 3
    assert np.isfinite(df[["Silhouette", "Calinski-Harabasz"]].to_numpy()).all()


@pytest.mark.parametrize("n_clips,n_samples,n_fft,hop", [
    (3, 44100, 2048, 512),       # frame tiles straddle clips
    (1, 2 * SR + 101, 2048, 512),
    (2, 30001, 1024, 256),
    (5, 5000, 512, 512),         # hop == n_fft, fewer bins than a tile
    (2, 4096, 2048, 1024)])
def test_stft_dense_kernel_matches_plain(cuda, n_clips, n_samples, n_fft, hop):
    from tpuvae_torch.ops.stft import stft_power_dense, stft_power_dense_plain

    y = torch.from_numpy(_tones(n_clips, n_samples, n_fft + hop)).to(cuda)
    got = stft_power_dense(y, n_fft, hop)
    want = stft_power_dense_plain(y, n_fft, hop)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n_clips, n_fft // 2 + 1,
                                       1 + n_samples // hop)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * want.max().item())


@pytest.mark.parametrize("pad_mode", ["edge", "reflect", "wrap"])
def test_stft_dense_kernel_pad_modes(cuda, pad_mode):
    from tpuvae_torch.ops.stft import stft_power_dense, stft_power_dense_plain

    y = torch.from_numpy(_tones(2, 9000, 6) + 0.5).to(cuda)
    got = stft_power_dense(y, 1024, 256, pad_mode=pad_mode)
    want = stft_power_dense_plain(y, 1024, 256, pad_mode=pad_mode)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * want.max().item())


def test_stft_dense_kernel_counts_launches_and_raises(cuda):
    from tpuvae_torch.dsp.primitives import stft_power
    from tpuvae_torch.ops.stft import STFT_DENSE, stft_power_dense

    y = torch.zeros((2, 4096), device=cuda)
    before = STFT_DENSE.launches
    assert float(stft_power_dense(y).abs().max()) == 0.0
    assert STFT_DENSE.launches == before + 1
    stft_power(y, method="pallas")
    assert STFT_DENSE.launches == before + 2
    with pytest.raises(ValueError, match="hop"):
        stft_power_dense(y, 2048, 500)
    with pytest.raises(ValueError, match="multiple of 16"):
        stft_power_dense(y, 40, 10)
    with pytest.raises(ValueError, match="float32"):
        stft_power_dense(y.double())
    assert stft_power_dense(y[:0]).shape == (0, 1025, 9)
    assert STFT_DENSE.launches == before + 2


def test_preprocess_pipelines_on_the_card(cuda, tmp_path):
    from tpuvae_torch import ops
    from tpuvae_torch.config import AdvancedPreprocessConfig, PreprocessConfig
    from tpuvae_torch.io.artifacts import load_advanced, load_basic
    from tpuvae_torch.io.synthetic import generate_dataset
    from tpuvae_torch.pipelines import preprocess_advanced, preprocess_basic
    from tpuvae_torch.utils.logging import RunLogger

    root = tmp_path / "Datasets"
    meta = generate_dataset(root, clips_per_genre_lang=3, duration=2.0)
    common = dict(duration=2.0, dataset_root=str(root), metadata_csv=str(meta),
                  extract_batch=8)
    ops.reset_launch_counts()
    r1 = preprocess_basic(PreprocessConfig(
        output_dir=str(tmp_path / "d1"), **common), logger=RunLogger(echo=False))
    counts = ops.launch_counts()
    assert r1["n"] == 18 and r1["failed"] == []
    assert counts["stft_features"] == counts["tuning"] == 3     # 8 + 8 + 2
    assert counts["stft_dense"] == counts["masked_median_select"] == 0
    assert r1["extract_detail"]["device_s"] > 0
    ops.reset_launch_counts()
    r2 = preprocess_advanced(AdvancedPreprocessConfig(
        output_dir=str(tmp_path / "d2"), stft_method="pallas",
        fixed_time_steps=64, **common), logger=RunLogger(echo=False))
    counts = ops.launch_counts()
    assert r2["n"] == 12
    assert counts["stft_dense"] == counts["masked_median_select"] == 2
    assert counts["stft_features"] == counts["tuning"] == 0
    # the card's artifacts against the plain versions' on the CPU
    c1 = preprocess_basic(PreprocessConfig(
        output_dir=str(tmp_path / "c1"), **common), device="cpu",
        logger=RunLogger(echo=False))
    assert c1["n"] == 18
    a, b = load_basic(tmp_path / "d1"), load_basic(tmp_path / "c1")
    np.testing.assert_allclose(a["features_raw"], b["features_raw"],
                               rtol=0.02, atol=1.0)    # bf16 power, fast mode
    adv = load_advanced(tmp_path / "d2")
    assert adv["mel"].shape == (12, 128, 64) and np.isfinite(adv["mel"]).all()
    assert adv["handcrafted"].shape == (12, 290)
