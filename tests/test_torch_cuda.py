"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the ``cuda`` fixture, never at
import) when no card is present.  Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: kernel 1 computes an fp32 radix-2 FFT where the plain version
calls cuFFT — rtol 1e-4 / atol 1e-6 x max power, rolloff within one bin
(sr / n_fft); bf16 power within one bf16 step.  Kernels 2 and 3 equal.
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
