"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the ``cuda`` fixture, never at
import) when no card is present.  Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: kernel 1 computes an fp32 radix-32 x 32 FFT in registers at
n_fft 2048, an r x 32 FFT in registers (a lane FFT by shuffles) at n_fft
256 .. 1,792, and a q x 128 FFT in the registers of four warps at every
larger n_fft = 256 q up to 5,888, where the plain version calls cuFFT —
rtol 1e-4 / atol
1e-6 x max power, rolloff within one bin (sr / n_fft; above 8 kHz the fp32
frequency table's gaps are ~1e-3 Hz wider); bf16 power within one bf16
step.  Kernels 2 and 3 equal;
kernel 3 also at the main path's 32 and 128 rows of piptrack keys, on
all-valid rows (its lists spill to global memory), on rows shorter than
its cluster and on rows that start off a 16-byte boundary.
Kernel 5: squared distances within 1e-5 x (max|x|^2 + max|y|^2) of its
plain version (fp32 FMAs against cuBLAS's fp32 product), self-distances
within the square root of that bound, with an exactly-zero diagonal and
exactly symmetric (one triangle computed, the other mirrored), also at
more than 65,535 x 64 rows.
Kernel 4 (dense-DFT STFT power): rtol 1e-4 with an atol of 1e-6 x max
power against its plain version — three TF32 tensor-core products of split
operands, summed per 32 samples and then in fp32, against cuBLAS's fp32
product, 2,048-term sums in two orders; relative error is unbounded where
``re`` and ``im`` cancel, so the atol scales with the maximum power.  Its
error is also bounded outright: the largest within 1e-5 of the max power,
and the signed mean over the bins above 1e-3 of the max power within 1e-6
of it (a sum kept whole in the tensor cores' truncating accumulator comes
out more than 1e-6 of it low at n_fft 2048 and fails; see
``tests/test_torch_stft_redesign.py``).  The preprocess pipelines run on the
card through their entry points and must launch each kernel once per
device batch.  Kernel 2 is also held equal at the main path's 1,292
frames for 32 and 128 clips, on a spectrum whose every other band row is a
candidate (its worst case), and at a length whose candidate lists do not
fit shared memory.
Kernel 6 (fused conv + BatchNorm statistics): y0 rtol 1e-5 / atol 1e-5 (9
fp32 FMAs against cuDNN), y1 rtol 1e-4 / atol 1e-4 (288-term fp32 sums in
two orders), means atol 1e-5, variances rtol 1e-4 / atol 1e-6 (per-CTA
partial sums in a fixed tree order against ``torch.sum``, then
``ss / n - mean^2``); and y1 within 1e-5 of its largest magnitude (three
TF32 products per term); two runs bit-equal.  The trunk's gradient on the card
against the CPU: within 1e-2 of each tensor's largest entry and 5e-3 in
relative L2 (a LeakyReLU pre-activation within rounding of zero may take
the other slope on one device; otherwise ~1e-5).
The mesh over one NCCL rank (``-k nccl``): ``make_dp_epoch`` of the
Hybrid VAE equal to the same steps without the mesh (rtol 1e-4; cuDNN's
backward sums in run-dependent order), ``silhouette_sharded`` within 1e-5
of ``silhouette_score``, the frame-sharded power and mel within 1e-5 of
the max of ``stft_power(method='fft')`` and its mel.
The compiled epoch (``-k "graphed or replays or scan_epochs or scanned or
host_fails"``): a replay of the captured Hybrid epoch bit-equal to the
eager epoch from a copied state and generator under deterministic
algorithms (with cuDNN's default freedom two eager epochs part by ~1e-7
of the loss); each replay draws new dropout masks; ``scan_epochs`` 4
against 1 and a resume at 3 at the CPU tests' tolerances (histories rtol
1e-6, learning rates 1e-7, weights rtol 1e-5 / atol 1e-7; the resume's
weights rtol 1e-4 / atol 1e-6 as ``tests/test_train.py``); kernel 6
counted per replay; a loss that reads the host fails the capture.
The trunks' BatchNorm + LeakyReLU (``-k bn_leaky``; ``ops/bn_leaky.py``) at
the ten training layers' shapes at batch 32, a ragged cut view and an NCHW
tensor: kernel A's means within 1e-6 of max |x| and variances rtol 1e-5 of
``batch_stats_plain`` (fp32 sums of up to 1 M terms in two orders), B's
output bit-equal to the plain ops on the statistics it used and within
1e-5 of the plain version, C and D within 1e-5 of the closed form on the
same statistics (dx against its largest entry, each per-channel sum
against the sum of its terms' magnitudes); two runs and a graph replay
bit-equal to the eager call; 9 / 10 / 10 / 10 launches of A / B / C / D per
training step of both trunks, none in eval mode or in bfloat16, whose
results equal the op-by-op path's bit for bit.
The spans of the compiled epoch (``-k spans``): a chunked ``fit`` records
its graph's warm, drain, capture and replays in that order under its
``fit`` span, the capture's ``kernels`` equals the kernel records the
profiler shows for one replay, and on an idle card a replay's first device
record starts after its ``graph.replay`` span starts, on the one clock.
"""

import copy

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


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("n_samples", [32 * HOP, 32 * HOP + 7, 17 * HOP + 1],
                         ids=["T33", "T33-odd-length", "T18-odd-length"])
def test_stft_features_kernel_ragged_frame_tile(cuda, exact, n_samples):
    """T is not a multiple of the kernel's frame tile (32 frames in fast
    mode, 16 in exact mode): the last CTA of a clip holds one or two frames.
    An odd clip length takes the 4-byte load path."""
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
    )

    y = torch.from_numpy(_tones(2, n_samples, 9)).to(cuda)
    got = stft_fused_features(y, N_FFT, HOP, sr=SR, n_mels=128, exact=exact)
    want = stft_fused_features_plain(y, N_FFT, HOP, sr=SR, n_mels=128,
                                     exact=exact)
    torch.cuda.synchronize()
    assert got.power.shape == want.power.shape == (2, 1025, 1 + n_samples // HOP)
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


def _tuning_inputs(power, dtype):
    power = power.to(dtype).contiguous()
    return power, power.float().amax(dim=1).contiguous()


@pytest.fixture(scope="module")
def power_30s(cuda):
    """fp32 power of 32 seeded 30 s clips, (32, 1025, 1292), on the card."""
    from tpuvae_torch.ops.stft import stft_fused_features_plain

    y = torch.from_numpy(_tones(32, 30 * SR, 13)).to(cuda)
    return stft_fused_features_plain(y, N_FFT, HOP, sr=SR, n_mels=128,
                                     exact=True).power


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_clips", [32, 128])
def test_tuning_kernel_equals_plain_at_the_main_shape(cuda, power_30s, dtype,
                                                      n_clips):
    """1,292 frames a clip: eight CTAs of 162 frames, lists in shared
    memory.  128 clips: the 32 spectra with gains and noise floors."""
    from tpuvae_torch.ops.tuning import estimate_tuning, estimate_tuning_plain

    g = torch.Generator(device=cuda).manual_seed(n_clips)
    parts = [power_30s]
    for k in range(1, n_clips // 32):
        noise = torch.empty_like(power_30s).exponential_(generator=g)
        parts.append(power_30s * (1.0 + 0.25 * k) + 1e-3 * k * noise)
    power, colmax = _tuning_inputs(torch.cat(parts), dtype)
    got = estimate_tuning(power, colmax, SR, N_FFT)
    want = estimate_tuning_plain(power, colmax, SR, N_FFT)
    assert got.shape == (n_clips,)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _alternating_power(n_clips, t, dev, seed):
    """Every odd row above every even one, and above 0.1 of the column's
    max: each odd band row inside 150-4000 Hz is a candidate, the most a
    frame can hold.  Odd rows take one of two values, so the median lands
    on a run of equal magnitudes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    odd = 2.0 + (torch.rand((n_clips, 513, t), generator=g, device=dev)
                 < 0.5).float()
    power = torch.ones((n_clips, 1025, t), device=dev)
    power[:, 1::2] = odd[:, :512]
    return power


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1292, 2600], ids=["smem-lists", "global-lists"])
def test_tuning_kernel_equals_plain_on_the_worst_case_spectrum(cuda, dtype, t):
    """At 2,600 frames a CTA's list (325 frames x 184) exceeds what shared
    memory holds: the wrapper hands the kernel a global buffer."""
    from tpuvae_torch.ops import tuning as tn

    power, colmax = _tuning_inputs(_alternating_power(3, t, cuda, t), dtype)
    power[1] = 0.0                                   # no candidate: tuning 0
    colmax[1] = 0.0
    _, r8, *_ = tn._tuning_consts(SR, N_FFT, 1025, 0.01)
    frames, capacity = tn.list_geometry(t, r8)
    assert (capacity > tn.SMEM_LIST_ENTRIES) == (t == 2600)
    got = tn.estimate_tuning(power, colmax, SR, N_FFT)
    want = tn.estimate_tuning_plain(power, colmax, SR, N_FFT)
    assert want[1].item() == 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tuning_kernel_refuses_global_lists_shorter_than_its_geometry(cuda):
    """The wrapper sizes the global lists from its copy of the kernel's
    cluster size; the kernel refuses a buffer shorter than what its own
    geometry indexes instead of writing past it."""
    from tpuvae_torch.dsp.chroma import PIPTRACK_THRESHOLD
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import tuning as tn

    t, n_clips = 2600, 2
    power, colmax = _tuning_inputs(_alternating_power(n_clips, t, cuda, 5),
                                   torch.float32)
    lo8, r8, fmask, binsb, edges, n_bins, binw = tn._device_consts(
        str(power.device), SR, N_FFT, 1025, 0.01)
    frames, capacity = tn.list_geometry(t, r8)
    entries = n_clips * tn.CLUSTER * capacity
    keys = torch.empty(entries, dtype=torch.int32, device=cuda)
    buckets = torch.empty(entries, dtype=torch.uint8, device=cuda)
    out = torch.empty(n_clips, device=cuda)
    ptr = _build.ptr

    def launch(list_entries):
        tn.TUNING(ptr(power), 0, ptr(colmax), n_clips, 1025, t, lo8, r8,
                  ptr(fmask), ptr(binsb), ptr(edges), n_bins, binw,
                  float(SR) / N_FFT, 12.0, PIPTRACK_THRESHOLD, frames,
                  capacity, ptr(keys), ptr(buckets), list_entries, ptr(out),
                  _build.stream_ptr(power.device))

    with pytest.raises(RuntimeError, match="failed to launch"):
        launch(entries - 1)
    launch(entries)
    torch.testing.assert_close(
        out, tn.estimate_tuning_plain(power, colmax, SR, N_FFT), rtol=0, atol=0)


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


@pytest.fixture(scope="module")
def piptrack_keys_30s(cuda, power_30s):
    """Order keys of the piptrack candidates of the 32 seeded 30 s clips,
    (32, 368 x 1292): the main path's input to kernel 3."""
    from tpuvae_torch.dsp.chroma import _tuning_candidates
    from tpuvae_torch.ops.select import masked_keys

    colmax = power_30s.amax(dim=1)
    _, mags, mask = _tuning_candidates(power_30s, SR, N_FFT, colmax)
    return masked_keys(mags.reshape(32, -1), mask.reshape(32, -1)).contiguous()


@pytest.mark.parametrize("n_rows", [32, 128])
def test_select_kernel_equals_plain_at_the_main_shape(cuda, piptrack_keys_30s,
                                                      n_rows):
    """Real piptrack keys, 475,456 a row: eight CTAs of 59,432 keys, their
    lists in shared memory.  128 rows: the 32 with keys shifted and masks
    thinned, plus an empty and a single-element row."""
    from tpuvae_torch.ops.select import (
        I32_MAX,
        select_stats,
        select_stats_plain,
    )

    keys = piptrack_keys_30s
    g = torch.Generator(device=cuda).manual_seed(n_rows)
    parts = [keys]
    for k in range(1, n_rows // 32):
        drop = torch.rand(keys.shape, generator=g, device=cuda) < 0.1 * k
        shifted = torch.where(keys < I32_MAX - 64, keys + 7 * k, keys)
        parts.append(torch.where(drop, torch.full_like(keys, I32_MAX), shifted))
    keys = torch.cat(parts).contiguous()
    keys[0] = I32_MAX                             # empty row: cnt_le == N
    keys[1] = I32_MAX
    keys[1, 1000] = 5                             # a single element
    got = select_stats(keys)
    want = select_stats_plain(keys)
    assert got[0].tolist() == [0, I32_MAX, keys.shape[1], I32_MAX]
    assert got[1].tolist() == [1, 5, 1, I32_MAX]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n_cols", [475_456, 216_003])
def test_select_kernel_equals_plain_on_all_valid_rows(cuda, n_cols):
    """Every key valid: a slice's list outgrows shared memory and the rest
    goes to the global spill.  Ties (a few hundred distinct values), signed
    zeros, odd and even counts."""
    from tpuvae_torch.ops import select as sel

    slice_, capacity, spill = sel.slice_geometry(n_cols)
    assert spill > 0 and capacity == sel.SMEM_LIST_ENTRIES
    g = torch.Generator(device=cuda).manual_seed(n_cols)
    vals = torch.randint(-300, 300, (4, n_cols), generator=g,
                         device=cuda).float() * 0.25
    vals[1, ::3] = -0.0
    vals[2] = torch.randn((n_cols,), generator=g, device=cuda)
    keys = sel.float_order_key(vals).contiguous()
    keys[3, -1] = sel.I32_MAX                     # n odd / even across rows
    got = sel.select_stats(keys)
    want = sel.select_stats_plain(keys)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n_cols", [1, 3, 5, 7, 9, 33])
def test_select_kernel_on_rows_shorter_than_the_cluster(cuda, n_cols):
    from tpuvae_torch.ops.select import (
        I32_MAX,
        select_stats,
        select_stats_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(n_cols)
    keys = torch.randint(-5, 5, (6, n_cols), generator=g, dtype=torch.int32,
                         device=cuda)
    keys[0] = I32_MAX
    keys[1, 1:] = I32_MAX
    torch.testing.assert_close(select_stats(keys), select_stats_plain(keys),
                               rtol=0, atol=0)


def test_select_kernel_on_an_unaligned_view(cuda):
    """Rows that start off a 16-byte boundary: a slice's first and last
    keys go through the scalar head and tail."""
    from tpuvae_torch.ops.select import select_stats, select_stats_plain

    g = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randint(-1000, 1000, (3 * 4101 + 1,), generator=g,
                         dtype=torch.int32, device=cuda)
    keys = flat[1:].view(3, 4101)
    assert keys.is_contiguous() and keys.data_ptr() % 16 == 4
    torch.testing.assert_close(select_stats(keys), select_stats_plain(keys),
                               rtol=0, atol=0)


def test_select_kernel_refuses_a_spill_shorter_than_its_geometry(cuda):
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops import select as sel

    n_rows, n_cols = 2, 475_456
    keys = torch.zeros((n_rows, n_cols), dtype=torch.int32, device=cuda)
    slice_, capacity, spill_per_cta = sel.slice_geometry(n_cols)
    entries = n_rows * sel.CLUSTER * spill_per_cta
    spill = torch.empty(entries, dtype=torch.int32, device=cuda)
    out = torch.empty((n_rows, 4), dtype=torch.int32, device=cuda)

    def launch(spill_entries):
        sel.SELECT(_build.ptr(keys), n_rows, n_cols, slice_, capacity,
                   spill_per_cta, _build.ptr(spill), spill_entries,
                   _build.ptr(out), _build.stream_ptr(keys.device))

    with pytest.raises(RuntimeError, match="failed to launch"):
        launch(entries - 1)
    launch(entries)
    torch.testing.assert_close(out, sel.select_stats_plain(keys), rtol=0,
                               atol=0)


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


@pytest.mark.parametrize("n", [186, 1336, 10240])
def test_self_distances_are_exactly_symmetric(cuda, n):
    """One triangle of tiles computed, each off-diagonal tile mirrored:
    d == d.T bit for bit, a zero diagonal, within tolerance of plain."""
    from tpuvae_torch.ops.pairwise import (
        self_distances,
        self_distances_plain,
        squared_distances,
    )

    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n, 32), generator=g, device=cuda)
    x[1] = x[0] + 1e-4
    d = self_distances(x)
    assert torch.equal(d, d.T)
    assert (d.diagonal() == 0).all()
    sq = float((x * x).sum(dim=1).max())
    assert (d - self_distances_plain(x)).abs().max().item() <= (2e-5 * sq) ** 0.5
    # the squared mode computes both triangles the same way
    d2 = squared_distances(x, x)
    assert torch.equal(d2, d2.T)
    torch.testing.assert_close(d, torch.sqrt(d2).fill_diagonal_(0.0),
                               rtol=1e-6, atol=0)


def test_pairwise_kernel_has_no_grid_limit(cuda):
    """More than 65,535 x 64 rows: the persistent grid walks any number of
    tiles."""
    from tpuvae_torch.ops.pairwise import (
        squared_distances,
        squared_distances_plain,
    )

    n = 65535 * 64 + 65
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((n, 3), generator=g, device=cuda)
    y = torch.randn((5, 3), generator=g, device=cuda)
    got = squared_distances(x, y)
    want = squared_distances_plain(x, y)
    tol = 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())
    assert got.shape == (n, 5)
    assert (got - want).abs().max().item() <= tol


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
                        logger=RunLogger(echo=False), make_plots=False)
    assert ops.launch_counts()["pairwise"] == 3
    assert np.isfinite(df[["Silhouette", "Calinski-Harabasz"]].to_numpy()).all()


def _assert_dense_error_bounded(got, want):
    """Kernel 4's error bound: max |err| <= 1e-5 x max power, and the signed
    mean error over the bins above 1e-3 of the max power within 1e-6 x max
    power (a truncating accumulator's error is one-signed: low)."""
    pmax = want.max().item()
    err = got - want
    assert err.abs().max().item() <= 1e-5 * pmax
    sel = want > 1e-3 * pmax
    assert abs(err[sel].mean().item()) <= 1e-6 * pmax


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
    _assert_dense_error_bounded(got, want)


def test_stft_dense_kernel_on_a_clip_spanning_80_db(cuda):
    """A loud tone plus one 1e-4 of its amplitude (power 1e-8 of the
    maximum), n_fft 2048 / hop 512: the faint tone lives in the lo halves of
    the kernel's TF32 split, and its bins must come out as the plain
    version's within a few percent."""
    from tpuvae_torch.ops.stft import stft_power_dense, stft_power_dense_plain

    t = np.arange(2 * SR) / SR
    loud = np.sin(2 * np.pi * 440.0 * t) + 1e-4 * np.sin(2 * np.pi * 3000.0 * t)
    y = torch.from_numpy(np.stack([loud, loud[::-1]]).astype(np.float32)).to(cuda)
    got = stft_power_dense(y, 2048, 512)
    want = stft_power_dense_plain(y, 2048, 512)
    torch.cuda.synchronize()
    pmax = want.max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * pmax)
    _assert_dense_error_bounded(got, want)
    # the faint tone's bin (3000 Hz -> bin 279), interior frames
    k = round(3000.0 * 2048 / SR)
    faint = want[:, k, 4:-4]
    assert faint.max().item() < 1e-7 * pmax
    torch.testing.assert_close(got[:, k, 4:-4], faint, rtol=0.05, atol=0)


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


def _pair_inputs(b, h, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, w, 1)),
            rng.standard_normal((3, 3, 1, 32)) * 0.3,
            rng.standard_normal(32) * 0.1,
            1.0 + 0.2 * rng.standard_normal(32),
            rng.standard_normal(32) * 0.1,
            rng.standard_normal((3, 3, 32, 64)) * 0.1,
            rng.standard_normal(64) * 0.1]
    return [torch.tensor(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("b,h,w", [
    (2, 16, 32), (3, 8, 64),      # the shapes of tests/test_fusedconv.py
    (1, 4, 4),                    # one CTA, mostly masked
    (7, 64, 128),                 # a ragged batch
    (5, 68, 196),                 # a non-reference input_hw: partial tiles
    (32, 128, 1024),              # the main path's batch
    (70, 16, 32),                 # more images than the wrapper's tickets
])
def test_fusedconv_kernels_match_plain(cuda, b, h, w):
    from tpuvae_torch.ops import fusedconv as fc

    x, w0, b0, g0, be0, w1, b1 = _pair_inputs(b, h, w, cuda)
    y0, s0, ss0 = fc.conv0_stats(x[..., 0], w0[:, :, 0], b0)
    py0, ps0, pss0 = fc.conv0_stats_plain(x[..., 0], w0[:, :, 0], b0)
    assert y0.shape == (b, h // 2, w // 2, 32) and s0.shape == (b, 1, 32)
    torch.testing.assert_close(y0, py0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s0, ps0, rtol=1e-5, atol=1e-5 * (h * w / 4))
    torch.testing.assert_close(ss0, pss0, rtol=1e-5, atol=1e-5 * (h * w / 4))
    got = fc.fused_trunk2_forward(x, w0, b0, g0, be0, w1, b1)
    again = fc.fused_trunk2_forward(x, w0, b0, g0, be0, w1, b1)
    want = fc.fused_trunk2_forward_plain(x, w0, b0, g0, be0, w1, b1)
    torch.cuda.synchronize()
    assert got[0].shape == (b, h // 4, w // 4, 64)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert ((got[0] - want[0]).abs().max().item()
            <= 1e-5 * want[0].abs().max().item())
    for (m, v), (pm, pv) in zip(got[1:], want[1:]):
        torch.testing.assert_close(m, pm, rtol=0, atol=1e-5)
        torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-6)
    assert torch.equal(got[0], again[0])
    for a, c in zip(got[1] + got[2], again[1] + again[2]):
        assert torch.equal(a, c)


def test_fusedconv_counts_launches_and_raises(cuda):
    from tpuvae_torch import ops
    from tpuvae_torch.ops import fusedconv as fc

    x, w0, b0, g0, be0, w1, b1 = _pair_inputs(2, 8, 16, cuda)
    ops.reset_launch_counts()
    fc.fused_trunk2_forward(x, w0, b0, g0, be0, w1, b1)
    counts = ops.launch_counts()
    assert counts["fusedconv_conv0"] == 1 and counts["fusedconv_conv1"] == 1
    fc.fused_trunk2_forward_plain(x, w0, b0, g0, be0, w1, b1)
    assert ops.launch_counts() == counts          # the plain version counts nothing
    with pytest.raises(ValueError, match="built for"):
        fc.conv0_stats(x[..., 0], torch.zeros((3, 3, 16), device=cuda),
                       torch.zeros(16, device=cuda))
    with pytest.raises(ValueError, match="built for"):
        fc.conv1_norm_stats(torch.zeros((1, 4, 4, 16), device=cuda),
                            torch.ones(16, device=cuda),
                            torch.zeros(16, device=cuda),
                            torch.zeros((3, 3, 16, 64), device=cuda), b1)
    with pytest.raises(ValueError, match="even"):
        fc.conv0_stats(x[:, :7, :, 0], w0[:, :, 0], b0)
    with pytest.raises(ValueError, match="do not pair"):
        fc.conv0_stats(x[..., 0], w0[:, :, 0].cpu().to(cuda), b0.cpu())


def test_fusedconv_halves_run_the_main_paths_kernels(cuda):
    """conv0_stats / conv1_norm_stats run the kernel bodies the trunk's
    forward runs, the batch finalise included: y0, y1 and the per-image
    sums are the forward's bits, and the finalised batch statistics (the
    images added in order) agree with _finalize of those sums; each
    variance is the kernel's unclamped one (its last row) clamped at 0,
    bit for bit."""
    from tpuvae_torch.ops import fusedconv as fc

    x, w0, b0, g0, be0, w1, b1 = _pair_inputs(5, 68, 196, cuda)
    x0, w00 = x[..., 0], w0[:, :, 0]
    y0, s0, ss0 = fc.conv0_stats(x0, w00, b0)
    y0_bn, s0_bn, ss0_bn, st0 = fc._conv0(x0, w00, b0, g0, be0, 1e-5)
    for a, c in ((y0, y0_bn), (s0, s0_bn), (ss0, ss0_bn)):
        assert torch.equal(a, c)
    n0 = y0.shape[0] * y0.shape[1] * y0.shape[2]
    mean0, var0 = fc._finalize(s0, ss0, n0)
    torch.testing.assert_close(st0[0], mean0, rtol=0, atol=1e-5)
    torch.testing.assert_close(st0[1], var0, rtol=1e-4, atol=1e-6)
    assert st0.shape == (5, 32)
    assert torch.equal(torch.clamp_min(st0[4], 0.0), st0[1])
    scale0, shift0 = st0[2], st0[3]
    y1, s1, ss1 = fc.conv1_norm_stats(y0, scale0, shift0, w1, b1)
    y1_bn, s1_bn, ss1_bn, st1 = fc._conv1(y0, scale0, shift0, w1, b1)
    for a, c in ((y1, y1_bn), (s1, s1_bn), (ss1, ss1_bn)):
        assert torch.equal(a, c)
    mean1, var1 = fc._finalize(s1, ss1, n0 // 4)
    torch.testing.assert_close(st1[0], mean1, rtol=0, atol=1e-5)
    torch.testing.assert_close(st1[1], var1, rtol=1e-4, atol=1e-6)
    assert st1.shape == (3, 64)
    assert torch.equal(torch.clamp_min(st1[2], 0.0), st1[1])


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_conv_trunk_on_the_card_matches_the_cpu(cuda, mode):
    import copy

    from tpuvae_torch import ops
    from tpuvae_torch.models.layers import ConvEncoderTrunk, lecun_init_

    cpu = lecun_init_(ConvEncoderTrunk(), torch.Generator().manual_seed(1))
    with torch.no_grad():
        for norm in cpu.norm:
            norm.running_mean.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
            norm.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(3))
    cpu.train(mode == "train")
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn((4, 64, 128, 1), generator=torch.Generator().manual_seed(4))
    cot = torch.randn((4, 1024), generator=torch.Generator().manual_seed(5))
    ops.reset_launch_counts()
    out_cpu, out_card = cpu(x), card(x.to(cuda))
    assert ops.launch_counts()["fusedconv_conv1"] == 1
    (out_cpu * cot).sum().backward()
    (out_card * cot.to(cuda)).sum().backward()
    torch.testing.assert_close(out_card.cpu(), out_cpu, rtol=1e-3, atol=1e-4)
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        scale = float(p.grad.abs().max())
        if name.endswith("bias") and name.startswith("conv") and mode == "train":
            scale = float(dict(cpu.named_parameters())[
                name.replace("bias", "weight")].grad.abs().max())
        diff = q.grad.cpu() - p.grad
        assert float(diff.abs().max()) <= 1e-2 * scale, name
        assert float(diff.norm()) <= 5e-3 * max(float(p.grad.norm()), scale), name
    for a, c in zip(cpu.buffers(), card.buffers()):
        torch.testing.assert_close(c.cpu(), a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("host_stream", [False, True], ids=["resident", "stream"])
def test_run_conditional_vae_on_the_card(cuda, tmp_path, host_stream):
    import pandas as pd

    from tpuvae_torch import ops
    from tpuvae_torch.config import ClusterConfig, ConditionalVAEConfig
    from tpuvae_torch.io.artifacts import save_advanced
    from tpuvae_torch.io.normalize import impute_and_scale, normalize_mel_images
    from tpuvae_torch.pipelines import run_conditional_vae
    from tpuvae_torch.train.checkpoint import load_checkpoint

    rng = np.random.default_rng(0)
    n, hw = 40, (128, 256)
    g = np.arange(n) % 3
    mel = (rng.normal(size=(n, *hw)) + 0.5 * g[:, None, None]).astype(np.float32)
    feats = (rng.normal(size=(n, 290)) + 2.0 * g[:, None]).astype(np.float32)
    mel_norm, mel_scaler = normalize_mel_images(mel)
    feats_norm, imputer, flat_scaler = impute_and_scale(feats)
    labels = np.array(["classical", "pop", "rock"])[g]
    save_advanced(
        tmp_path / "d2", mel_raw=mel, mel_normalized=mel_norm,
        features_raw=feats, features_normalized=feats_norm,
        lyrics_embeddings=rng.normal(size=(n, 768)).astype(np.float32),
        labels=labels, mel_scaler=mel_scaler, flat_scaler=flat_scaler,
        imputer=imputer, config={},
        metadata=pd.DataFrame({"file_id": [f"c{i}" for i in range(n)],
                               "genre": labels, "language": "english"}))
    cfg = ConditionalVAEConfig(epochs=2, batch_size=16, host_stream=host_stream)
    ops.reset_launch_counts()
    df = run_conditional_vae(str(tmp_path / "d2"), str(tmp_path / "results"),
                             cfg, ClusterConfig(), make_plots=False)
    counts = ops.launch_counts()
    # 34 train rows = 3 steps, 6 val rows = 1 batch, 2 epochs; 3 latent batches
    assert counts["fusedconv_conv0"] == counts["fusedconv_conv1"] == 2 * 4 + 3
    assert counts["pairwise"] == 4
    assert len(df) == 4
    assert np.isfinite(df[["Silhouette", "NMI", "ARI", "Purity"]].to_numpy()).all()
    flat, meta = load_checkpoint(
        tmp_path / "results" / "Conditional_VAE" / "serving" / "model")
    assert meta["arch"] == "cvae" and meta["input_hw"] == list(hw)
    assert all(np.isfinite(v).all() for v in flat.values())


# -- the Hybrid VAE slice: kernel 5 at D = 128, the sweeps, conv serving ------

@pytest.mark.parametrize("n", [1336, 10240])
def test_pairwise_kernel_at_the_hybrid_latent_width(cuda, n):
    """Kernel 5 at D = 128 (the Hybrid's latents): within tolerance of
    plain, exactly symmetric, zero diagonal."""
    from tpuvae_torch.ops.pairwise import (
        self_distances,
        self_distances_plain,
        squared_distances,
        squared_distances_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(n + 128)
    x = torch.randn((n, 128), generator=g, device=cuda)
    x[1] = x[0] + 1e-4
    sq = float((x * x).sum(dim=1).max())
    d2 = squared_distances(x, x)
    assert (d2 - squared_distances_plain(x, x)).abs().max().item() <= 2e-5 * sq
    d = self_distances(x)
    assert torch.equal(d, d.T) and (d.diagonal() == 0).all()
    assert (d - self_distances_plain(x)).abs().max().item() <= (2e-5 * sq) ** 0.5


def _planted_latents(n=1336, dim=128, groups=6, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 1.5, (groups, dim))
    y = np.arange(n) % groups
    return (centres[y] + rng.normal(0.0, 0.5, (n, dim))).astype(np.float32), y


def test_sweeps_and_dbscan_on_the_card_match_the_cpu(cuda):
    """The Ward and DBSCAN sweeps at the reference's N: the card's
    (kernel 5 once per sweep) equal to the CPU's (plain distances)."""
    from tpuvae_torch import ops
    from tpuvae_torch.cluster import (
        agglomerative_k_sweep,
        dbscan,
        dbscan_eps_sweep,
        kmeans_k_sweep,
    )

    x, y = _planted_latents()
    xc = torch.from_numpy(x).to(cuda)
    eps = np.arange(3.0, 19.0 + 1e-9, 1.0)
    ops.reset_launch_counts()
    agg = agglomerative_k_sweep(xc, range(2, 15))
    db = dbscan_eps_sweep(xc, eps, min_samples=5)
    assert ops.launch_counts()["pairwise"] == 2
    agg_cpu = agglomerative_k_sweep(x, range(2, 15))
    db_cpu = dbscan_eps_sweep(x, eps, min_samples=5)
    for got, want in ((agg, agg_cpu), (db, db_cpu)):
        assert got.best_param == want.best_param
        np.testing.assert_array_equal(got.best_labels, want.best_labels)
        for p, s in want.scores.items():
            assert (s is None) == (got.scores[p] is None)
            if s is not None:
                assert abs(got.scores[p] - s) <= 1e-5
    assert agg.best_param == 6
    np.testing.assert_array_equal(dbscan(xc, 12.0), dbscan(x, 12.0))
    km = kmeans_k_sweep(xc, range(2, 15), n_init=10, seed=42)
    assert km.best_param == 6


def test_run_hybrid_vae_on_the_card(cuda, tmp_path):
    import pandas as pd

    from tpuvae_torch import ops
    from tpuvae_torch.config import ClusterConfig, HybridVAEConfig
    from tpuvae_torch.io.artifacts import save_advanced
    from tpuvae_torch.io.normalize import impute_and_scale, normalize_mel_images
    from tpuvae_torch.pipelines import run_hybrid_vae
    from tpuvae_torch.train.checkpoint import load_checkpoint

    rng = np.random.default_rng(0)
    n, hw = 40, (128, 256)
    g = np.arange(n) % 3
    mel = (rng.normal(size=(n, *hw)) + 0.5 * g[:, None, None]).astype(np.float32)
    feats = rng.normal(size=(n, 290)).astype(np.float32)
    mel_norm, mel_scaler = normalize_mel_images(mel)
    feats_norm, imputer, flat_scaler = impute_and_scale(feats)
    labels = np.array(["classical", "pop", "rock"])[g]
    save_advanced(
        tmp_path / "d2", mel_raw=mel, mel_normalized=mel_norm,
        features_raw=feats, features_normalized=feats_norm,
        lyrics_embeddings=rng.normal(size=(n, 768)).astype(np.float32),
        labels=labels, mel_scaler=mel_scaler, flat_scaler=flat_scaler,
        imputer=imputer, config={},
        metadata=pd.DataFrame({"file_id": [f"c{i}" for i in range(n)],
                               "genre": labels, "language": "english"}))
    ops.reset_launch_counts()
    df = run_hybrid_vae(str(tmp_path / "d2"), str(tmp_path / "results"),
                        HybridVAEConfig(epochs=2, batch_size=16),
                        ClusterConfig(), make_plots=False)
    counts = ops.launch_counts()
    # 34 train rows = 3 steps, 6 val rows = 1 batch, 2 epochs; 3 latent batches
    assert counts["fusedconv_conv0"] == counts["fusedconv_conv1"] == 2 * 4 + 3
    # one per sweep and one for the rows, one more per Davies-Bouldin
    assert counts["pairwise"] == 4 + int((df["n_clusters"] > 1).sum())
    assert len(df) == 4 and np.isfinite(df["Silhouette"].to_numpy()).all()
    lat = np.load(tmp_path / "results" / "Convolutional_VAE"
                  / "hybrid_latent_features.npy")
    assert lat.shape == (n, 128) and np.isfinite(lat).all()
    flat, meta = load_checkpoint(
        tmp_path / "results" / "Convolutional_VAE" / "serving" / "model")
    assert meta["arch"] == "hybrid" and meta["input_hw"] == list(hw)
    assert all(np.isfinite(v).all() for v in flat.values())


@pytest.fixture(scope="module")
def conv_bundles(tmp_path_factory):
    """Seeded conv models saved as cvae and hybrid serving bundles over a
    ``processed_data2`` whose mel scaler was fitted on the mel images of 2 s
    WAVs through kernel 4's plain version (``stft_method="pallas"``)."""
    import pickle
    import wave

    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.dsp.features import extract_mel_image
    from tpuvae_torch.infer import save_serving_model
    from tpuvae_torch.io.normalize import normalize_mel_images
    from tpuvae_torch.io.wav import load_audio
    from tpuvae_torch.models import ConditionalVAE, HybridVAE

    root = tmp_path_factory.mktemp("conv_bundles")
    waves = _tones(8, 2 * SR, seed=5)
    paths = []
    for i, y in enumerate(waves):
        p = root / f"clip_{i}.wav"
        pcm = np.clip(np.round(y * 0.3 * 32767), -32768, 32767).astype("<i2")
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        paths.append(p)
    cfg = AdvancedPreprocessConfig(duration=2.0, fixed_time_steps=64,
                                   stft_method="pallas")
    wav = np.stack([load_audio(p, SR, 2.0) for p in paths])
    mel = extract_mel_image(torch.from_numpy(wav), cfg).numpy()
    _, mel_scaler = normalize_mel_images(mel)
    data = root / "processed_data2"
    data.mkdir()
    for name, obj in (("config", {**cfg.to_dict(),
                                  "lyrics_embedder_backend": "hashed-ngram"}),
                      ("mel_scaler", mel_scaler)):
        with open(data / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)
    gen = torch.Generator().manual_seed(7)
    hw = [128, 64]
    common = {"text_dim": 768, "input_hw": hw, "compute_dtype": "float32",
              "data_dir": str(data)}
    for arch, model, extra in (
            ("hybrid", HybridVAE(input_hw=tuple(hw), generator=gen),
             {"latent_dim": 128, "best_k": 3}),
            ("cvae", ConditionalVAE(num_classes=3, input_hw=tuple(hw),
                                    generator=gen),
             {"latent_dim": 64, "num_classes": 3,
              "genre_names": ["classical", "pop", "rock"]})):
        centres = np.random.default_rng(1).normal(
            size=(3, extra["latent_dim"])).astype(np.float32)
        save_serving_model(root / "results", model, centres,
                           {"arch": arch, **common, **extra})
    return root, paths


@pytest.mark.parametrize("arch", ["hybrid", "cvae"])
def test_conv_serving_on_the_card_matches_the_cpu(cuda, conv_bundles, arch):
    """``ClipEncoder`` of a cvae / hybrid bundle on the card (kernel 4 for
    the mel image, kernel 6 in the trunk) against ``device="cpu"``: the
    mel-dB images within 1e-2 dB (kernel 4's power within 1e-5 of the max
    power, in dB where it is far below the max), latents within 1e-3."""
    from tpuvae_torch import ops
    from tpuvae_torch.infer import ClipEncoder

    root, paths = conv_bundles
    kw = {"lyrics": [f"la la {i}" for i in range(len(paths))]}
    if arch == "cvae":
        kw["genres"] = ["pop", "rock", "classical", "pop"] * 2
    card = ClipEncoder.load(arch, results_dir=str(root / "results"))
    cpu = ClipEncoder.load(arch, results_dir=str(root / "results"),
                           device="cpu")
    waves = card.load_waveforms(paths)
    torch.testing.assert_close(card.extract(waves).cpu(), cpu.extract(waves),
                               rtol=0, atol=1e-2)
    ops.reset_launch_counts()
    got = card.encode_waveforms(waves, batch_size=4, **kw)
    counts = ops.launch_counts()
    assert counts["stft_dense"] == 2 and counts["fusedconv_conv0"] == 2
    want = cpu.encode_waveforms(waves, batch_size=4, **kw)
    np.testing.assert_allclose(got.latents, want.latents, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.clusters, want.clusters)


# -- the input front end: the lyrics encoder, the native loader, FLAC ------------

def _xlmr_checkpoint(path, layers=2, vocab=1000, seed=0):
    """A checkpoint directory at XLM-R-base width (hidden 768, 12 heads,
    intermediate 3,072) with ``layers`` layers and a ``vocab``-row table:
    seeded weights in HuggingFace naming, ``config.json`` and a unigram
    sentencepiece model."""
    import json

    from tpuvae_torch.text.tokenizer import unigram_pieces, write_sentencepiece_model

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, loc=0.0):
        return loc + 0.02 * torch.randn(*shape, generator=g)

    h, inter = 768, 3072
    sd = {"embeddings.word_embeddings.weight": rnd(vocab, h),
          "embeddings.position_embeddings.weight": rnd(514, h),
          "embeddings.token_type_embeddings.weight": rnd(1, h),
          "embeddings.LayerNorm.weight": rnd(h, loc=1.0),
          "embeddings.LayerNorm.bias": rnd(h)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)),
                            ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)),
                            ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (inter, h)),
                            ("output.dense", (h, inter))):
            sd[p + name + ".weight"] = rnd(*shape)
            sd[p + name + ".bias"] = rnd(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = rnd(h, loc=1.0)
            sd[p + name + ".bias"] = rnd(h)
    path.mkdir(parents=True)
    torch.save(sd, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps({"num_attention_heads": 12}))
    texts = ["the road goes ever on and on down from the door",
             "amar sonar bangla ami tomay bhalobashi", "আমার সোনার বাংলা"]
    write_sentencepiece_model(path / "sentencepiece.bpe.model",
                              unigram_pieces(texts, n_pieces=vocab - 2))
    return path


def test_lyrics_encoder_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The XLM-R encoder at full width (2 layers) on the card against the
    same code and weights on the CPU: within 1e-4, padded rows included
    (fp32 products, TF32 off)."""
    from tpuvae_torch.text.embedder import embed_lyrics, load_checkpoint_encoder

    ckpt = _xlmr_checkpoint(tmp_path / "xlmr")
    lyrics = ["the road goes ever on", "", "আমার সোনার বাংলা " * 40,
              "amar sonar bangla verse 3"] * 3
    card, backend = embed_lyrics(lyrics, checkpoint=str(ckpt), batch_size=5)
    cpu, _ = embed_lyrics(lyrics, checkpoint=str(ckpt), device="cpu")
    assert backend == "xlmr-checkpoint:xlmr" and card.shape == (12, 768)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)
    enc = load_checkpoint_encoder(ckpt, "cuda")
    assert next(enc.model.parameters()).device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_native_rows_loader_fills_a_pinned_slot(cuda, tmp_path):
    """``load_audio(out=...)`` writes a clip straight into a row of a pinned
    buffer (float32 and the int16 wire) as ``_extract_batched`` does; the
    row's copy on the card is the clip, FLAC and WAV alike."""
    from tpuvae_torch.io import native_loader
    from tpuvae_torch.io.flac import write_flac
    from tpuvae_torch.io.synthetic import write_wav
    from tpuvae_torch.io.wav import load_audio

    y = _tones(1, 2 * SR, 3)[0] * 0.2
    write_wav(tmp_path / "a.wav", y, SR)
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype(np.int64)
    write_flac(tmp_path / "a.flac", pcm, SR, 16)
    for dtype in (torch.float32, torch.int16):
        slot = torch.empty((2, 2 * SR), dtype=dtype, pin_memory=True)
        rows = slot.numpy()
        native_loader.reset_decode_counts()
        load_audio(tmp_path / "a.wav", SR, 2.0, out=rows[0])
        load_audio(tmp_path / "a.flac", SR, 2.0, out=rows[1])
        assert native_loader.decode_counts() == {"native": 2, "python": 0}
        dev = slot.to(cuda, non_blocking=True).cpu()
        assert torch.equal(dev[0], dev[1])
        want = load_audio(tmp_path / "a.wav", SR, 2.0)
        if dtype == torch.int16:
            want = np.clip(np.rint(want * 32768.0), -32768, 32767)
        np.testing.assert_array_equal(dev[0].numpy(), want.astype(rows.dtype))


def test_flac_encode_with_a_checkpoint_on_the_card(cuda, tmp_path, monkeypatch):
    """A mixed WAV / FLAC corpus through ``preprocess_advanced`` on the card
    with an XLM-R checkpoint (every clip decoded natively, the backend
    recorded), then a hybrid bundle on it serving a FLAC upload with lyrics:
    its WAV twin's latent, no backend warning, within 1e-4 of the CPU."""
    import base64

    from tpuvae_torch import ops
    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.infer import ClipEncoder, save_serving_model
    from tpuvae_torch.io.flac import read_flac
    from tpuvae_torch.io.normalize import load_normalizer
    from tpuvae_torch.io.synthetic import generate_dataset
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.pipelines import preprocess_advanced
    from tpuvae_torch.serve import ServingApp
    from tpuvae_torch.utils.logging import RunLogger

    ckpt = _xlmr_checkpoint(tmp_path / "xlmr")
    root = tmp_path / "Datasets"
    meta = generate_dataset(root, clips_per_genre_lang=3, duration=2.0,
                            container="mixed")
    ops.reset_launch_counts()
    res = preprocess_advanced(AdvancedPreprocessConfig(
        output_dir=str(tmp_path / "d2"), stft_method="pallas",
        fixed_time_steps=64, duration=2.0, dataset_root=str(root),
        metadata_csv=str(meta), extract_batch=8),
        logger=RunLogger(echo=False), text_checkpoint=str(ckpt))
    assert res["n"] == 12 and res["extract_detail"]["decodes_native"] == 12
    assert ops.launch_counts()["stft_dense"] == 2
    cfg = load_normalizer(tmp_path / "d2" / "config.pkl")
    assert cfg["lyrics_embedder_backend"] == "xlmr-checkpoint:xlmr"
    save_serving_model(
        tmp_path / "results",
        HybridVAE(input_hw=(128, 64), generator=torch.Generator().manual_seed(1)),
        np.zeros((3, 128), np.float32),
        {"arch": "hybrid", "latent_dim": 128, "text_dim": 768,
         "input_hw": [128, 64], "compute_dtype": "float32",
         "data_dir": str(tmp_path / "d2")})
    monkeypatch.setenv("TPUVAE_TEXT_CHECKPOINT", str(ckpt))
    flac = sorted(root.rglob("*.flac"))[0]
    pcm, _ = read_flac(flac)
    import wave

    with wave.open(str(tmp_path / "twin.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.round(pcm[:, 0] * 32768).astype("<i2").tobytes())
    lyric = ["the road goes ever on"]
    replies = {}
    for device in ("cuda", "cpu"):
        app = ServingApp(ClipEncoder.load("hybrid", str(tmp_path / "results"),
                                          device=device))
        try:
            replies[device] = [app.encode({
                "audio_b64": [base64.b64encode(p.read_bytes()).decode()],
                "lyrics": lyric}) for p in (flac, tmp_path / "twin.wav")]
        finally:
            app.close()
    for r in replies.values():
        assert r[0]["warnings"] == r[1]["warnings"] == []
        assert r[0]["latents"] == r[1]["latents"]
    np.testing.assert_allclose(replies["cuda"][0]["latents"],
                               replies["cpu"][0]["latents"], rtol=0, atol=1e-4)


# -- the whole workflow: t-SNE, checkpoints, plots ----------------------------

@pytest.mark.parametrize("n", [186, 1336])
def test_pairwise_kernel_at_tsne_width(cuda, n):
    """Kernel 5 at D = 2 (t-SNE's per-step distances; its scalar-load
    path): within rtol 1e-5 / atol 1e-5 x max of its plain version."""
    from tpuvae_torch.ops.pairwise import (
        squared_distances,
        squared_distances_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(n)
    y = 10.0 * torch.randn((n, 2), generator=g, device=cuda)
    want = squared_distances_plain(y, y)
    torch.testing.assert_close(squared_distances(y, y), want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def _knn(e, k=10):
    e = torch.from_numpy(e)
    d = torch.cdist(e, e)
    d.fill_diagonal_(float("inf"))
    return d.topk(k, largest=False).indices.numpy()


def test_tsne_on_the_card_matches_the_cpu(cuda):
    """P within rtol 1e-4 / atol 1e-4 x max on planted latents, their
    groups kept together,
    1,001 kernel-5 launches; on a helix (neighbourhoods fixed by the curve)
    the card's and the CPU's embeddings share >= 0.9 of each point's 10
    nearest neighbours."""
    import importlib

    from tpuvae_torch import ops
    from tpuvae_torch.metrics.pairwise import squared_distances

    tsne_mod = importlib.import_module("tpuvae_torch.viz.tsne")
    x, y = _planted_latents()
    xc, xh = torch.from_numpy(x).to(cuda), torch.from_numpy(x)
    p_cpu = tsne_mod._calibrated_p(squared_distances(xh, xh), 30.0)
    # P's relative error is beta_i times kernel 5's error on d2: largest on
    # the small tail entries (1.4e-4 at P ~ 1.6e-5), hence the atol
    torch.testing.assert_close(
        tsne_mod._calibrated_p(squared_distances(xc, xc), 30.0).cpu(), p_cpu,
        rtol=1e-4, atol=1e-4 * p_cpu.max().item())
    ops.reset_launch_counts()
    emb = tsne_mod.tsne(x, device=cuda)
    assert ops.launch_counts()["pairwise"] == 1001
    assert np.mean(y[_knn(emb)] == y[:, None]) >= 0.99
    t = np.linspace(0.0, 8 * np.pi, 1336)
    basis = np.linalg.qr(np.random.default_rng(0).normal(size=(128, 3)))[0]
    h = ((np.stack([np.cos(t), np.sin(t), t / 4], 1) * 3.0)
         @ basis.T).astype(np.float32)
    a, b = _knn(tsne_mod.tsne(h, device=cuda)), _knn(tsne_mod.tsne(h, device="cpu"))
    assert np.mean([len(set(a[i]) & set(b[i])) / 10 for i in range(1336)]) >= 0.9


def test_fit_resume_on_the_card(cuda, tmp_path):
    """A 6-epoch fit against a 3-epoch fit resumed to 6 on the card (the
    CUDA generator's state restored), held to the spread of two
    uninterrupted runs; both host_stream and resident data."""
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train.loop import FitConfig, fit
    from tpuvae_torch.train.objectives import simple_vae_objective
    from tpuvae_torch.train.state import create_state

    x = np.random.default_rng(0).normal(size=(256, 370)).astype(np.float32)

    def run(epochs, ck=None, stream=False):
        model = SimpleVAE(generator=torch.Generator().manual_seed(0)).to(cuda)
        cfg = FitConfig(epochs=epochs, batch_size=32, patience=100, seed=0,
                        plateau_patience=0, host_stream=stream,
                        checkpoint_dir=None if ck is None else str(ck),
                        checkpoint_every=1)
        data = (x,) if stream else (torch.from_numpy(x).to(cuda),)
        res = fit(create_state(model, 1e-3), simple_vae_objective(0.8), data,
                  cfg)
        return res.history["train_loss"], [
            v.detach().cpu().numpy() for v in model.state_dict().values()]

    for stream in (False, True):
        la, wa = run(6, stream=stream)
        lb, wb = run(6, stream=stream)
        run(3, tmp_path / f"ck{stream}", stream)
        lc, wc = run(6, tmp_path / f"ck{stream}", stream)
        spread = max(float(np.abs(a - b).max()) for a, b in zip(wa, wb))
        diff = max(float(np.abs(a - c).max()) for a, c in zip(wa, wc))
        assert diff <= 4.0 * spread, (stream, diff, spread)
        np.testing.assert_allclose(lc, la, rtol=max(1e-7, 4 * max(
            abs(p - q) / abs(p) for p, q in zip(la, lb))))


def test_plots_on_the_card_or_their_refusal(cuda, tmp_path):
    """With matplotlib the Conditional VAE's three figures are drawn; the
    card's machine may have none, and then ``make_plots=True`` is refused
    with an ImportError naming it before any training."""
    import importlib.util

    import pandas as pd

    from tpuvae_torch.config import ConditionalVAEConfig
    from tpuvae_torch.io.artifacts import save_advanced
    from tpuvae_torch.io.normalize import impute_and_scale, normalize_mel_images
    from tpuvae_torch.pipelines import run_conditional_vae
    from tpuvae_torch.utils.logging import RunLogger

    rng = np.random.default_rng(0)
    n = 24
    labels = np.array(["pop", "rock", "jazz"])[np.arange(n) % 3]
    mel = rng.normal(size=(n, 64, 128)).astype(np.float32)
    feats = rng.normal(size=(n, 290)).astype(np.float32)
    mel_norm, mel_scaler = normalize_mel_images(mel)
    feats_norm, imputer, flat_scaler = impute_and_scale(feats)
    save_advanced(tmp_path / "d2", mel_raw=mel, mel_normalized=mel_norm,
                  features_raw=feats, features_normalized=feats_norm,
                  lyrics_embeddings=rng.normal(size=(n, 768)).astype(np.float32),
                  labels=labels, mel_scaler=mel_scaler, flat_scaler=flat_scaler,
                  imputer=imputer, config={},
                  metadata=pd.DataFrame({"file_id": [f"c{i}" for i in range(n)],
                                         "genre": labels,
                                         "language": "english"}))
    out = tmp_path / "results"

    def run():
        return run_conditional_vae(
            str(tmp_path / "d2"), str(out),
            ConditionalVAEConfig(epochs=1, batch_size=8),
            logger=RunLogger(echo=False), make_plots=True)

    if importlib.util.find_spec("matplotlib") is None:
        with pytest.raises(ImportError, match="matplotlib"):
            run()
        assert not out.exists()
    else:
        run()
        for png in ("reconstruction.png", "cvae_latent_tsne_genre.png",
                    "cluster_lang_distribution.png"):
            assert (out / "Conditional_VAE" / png).stat().st_size > 0


# -- kernel 1 at every geometry of the JAX kernel --------------------------------

def _one_bin_hz(n_fft):
    """One bin of the rolloff's fp32 frequency table (sr / n_fft, widened by
    fp32 rounding by ~1e-3 Hz above 8 kHz)."""
    from tpuvae_torch.dsp.primitives import fft_frequencies

    return max(SR / n_fft * 1.0001,
               float(np.diff(fft_frequencies(SR, n_fft)).max()))


def _hold_kernel_1(got, want, n_fft, exact):
    pmax = want.power.float().max().item()
    for name in ("power", "mel_power", "colmax"):
        rtol = 2.0 ** -7 if (name == "power" and not exact) else 1e-4
        torch.testing.assert_close(getattr(got, name).float(),
                                   getattr(want, name).float(), rtol=rtol,
                                   atol=1e-6 * pmax)
    for name in ("centroid", "bandwidth", "rms", "zcr"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-6)
    assert (got.rolloff - want.rolloff).abs().max().item() <= _one_bin_hz(n_fft)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("q", list(range(1, 24)))
def test_stft_features_kernel_at_every_n_fft(cuda, q, exact):
    """n_fft = 256 q (the plan ``kernel_plan`` names) at hop n_fft / 4 and
    n_fft, on a clip length that is not a multiple of either."""
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
    )

    n_fft = 256 * q
    y = torch.from_numpy(_tones(2, 2 * SR + 101, q)).to(cuda)
    for hop in (n_fft // 4, n_fft):
        got = stft_fused_features(y, n_fft, hop, sr=SR, n_mels=128,
                                  exact=exact)
        want = stft_fused_features_plain(y, n_fft, hop, sr=SR, n_mels=128,
                                         exact=exact)
        torch.cuda.synchronize()
        assert got.power.shape == (2, n_fft // 2 + 1, 1 + (2 * SR + 101) // hop)
        _hold_kernel_1(got, want, n_fft, exact)


@pytest.mark.parametrize("pad_mode", ["edge", "reflect"])
@pytest.mark.parametrize("n_fft", [512, 1024, 1536, 2048, 3072, 5632])
def test_stft_features_kernel_pad_modes(cuda, n_fft, pad_mode):
    from tpuvae_torch.dsp.primitives import stft_power
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
        stft_power_plain,
    )

    y = torch.from_numpy(_tones(2, SR + 7, 4) + 0.2).to(cuda)
    hop = n_fft // 4
    got = stft_fused_features(y, n_fft, hop, sr=SR, n_mels=128, exact=True,
                              pad_mode=pad_mode)
    want = stft_fused_features_plain(y, n_fft, hop, sr=SR, n_mels=128,
                                     exact=True, pad_mode=pad_mode)
    _hold_kernel_1(got, want, n_fft, True)
    p = stft_power(y, n_fft, hop, pad_mode=pad_mode, method="ct_pallas")
    w = stft_power_plain(y, n_fft, hop, pad_mode=pad_mode)
    torch.testing.assert_close(p, w, rtol=1e-4, atol=1e-6 * w.max().item())


@pytest.mark.parametrize("q", list(range(1, 8)))
def test_stft_power_only_kernel_at_the_register_sizes(cuda, q):
    """The power-only entry (``stft_power(..., method="ct_pallas")``) at
    n_fft 256 .. 1,792, hop n_fft / 4."""
    from tpuvae_torch.dsp.primitives import stft_power
    from tpuvae_torch.ops.stft import stft_power_plain

    n_fft = 256 * q
    y = torch.from_numpy(_tones(2, SR + 101, 20 + q)).to(cuda)
    got = stft_power(y, n_fft, n_fft // 4, method="ct_pallas")
    want = stft_power_plain(y, n_fft, n_fft // 4)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * want.max().item())


@pytest.mark.parametrize("q", list(range(9, 24)))
def test_stft_power_only_kernel_at_the_group_sizes(cuda, q):
    """The power-only entry at n_fft 2,304 .. 5,888 (the group register
    plan), hop n_fft / 4."""
    from tpuvae_torch.dsp.primitives import stft_power
    from tpuvae_torch.ops.stft import stft_power_plain

    n_fft = 256 * q
    y = torch.from_numpy(_tones(2, SR + 101, 20 + q)).to(cuda)
    got = stft_power(y, n_fft, n_fft // 4, method="ct_pallas")
    want = stft_power_plain(y, n_fft, n_fft // 4)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * want.max().item())


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("n_fft,hop", [(768, 3), (1280, 5), (1792, 7),
                                       (2304, 9), (2816, 11), (5888, 23)])
def test_stft_features_kernel_odd_hop_on_an_odd_length(cuda, n_fft, hop,
                                                       exact):
    """An odd hop on 0.2 s clips of an odd length: frames start on odd
    samples, so the loader takes its 4-byte path."""
    from tpuvae_torch.ops.stft import (
        stft_fused_features,
        stft_fused_features_plain,
    )

    n_samples = SR // 5 + 1
    y = torch.from_numpy(_tones(2, n_samples, hop)).to(cuda)
    got = stft_fused_features(y, n_fft, hop, sr=SR, n_mels=128, exact=exact)
    want = stft_fused_features_plain(y, n_fft, hop, sr=SR, n_mels=128,
                                     exact=exact)
    torch.cuda.synchronize()
    assert got.power.shape == (2, n_fft // 2 + 1, 1 + n_samples // hop)
    _hold_kernel_1(got, want, n_fft, exact)


def test_kernel_plan_is_the_plan_that_ran(cuda):
    """Each size launches the library of the plan ``kernel_plan`` names: the
    register plan of ``stft_small.cu`` at n_fft <= 1,792, ``stft_features.cu``
    at 2048, the group register plan of ``stft_large_{a,b,c}.cu`` at 2,304
    .. 5,888; all count as ``stft_features``."""
    from tpuvae_torch import ops
    from tpuvae_torch.ops.stft import (
        STFT_FEATURES,
        STFT_LARGE,
        STFT_SMALL,
        kernel_plan,
        plan_kernel,
        stft_fused_features,
    )

    y = torch.from_numpy(_tones(1, SR // 2, 7)).to(cuda)
    libs = {"stft_features": STFT_FEATURES, "stft_small": STFT_SMALL}
    libs.update({k.library: k for k in STFT_LARGE.values()})
    for q in range(1, 24):
        n_fft = 256 * q
        ops.reset_launch_counts()
        stft_fused_features(y, n_fft, n_fft // 4, sr=SR, n_mels=128)
        want = plan_kernel(n_fft).library
        assert want == {"register_r": "stft_small",
                        "register32x32": "stft_features"}.get(
            kernel_plan(n_fft), "stft_large_" + "abc"[(q - 9) // 5])
        assert {name: k.launches for name, k in libs.items()} == {
            name: int(name == want) for name in libs}, n_fft
        assert ops.launch_counts()["stft_features"] == 1


def test_stft_features_kernel_refuses_every_size_but_2048(cuda):
    """``STFT_FEATURES`` (the radix-32 x 32 plan) takes n_fft 2048 alone:
    at 4096 its C entry returns ``cudaErrorInvalidValue`` and
    ``_build.Kernel`` raises, launching nothing; the same arguments at 2048
    launch."""
    from tpuvae_torch.ops import _build
    from tpuvae_torch.ops.stft import STFT_FEATURES, _fft_consts

    n_samples, hop = 8192, 1024
    t = 1 + n_samples // hop
    y = torch.zeros((1, n_samples), device=cuda)
    window, tw, xtw = _fft_consts(str(cuda), 2048)
    ptr = _build.ptr

    def call(n_fft):
        power = torch.empty((1, n_fft // 2 + 1, t), device=cuda)
        STFT_FEATURES(ptr(y), 1, n_samples, 0, n_samples, n_fft, hop, t,
                      ptr(window), ptr(tw), ptr(xtw), None, None, None, 0, 0,
                      ptr(power), 0, None, None, _build.stream_ptr(cuda))
        return power

    before = STFT_FEATURES.launches
    with pytest.raises(RuntimeError,
                       match=r"failed to launch: error 1 \(invalid argument"):
        call(4096)
    assert STFT_FEATURES.launches == before
    assert float(call(2048).abs().max()) == 0.0
    assert STFT_FEATURES.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_fft", [1024, 3072])
def test_tuning_kernel_equals_plain_at_other_n_fft(cuda, n_fft, dtype):
    """Kernel 2 on kernel 1's power at another band, ``r8`` and list size."""
    from tpuvae_torch.ops.stft import stft_fused_features
    from tpuvae_torch.ops.tuning import estimate_tuning, estimate_tuning_plain

    y = _tones(4, 4 * SR, 6)
    y[2] = 0.0
    fe = stft_fused_features(torch.from_numpy(y).to(cuda), n_fft, n_fft // 4,
                             sr=SR, n_mels=128, exact=dtype == torch.float32)
    assert fe.power.dtype == dtype
    got = estimate_tuning(fe.power, fe.colmax, SR, n_fft)
    want = estimate_tuning_plain(fe.power, fe.colmax, SR, n_fft)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert want[2].item() == 0.0


def test_preprocess_basic_at_1024_on_the_card(cuda, tmp_path):
    from tpuvae_torch import ops
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.io.artifacts import load_basic
    from tpuvae_torch.io.synthetic import generate_dataset
    from tpuvae_torch.pipelines import preprocess_basic
    from tpuvae_torch.utils.logging import RunLogger

    root = tmp_path / "Datasets"
    meta = generate_dataset(root, clips_per_genre_lang=3, duration=2.0)
    common = dict(duration=2.0, dataset_root=str(root), metadata_csv=str(meta),
                  extract_batch=8, n_fft=1024, hop_length=256)
    ops.reset_launch_counts()
    r = preprocess_basic(PreprocessConfig(output_dir=str(tmp_path / "d1"),
                                          **common),
                         logger=RunLogger(echo=False))
    counts = ops.launch_counts()
    assert r["n"] == 18 and r["failed"] == []
    assert counts["stft_features"] == counts["tuning"] == 3     # 8 + 8 + 2
    assert counts["stft_dense"] == counts["masked_median_select"] == 0
    c = preprocess_basic(PreprocessConfig(output_dir=str(tmp_path / "c1"),
                                          **common), device="cpu",
                         logger=RunLogger(echo=False))
    np.testing.assert_allclose(load_basic(tmp_path / "d1")["features_raw"],
                               load_basic(tmp_path / "c1")["features_raw"],
                               rtol=0.02, atol=1.0)    # bf16 power, fast mode
    assert c["n"] == 18


def test_auto_off_the_kernel_domain_and_explicit_ct_pallas(cuda):
    """n_fft 1000: explicit ct_pallas raises before any launch; auto runs
    the fft route (kernel 3 for the tuning) and equals explicit fft."""
    from tpuvae_torch import ops
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features
    from tpuvae_torch.dsp.primitives import stft_power

    y = torch.from_numpy(_tones(3, 2 * SR, 8)).to(cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=r"256 \| n_fft"):
        stft_power(y, 1000, 250, method="ct_pallas")
    kw = dict(duration=2.0, n_fft=1000, hop_length=250)
    auto = extract_basic_features(y, PreprocessConfig(**kw))
    fft = extract_basic_features(y, PreprocessConfig(stft_method="fft", **kw))
    counts = ops.launch_counts()
    assert counts["stft_features"] == counts["tuning"] == 0
    assert counts["masked_median_select"] == 2
    torch.testing.assert_close(auto, fft, rtol=0, atol=0)
    assert torch.isfinite(auto).all()


def test_ct_method_on_the_card_matches_the_cpu(cuda):
    from tpuvae_torch.dsp.primitives import stft_power

    y = _tones(2, 2 * SR, 10)
    window = np.hamming(3072).astype(np.float32)
    got = stft_power(torch.from_numpy(y).to(cuda), 3072, 768, window=window,
                     pad_mode="edge", method="ct")
    want = stft_power(torch.from_numpy(y), 3072, 768, window=window,
                      pad_mode="edge", method="ct")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-6 * want.max().item())


# -- bf16 compute of the conv models ----------------------------------------------

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """bfloat16's spacing at |x|: 2^(floor(log2 |x|) - 7)."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.where(x == 0, -125, e) - 8)


def test_resolve_device_pins_full_precision_reductions(cuda):
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("layer", ["dense", "conv", "conv_transpose",
                                   "bn1d_train", "bn1d_eval", "bn2d_train",
                                   "bn2d_eval"])
def test_bf16_layers_on_the_card_match_the_cpu(cuda, layer):
    """One ulp at each rounding point (``tests/test_torch_bf16.py``'s
    contract against flax): the card's bf16 products (float32 sums) and
    the CPU's float32 products of the same bf16 operands; BatchNorm's
    float32 statistics in two reduction orders."""
    import copy

    from tpuvae_torch.models import layers

    g = torch.Generator().manual_seed(11)
    if layer == "dense":
        mod, x = layers.Dense(2048, 64, torch.bfloat16), torch.randn((32, 2048), generator=g)
    elif layer.startswith("conv"):
        cls = layers.Stride2Conv if layer == "conv" else layers.Stride2ConvTranspose
        mod, x = cls(64, 128, torch.bfloat16), torch.randn((8, 64, 32, 2), generator=g)
    else:
        cls = layers.BatchNorm1d if layer.startswith("bn1d") else layers.BatchNorm2d
        mod = cls(64, torch.bfloat16)
        shape = (32, 64) if layer.startswith("bn1d") else (8, 64, 16, 8)
        x = 3.0 * torch.randn(shape, generator=g) + 1.0
        with torch.no_grad():
            mod.weight.uniform_(0.5, 1.5, generator=g)
            mod.running_var.uniform_(0.5, 1.5, generator=g)
            mod.running_mean.normal_(0, 0.1, generator=g)
    if not layer.startswith("bn"):
        layers.lecun_init_(mod, g)
    with torch.no_grad():
        mod.bias.normal_(0, 0.1, generator=g)
    mod.train(layer.endswith("train"))
    card = copy.deepcopy(mod).to(cuda)
    x = x.bfloat16()
    with torch.no_grad():
        want, got = mod(x), card(x.to(cuda)).cpu()
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    shift = mod.bias.detach().bfloat16().float().view(
        (1, -1) + (1,) * (want.dim() - 2))
    terms = torch.maximum(big, (want - shift).abs())
    err = (got - want).abs()
    bound = _bf16_ulp(terms) + (0 if layer.startswith("bn") else _bf16_ulp(big))
    assert bool((err <= bound).all()), float((err / _bf16_ulp(big)).max())
    for a, c in zip(mod.buffers(), card.buffers()):
        torch.testing.assert_close(c.cpu(), a, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel6_launches_by_compute_dtype(cuda, dtype):
    """The fp32 trunk launches kernel 6 once per forward; the bf16 trunk
    never (its layers 0-1 are library convolutions, as the JAX trunk's)."""
    from tpuvae_torch import ops
    from tpuvae_torch.models.layers import ConvEncoderTrunk, lecun_init_

    trunk = lecun_init_(ConvEncoderTrunk(dtype=dtype),
                        torch.Generator().manual_seed(1)).to(cuda)
    x = torch.randn((4, 64, 128, 1), device=cuda)
    ops.reset_launch_counts()
    out = trunk.train()(x)
    out.float().sum().backward()
    with torch.no_grad():
        trunk.eval()(x)
    counts = ops.launch_counts()
    want = 2 if dtype == "float32" else 0
    assert counts["fusedconv_conv0"] == counts["fusedconv_conv1"] == want
    assert out.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("arch", ["cvae", "hybrid"])
def test_bf16_models_on_the_card_match_the_cpu(cuda, arch):
    """A bf16 model's forward in both modes, card against CPU, within the
    bf16 contract: relative L2 at most the fp32 model's distance on the
    same weights, the largest error at most 3 x it."""
    import copy

    from tpuvae_torch.models import ConditionalVAE, HybridVAE
    from tpuvae_torch.models.layers import lecun_init_

    hw = (128, 128)
    g = torch.Generator().manual_seed(3)
    inputs = [torch.randn((4, *hw, 1), generator=g),
              torch.randn((4, 768), generator=g)]
    if arch == "cvae":
        build = lambda dt: ConditionalVAE(num_classes=3, input_hw=hw, dtype=dt)  # noqa: E731
        inputs.append(torch.eye(3)[[0, 1, 2, 0]])
    else:
        build = lambda dt: HybridVAE(input_hw=hw, dtype=dt)  # noqa: E731
    bf = lecun_init_(build(torch.bfloat16), torch.Generator().manual_seed(4))
    f32 = build(torch.float32)
    f32.load_state_dict(bf.state_dict())
    eps = torch.randn((4, 64 if arch == "cvae" else 128), generator=g)
    for train in (False, True):
        outs = []
        for model, dev in ((bf, cuda), (bf, "cpu"), (f32, cuda)):
            m = copy.deepcopy(model).to(dev).train(train)
            with torch.no_grad():
                outs.append([o.float().cpu() for o in m(
                    *[a.to(dev) for a in inputs], eps.to(dev))])
        for got, want, ref in zip(*outs):
            d = got - want
            s = want - ref
            assert float(d.norm()) <= float(s.norm()), (train, d.norm(), s.norm())
            assert float(d.abs().max()) <= 3.0 * float(s.abs().max())


# -- the mesh over torch.distributed, one rank over NCCL -----------------------

@pytest.fixture(scope="module")
def nccl_mesh(cuda):
    """A mesh of this one process over NCCL: the process's group where it
    has one (NCCL for CUDA tensors), else one started on a localhost
    store."""
    import socket

    import torch.distributed as dist

    from tpuvae_torch.parallel import MeshContext

    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    ctx = MeshContext.create(device="cuda")
    assert ctx.n_devices == 1 and ctx.device.type == "cuda"
    return ctx


def test_dp_epoch_over_nccl_equals_the_plain_steps(cuda, nccl_mesh):
    """``make_dp_epoch`` of the fp32 Hybrid VAE ('sum' objective) over one
    NCCL rank: kernel 6 once per step, and the epoch's loss that of the
    same steps without the mesh (rtol 1e-4: cuDNN's backward sums in
    run-dependent order)."""
    from tpuvae_torch import ops
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.parallel import make_dp_epoch
    from tpuvae_torch.parallel.dp import rank_seed
    from tpuvae_torch.train import create_state, hybrid_objective

    g = torch.Generator(device=cuda).manual_seed(0)
    mel = torch.randn((32, 64, 128, 1), generator=g, device=cuda)
    text = torch.randn((32, 32), generator=g, device=cuda)

    def state():
        return create_state(HybridVAE(
            latent_dim=16, text_dim=32, input_hw=(64, 128),
            generator=torch.Generator().manual_seed(0)).to(cuda), 1e-4)

    obj = hybrid_objective()
    epoch = make_dp_epoch(obj, nccl_mesh.mesh, batch_size=8, n_local=32,
                          n_train_arrays=2, loss_reduction="sum")
    ops.reset_launch_counts()
    _, loss, _ = epoch(state(), 5, mel, text)
    assert ops.launch_counts()["fusedconv_conv1"] == 4
    ref = state()
    gen = torch.Generator(device=cuda).manual_seed(rank_seed(5, 0))
    perm = torch.randperm(32, generator=gen, device=cuda)
    ref.model.train()
    total = 0.0
    for i in range(0, 32, 8):
        idx = perm[i:i + 8]
        ref.optimizer.zero_grad(set_to_none=True)
        step_loss, _ = obj(ref.model, (mel[idx], text[idx]), gen, True)
        step_loss.backward()
        ref.optimizer.step()
        total += float(step_loss)
    np.testing.assert_allclose(float(loss), total, rtol=1e-4)


def test_silhouette_sharded_over_nccl(cuda, nccl_mesh):
    from tpuvae_torch.metrics import (
        compact_labels,
        silhouette_score,
        silhouette_sharded,
    )

    rng = np.random.default_rng(4)
    y = np.arange(301) % 5
    x = (rng.normal(0, 2, (5, 16))[y] + rng.normal(size=(301, 16))).astype(
        np.float32)
    y[7] = 5                                   # a singleton cluster
    lab, k = compact_labels(y)
    got = silhouette_sharded(x, lab, k, nccl_mesh)
    want = float(silhouette_score(torch.from_numpy(x).to(cuda), lab, k))
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (1024, 300)])
def test_framesharded_stft_over_nccl(cuda, nccl_mesh, n_fft, hop):
    """One rank holds the whole clip: the power and the mel equal
    ``stft_power(method='fft')`` and its mel within 1e-5 of the max."""
    from tpuvae_torch.dsp import (
        mel_image_framesharded,
        mel_power_from_stft,
        stft_power,
        stft_power_framesharded,
    )

    y = torch.from_numpy(_tones(2, 60 * SR, 8)).to(cuda)
    s, n = stft_power_framesharded(y, nccl_mesh, n_fft, hop)
    want = stft_power(y, n_fft, hop, method="fft")
    assert tuple(s.shape) == tuple(want.shape) and s.to_local().is_cuda
    err = (s.to_local()[..., :n] - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-5
    mel, _ = mel_image_framesharded(y, nccl_mesh, SR, n_fft, hop, 64)
    want_mel = mel_power_from_stft(want, SR, n_fft, 64)
    err = (mel.to_local()[..., :n] - want_mel).abs().max() / want_mel.abs().max()
    assert float(err) <= 1e-5


# -- the compiled epoch: CUDA graphs and scan_epochs ----------------------------

def _hybrid_epoch(cuda, dtype="float32", seed=0):
    """A small Hybrid VAE (mel 64 x 128, text 32) with kernel 6 in its
    trunk, its state, generator and resident epoch: 40 training rows in
    batches of 16 (two full and a remainder of 8) and 10 validation rows."""
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.train import create_state, hybrid_objective
    from tpuvae_torch.train.loop import resident_epoch

    g = torch.Generator().manual_seed(seed)
    audio = torch.randn((50, 64, 128, 1), generator=g).to(cuda)
    text = torch.randn((50, 32), generator=g).to(cuda)
    model = HybridVAE(latent_dim=16, text_dim=32, input_hw=(64, 128),
                      generator=torch.Generator().manual_seed(seed),
                      dtype=dtype).to(cuda)
    state = create_state(model, 1e-3)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    epoch = resident_epoch(model, state.optimizer, hybrid_objective(),
                           (audio[:40], text[:40]), (audio[40:], text[40:]),
                           16, gen)
    return state, gen, epoch, (audio, text)


def _clone(state, gen, data, cuda):
    """The same state and generator, copied: the eager epoch's inputs."""
    import copy

    from tpuvae_torch.train import create_state, hybrid_objective
    from tpuvae_torch.train.loop import resident_epoch
    from tpuvae_torch.train.state import get_learning_rate, load_optimizer_state

    model = copy.deepcopy(state.model)
    clone = create_state(model, get_learning_rate(state))
    load_optimizer_state(clone.optimizer,
                         copy.deepcopy(state.optimizer.state_dict()))
    g2 = torch.Generator(device=cuda)
    g2.set_state(gen.get_state())
    audio, text = data
    return clone, resident_epoch(model, clone.optimizer, hybrid_objective(),
                                 (audio[:40], text[:40]),
                                 (audio[40:], text[40:]), 16, g2), g2


def test_graphed_epoch_equals_the_eager_epoch(cuda):
    """One replay of the captured Hybrid epoch against the same epoch
    function run eagerly from a copy of the state and the generator: the
    same kernels in the same order on the same inputs.  Under
    deterministic algorithms (cuDNN's and cuBLAS's run-to-run freedom off:
    with it two eager epochs part by ~1e-7 of the loss, which Adam then
    amplifies) the losses, the weights, Adam's state and the generator's
    state after it are bit-equal; kernel 6 counts its launches once per
    replay."""
    from tpuvae_torch.parity import deterministic_algorithms

    with deterministic_algorithms() as nondeterministic:
        _graphed_against_eager(cuda)
    assert not nondeterministic


def _graphed_against_eager(cuda):
    from tpuvae_torch import ops
    from tpuvae_torch.ops import _build
    from tpuvae_torch.graphs import CapturedGraph, capture_stream

    state, gen, epoch, data = _hybrid_epoch(cuda)
    graphed = CapturedGraph(epoch, cuda, generator=gen, reserve_batch=16)
    ops.reset_launch_counts()
    first = [t.clone() for t in graphed()]        # eager
    counts = ops.launch_counts()
    assert counts["fusedconv_conv0"] == counts["fusedconv_conv1"] == 4
    clone, eager, g2 = _clone(state, gen, data, cuda)
    for _ in range(2):
        ops.reset_launch_counts()
        got = [t.clone() for t in graphed()]
        assert ops.launch_counts()["fusedconv_conv1"] == 4   # 3 train + 1 val
        want = eager()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (a, b)
        assert torch.equal(gen.get_state(), g2.get_state())
        for (k, a), b in zip(state.model.state_dict().items(),
                             clone.model.state_dict().values()):
            assert torch.equal(a, b), k
    assert not torch.equal(got[0], first[0])
    # the kernels hand their tickets back as 0: no replay needs a memset
    with torch.cuda.stream(capture_stream(cuda)):
        tickets = _build.reserve_tickets(cuda, 16)
    assert int(tickets.count_nonzero()) == 0
    for p, q in zip(state.model.parameters(), clone.model.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][key],
                               clone.optimizer.state[q][key])


def test_captured_hybrid_epoch_at_the_benchmarks_shapes_keeps_its_layouts(
        cuda):
    """The Hybrid training epoch at the benchmark's shapes (batch 32, mel
    128 x 1024, text 768, float32, cuDNN's default algorithms; 96 training
    and 32 validation rows) captured through ``CapturedGraph``, one replay
    profiled.  cuDNN's layout transposes (``nhwcToNchw``, ``nchwToNhwc``)
    take under 4% of the replay's device time: the float32 decoder runs in
    NCHW, where cuDNN's float32 engines compute, and kernel 6's backward
    runs no forward convolution; what is left is the channels-last
    encoder's.  cuDNN's legacy float32 engines (``dgrad_engine``,
    ``wgrad_alg0_engine``) stay: no other engine computes these stride-2
    data and weight gradients in float32 with TF32 off.  Legacy engines
    and transposes together are held under 50% of the replay, a guard
    above the level they read (45.7% on an H100, whose shorter replay
    makes the unchanged legacy time a larger share)."""
    from tpuvae_torch.graphs import CapturedGraph
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.train import create_state, hybrid_objective
    from tpuvae_torch.train.loop import resident_epoch

    g = torch.Generator(device=cuda).manual_seed(5)
    audio = torch.randn((128, 128, 1024, 1), generator=g, device=cuda)
    text = torch.randn((128, 768), generator=g, device=cuda) * 0.1
    model = HybridVAE(generator=torch.Generator().manual_seed(5)).to(cuda)
    state = create_state(model, 1e-4)
    gen = torch.Generator(device=cuda).manual_seed(6)
    epoch = resident_epoch(model, state.optimizer, hybrid_objective(),
                           (audio[:96], text[:96]), (audio[96:], text[96:]),
                           32, gen)
    graphed = CapturedGraph(epoch, cuda, generator=gen, reserve_batch=32)
    graphed()                                   # eager
    graphed()                                   # capture and first replay
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graphed()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    total = sum(by_name.values())
    share = {key: sum(t for n, t in by_name.items() if key in n) / total
             for key in ("nhwcToNchwKernel", "nchwToNhwcKernel",
                         "dgrad_engine", "wgrad_alg0_engine")}
    print("device time shares of one replay:", share)
    assert total > 0
    assert share["nhwcToNchwKernel"] + share["nchwToNhwcKernel"] < 0.04, share
    assert sum(share.values()) < 0.50, share
    graphed.close()


def test_replays_draw_new_dropout_masks(cuda):
    """The Simple VAE's forward in train mode (dropout 0.2 and the noise
    from the generator) captured alone: two replays draw different masks,
    and each equals the eager forward from the generator's state before
    it."""
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.graphs import CapturedGraph

    model = SimpleVAE(generator=torch.Generator().manual_seed(2)).to(cuda)
    model.train()
    x = torch.randn((32, 370), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)

    def forward(g):
        with torch.no_grad():
            return (model(x, generator=g)[0],)

    graphed = CapturedGraph(lambda: forward(gen), cuda, generator=gen,
                            reserve_batch=32)
    graphed()
    outs = []
    for _ in range(2):
        g2 = torch.Generator(device=cuda)
        g2.set_state(gen.get_state())
        outs.append(graphed()[0].clone())
        assert torch.equal(outs[-1], forward(g2)[0])
    assert not torch.equal(outs[0], outs[1])


def _scan_run(cuda, scan_epochs, **kw):
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train import (FitConfig, create_state, fit,
                                    simple_vae_objective)

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(200, 370)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(48, 370)).astype(np.float32) * 3)
    model = SimpleVAE(generator=torch.Generator().manual_seed(0)).to(cuda)
    cfg = FitConfig(**{**dict(epochs=14, batch_size=32, patience=4,
                              monitor="val", restore_best=True,
                              plateau_patience=1, seed=0,
                              scan_epochs=scan_epochs), **kw})
    res = fit(create_state(model, 1e-2), simple_vae_objective(0.5),
              (x.to(cuda),), cfg, val_data=(v.to(cuda),))
    return res, [t.cpu() for t in model.state_dict().values()]


def test_scan_epochs_on_the_card_equal_per_epoch(cuda):
    """K = 4 (device control, one host read per chunk) against K = 1 (one
    replay and one host read per epoch), both graphed: histories rtol
    1e-6, learning rates rtol 1e-7, equal best and stopped epochs, weights
    rtol 1e-5 / atol 1e-7."""
    a, wa = _scan_run(cuda, 1)
    b, wb = _scan_run(cuda, 4)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(a.history[key], b.history[key], rtol=1e-6)
    np.testing.assert_allclose(a.history["lr"], b.history["lr"], rtol=1e-7)
    assert (a.best_epoch, a.stopped_epoch) == (b.best_epoch, b.stopped_epoch)
    for p, q in zip(wa, wb):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5, atol=1e-7)
    ran = len(a.history["train_loss"])
    assert a.host_reads == ran and b.host_reads == -(-ran // 4)


def test_scan_epochs_resume_on_the_card(cuda, tmp_path):
    """K = 3 with checkpoints every 2 epochs: a run stopped after 6 epochs
    and resumed to 10 lands where the uninterrupted run does (the CUDA
    generator's state after the replays is the one saved)."""
    kw = dict(epochs=10, patience=100, checkpoint_every=2, checkpoint_keep=2)
    full, wf = _scan_run(cuda, 3, **kw, checkpoint_dir=str(tmp_path / "a"))
    _scan_run(cuda, 3, **{**kw, "epochs": 6},
              checkpoint_dir=str(tmp_path / "b"))
    resumed, wr = _scan_run(cuda, 3, **kw, checkpoint_dir=str(tmp_path / "b"))
    assert (resumed.best_epoch, resumed.stopped_epoch) == (full.best_epoch,
                                                           full.stopped_epoch)
    np.testing.assert_allclose(resumed.history["train_loss"],
                               full.history["train_loss"], rtol=1e-5)
    for p, q in zip(wf, wr):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-4, atol=1e-6)


def test_scanned_hybrid_fit_counts_kernel6_per_replay(cuda):
    """A Hybrid ``fit`` of 6 epochs at K = 4: kernel 6 runs inside the
    graph and counts once per batch of every epoch, replays included."""
    from tpuvae_torch import ops
    from tpuvae_torch.train import FitConfig, fit, hybrid_objective

    state, _, _, (audio, text) = _hybrid_epoch(cuda)
    ops.reset_launch_counts()
    res = fit(state, hybrid_objective(), (audio[:40], text[:40]),
              FitConfig(epochs=6, batch_size=16, patience=100, monitor="val",
                        scan_epochs=4), val_data=(audio[40:], text[40:]))
    counts = ops.launch_counts()
    assert len(res.history["train_loss"]) == 6 and res.host_reads == 2
    assert counts["fusedconv_conv0"] == counts["fusedconv_conv1"] == 6 * 4
    assert np.isfinite(res.history["val_loss"]).all()


def test_a_loss_that_reads_the_host_fails_the_capture(cuda, tmp_path):
    """A ``loss_fn`` that calls ``.item()`` runs its eager first epoch, then
    fails the capture with the operation named, and is not run eagerly in
    the graph's place.  In a child process, so that whatever a failed
    capture leaves behind stays out of the other tests."""
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "item.py"
    script.write_text(
        "import torch\n"
        "from tpuvae_torch.models import SimpleAutoencoder\n"
        "from tpuvae_torch.train import FitConfig, create_state, fit\n"
        "calls = []\n"
        "def loss_fn(model, batch, generator, train):\n"
        "    (x,) = batch\n"
        "    loss = ((model(x)[0] - x) ** 2).mean()\n"
        "    calls.append(loss.item())\n"
        "    return loss, {}\n"
        "x = torch.randn((40, 12), device='cuda')\n"
        "m = SimpleAutoencoder(input_dim=12, latent_dim=4).cuda()\n"
        "try:\n"
        "    fit(create_state(m, 1e-3), loss_fn, (x,),\n"
        "        FitConfig(epochs=5, batch_size=16, scan_epochs=2))\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', len(calls), str(e).splitlines()[0])\n"
        "else:\n"
        "    print('NO RAISE', len(calls))\n")
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(script)], cwd=repo,
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(repo)})
    line = [ln for ln in out.stdout.splitlines() if ln.startswith(("RAISED",
                                                                    "NO"))]
    assert line, out.stdout + out.stderr
    # the 3 batches of the eager first epoch; in the capture the first
    # .item() raised before its value was appended
    assert line[0].startswith("RAISED 3 capturing the epoch as a CUDA graph "
                              "failed at "), line[0]
    assert "calls.append(loss.item())" in line[0], line[0]


# -- the compiled loops: t-SNE, the data-parallel epoch, host_stream ------------

def test_graphed_tsne_equals_the_eager_loop(cuda):
    """The perplexity search (one graph of 50 bisection steps) and the
    descent (graphs of 50 steps and of one, at 130 steps with 60
    exaggerated: neither phase a multiple of 50) bit-equal to the same
    step functions run eagerly; kernel 5 once per step through the
    replays."""
    import importlib

    from tpuvae_torch import ops
    from tpuvae_torch.metrics.pairwise import squared_distances

    tsne_mod = importlib.import_module("tpuvae_torch.viz.tsne")
    x, _ = _planted_latents()
    xc = torch.from_numpy(x[:400]).to(cuda)
    d2 = squared_distances(xc, xc)
    p = tsne_mod._calibrated_p(d2, 30.0)
    cal = tsne_mod._Calibration(d2, 30.0)
    for _ in range(tsne_mod.BISECTION_STEPS):
        cal.step()
    assert torch.equal(p, cal.p())
    y0 = 1e-4 * torch.randn((400, 2), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    ops.reset_launch_counts()
    got = tsne_mod._tsne_optimize(p, y0, 50.0, n_iter=130,
                                  exaggeration_iters=60)
    assert ops.launch_counts()["pairwise"] == 130
    desc = tsne_mod._Descent(p, y0, 50.0)
    for i in range(130):
        desc.phase(i < 60)
        desc.step()
    assert torch.equal(got, desc.y)


class _Events:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


def test_graphed_dp_epoch_over_nccl_equals_the_eager_epoch(cuda, nccl_mesh):
    """``dp_epoch_runner`` over one NCCL rank: the epoch is a graph (logged
    once), its first call eager; epochs 0-3 (the generator that lives
    across them re-seeded before each, replays from epoch 1) bit-equal to
    the eager epoch of a new ``make_dp_epoch`` each epoch (a fresh
    generator) under deterministic algorithms: totals, the generator's
    state and the weights; kernel 6 once per step through the replays."""
    from tpuvae_torch import graphs, ops
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.parallel import make_dp_epoch
    from tpuvae_torch.parity import deterministic_algorithms
    from tpuvae_torch.train import create_state, hybrid_objective
    from tpuvae_torch.train.loop import dp_epoch_runner

    g = torch.Generator(device=cuda).manual_seed(1)
    mel = torch.randn((32, 64, 128, 1), generator=g, device=cuda)
    text = torch.randn((32, 32), generator=g, device=cuda)
    obj = hybrid_objective()

    def state():
        return create_state(HybridVAE(
            latent_dim=16, text_dim=32, input_hw=(64, 128),
            generator=torch.Generator().manual_seed(0)).to(cuda), 1e-3)

    def epoch_fn():
        return make_dp_epoch(obj, nccl_mesh.mesh, batch_size=8, n_local=32,
                             n_train_arrays=2, loss_reduction="sum")

    with deterministic_algorithms() as nondeterministic:
        graphed, log = state(), _Events()
        ep = epoch_fn()
        run = dp_epoch_runner(ep, graphed, (mel, text), cuda, log)
        assert isinstance(run, graphs.CapturedGraph)
        assert log.events == [("dp_epoch_graph", {"graph": True,
                                                  "reason": "nccl on cuda"})]
        eager = state()
        try:
            for e in range(4):
                ep.seed(e, cuda)
                ops.reset_launch_counts()
                got = [t.clone() for t in run()]
                assert ops.launch_counts()["fusedconv_conv1"] == 4
                fresh = epoch_fn()
                fresh.seed(e, cuda)
                want = fresh.run(eager, mel, text)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), e
                assert torch.equal(ep.generator(cuda).get_state(),
                                   fresh.generator(cuda).get_state()), e
        finally:
            graphed.optimizer.zero_grad(set_to_none=True)
            graphs.close(run)
        for (k, a), b in zip(graphed.model.state_dict().items(),
                             eager.model.state_dict().values()):
            assert torch.equal(a, b), k
    assert not nondeterministic


def _stream_fit(cuda, arch, epochs):
    """``fit(host_stream=True)`` on host arrays: the Hybrid VAE (mel 64 x
    128, text 32) at ``arch``'s dtype or the Simple VAE at 370 features;
    40 training rows in batches of 16 (two full, a remainder of 8) and 10
    validation rows."""
    from tpuvae_torch.models import HybridVAE, SimpleVAE
    from tpuvae_torch.train import (FitConfig, create_state, fit,
                                    hybrid_objective, simple_vae_objective)

    g = torch.Generator().manual_seed(0)
    init = torch.Generator().manual_seed(0)
    if arch == "simple":
        data = (torch.randn((50, 370), generator=g).numpy(),)
        model, obj = SimpleVAE(generator=init), simple_vae_objective(0.5)
    else:
        data = (torch.randn((50, 64, 128, 1), generator=g).numpy(),
                torch.randn((50, 32), generator=g).numpy())
        model = HybridVAE(latent_dim=16, text_dim=32, input_hw=(64, 128),
                          generator=init,
                          dtype="bfloat16" if arch == "hybrid_bf16"
                          else "float32")
        obj = hybrid_objective()
    model = model.to(cuda)
    res = fit(create_state(model, 1e-3), obj, tuple(d[:40] for d in data),
              FitConfig(epochs=epochs, batch_size=16, patience=100,
                        monitor="val", host_stream=True),
              val_data=tuple(d[40:] for d in data))
    return res, [t.detach().clone() for t in model.state_dict().values()]


@pytest.mark.parametrize("arch", ["hybrid_fp32", "hybrid_bf16", "simple"])
def test_graphed_host_stream_fit_equals_the_eager_fit(cuda, monkeypatch,
                                                      arch):
    """``fit(host_stream=True)`` for 3 epochs with its steps as graphs
    (one per batch shape, train and validation) against the same ``fit``
    with every step eager (``graphs.runner`` returning the function):
    losses and weights bit-equal — the fp32 Hybrid under deterministic
    algorithms (cuDNN's run-to-run freedom parts two eager runs), the bf16
    Hybrid and the Simple VAE with the default algorithms; kernel 6 once
    per batch through the replays at fp32, never at bf16."""
    import contextlib

    from tpuvae_torch import graphs, ops
    from tpuvae_torch.parity import deterministic_algorithms

    ctx = (deterministic_algorithms() if arch == "hybrid_fp32"
           else contextlib.nullcontext([]))
    with ctx as nondeterministic:
        ops.reset_launch_counts()
        got, wg = _stream_fit(cuda, arch, 3)
        counts = ops.launch_counts()
        with monkeypatch.context() as m:
            m.setattr(graphs, "runner", lambda fn, device, **kw: fn)
            want, we = _stream_fit(cuda, arch, 3)
    assert not nondeterministic
    assert got.history["train_loss"] == want.history["train_loss"]
    assert got.history["val_loss"] == want.history["val_loss"]
    assert np.isfinite(got.history["train_loss"]).all()
    for a, b in zip(wg, we):
        assert torch.equal(a, b)
    k6 = 3 * 4 if arch == "hybrid_fp32" else 0       # 3 train + 1 val
    assert counts["fusedconv_conv0"] == counts["fusedconv_conv1"] == k6


def _child(tmp_path, name: str, source: str, *args: str) -> list[str]:
    """Run ``source`` as a script in a fresh interpreter with the checkout
    on its path; its stdout's lines."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / name
    script.write_text(source)
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(script), *args], cwd=repo,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(repo)})
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.splitlines()


def test_a_loss_that_reads_the_host_fails_the_host_stream_capture(cuda,
                                                                   tmp_path):
    """Under ``host_stream`` a ``loss_fn`` that calls ``.item()`` runs its
    first batch eagerly, then fails the step's capture with the operation
    named, and is not run eagerly in the graph's place."""
    lines = _child(tmp_path, "item_stream.py", (
        "import numpy as np\n"
        "from tpuvae_torch.models import SimpleAutoencoder\n"
        "from tpuvae_torch.train import FitConfig, create_state, fit\n"
        "calls = []\n"
        "def loss_fn(model, batch, generator, train):\n"
        "    (x,) = batch\n"
        "    loss = ((model(x)[0] - x) ** 2).mean()\n"
        "    calls.append(loss.item())\n"
        "    return loss, {}\n"
        "x = np.random.default_rng(0).normal(size=(40, 12)).astype('f4')\n"
        "m = SimpleAutoencoder(input_dim=12, latent_dim=4).cuda()\n"
        "try:\n"
        "    fit(create_state(m, 1e-3), loss_fn, (x,),\n"
        "        FitConfig(epochs=2, batch_size=16, host_stream=True))\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', len(calls), str(e).splitlines()[0])\n"
        "else:\n"
        "    print('NO RAISE', len(calls))\n"))
    line = [ln for ln in lines if ln.startswith(("RAISED", "NO"))]
    assert line, lines
    assert line[0].startswith("RAISED 1 capturing the host_stream step as a "
                              "CUDA graph failed at "), line[0]
    assert "calls.append(loss.item())" in line[0], line[0]


def test_gloo_on_the_card_runs_the_dp_epoch_eagerly_and_says_so(cuda,
                                                                tmp_path):
    """Two gloo ranks on ``cuda:0``: ``fit(mesh=)`` decides before its first
    epoch that the data-parallel epoch runs eagerly (gloo's collectives
    pass through the host) and logs it once, on each rank."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    script = tmp_path / "gloo_fit.py"
    script.write_text(
        "import json, sys, torch, torch.distributed as dist\n"
        "rank = int(sys.argv[1])\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/s',"
        " rank=rank, world_size=2)\n"
        "from tpuvae_torch.models import SimpleAutoencoder\n"
        "from tpuvae_torch.parallel import MeshContext\n"
        "from tpuvae_torch.train import (FitConfig, autoencoder_objective,\n"
        "                                create_state, fit)\n"
        "ctx = MeshContext.create(device='cuda')\n"
        "events = []\n"
        "class Log:\n"
        "    def log(self, event, **fields):\n"
        "        events.append([event, fields])\n"
        "x = torch.randn((32, 12), generator=torch.Generator().manual_seed(0))\n"
        "m = SimpleAutoencoder(input_dim=12, latent_dim=4,\n"
        "    generator=torch.Generator().manual_seed(0)).to(ctx.device)\n"
        "fit(create_state(m, 1e-3), autoencoder_objective(),\n"
        "    (x.to(ctx.device),), FitConfig(epochs=2, batch_size=8,\n"
        "    log_every=1), mesh=ctx.mesh, logger=Log())\n"
        "print('EVENTS', json.dumps(events))\n"
        "dist.destroy_process_group()\n")
    env = {**__import__("os").environ, "PYTHONPATH": str(repo)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], cwd=repo,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        line = [ln for ln in out.splitlines() if ln.startswith("EVENTS ")]
        assert line, out
        names = [e for e, _ in json.loads(line[0][7:])]
        fields = dict(json.loads(line[0][7:]))["dp_epoch_graph"]
        assert names.count("dp_epoch_graph") == 1
        assert names.index("dp_epoch_graph") < names.index("epoch")
        assert fields["graph"] is False
        assert fields["reason"].startswith("gloo on cuda"), fields


def test_a_closed_graph_hands_its_pool_back(cuda):
    """A graph whose capture allocates 2 x 64 MB of temporaries: the card's
    reserved memory grows by at least that with the capture and is back
    where it was after ``close()`` (the pool's blocks go back to the card,
    no process-wide ``empty_cache``)."""
    from tpuvae_torch.graphs import CapturedGraph

    x = torch.ones(16 * 2**20, device=cuda)

    def fn():
        y = x * 2.0
        return ((y + 1.0).amax(),)

    g = CapturedGraph(fn, cuda, what="a test graph")
    g()
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(cuda)
    assert float(g()[0]) == 3.0
    after_capture = torch.cuda.memory_reserved(cuda)
    g.close()
    after_close = torch.cuda.memory_reserved(cuda)
    assert after_capture - before >= 128 * 2**20, (before, after_capture)
    assert after_close <= before, (before, after_capture, after_close)


_LEAD_IN = "spin_kernel"       # torch.cuda._sleep's kernel


def _kernel_records(prof) -> list:
    """The profiler's device records that are kernels, not copies or fills
    (``Memcpy ...``, ``Memset ...``) or a lead-in's, in order of their
    start."""
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.name().startswith(("Memcpy", "Memset"))
                   and _LEAD_IN not in e.name()),
                  key=lambda e: e.start_ns())


def _lead_in():
    """32 one-thread kernels of their own launches, the card synchronised.
    A profiled session can come up short of its first few kernel records:
    first in a fresh process, and after the profiled replay of the
    benchmark-sized Hybrid epoch (a replay's count 5 short, or the first
    two of five replays missing).  The tests that count records start
    each session with this, so what goes missing is the lead-in's."""
    for _ in range(32):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _profiled(fn):
    """``fn()`` under the profiler (host and device activity) after a
    lead-in, the card synchronised before the profiler stops; the
    profile."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _lead_in()
        fn()
        torch.cuda.synchronize()
    return prof


def test_spans_of_a_chunked_fit_come_warm_drain_capture_replays(cuda):
    """A Simple VAE ``fit`` of 9 epochs at K = 4 under the span recorder:
    under its ``fit`` span the epoch graph's ``graph.warm``,
    ``graph.drain``, ``graph.capture`` (with the kernel nodes it holds)
    and 8 ``graph.replay`` spans, one after another, and one
    ``fit.host_read`` per chunk."""
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train import (FitConfig, create_state, fit,
                                    simple_vae_objective)
    from tpuvae_torch.utils.logging import recording

    x = torch.randn((200, 370), generator=torch.Generator().manual_seed(1))
    model = SimpleVAE(generator=torch.Generator().manual_seed(0)).to(cuda)
    with recording() as spans:
        res = fit(create_state(model, 1e-3), simple_vae_objective(0.5),
                  (x.to(cuda),), FitConfig(epochs=9, batch_size=32,
                                           patience=100, scan_epochs=4))
    names = [s["name"] for s in spans]
    graph = [s for s in spans if s["name"].startswith("graph.")]
    assert names[0] == "fit" and spans[0]["parent"] is None
    assert [s["name"] for s in graph] == [
        "graph.warm", "graph.drain", "graph.capture"] + ["graph.replay"] * 8
    assert names.count("fit.host_read") == res.host_reads == 3
    assert all(s["parent"] == 0 for s in spans[1:])
    for a, b in zip(graph, graph[1:]):
        assert a["end_ns"] <= b["start_ns"]
    capture = graph[2]["attrs"]
    assert capture["what"] == "the epoch" and capture["kernels"] > 7 * 10


def _simple_epoch(cuda):
    """A Simple VAE resident epoch on 200 rows in batches of 32, its state
    and generator."""
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train import create_state, simple_vae_objective
    from tpuvae_torch.train.loop import resident_epoch

    x = torch.randn((200, 370), generator=torch.Generator().manual_seed(1))
    model = SimpleVAE(generator=torch.Generator().manual_seed(0)).to(cuda)
    state = create_state(model, 1e-3)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return resident_epoch(model, state.optimizer, simple_vae_objective(0.5),
                          (x.to(cuda),), None, 32, gen), gen


@pytest.mark.parametrize("arch", ["simple", "hybrid"])
def test_spans_capture_counts_the_kernels_a_replay_runs(cuda, arch):
    """An epoch graph (the Simple VAE's; the small Hybrid's with kernel 6,
    cuDNN's and cuBLAS's kernels) captured under the recorder: ``kernels``
    equals the records the profiler gives the replay's launch (by its
    correlation id) less its fills and the graph's copy nodes (the card
    runs some copy nodes as kernels, and then records them so)."""
    import collections

    from tpuvae_torch.graphs import MEMCPY_NODE, CapturedGraph, node_counts
    from tpuvae_torch.utils.logging import recording

    if arch == "simple":
        epoch, gen = _simple_epoch(cuda)
        batch = 32
    else:
        _, gen, epoch, _ = _hybrid_epoch(cuda)
        batch = 16
    graphed = CapturedGraph(epoch, cuda, generator=gen, reserve_batch=batch)
    with recording() as spans:
        graphed()
        graphed()
    (capture,) = [s for s in spans if s["name"] == "graph.capture"]
    copies = node_counts(graphed.graph).get(MEMCPY_NODE, 0)
    torch.cuda.synchronize()
    prof = _profiled(graphed)
    by_launch = collections.Counter(
        e.correlation_id() for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.name().startswith("Memset"))
    sizes = sorted(by_launch.values(), reverse=True)
    assert sizes[0] - copies == capture["attrs"]["kernels"], (
        capture["attrs"]["kernels"], copies, sizes[:5])


def test_spans_on_an_idle_card_a_replay_runs_after_its_span(cuda):
    """Five replays of a two-kernel graph, each on an idle card: the first
    kernel of each (its records grouped by the launch's correlation id)
    starts after its ``graph.replay`` span starts and within 50 ms of it,
    on the profiler's clock."""
    from tpuvae_torch.graphs import CapturedGraph
    from tpuvae_torch.utils.logging import recording, span

    x = torch.ones(1 << 20, device=cuda)

    def fn():
        return ((x * 2.0).sum(),)

    graphed = CapturedGraph(fn, cuda, what="a test graph")
    graphed()
    graphed()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with recording() as spans, \
            torch.profiler.profile(activities=acts) as prof:
        _lead_in()
        for _ in range(5):
            with span("test.idle"):
                torch.cuda.synchronize()
            graphed()
        torch.cuda.synchronize()
    replays = [s for s in spans if s["name"] == "graph.replay"]
    firsts = {}                 # each launch's first kernel, by its id
    for e in _kernel_records(prof):
        firsts.setdefault(e.correlation_id(), e.start_ns())
    assert len(replays) == len(firsts) == 5
    for rep, first in zip(replays, sorted(firsts.values())):
        assert rep["start_ns"] <= first <= rep["start_ns"] + 50_000_000, (
            first - rep["start_ns"])


# -- the narrow stride-2 transposed convolutions (ops/s2_dgrad.py) ------------------

def _s2_case(dev, n, c, f, h, w, layout, seed, with_bias=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "channels_last":
        x = torch.randn((n, h, w, c), generator=g, device=dev).permute(0, 3, 1, 2)
    elif layout == "cut_nchw":
        x = torch.randn((n, c, h + 1, w + 1), generator=g, device=dev)[
            :, :, :h, :w]
    else:
        x = torch.randn((n, c, h, w), generator=g, device=dev)
    weight = torch.randn((c, f, 3, 3), generator=g, device=dev) * (9 * c) ** -0.5
    bias = (torch.randn((f,), generator=g, device=dev) * 0.1
            if with_bias else None)
    return x, weight, bias


@pytest.mark.parametrize("n,c,f,h,w,layout", [
    (32, 128, 64, 16, 128, "nchw"),             # decoder layer 3
    (32, 64, 32, 32, 256, "nchw"),              # decoder layer 4
    (32, 128, 64, 16, 128, "channels_last"),    # encoder layer 2's dx
    (32, 64, 32, 32, 256, "channels_last"),     # kernel 6's conv1's dx
    (3, 64, 64, 5, 9, "nchw"),                  # partial tiles, 2 slices
    (2, 100, 32, 7, 13, "channels_last"),       # C not a multiple of 32
    (1, 1, 32, 1, 1, "channels_last"),          # one position, one channel
    (2, 48, 64, 6, 5, "nchw"),                  # rows off 16 bytes: a copy
    (2, 96, 32, 9, 20, "cut_nchw"),
])
def test_s2_dgrad_kernel_matches_plain(cuda, n, c, f, h, w, layout):
    """The kernel within 1e-5 of the plain version's largest entry (three
    TF32 products, 9 C-term sums in two orders), its output in the input's
    layout, two calls bit-equal."""
    from tpuvae_torch.ops import s2_dgrad as s2

    x, weight, bias = _s2_case(cuda, n, c, f, h, w, layout, 5 + c + h)
    got = s2.s2_conv_transpose(x, weight, bias)
    again = s2.s2_conv_transpose(x, weight, bias)
    want = s2.s2_conv_transpose_plain(x, weight, bias)
    torch.cuda.synchronize()
    assert got.shape == (n, f, 2 * h, 2 * w)
    if layout == "nchw" and w % 4 == 0:
        assert got.is_contiguous()
    else:
        assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    assert torch.equal(got, again)


def test_s2_dgrad_kernel_reads_a_permuted_weight_and_no_bias(cuda):
    """Kernel 6's conv1 weight (3, 3, C_in, F_out) read through a permuted
    view as the transposed convolution's (F_out, C_in, 3, 3), no bias."""
    from tpuvae_torch.ops import s2_dgrad as s2

    x, _, _ = _s2_case(cuda, 4, 64, 32, 8, 16, "channels_last", 3)
    w1 = torch.randn((3, 3, 32, 64), device=cuda) / 24
    weight = w1.permute(3, 2, 0, 1)
    got = s2.s2_conv_transpose(x, weight)
    want = s2.s2_conv_transpose_plain(x, weight.contiguous())
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_s2_dgrad_counts_launches_and_refuses_other_widths(cuda):
    from tpuvae_torch import ops
    from tpuvae_torch.ops import s2_dgrad as s2

    x, weight, bias = _s2_case(cuda, 2, 64, 32, 4, 8, "nchw", 1)
    ops.reset_launch_counts()
    s2.s2_conv_transpose(x, weight, bias)
    assert ops.launch_counts()["s2_dgrad"] == 1
    s2.s2_conv_transpose_plain(x, weight, bias)
    assert ops.launch_counts()["s2_dgrad"] == 1
    for bad in (weight[:, :16], weight.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="s2_dgrad kernel takes"):
            s2.s2_conv_transpose(x if bad.dtype == torch.float32
                                 else x.to(torch.bfloat16), bad)
    wide, _, _ = _s2_case(cuda, 1, 256, 64, 2, 2, "nchw", 2)
    with pytest.raises(ValueError, match="s2_dgrad kernel takes"):
        s2.s2_conv_transpose(wide, torch.zeros((256, 64, 3, 3), device=cuda))


@pytest.mark.parametrize("dtype,want", [("float32", 4), ("bfloat16", 0)])
def test_s2_dgrad_launches_in_a_hybrid_training_step(cuda, dtype, want):
    """A Hybrid VAE training step sends decoder layers 3 and 4 and the data
    gradients of encoder layers 1 and 2 through the kernel in float32, an
    eval forward decoder layers 3 and 4; bfloat16 none.  (The trunks'
    gradients against the CPU: ``test_conv_trunk_on_the_card_matches_the_cpu``.)"""
    from tpuvae_torch import ops
    from tpuvae_torch.models import HybridVAE

    torch.manual_seed(0)
    model = HybridVAE(latent_dim=16, text_dim=32, input_hw=(64, 128),
                      dtype=getattr(torch, dtype)).to(cuda)
    mel = torch.randn((4, 64, 128, 1), device=cuda)
    text = torch.randn((4, 32), device=cuda)
    eps = torch.randn((4, 16), device=cuda)
    ops.reset_launch_counts()
    out = model(mel, text, eps)
    (out[0].float().square().mean() + out[1].float().square().mean()).backward()
    torch.cuda.synchronize()
    assert ops.launch_counts()["s2_dgrad"] == want
    model.eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        model(mel, text, eps)
    assert ops.launch_counts()["s2_dgrad"] == want // 2


# -- the trunks' BatchNorm + LeakyReLU (ops/bn_leaky.py) -----------------------------

# (N, C, H, W, layout): the ten training layers at batch 32 (encoder 1 with
# statistics given, 2-5 channels-last, decoder 0-4 the cut view of the
# transposed convolution's output), a ragged small cut view, an NCHW
# tensor (the scalar path) and decoder layer 4 with the NCHW gradient the
# main path hands it (the last transposed convolution has one output
# channel; the scalar path on the cut view)
BN_LEAKY_CASES = [
    (32, 64, 32, 256, "given"), (32, 128, 16, 128, "channels_last"),
    (32, 256, 8, 64, "channels_last"), (32, 512, 4, 32, "channels_last"),
    (32, 512, 2, 16, "channels_last"), (32, 512, 4, 32, "cut"),
    (32, 256, 8, 64, "cut"), (32, 128, 16, 128, "cut"), (32, 64, 32, 256, "cut"),
    (32, 32, 64, 512, "cut"), (3, 12, 5, 7, "cut"), (3, 5, 7, 9, "nchw"),
    (32, 32, 64, 512, "cut_nchw_grad"), (32, 512, 4, 32, "cut_nchw"),
    (32, 32, 64, 512, "cut_nchw"), (3, 12, 5, 7, "cut_nchw")]
BN_LEAKY_IDS = ["enc1", "enc2", "enc3", "enc4", "enc5", "dec0", "dec1", "dec2",
                "dec3", "dec4", "ragged", "nchw", "dec4_nchw_grad",
                "dec0_nchw", "dec4_nchw", "ragged_nchw"]


def _bn_leaky_case(dev, n, c, h, w, kind, seed):
    from tpuvae_torch.models.layers import BatchNorm2d

    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "nchw":
        x = torch.randn((n, c, h, w), generator=g, device=dev) * 1.5 + 0.25
    elif kind == "cut_nchw":             # the float32 decoder's cut view
        full = torch.randn((n, c, h + 1, w + 1), generator=g, device=dev)
        x = (full * 1.5 + 0.25)[:, :, :h, :w]
    elif kind.startswith("cut"):         # the view itself, not a dense copy
        full = torch.randn((n, h + 1, w + 1, c), generator=g, device=dev)
        x = (full * 1.5 + 0.25).permute(0, 3, 1, 2)[:, :, :h, :w]
    else:
        x = torch.randn((n, h, w, c), generator=g, device=dev)
        x = (x * 1.5 + 0.25).permute(0, 3, 1, 2)
    if kind in ("cut_nchw_grad", "cut_nchw"):
        gy = torch.randn((n, c, h, w), generator=g, device=dev)
    else:
        gy = torch.randn((n, h, w, c), generator=g,
                         device=dev).permute(0, 3, 1, 2)
    bn = BatchNorm2d(c).to(dev)
    with torch.no_grad():
        bn.weight.copy_(torch.rand((c,), generator=g, device=dev) + 0.5)
        bn.bias.copy_(torch.randn((c,), generator=g, device=dev) * 0.2)
        bn.running_mean.copy_(torch.randn((c,), generator=g, device=dev))
        bn.running_var.copy_(torch.rand((c,), generator=g, device=dev) + 0.5)
    stats = None
    if kind == "given":
        stats = (x.mean(dim=(0, 2, 3)) + 0.01,
                 x.var(dim=(0, 2, 3), unbiased=False) * 1.1)
    return x, gy, bn, stats


def _bn_leaky_run(x, gy, bn, stats):
    """Forward and backward through the kernels: ``(y, grads, running
    statistics)``, grads by x, weight, bias (and mean, var if given)."""
    from tpuvae_torch.ops import bn_leaky as bnl

    xl = x.detach().requires_grad_(True)
    leaves = [xl, bn.weight, bn.bias]
    if stats is None:
        y = bnl.bn_leaky(xl, bn)
    else:
        mean, var = (t.detach().requires_grad_(True) for t in stats)
        leaves += [mean, var]
        y = bnl.bn_leaky_given(xl, mean, var, bn)
    grads = torch.autograd.grad(y, leaves, gy)
    # y detached: no autograd graph (and no leaf's gradient accumulator made
    # on this stream) outlives the run, so a CUDA graph can capture the next
    return y.detach(), grads, (bn.running_mean.clone(),
                               bn.running_var.clone(),
                               bn.num_batches_tracked.clone())


@pytest.mark.parametrize("n,c,h,w,kind", BN_LEAKY_CASES, ids=BN_LEAKY_IDS)
def test_bn_leaky_kernels_match_plain(cuda, n, c, h, w, kind):
    """Kernels A-D against the plain versions on the card.  A's statistics
    against ``batch_stats_plain``: means within 1e-6 of max |x|, variances
    rtol 1e-5 (fp32 sums of n terms in two orders); the running statistics
    moved by them within rtol 1e-6.  B's output bit-equal to the plain ops
    on the statistics it normalised with (each op rounds to nearest, as
    B's intrinsics do), and within rtol / atol 1e-5 of the plain version.
    C and D against the closed form (``bn_leaky_backward_plain``) on the
    same statistics, whose LeakyReLU mask is then the same bit for bit: dx
    within 1e-5 of its largest entry, each per-channel sum within 1e-5 of
    the sum of its terms' magnitudes.  y and dx in x's layout:
    channels-last unless x is NCHW (dense or the float32 decoder's cut
    view, with an NCHW gradient: the pixel-major launch plan)."""
    from tpuvae_torch.ops import bn_leaky as bnl

    x, gy, bn, stats = _bn_leaky_case(cuda, n, c, h, w, kind, n * c + h)
    twin = copy.deepcopy(bn)
    if stats is None:        # A again, on a copy: what the op normalises with
        kstats = bnl._stats(x, copy.deepcopy(bn), bnl._Launch(x))
        mean, var = kstats[0], kstats[1]
        pm, pv = bnl.batch_stats_plain(x)
        assert (mean - pm).abs().max() <= 1e-6 * x.abs().max()
        torch.testing.assert_close(var, pv, rtol=1e-5, atol=1e-7)
    else:
        mean, var = stats
    y, grads, running = _bn_leaky_run(x, gy, bn, stats)
    torch.cuda.synchronize()
    nchw = kind in ("nchw", "cut_nchw")
    fmt = torch.contiguous_format if nchw else torch.channels_last
    assert y.is_contiguous(memory_format=fmt)
    assert grads[0].is_contiguous(memory_format=fmt)
    for got, old, new in zip(running[:2], (twin.running_mean, twin.running_var),
                             (mean, var)):
        torch.testing.assert_close(got, old * 0.99 + 0.01 * new, rtol=1e-6,
                                   atol=1e-7)
    assert int(running[2]) == int(twin.num_batches_tracked) + 1
    shape = (1, -1, 1, 1)
    rstd = 1.0 / torch.sqrt(var + bn.eps)
    scale = rstd * bn.weight.detach()
    xm = x - mean.view(shape)
    pre = xm * scale.view(shape) + bn.bias.detach().view(shape)
    assert torch.equal(y, torch.nn.functional.leaky_relu(pre, 0.01))
    plain = (bnl.bn_leaky_plain(x, copy.deepcopy(twin)) if stats is None else
             bnl.bn_leaky_given_plain(x, mean, var, copy.deepcopy(twin)))
    torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5)
    back = bnl.bn_leaky_backward_plain(
        gy, x, mean, var, bn.weight.detach(), bn.bias.detach(), bn.eps,
        given=stats is not None)
    assert (grads[0] - back[0]).abs().max() <= 1e-5 * back[0].abs().max()
    gp = torch.where(pre > 0, gy, gy * 0.01)
    mag1 = (gp * xm).abs().sum(dim=(0, 2, 3))
    mag0 = gp.abs().sum(dim=(0, 2, 3))
    assert ((grads[1] - back[1]).abs() <= 1e-5 * mag1 * rstd).all()
    assert ((grads[2] - back[2]).abs() <= 1e-5 * mag0).all()
    if stats is not None:
        assert ((grads[3] - back[3]).abs() <= 1e-5 * mag0 * scale).all()
        assert ((grads[4] - back[4]).abs()
                <= 1e-5 * mag1 * scale * rstd * rstd).all()


@pytest.mark.parametrize("n,c,h,w,kind", [BN_LEAKY_CASES[i] for i in (0, 5, 9, 10)],
                         ids=[BN_LEAKY_IDS[i] for i in (0, 5, 9, 10)])
def test_bn_leaky_kernels_are_deterministic_and_replay_bit_equal(
        cuda, n, c, h, w, kind):
    """Two eager runs from the same state give the same bits (no float
    atomics), and a CUDA graph's replay of forward + backward equals the
    eager call bit for bit; the replay counts each kernel once."""
    from tpuvae_torch import ops
    from tpuvae_torch.graphs import CapturedGraph

    x, gy, bn, stats = _bn_leaky_case(cuda, n, c, h, w, kind, 7)
    start = copy.deepcopy(bn.state_dict())
    runs = []
    for _ in range(2):
        bn.load_state_dict(start)
        runs.append(_bn_leaky_run(x, gy, bn, stats))
    for a, b in zip(_flat(runs[0]), _flat(runs[1])):
        assert torch.equal(a, b)
    bn.load_state_dict(start)
    graphed = CapturedGraph(lambda: _flat(_bn_leaky_run(x, gy, bn, stats)),
                            cuda, reserve_batch=n, what="bn_leaky")
    eager = [t.clone() for t in graphed()]
    bn.load_state_dict(start)
    ops.reset_launch_counts()
    replayed = graphed()
    torch.cuda.synchronize()
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)
    counts = ops.launch_counts()
    assert counts["bn_leaky_stats"] == (0 if stats is not None else 1)
    assert counts["bn_leaky_norm"] == counts["bn_leaky_grad_sums"] == \
        counts["bn_leaky_grad_input"] == 1
    graphed.close()


def _flat(run):
    y, grads, running = run
    return [y, *grads, *running]


def test_bn_leaky_launches_per_trunk_step_and_not_for_eval_or_bf16(cuda):
    """A training step of both fp32 trunks at batch 32 on 128 x 1024 mel
    images launches A 9 times, B 10 times, C and D 11 times each (encoder
    layer 1 takes kernel 6's statistics; the decoder's last layer has no
    BatchNorm; kernel 6's backward runs C and D for layer 0).  Eval mode and the bf16 trunks launch none, and give the
    op-by-op path's results bit for bit (the rule patched off)."""
    from tpuvae_torch import ops
    from tpuvae_torch.models.layers import (
        ConvDecoderTrunk,
        ConvEncoderTrunk,
        lecun_init_,
    )
    from tpuvae_torch.ops import bn_leaky as bnl
    from tpuvae_torch.parity import deterministic_algorithms

    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((32, 128, 1024, 1), generator=g, device=cuda)

    def step(dtype, train):
        init = torch.Generator().manual_seed(3)
        enc = lecun_init_(ConvEncoderTrunk(dtype=dtype), init)
        dec = lecun_init_(ConvDecoderTrunk(feature_hw=(2, 16), dtype=dtype),
                          init)
        enc, dec = enc.to(cuda).train(train), dec.to(cuda).train(train)
        out = dec(enc(x))
        loss = out.float().square().mean()
        params = [*enc.parameters(), *dec.parameters()]
        return [out, *torch.autograd.grad(loss, params),
                *enc.buffers(), *dec.buffers()]

    ops.reset_launch_counts()
    step(torch.float32, True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["bn_leaky_stats"], counts["bn_leaky_norm"],
            counts["bn_leaky_grad_sums"], counts["bn_leaky_grad_input"]) == (
                9, 10, 11, 11)
    for dtype, train in ((torch.float32, False), (torch.bfloat16, True),
                         (torch.bfloat16, False)):
        ops.reset_launch_counts()
        with deterministic_algorithms():
            got = step(dtype, train)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(bnl, "takes_kernels", lambda x, bn: False)
                want = step(dtype, train)
        torch.cuda.synchronize()
        assert not any(ops.launch_counts()[k] for k in (
            "bn_leaky_stats", "bn_leaky_norm", "bn_leaky_grad_sums",
            "bn_leaky_grad_input")), (dtype, train)
        assert all(bool(torch.isfinite(t).all()) for t in got)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (dtype, train)

