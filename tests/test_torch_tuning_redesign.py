"""Kernel 2's Hopper design (``csrc/tuning.cu`` + ``csrc/cluster_select.cuh``)
emulated on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).  Its
scheme is emulated here step by step and held bit-equal to the plain
version and to the JAX package's Pallas kernel (interpret mode):

* a cluster of ``CLUSTER`` CTAs per clip, CTA ``r`` owning frames
  ``[r F, (r + 1) F)``, ``F = ceil(T / CLUSTER)`` (``list_geometry``);
* each CTA compacts its candidates into a list of (int32 order key, vote
  bucket), in an order the kernel does not fix (shuffled here);
* the exact median by an MSB-first radix select in four 8-bit passes whose
  per-CTA digit histograms are merged by integer sums;
* the vote over the lists, the magnitude compared as a float, the merged
  histogram's first argmax.

Also: the per-frame candidate bound ``ceil(r8 / 2)`` that sizes the lists
is reached by an alternating spectrum; a silent clip has no candidate
(tuning 0); a threshold equal to candidates' magnitudes counts them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvae_torch.dsp import chroma
from tpuvae_torch.ops import tuning as tn
from tpuvae_torch.ops.select import I32_MAX, float_order_key, key_to_float

SR = 22050
N_FFT = 2048
HOP = 512


def _candidates(power, colmax):
    """Per-element piptrack results of the band ``(B, R, T)``: candidate
    mask, magnitude and vote bucket, through the plain version's own ops
    (the bucket on the full band, as ``_tuning_vote`` computes it)."""
    pitches, mags, mask = chroma._tuning_candidates(power.float(), SR, N_FFT,
                                                    colmax)
    safe = torch.where(mask, pitches, torch.full_like(pitches, 440.0))
    res = torch.remainder(12 * torch.log2(16.0 * safe / 440.0), 1.0)
    res = torch.where(res >= 0.5, res - 1.0, res)
    edges = np.linspace(-0.5, 0.5, 101, dtype=np.float32)
    bucket = torch.clamp(torch.floor((res + 0.5) / float(edges[1] - edges[0])
                                     ).to(torch.int64), 0, 99)
    return mask, mags, bucket, edges


def _cta_lists(mask, mags, bucket, rng):
    """CTA r's compacted list: the (key, bucket) of the candidates of its
    frames, in a shuffled order."""
    t = mask.shape[-1]
    frames = tn.list_geometry(t, mask.shape[0])[0]
    lists = []
    for r in range(tn.CLUSTER):
        sl = slice(r * frames, min((r + 1) * frames, t))
        m = mask[:, sl]
        keys = float_order_key(mags[:, sl][m]).numpy()
        bk = bucket[:, sl][m].numpy()
        order = rng.permutation(len(keys))
        lists.append((keys[order], bk[order]))
    return lists


def _radix_median_rank(lists):
    """``cluster_median_rank``: four 8-bit passes, per-CTA histograms of the
    keys matching the prefix, merged by integer sums; then the smallest key
    above when the even count's upper middle is not the lower one."""
    u_lists = [(k.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000 for k, _ in lists]
    n = sum(len(u) for u in u_lists)
    if n == 0:
        return 0, None, 0, None
    k = (n - 1) // 2
    prefix, below_all, cnt_le = 0, 0, 0
    for p in range(4):
        shift = 24 - 8 * p
        merged = np.zeros(256, np.int64)
        for u in u_lists:
            match = (u >> (shift + 8)) == (prefix >> (shift + 8)) if p else \
                np.ones(len(u), bool)
            merged += np.bincount((u[match] >> shift) & 0xFF, minlength=256)
        incl = np.cumsum(merged)
        d = int(np.searchsorted(incl, k, side="right"))
        below = int(incl[d] - merged[d])
        prefix |= d << shift
        k -= below
        below_all += below
        if p == 3:
            cnt_le = below_all + int(merged[d])
    key_lo = np.int32(np.uint32(prefix ^ 0x80000000).view(np.int32))
    min_above = None
    if n // 2 != (n - 1) // 2 and cnt_le < n // 2 + 1:
        above = [keys[keys > key_lo] for keys, _ in lists]
        min_above = min(int(a.min()) for a in above if len(a))
    return n, int(key_lo), cnt_le, min_above


def _emulated_tuning(power, colmax, seed=0):
    """The kernel's scheme, clip by clip -> ``(B,)`` float32 tunings."""
    mask, mags, bucket, edges = _candidates(power, colmax)
    rng = np.random.default_rng(seed)
    out = np.zeros(power.shape[0], np.float32)
    for b in range(power.shape[0]):
        lists = _cta_lists(mask[b], mags[b], bucket[b], rng)
        n, key_lo, cnt_le, min_above = _radix_median_rank(lists)
        if n == 0:
            continue
        to_f = lambda key: key_to_float(  # noqa: E731
            torch.tensor([key], dtype=torch.int32)).numpy()[0]
        v_lo = to_f(key_lo)
        v_hi = to_f(min_above) if min_above is not None else v_lo
        thresh = np.float32(0.5) * (v_lo + v_hi)
        vote = np.zeros(100, np.int64)
        for keys, bk in lists:
            sel = key_to_float(torch.from_numpy(keys)).numpy() >= thresh
            vote += np.bincount(bk[sel], minlength=100)
        if vote.max() > 0:
            out[b] = edges[int(np.argmax(vote))]
    return out


def _jax_tuning(power, colmax):
    from tpuvae.ops.tuning import estimate_tuning_pallas

    p = power.float().numpy()
    jp = jnp.asarray(p).astype(jnp.bfloat16 if power.dtype == torch.bfloat16
                               else jnp.float32)
    return np.asarray(estimate_tuning_pallas(jp, SR, N_FFT,
                                             colmax=jnp.asarray(colmax.numpy()),
                                             interpret=True))


def _tones_power(n_clips, n_samples, seed):
    from tpuvae_torch.ops.stft import stft_fused_features_plain

    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    clips = []
    for _ in range(n_clips):
        f0 = 220 * 2 ** rng.uniform(-0.5, 0.5)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(4))
        clips.append((sig + 0.1 * rng.normal(size=t.shape)).astype(np.float32))
    fe = stft_fused_features_plain(torch.from_numpy(np.stack(clips)), N_FFT,
                                   HOP, sr=SR, n_mels=16, exact=True)
    return fe.power


def _alternating_power(n_clips, t, seed, levels=(2.0, 3.0), share_low=0.5):
    """Every odd row above its even neighbours and above 0.1 of the
    column's max: each odd band row inside the mask is a candidate.  Odd
    rows take one of ``levels`` (a symmetric peak: magnitude = power)."""
    rng = np.random.default_rng(seed)
    power = np.ones((n_clips, N_FFT // 2 + 1, t), np.float32)
    low = rng.random((n_clips, N_FFT // 4, t)) < share_low
    power[:, 1::2] = np.where(low, levels[0], levels[1])
    return torch.from_numpy(power)


def _inputs(power, dtype):
    power = power.to(dtype)
    return power, power.float().amax(dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_design_equals_plain_and_pallas_on_tones(dtype):
    power, colmax = _inputs(_tones_power(3, 2 * SR + 101, 11), dtype)
    want = tn.estimate_tuning_plain(power, colmax, SR, N_FFT).numpy()
    got = _emulated_tuning(power, colmax)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_jax_tuning(power, colmax), want)
    # the compaction order does not matter: an order statistic and a count
    np.testing.assert_array_equal(_emulated_tuning(power, colmax, seed=5), want)


def test_alternating_spectrum_reaches_the_list_bound():
    """Rows r and r + 1 are never both candidates and row 0 never is, so a
    frame holds at most ceil(r8 / 2): the alternating band reaches it."""
    lo8, r8, fmask, *_ = tn._tuning_consts(SR, N_FFT, N_FFT // 2 + 1, 0.01)
    band = _alternating_power(1, 5, 0)[0, lo8:lo8 + r8].numpy()
    st = band                                   # all above 0.1 x colmax
    left = np.concatenate([st[:1], st[:-1]])
    right = np.concatenate([st[1:], st[-1:]])
    cand = (st > left) & (st >= right)
    assert (cand.sum(axis=0) == -(-r8 // 2)).all()
    assert not (cand[:-1] & cand[1:]).any() and not cand[0].any()
    frames, capacity = tn.list_geometry(1292, r8)
    assert (frames, capacity) == (162, 162 * (-(-r8 // 2)))
    # the candidates that fmask keeps, per frame, stay within the bound
    assert (cand & (fmask[:, None] > 0.5)).sum(axis=0).max() <= -(-r8 // 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_design_on_the_worst_case_and_a_silent_clip(dtype):
    power = _alternating_power(3, 37, 1)
    power[1] = 0.0                              # no candidate at all
    power, colmax = _inputs(power, dtype)
    mask = _candidates(power, colmax)[0]
    assert mask[0].sum(dim=0).min() > 100 and not mask[1].any()
    want = tn.estimate_tuning_plain(power, colmax, SR, N_FFT).numpy()
    assert want[1] == 0.0
    np.testing.assert_array_equal(_emulated_tuning(power, colmax), want)
    np.testing.assert_array_equal(_jax_tuning(power, colmax), want)


def test_a_threshold_equal_to_candidate_magnitudes_counts_them():
    """Three quarters of the candidates at magnitude 2, the rest at 3: the
    median is exactly 2, and the vote (>=) counts every candidate, where a
    strict compare would count a quarter of them."""
    power, colmax = _inputs(_alternating_power(2, 29, 2, share_low=0.75),
                            torch.float32)
    mask, mags, bucket, _ = _candidates(power, colmax)
    for b in range(2):
        n, key_lo, cnt_le, min_above = _radix_median_rank(
            _cta_lists(mask[b], mags[b], bucket[b], np.random.default_rng(b)))
        assert n == int(mask[b].sum())
        assert key_to_float(torch.tensor([key_lo], dtype=torch.int32)) == 2.0
        assert cnt_le > n // 2 + 1               # v_hi = v_lo: thresh = 2.0
        assert int((mags[b][mask[b]] > 2.0).sum()) < n // 2
    want = tn.estimate_tuning_plain(power, colmax, SR, N_FFT).numpy()
    np.testing.assert_array_equal(_emulated_tuning(power, colmax), want)
    np.testing.assert_array_equal(_jax_tuning(power, colmax), want)


@pytest.mark.parametrize("t,capacity_in_smem", [(1292, True), (2600, False)])
def test_list_geometry_and_the_global_buffer_switch(t, capacity_in_smem):
    _, r8, *_ = tn._tuning_consts(SR, N_FFT, N_FFT // 2 + 1, 0.01)
    frames, capacity = tn.list_geometry(t, r8)
    assert frames * tn.CLUSTER >= t > (frames - 1) * tn.CLUSTER
    assert capacity == frames * -(-r8 // 2)
    assert (capacity <= tn.SMEM_LIST_ENTRIES) == capacity_in_smem
    # 5 bytes an entry, beside ~4.2 KB of static scratch, under 227 KB
    assert tn.SMEM_LIST_ENTRIES * 5 + 4160 <= 232448


def test_order_keys_of_signed_zeros_compare_as_floats():
    """+0.0 and -0.0 have different keys but are equal floats: the vote
    compares ``key_to_float(key) >= thresh``, not keys."""
    z = torch.tensor([0.0, -0.0], dtype=torch.float32)
    keys = float_order_key(z)
    assert keys[0] != keys[1] and int(keys.max()) < I32_MAX
    back = key_to_float(keys)
    assert (back >= 0.0).all()
    assert torch.equal(back.view(torch.int32), z.view(torch.int32))
