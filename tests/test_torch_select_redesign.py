"""Kernel 3's Hopper design (``csrc/select.cu`` + ``csrc/cluster_select.cuh``)
emulated on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).  Its
scheme is emulated here step by step and held bit-equal to the plain
version and to the JAX package's Pallas kernel (interpret mode):

* a cluster of ``CLUSTER`` CTAs per row, CTA ``r`` reading the keys
  ``[r S, (r + 1) S)`` (``slice_geometry``): a scalar head up to the first
  16-byte boundary, 16-byte vectors, a scalar tail;
* each CTA compacts the keys below the sentinel into a list, in an order
  the kernel does not fix (shuffled here); entries past the shared-memory
  capacity go to a global spill, and the two read as one list;
* the exact rank by an MSB-first radix select in four 8-bit passes whose
  per-CTA digit histograms are merged by integer sums, then the smallest
  key above ``key_lo`` whenever one exists;
* an empty row gives ``(0, INT32_MAX, N, INT32_MAX)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvae_torch.ops import select as sel

I32_MAX = sel.I32_MAX


def _slice_parts(addr: int, length: int) -> tuple[int, int, int]:
    """The kernel's split of a slice starting at byte address ``addr``:
    ``(head, vectors, tail)`` keys."""
    head = min(((16 - addr % 16) % 16) // 4, length)
    n_vec = (length - head) // 4
    return head, n_vec, length - head - 4 * n_vec


def _cta_lists(row: np.ndarray, rng, row_addr: int = 0, capacity=None):
    """CTA r's list as the kernel leaves it: (shared part, spill part), the
    valid keys of its slice compacted in a shuffled order."""
    n_cols = row.shape[0]
    slice_, cap, spill = sel.slice_geometry(n_cols)
    cap = cap if capacity is None else capacity
    lists = []
    for r in range(sel.CLUSTER):
        lo = min(r * slice_, n_cols)
        hi = min(lo + slice_, n_cols)
        head, n_vec, tail = _slice_parts(row_addr + 4 * lo, hi - lo)
        # every key of the slice is read once: head, vectors, tail
        parts = [row[lo:lo + head],
                 row[lo + head:lo + head + 4 * n_vec].reshape(-1, 4).ravel(),
                 row[lo + head + 4 * n_vec:hi]]
        got = np.concatenate(parts)
        np.testing.assert_array_equal(got, row[lo:hi])
        valid = got[got < I32_MAX]
        valid = valid[rng.permutation(len(valid))]
        assert len(valid) <= slice_
        lists.append((valid[:cap], valid[cap:]))
    return lists


def _cluster_median_rank(lists, n_cols: int):
    """``cluster_median_rank(..., always_min_above=true)`` as select.cu
    reports it: ``(n, key_lo, cnt_le, min_above)``."""
    keys = [np.concatenate([a, b]) for a, b in lists]     # KeyList
    u_lists = [(k.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000 for k in keys]
    n = sum(len(u) for u in u_lists)
    if n == 0:
        return 0, I32_MAX, n_cols, I32_MAX
    k = (n - 1) // 2
    prefix, below_all, cnt_le = 0, 0, 0
    for p in range(4):
        shift = 24 - 8 * p
        merged = np.zeros(256, np.int64)
        for u in u_lists:
            match = ((u >> (shift + 8)) == (prefix >> (shift + 8))) if p else \
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
    key_lo = int(np.uint32(prefix ^ 0x80000000).view(np.int32))
    min_above = I32_MAX
    if cnt_le < n:
        min_above = min(int(a[a > key_lo].min()) for a in keys
                        if (a > key_lo).any())
    return n, key_lo, cnt_le, min_above


def _emulated(keys: np.ndarray, seed=0, row_addr=0, capacity=None):
    rng = np.random.default_rng(seed)
    return np.array([_cluster_median_rank(
        _cta_lists(row, rng, row_addr, capacity), keys.shape[1])
        for row in keys], np.int64)


def _pallas_stats(keys: np.ndarray) -> np.ndarray:
    from tpuvae.ops.select import _masked_median_stats

    b, n = keys.shape
    pad = (-n) % 128
    jk = jnp.pad(jnp.asarray(keys), ((0, 0), (0, pad)),
                 constant_values=I32_MAX)
    return np.asarray(_masked_median_stats(jk.reshape(b, -1, 128), True))[:, 0]


def _check(keys: np.ndarray, **kw):
    """Emulation == plain bit for bit, and == the Pallas kernel (whose
    cnt_le of an empty row also counts its 128-lane pad)."""
    want = sel.select_stats_plain(torch.from_numpy(keys)).numpy()
    got = _emulated(keys, **kw)
    np.testing.assert_array_equal(got, want)
    jax_stats = _pallas_stats(keys)
    np.testing.assert_array_equal(jax_stats[:, [0, 1, 3]], want[:, [0, 1, 3]])
    full = want[:, 0] > 0
    np.testing.assert_array_equal(jax_stats[full, 2], want[full, 2])
    np.testing.assert_array_equal(want[~full, 2], keys.shape[1])
    return want


def _keys(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return sel.masked_keys(torch.from_numpy(vals),
                           torch.from_numpy(mask)).numpy()


def test_emulated_design_on_edge_rows():
    """An empty row (cnt_le == N), a single element, ties and signed zeros,
    odd and even counts (min_above the true neighbour either way)."""
    rng = np.random.default_rng(7)
    n_cols = 3001
    vals = (rng.integers(-20, 20, size=(6, n_cols)) * 0.5).astype(np.float32)
    mask = rng.random((6, n_cols)) < 0.4
    mask[0] = False                                  # empty
    mask[1] = False
    mask[1, 17] = True                               # single element
    vals[2, :200] = 0.0
    vals[2, 200:400] = -0.0                          # signed zeros, ties
    mask[3, :] = True
    mask[3, -1] = False                              # n = 3000, even
    mask[4, :] = True                                # n = 3001, odd
    want = _check(_keys(vals, mask))
    assert tuple(want[0]) == (0, I32_MAX, n_cols, I32_MAX)
    assert want[1, 0] == 1 and want[1, 2] == 1 and want[1, 3] == I32_MAX
    assert want[4, 0] % 2 == 1 and want[4, 3] < I32_MAX


def test_odd_count_still_reports_the_true_neighbour():
    """For odd n the median needs only key_lo; the kernel still returns the
    smallest key above it, as the plain version and Pallas do."""
    vals = np.array([[3.0, 1.0, 2.0, 5.0, 4.0]], np.float32)
    keys = _keys(vals, np.ones_like(vals, bool))
    want = _check(keys)
    f = sel.key_to_float(torch.from_numpy(want[0, [1, 3]].astype(np.int32)))
    assert f.tolist() == [3.0, 4.0]


@pytest.mark.parametrize("n_cols", [1, 3, 7, 8, 9, 31, 33])
def test_rows_shorter_than_the_cluster(n_cols):
    rng = np.random.default_rng(n_cols)
    vals = rng.normal(size=(3, n_cols)).astype(np.float32)
    mask = rng.random((3, n_cols)) < 0.6
    mask[0] = True
    slice_, capacity, spill = sel.slice_geometry(n_cols)
    assert slice_ == (4 if n_cols <= 32 else 8) and capacity == slice_
    assert spill == 0
    _check(_keys(vals, mask))


@pytest.mark.parametrize("row_addr", [0, 4, 8, 12])
def test_every_key_is_read_once_whatever_the_alignment(row_addr):
    """Head, vectors and tail cover each slice exactly (asserted inside
    ``_cta_lists``) for rows starting at any 4-byte offset."""
    rng = np.random.default_rng(row_addr)
    vals = rng.normal(size=(2, 4101)).astype(np.float32)
    mask = rng.random((2, 4101)) < 0.5
    _check(_keys(vals, mask), row_addr=row_addr)
    for length in range(0, 9):
        head, n_vec, tail = _slice_parts(row_addr, length)
        assert head + 4 * n_vec + tail == length and 0 <= tail < 4
        assert (row_addr + 4 * head) % 16 == 0 or n_vec == 0


def test_slice_geometry_and_the_spill_switch():
    """At the main path's 475,456 keys a slice is 59,432 keys: a list
    spills past 27,000 entries.  Rows up to 8 x 27,000 keys never spill."""
    assert sel.slice_geometry(475_456) == (59_432, 27_000, 32_432)
    assert sel.slice_geometry(216_000) == (27_000, 27_000, 0)
    assert sel.slice_geometry(216_001)[2] == 4
    for n in (1, 100, 4099, 216_000, 216_001, 475_456, 10**6 + 3):
        slice_, capacity, spill = sel.slice_geometry(n)
        assert slice_ % 4 == 0 and slice_ * sel.CLUSTER >= n
        assert (slice_ - 4) * sel.CLUSTER < max(n, 1)
        assert capacity + spill == slice_
    # two CTAs an SM: 2 x (lists + ~3.2 KB static + 1 KB reserved) <= 228 KB
    assert 2 * (sel.SMEM_LIST_ENTRIES * 4 + 3200 + 1024) <= 233_472


def test_all_valid_row_spills_and_stays_exact():
    """Every key valid: 27,004 keys a slice, the last four of each list in
    the spill."""
    rng = np.random.default_rng(1)
    n_cols = 216_003
    vals = (rng.integers(-500, 500, size=(2, n_cols)) * 0.125).astype(np.float32)
    mask = np.ones((2, n_cols), bool)
    mask[1, 5] = False
    _check(_keys(vals, mask))


@pytest.mark.parametrize("capacity", [1, 37, 10_000])
def test_any_shared_capacity_gives_the_same_numbers(capacity):
    """The spill switch at other capacities: the list reads as one."""
    rng = np.random.default_rng(capacity)
    vals = rng.normal(size=(3, 20_000)).astype(np.float32)
    mask = rng.random((3, 20_000)) < 0.7
    keys = _keys(vals, mask)
    want = sel.select_stats_plain(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(_emulated(keys, capacity=capacity), want)


def test_compaction_order_does_not_matter():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(2, 9000)).astype(np.float32)
    mask = rng.random((2, 9000)) < 0.3
    keys = _keys(vals, mask)
    a = _emulated(keys, seed=1)
    b = _emulated(keys, seed=99)
    np.testing.assert_array_equal(a, b)


def test_real_piptrack_keys():
    """The main path's keys: piptrack candidates of two tone clips from
    ``_tuning_candidates``, a few per frame."""
    from tpuvae_torch.dsp.chroma import _tuning_candidates
    from tpuvae_torch.ops.stft import stft_fused_features_plain

    sr, n_fft, hop = 22050, 2048, 512
    rng = np.random.default_rng(5)
    t = np.arange(3 * sr) / sr
    clips = []
    for _ in range(2):
        f0 = 220 * 2 ** rng.uniform(-0.5, 0.5)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t) / (k + 1)
                  for k in range(4))
        clips.append((sig + 0.1 * rng.normal(size=t.shape)).astype(np.float32))
    fe = stft_fused_features_plain(torch.from_numpy(np.stack(clips)), n_fft,
                                   hop, sr=sr, n_mels=16, exact=True)
    _, mags, mask = _tuning_candidates(fe.power, sr, n_fft, fe.colmax)
    keys = sel.masked_keys(mags.reshape(2, -1), mask.reshape(2, -1)).numpy()
    want = _check(keys)
    assert (want[:, 0] > 0).all() and (want[:, 0] < keys.shape[1] // 4).all()


def test_jax_keys_equal_the_ports():
    """The keys both packages hand their kernels are the same int32s."""
    from tpuvae.dsp.chroma import _float_order_key

    rng = np.random.default_rng(0)
    vals = rng.normal(size=(2, 500)).astype(np.float32)
    vals[0, :10] = -0.0
    mask = rng.random((2, 500)) < 0.5
    packed = jnp.where(jnp.asarray(mask), _float_order_key(jnp.asarray(vals)),
                       jnp.uint32(0xFFFFFFFF))
    jkeys = jax.lax.bitcast_convert_type(packed ^ jnp.uint32(0x80000000),
                                         jnp.int32)
    np.testing.assert_array_equal(_keys(vals, mask), np.asarray(jkeys))
