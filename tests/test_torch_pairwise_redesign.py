"""Kernel 5's Hopper design (``csrc/pairwise.cu``) emulated on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).  Its
scheme is emulated here step by step and held to the plain version and to
the JAX package's Pallas kernel (interpret mode) within kernel 5's stated
tolerance, 1e-5 x (max|x|^2 + max|y|^2) on the squared distances:

* a persistent grid of ``G`` CTAs, CTA ``b`` taking tiles ``b, b + G,
  ...``; in self mode the tiles on or above the diagonal, row-major, found
  by the kernel's running (row, row start, row end) walk;
* a thread's micro-tile of runs of 4 rows by 4 columns (8 x 8 at T =
  128, 4 x 4 at 64), read from the swizzled operand blocks as float4s;
* D in chunks of 32, zero-filled past N and D; the cross term and the row
  norms as fp32 FMA chains over D in one order;
* each off-diagonal tile written directly and, transposed, as its mirror:
  every element of the (N, N) result is written exactly once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvae_torch.ops import pairwise as pw

CHUNK = 32


def _tile_walk(n: int, m: int, self_mode: bool, tile: int, grid: int):
    """The ``(bi, bj)`` tiles each CTA of the persistent grid computes, as
    the kernel's loop walks them."""
    nbr, nbc = -(-n // tile), -(-m // tile)
    total = nbr * (nbr + 1) // 2 if self_mode else nbr * nbc
    walks = []
    for b in range(grid):
        bi, row_beg, row_end = 0, 0, nbr
        tiles = []
        for t in range(b, total, grid):
            if self_mode:
                while t >= row_end:
                    bi += 1
                    row_beg = row_end
                    row_end += nbr - bi
                bj = bi + (t - row_beg)
            else:
                bi, bj = divmod(t, nbc)
            tiles.append((bi, bj))
        walks.append(tiles)
    return walks


def _fma_chain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``acc = fmaf(a[:, k], b[:, k], acc)`` for k = 0 .. D-1 in fp32 (the
    product is exact in fp64; the sum rounds once to fp32 per step)."""
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k in range(a.shape[1]):
        acc = (np.outer(a[:, k].astype(np.float64), b[:, k].astype(np.float64))
               + acc).astype(np.float32)
    return acc


def _norms(a: np.ndarray) -> np.ndarray:
    acc = np.zeros(a.shape[0], np.float32)
    for k in range(a.shape[1]):
        acc = (a[:, k].astype(np.float64) ** 2 + acc).astype(np.float32)
    return acc


def _staged(v: np.ndarray, row0: int, tile: int, d: int) -> np.ndarray:
    """The (tile, D padded to chunks) block the kernel stages, zero-filled."""
    dp = -(-max(d, 1) // CHUNK) * CHUNK
    blk = np.zeros((tile, dp), np.float32)
    rows = v[row0:row0 + tile]
    blk[:rows.shape[0], :d] = rows
    return blk


def _tile_values(x, y, bi, bj, tile, self_mode):
    n, d = x.shape
    xb = _staged(x, bi * tile, tile, d)
    yb = _staged(y, bj * tile, tile, d)
    acc = _fma_chain(xb, yb)
    xn, yn = _norms(xb), _norms(yb)
    v = np.maximum((xn[:, None] + yn[None, :]).astype(np.float32)
                   - np.float32(2.0) * acc, np.float32(0.0)).astype(np.float32)
    if self_mode:
        v = np.sqrt(v)
        r = bi * tile + np.arange(tile)[:, None]
        c = bj * tile + np.arange(tile)[None, :]
        v[r == c] = 0.0
    return v


def _emulated(x: np.ndarray, y: np.ndarray, self_mode: bool, tile: int,
              grid: int = 7):
    """The kernel's output and how many times each element was written."""
    n, m = x.shape[0], y.shape[0]
    out = np.full((n, m), np.nan, np.float32)
    writes = np.zeros((n, m), np.int64)
    for walk in _tile_walk(n, m, self_mode, tile, grid):
        for bi, bj in walk:
            v = _tile_values(x, y, bi, bj, tile, self_mode)
            r0, c0 = bi * tile, bj * tile
            rr, cc = min(tile, n - r0), min(tile, m - c0)
            out[r0:r0 + rr, c0:c0 + cc] = v[:rr, :cc]
            writes[r0:r0 + rr, c0:c0 + cc] += 1
            if self_mode and bi != bj:            # the mirror, from the stage
                out[c0:c0 + cc, r0:r0 + rr] = v[:rr, :cc].T
                writes[c0:c0 + cc, r0:r0 + rr] += 1
    return out, writes


def _tol(x, y):
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


@pytest.mark.parametrize("n,tile", [(150, 64), (129, 128), (300, 64), (64, 64)])
@pytest.mark.parametrize("grid", [1, 5])
def test_upper_triangle_walk_covers_every_pair_once(n, tile, grid):
    walks = _tile_walk(n, n, True, tile, grid)
    got = sorted(t for w in walks for t in w)
    nb = -(-n // tile)
    assert got == [(i, j) for i in range(nb) for j in range(i, nb)]
    full = sorted(t for w in _tile_walk(n, 77, False, tile, grid) for t in w)
    assert full == [(i, j) for i in range(nb) for j in range(-(-77 // tile))]


def _micro_tile(tid: int, tile: int):
    """Rows and columns of thread ``tid``'s micro-tile (``Geometry``)."""
    groups = tile // 64
    lane, warp = tid % 32, tid // 32
    lr, lc, wr, wc = lane % 4, lane // 4, warp % 4, warp // 4
    rbase = wr * 16 * groups + 4 * lr
    cbase = wc * 32 * groups + 4 * lc
    rows = [rbase + 16 * ii + q for ii in range(groups) for q in range(4)]
    cols = [cbase + 32 * jj + q for jj in range(groups) for q in range(4)]
    return rows, cols


@pytest.mark.parametrize("tile", pw.TILES)
def test_micro_tiles_cover_the_tile_once(tile):
    seen = np.zeros((tile, tile), np.int64)
    for tid in range(256):
        rows, cols = _micro_tile(tid, tile)
        seen[np.ix_(rows, cols)] += 1
    assert (seen == 1).all()
    # a warp's direct store of one row of its 4 x 4 blocks: 8 lanes, 16
    # bytes each, 32 consecutive columns (one 128-byte line) per row
    for warp in range(8):
        lanes = [_micro_tile(32 * warp + lane, tile) for lane in range(32)]
        for lr in range(4):
            cols = sorted(c for rows_cols in lanes[lr::4]
                          for c in rows_cols[1][:4])
            assert cols == list(range(cols[0], cols[0] + 32))
            assert cols[0] % 32 == 0


def _op_index(k, r, tile):
    """``op_index`` of csrc/pairwise.cu."""
    return k * tile + (r ^ (((k >> 2) & 7) << 2))


@pytest.mark.parametrize("tile", pw.TILES)
def test_operand_swizzle_is_conflict_free(tile):
    """The swizzled layout of a transposed (32 x tile) block: a
    permutation of each row; the transposing stores of a warp (lane ->
    row 4 w + lane // 8, columns 4 (lane % 8) + j) and the y reads (32
    consecutive columns) hit 32 distinct banks; four consecutive columns
    from a multiple of 4 stay one aligned float4."""
    for k in range(CHUNK):
        idx = [_op_index(k, r, tile) for r in range(tile)]
        assert sorted(idx) == list(range(k * tile, (k + 1) * tile))
        for r0 in range(0, tile, 4):
            run = [_op_index(k, r0 + i, tile) for i in range(4)]
            assert run[0] % 4 == 0 and run == list(range(run[0], run[0] + 4))
        for c0 in range(0, tile, 32):
            banks = {_op_index(k, c0 + lane, tile) % 32 for lane in range(32)}
            assert len(banks) == 32
    for w in range(tile // 4):
        for j in range(4):
            banks = {_op_index(4 * (lane % 8) + j, 4 * w + lane // 8, tile) % 32
                     for lane in range(32)}
            assert len(banks) == 32
    # a warp's float4 reads of x (4 runs) and y (8 runs) at one k: distinct
    # 16-byte slots of one 128-byte window, one wavefront
    for k in range(CHUNK):
        for warp in range(8):
            for g in range(tile // 64):
                for side in (0, 1):
                    starts = {_op_index(k, _micro_tile(32 * warp + lane, tile)
                                        [side][4 * g], tile)
                              for lane in range(32)}
                    assert len(starts) == (4, 8)[side]
                    assert all(s0 % 4 == 0 for s0 in starts)
                    assert len({s0 // 4 % 8 for s0 in starts}) == len(starts)
                    assert max(starts) - min(starts) < 32


def test_transposed_stage_writes_and_reads_are_conflict_free():
    """The mirror's stage: stride tile + 4 floats (an odd count of
    float4s).  A float4 write of four rows at one column per lane: each
    quarter-warp phase hits 8 distinct 16-byte bank slots."""
    for tile in pw.TILES:
        stride = tile + 4
        assert stride % 4 == 0 and (stride // 4) % 2 == 1
        for warp in range(8):
            for qc in range(4):
                slots = []
                for lane in range(32):
                    rows, cols = _micro_tile(32 * warp + lane, tile)
                    slots.append(((cols[qc] * stride + rows[0]) // 4) % 8)
                for phase in range(4):
                    assert len(set(slots[8 * phase:8 * phase + 8])) == 8


@pytest.mark.parametrize("n,d,tile", [(150, 37, 64), (200, 32, 128),
                                      (70, 3, 64)])
def test_self_mode_is_exactly_symmetric_and_within_tolerance(n, d, tile):
    """N not a multiple of the tile, D not a multiple of the chunk."""
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[1] = x[0] + 1e-4
    out, writes = _emulated(x, x, True, tile)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, out.T)
    assert (np.diagonal(out) == 0).all()
    want = pw.self_distances_plain(torch.from_numpy(x)).numpy()
    assert np.abs(out - want).max() <= _tol(x, x) ** 0.5


@pytest.mark.parametrize("n,d,tile", [(150, 37, 64), (200, 32, 128)])
def test_a_mirrored_tile_equals_the_directly_computed_one(n, d, tile):
    """Tile (bj, bi) computed directly is bit-equal to tile (bi, bj)
    transposed: the same products and norms, summed in the same order."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    nb = -(-n // tile)
    for bi in range(nb):
        for bj in range(bi, nb):
            a = _tile_values(x, x, bi, bj, tile, True)
            b = _tile_values(x, x, bj, bi, tile, True)
            np.testing.assert_array_equal(a, b.T)


@pytest.mark.parametrize("n,m,d,tile", [(100, 77, 37, 64), (65, 200, 3, 128),
                                        (130, 130, 8, 64)])
def test_squared_mode_within_tolerance_of_plain_and_pallas(n, m, d, tile):
    from tpuvae.ops.pairwise import squared_distances_pallas

    rng = np.random.default_rng(n * m + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(m, d)).astype(np.float32)
    out, writes = _emulated(x, y, False, tile)
    assert (writes == 1).all() and (out >= 0).all()
    tol = _tol(x, y)
    want = pw.squared_distances_plain(torch.from_numpy(x),
                                      torch.from_numpy(y)).numpy()
    assert np.abs(out - want).max() <= tol
    jax_out = np.asarray(squared_distances_pallas(jnp.asarray(x),
                                                  jnp.asarray(y),
                                                  interpret=True))
    assert np.abs(out - jax_out).max() <= tol


@pytest.mark.parametrize("n,self_mode,want", [
    (10240, True, 128), (1336, True, 64), (186, True, 64), (4000, True, 128),
    (2000, True, 64), (10240, False, 128), (1336, False, 64)])
def test_tile_size_keeps_the_sms_busy(n, self_mode, want):
    """128-wide tiles where they give at least two tiles an SM (132 SMs),
    64-wide ones below."""
    assert pw.tile_size(n, n, self_mode, 132) == want

