"""Kernel 6's Hopper design (``csrc/fusedconv.cu``) emulated on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).  What
conv1's new design computes is emulated here in plain PyTorch and held to
the plain version at the tolerances ``chip_smoke.py`` holds the kernel to
(y1 rtol / atol 1e-4 and within 1e-5 of its largest magnitude; means atol
1e-5; variances rtol 1e-4 / atol 1e-6):

* an implicit GEMM over the stride-2, (0, 1)-padded taps: M output pixels,
  N = 64 channels, K = 9 taps x 32 channels, the zero padding AFTER the
  affine and LeakyReLU;
* three TF32 products of split operands (``ops.stft._split_tf32`` for the
  weights, the same rounding for the activations), accumulated as the
  tensor cores do (8 exact products a step, truncated into fp32), with each
  tap's twelve products promoted into fp32 running sums — and a single TF32
  product, which fails;
* the kernel's index maps: fragment rows to tile pixels, taps to input
  pixels of the 17 x 17 staged tile, the XOR swizzle that keeps the
  fragment reads free of bank conflicts;
* the statistics: conv0's partial row per tile added in tile order by
  eight interleaved sums; conv1's warpgroups own contiguous tile ranges and
  publish one partial row per run of tiles in one image, added in worker
  order once the image's ticket counts every run.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuvae_torch.ops import fusedconv as fc
from tpuvae_torch.ops import stft as ops_stft


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on a torch tensor, by integer arithmetic."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _round_toward_zero_f32(x64: torch.Tensor) -> torch.Tensor:
    f = x64.to(torch.float32)
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _inputs(b=2, h=32, w=64, seed=0):
    """Layer 1's inputs as the pair makes them: raw y0 of a standardized
    image, the BatchNorm fold of its batch statistics, weights at flax's
    initial scale."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.standard_normal((b, h, w)))
    y0, s0, ss0 = fc.conv0_stats_plain(x, t(rng.standard_normal((3, 3, 32)) / 3),
                                       t(0.1 * rng.standard_normal(32)))
    mean0, var0 = fc._finalize(s0, ss0, b * (h // 2) * (w // 2))
    scale, shift = fc._fold(mean0, var0, t(1 + 0.2 * rng.standard_normal(32)),
                            t(0.1 * rng.standard_normal(32)), 1e-5)
    w1 = t(rng.standard_normal((3, 3, 32, 64)) * (9 * 32) ** -0.5)
    b1 = t(0.1 * rng.standard_normal(64))
    return y0, scale, shift, w1, b1


def _normalized(y0, scale, shift):
    """The kernel's affine (one rounding: an FMA) and LeakyReLU."""
    z = (y0.double() * scale.double() + shift.double()).float()
    return torch.where(z > 0, z, fc.LEAKY_SLOPE * z)


def _taps(z):
    """The nine stride-2 taps of the (0, 1)-padded activation, each
    (B, H/2, W/2, C): tap (p, q) of output pixel (i, j) is z[2i+p, 2j+q],
    zero past the image."""
    h2, w2 = z.shape[1] // 2, z.shape[2] // 2
    zp = F.pad(z, (0, 0, 0, 1, 0, 1))
    return [zp[:, p::2, q::2][:, :h2, :w2] for p in range(3) for q in range(3)]


def _emulated_conv1(y0, scale, shift, w1, b1, products):
    """y1 of conv1 as an implicit GEMM on the tensor cores.  ``products=3``:
    the kernel (lo x hi, hi x lo, hi x hi per tap, the tap's partial sum
    promoted); ``products=1``: hi x hi, all taps in one accumulator."""
    taps = _taps(_normalized(y0, scale, shift))
    b, h2, w2, c = taps[0].shape
    w_hi, w_lo = (torch.from_numpy(a).double().reshape(9, c, -1)
                  for a in ops_stft._split_tf32(w1.numpy()))
    acc = torch.zeros((b * h2 * w2, w_hi.shape[-1]))
    part = torch.zeros_like(acc)
    for tap, a in enumerate(taps):
        a = a.reshape(-1, c)
        a_hi = _round_tf32(a)
        a_lo = _round_tf32(a - a_hi).double()
        a_hi = a_hi.double()
        pairs = (((a_lo, w_hi[tap]), (a_hi, w_lo[tap]), (a_hi, w_hi[tap]))
                 if products == 3 else ((a_hi, w_hi[tap]),))
        for i, (lhs, rhs) in enumerate(pairs):
            for kk in range(c // 8):
                s = lhs[:, 8 * kk:8 * kk + 8] @ rhs[8 * kk:8 * kk + 8]
                first = products == 3 and i == 0 and kk == 0
                part = _round_toward_zero_f32(s if first else part.double() + s)
        if products == 3:
            acc = acc + part
    y1 = (part if products == 1 else acc) + b1
    return y1.reshape(b, h2, w2, -1)


def _batch_stats(y):
    n = y.shape[0] * y.shape[1] * y.shape[2]
    return fc._finalize(y.sum(dim=(1, 2))[:, None], (y * y).sum(dim=(1, 2))[:, None], n)


def _assert_kernel_tolerances(y1, want):
    torch.testing.assert_close(y1, want, rtol=1e-4, atol=1e-4)
    assert (y1 - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    (m, v), (pm, pv) = _batch_stats(y1), _batch_stats(want)
    torch.testing.assert_close(m, pm, rtol=0, atol=1e-5)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-6)


def test_three_tf32_products_with_promoted_taps_hold_the_kernel_tolerances():
    y0, scale, shift, w1, b1 = _inputs()
    want = fc.conv1_norm_stats_plain(y0, scale, shift, w1, b1)[0]
    _assert_kernel_tolerances(
        _emulated_conv1(y0, scale, shift, w1, b1, products=3), want)


def test_one_tf32_product_fails_them():
    y0, scale, shift, w1, b1 = _inputs()
    want = fc.conv1_norm_stats_plain(y0, scale, shift, w1, b1)[0]
    got = _emulated_conv1(y0, scale, shift, w1, b1, products=1)
    with pytest.raises(AssertionError):
        _assert_kernel_tolerances(got, want)
    assert (got - want).abs().max().item() > 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("h,w", [(32, 64), (6, 10)])
def test_tap_gather_is_the_stride2_same_convolution(h, w):
    """Exact products over the nine gathered taps equal the plain
    convolution (pads (0, 1), zero AFTER the affine), odd tile counts
    included."""
    y0, scale, shift, w1, b1 = _inputs(h=2 * h, w=2 * w, seed=1)
    z = _normalized(y0, scale, shift).double()
    taps = _taps(z)
    got = sum(t @ w1.double().reshape(9, 32, 64)[i]
              for i, t in enumerate(taps)) + b1.double()
    zp = F.pad(z.permute(0, 3, 1, 2), (0, 1, 0, 1))
    want = F.conv2d(zp, w1.double().permute(3, 2, 0, 1), b1.double(),
                    stride=2).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert got.shape == (2, h // 2, w // 2, 64)


# -- the kernel's index maps (csrc/fusedconv.cu, conv1) --------------------------

K_IN = 17                      # staged input tile: 17 x 17 pixels x 32 channels


def _tile_at(p, ch):
    """Float offset of the 16-byte chunk ``ch`` of staged pixel ``p``."""
    return p * 32 + ((ch ^ ((p >> 1) & 7)) << 2)


def test_fragment_rows_read_their_taps_input_pixels():
    """wgmma's m64 fragment: warp w, lane (g, t) holds rows 16 w + g and
    16 w + g + 8, i.e. tile pixels (2 w, g) and (2 w + 1, g); for tap (p, q)
    the kernel reads staged pixel 4 w 17 + 2 g + (2 h + p) 17 + q, which is
    input pixel (2 oy + p, 2 ox + q) of the tile."""
    for warp in range(4):
        for g in range(8):
            for h in range(2):
                row = 16 * warp + g + 8 * h
                oy, ox = row // 8, row % 8
                assert (oy, ox) == (2 * warp + h, g)
                for p in range(3):
                    for q in range(3):
                        pix = 4 * warp * K_IN + 2 * g + (2 * h + p) * K_IN + q
                        assert divmod(pix, K_IN) == (2 * oy + p, 2 * ox + q)


def test_staged_tile_swizzle_is_a_bijection_free_of_bank_conflicts():
    offs = {_tile_at(p, ch) + e for p in range(K_IN * K_IN) for ch in range(8)
            for e in range(4)}
    assert offs == set(range(K_IN * K_IN * 32))
    # one fragment load: lanes (g, t) of a warp read channel 8 kk + 4 j + t of
    # staged pixels base + 2 g; the 32 lanes hit 32 different banks
    for base in range(K_IN * K_IN - 15):
        for chunk in range(8):
            banks = {(_tile_at(base + 2 * g, chunk) + t) % 32
                     for g in range(8) for t in range(4)}
            assert len(banks) == 32


def test_tiles_cover_every_output_pixel_once():
    for h2, w2 in ((32, 256), (17, 49), (2, 2)):
        tiles = fc._tiles(h2, w2, fc._TILE1)
        tiles_x = -(-w2 // fc._TILE1[1])
        hit = np.zeros((h2, w2), int)
        for tin in range(tiles):
            ty, tx = divmod(tin, tiles_x)
            for row in range(64):
                oy, ox = ty * 8 + row // 8, tx * 8 + row % 8
                if oy < h2 and ox < w2:
                    hit[oy, ox] += 1
        assert (hit == 1).all()


def _image_sum(rows):
    """conv0's ``image_sum``: the rows in tile order into eight interleaved
    fp32 sums, added in a fixed tree."""
    s = [np.float32(0)] * 8
    for k in range(0, len(rows), 8):
        for j in range(8):
            if k + j < len(rows):
                s[j] = np.float32(s[j] + rows[k + j])
    return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]))


def _seg_start(w, n, workers):
    return w * n // workers


def _worker_of(i, n, workers):
    return ((i + 1) * workers - 1) // n


@pytest.mark.parametrize("n_tiles,workers", [(4096, 264), (48, 48), (9, 4),
                                             (130, 97)])
def test_contiguous_split_and_segment_counts(n_tiles, workers):
    """conv1's warpgroups own contiguous tile ranges; the ticket of an image
    waits for one segment per worker that meets it."""
    owner = np.empty(n_tiles, int)
    for w in range(workers):
        a, b = _seg_start(w, n_tiles, workers), _seg_start(w + 1, n_tiles, workers)
        assert b > a                              # workers <= tiles: none idle
        owner[a:b] = w
    assert (owner == [_worker_of(i, n_tiles, workers)
                      for i in range(n_tiles)]).all()
    for tiles in (1, 3, 16):
        for img in range(n_tiles // tiles):
            lo, hi = img * tiles, (img + 1) * tiles
            segs = len(set(owner[lo:hi]))
            assert segs == (_worker_of(hi - 1, n_tiles, workers)
                            - _worker_of(lo, n_tiles, workers) + 1)


def _tiled(y1):
    b, h2, w2, f = y1.shape
    t = y1.reshape(b, h2 // 8, 8, w2 // 8, 8, f).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, -1, 64, f).numpy()


@pytest.mark.parametrize("workers", [None, 5, 48])
def test_statistics_in_the_kernels_order_hold_the_variance_tolerance(workers):
    """``None``: conv0's order (a row per tile, eight interleaved sums);
    else conv1's (a row per worker's run of tiles in one image, the rows in
    worker order)."""
    y0, scale, shift, w1, b1 = _inputs(b=2, h=64, w=96, seed=2)
    y1 = fc.conv1_norm_stats_plain(y0, scale, shift, w1, b1)[0]
    b, h2, w2, f = y1.shape
    tiles = _tiled(y1)
    per_img = tiles.shape[1]
    rows = np.stack([tiles.sum(axis=2, dtype=np.float32),
                     (tiles ** 2).sum(axis=2, dtype=np.float32)])
    if workers is None:
        s, ss = (np.array([[_image_sum(r[i, :, c]) for c in range(f)]
                           for i in range(b)], np.float32) for r in rows)
    else:
        n = b * per_img
        flat = rows.reshape(2, n, f)
        out = np.zeros((2, b, f), np.float32)
        for img in range(b):
            for w in range(_worker_of(img * per_img, n, workers),
                           _worker_of((img + 1) * per_img - 1, n, workers) + 1):
                lo = max(_seg_start(w, n, workers), img * per_img)
                hi = min(_seg_start(w + 1, n, workers), (img + 1) * per_img)
                out[:, img] += flat[:, lo:hi].sum(axis=1, dtype=np.float32)
        s, ss = out
    mean, var = fc._finalize(torch.from_numpy(s)[:, None],
                             torch.from_numpy(ss)[:, None], b * h2 * w2)
    pm, pv = _batch_stats(y1)
    torch.testing.assert_close(mean, pm, rtol=0, atol=1e-5)
    torch.testing.assert_close(var, pv, rtol=1e-4, atol=1e-6)
