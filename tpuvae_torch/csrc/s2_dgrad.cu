// Stride-2 3 x 3 transposed convolution of the conv trunks in the port's
// SAME convention, for the narrow layers: the float32 decoder's layers 3 and
// 4 (forward) and the data gradients of encoder layers 1 (kernel 6's conv1)
// and 2, which are the same map:
//   out[b, f, 2m + pr, 2n + ps] = bias[f] + sum_{c, (p, q)} in[b, c, m', n']
//                                 * w[c, f, p, q],
// over the taps (p, q) that reach output phase (pr, ps) from input (m', n'):
// p = 1 for an odd row (m' = m), p in {0, 2} for an even one (m' = m, m - 1);
// likewise q and the columns.  in (B, C, h, w), out (B, F, 2h, 2w) written
// dense (no (2h + 1) x (2w + 1) result to cut), w (C, F, 3, 3) at any
// strides (conv_transpose2d's layout, which is also a stride-2
// convolution's (F_out, C_in, 3, 3) weight read as a transposed one).
//
// Replaces no Pallas kernel: the JAX package leaves these convolutions to
// XLA.  It was written because cuDNN 9's only float32 (TF32 off) engine for
// them, the legacy stride-2 `dgrad_engine`, runs the narrow calls at 10-18
// TFLOP/s and took ~25% of a Hybrid epoch's device time.  Bound at batch 32
// (64 -> 32 channels at 32 x 256 -> 64 x 512): 201 MB moved (0.060 ms at
// 3.35 TB/s) and 9.66 GFLOP, which as three TF32 products on the tensor
// cores (495 TFLOP/s) is 0.059 ms: bytes and operations alike.
//
// Design (sm_90a):
// * Phase split.  An input position (m, n) feeds the four outputs (2m + pr,
//   2n + ps) through 9 taps that read only four shifted inputs: (m, n) for
//   taps (0|1, 0|1), (m - 1, n) for (2, 0|1), (m, n - 1) for (0|1, 2) and
//   (m - 1, n - 1) for (2, 2).  So a warpgroup loads and splits each shift's
//   A fragment once and runs the taps that share it (4, 2, 2, 1) into the
//   accumulators of their four phases: an implicit GEMM with M = 64 input
//   positions (an 8 x 8 tile, one wgmma m64 tile), N = a slice of F, K = 32
//   channels a block.
// * fp32 accuracy: THREE TF32 products (x = hi + lo, hi = tf32(x), lo =
//   tf32(x - hi): lo*hi + hi*lo + hi*hi drops only lo*lo), as kernel 6's
//   conv1 does; TF32 stays off for every library call.
// * The tensor cores' fp32 accumulator truncates.  Each tap's twelve
//   products of one 32-channel block (4 k-steps x 3) build a partial sum
//   whose first product overwrites it; the CUDA cores add it, rounded to
//   nearest, into the phase's fp32 running sum.
// * Weights resident.  A CTA keeps its slice of w (all nine taps, every
//   channel, NS output channels) split into hi and lo in shared memory, 144
//   KB, K-major in the 128-byte-swizzled layout wgmma's descriptors name.
//   The slice is as wide as that room allows: NS = 32 up to 64 channels, 16
//   up to 128; F / NS CTAs (slices) share each tile, so the 128 -> 64 calls
//   read their input four times, from L2, and each CTA its weights once.
// * Persistent CTAs of two warpgroups, three for the 16-channel slices
//   (their products are half as long, so a third warpgroup's loads and
//   splits fill the gaps; 155-160 registers fit three); warpgroup w of
//   slice s walks tiles w, w + W, ... so that the slices of a tile run at
//   about the same time.
//   Each warpgroup streams its tiles' 32-channel blocks through two buffers
//   with cp.async: block i + 1 loads while block i multiplies.  The input is
//   staged as it lies (NCHW rows of a channel, or channels-last pixel
//   vectors) and transposed into K-major A fragments on the way to the
//   registers; the K order within a block is permuted so that a thread's
//   eight channels are adjacent (two 16-byte loads from a channels-last
//   tile).  The next shift's fragments load while the current products
//   run.  (Two groups of products in flight, their partial sums alternating
//   between two register sets, measured slower: ptxas serialised the
//   `wgmma`s around the group carried from one block into the next, and
//   without the carry it gained nothing.)
// * Stores from registers: a thread holds both column phases of its output
//   row, so NCHW stores are 8-byte pairs that make whole 64-byte row
//   segments, channels-last stores 8 bytes of a pixel's channel vector.
// * No atomics: two calls give the same bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 8;                    // an 8 x 8 tile of input positions
constexpr int kHalo = kT + 1;            // staged rows (and NHWC columns)
constexpr int kKb = 32;                  // channels a K block
// warpgroups a CTA: three where the slice is 16 channels (fewer registers)
template <int NS>
__host__ __device__ constexpr int warp_groups() { return NS == 16 ? 3 : 2; }
constexpr int kWBytes = 9 * 2 * 64 * 128;   // 9 taps x (hi, lo) x KB*NS = 64 rows
// NHWC stage: 9 x 9 positions x 128 bytes (a block's 32 channels)
constexpr int kStageNhwc = kHalo * kHalo * kKb * 4;
// NCHW stage: per channel 9 rows x 12 columns (n0 - 4 .. n0 + 7) at a
// channel stride of 108 floats, channel c offset by 8 ((c / 8) % 4) floats
// so that the four channel groups a warp reads fall in different banks
constexpr int kColsNchw = 12;
constexpr int kChanStride = 108;
constexpr int kStageNchw = (kKb * kChanStride + 24) * 4;
constexpr int kSmemBytes(bool nhwc, int wgs) {
  return 1024 + kWBytes + 2 * wgs * (nhwc ? kStageNhwc : kStageNchw);
}

static_assert(kSmemBytes(false, 3) <= 232448, "one CTA's shared memory");
static_assert(kStageNchw % 16 == 0 && kStageNhwc % 16 == 0, "16-byte stages");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// K-major operand tile in the 128-byte-swizzled layout: rows of 128 bytes,
// groups of 8 rows 1024 bytes apart, chunk c of row r stored at c ^ (r % 8)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// d (64 x NS fp32 fragment) = a (64 x 8 TF32, registers) x b (8 x NS TF32,
// K-major in shared memory) + (keep ? d : 0)
template <int NS>
__device__ __forceinline__ void wgmma(float (&d)[NS / 2], const uint32_t (&a)[4],
                                      uint64_t desc_b, int keep);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t desc_b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc_b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

// Channel of K position k (0..7) in k-step kk (0..3) of a block: a thread
// (fragment column t) reads k = t and t + 4 of every step, which are
// channels 8 t + 2 kk and 8 t + 2 kk + 1: its eight channels are adjacent.
__host__ __device__ constexpr int k_channel(int kk, int k) {
  return 8 * (k & 3) + 2 * kk + (k >> 2);
}

// NCHW stage: offset (floats) of channel c's (row, column) element
__device__ __forceinline__ int nchw_at(int c, int row, int col) {
  return c * kChanStride + ((c >> 3) & 3) * 8 + row * kColsNchw + col;
}

// NHWC stage: offset (floats) of 16-byte chunk j of staged position pos
__device__ __forceinline__ int nhwc_at(int pos, int j) {
  return pos * kKb + ((j ^ (pos & 7)) << 2);
}

struct Geometry {
  const float* x;
  long long sb, sc, sh, sw;              // x's strides, in floats
  int channels, height, width, kblocks, tiles_x, tiles_per_image;
};

// Stage 32-channel block kb of tile `tile` (this warpgroup's 128 threads):
// input rows m0 - 1 .. m0 + 7, columns n0 - 1 .. n0 + 7, zero outside the
// image and past the last channel.
template <bool kNhwc>
__device__ __forceinline__ void stage(const Geometry& g, uint32_t buf, int tile,
                                      int kb, int wtid) {
  const int b = tile / g.tiles_per_image;
  const int tin = tile - b * g.tiles_per_image;
  const int ty = tin / g.tiles_x;
  const int m0 = ty * kT;
  const int n0 = (tin - ty * g.tiles_x) * kT;
  const float* xb = g.x + b * g.sb;
  if (kNhwc) {
    for (int e = wtid; e < kHalo * kHalo * 8; e += 128) {
      const int pos = e >> 3;
      const int j = e & 7;
      const int r = pos / kHalo;
      const int gm = m0 - 1 + r;
      const int gn = n0 - 1 + pos - r * kHalo;
      const int c0 = kb * kKb + 4 * j;
      int bytes = 0;
      const float* src = g.x;
      if (gm >= 0 && gm < g.height && gn >= 0 && gn < g.width &&
          c0 < g.channels) {
        bytes = min(g.channels - c0, 4) * 4;
        src = xb + gm * g.sh + gn * g.sw + c0;
      }
      cp_async16(buf + nhwc_at(pos, j) * 4, src, bytes);
    }
  } else {
    for (int e = wtid; e < kKb * kHalo * 3; e += 128) {
      const int c = e / (kHalo * 3);
      const int rem = e - c * (kHalo * 3);
      const int r = rem / 3;
      const int j = rem - r * 3;
      const int gm = m0 - 1 + r;
      const int col0 = n0 - 4 + 4 * j;
      const int gc = kb * kKb + c;
      int bytes = 0;
      const float* src = g.x;
      if (gm >= 0 && gm < g.height && col0 >= 0 && col0 < g.width &&
          gc < g.channels) {
        bytes = min(g.width - col0, 4) * 4;
        src = xb + gc * g.sc + gm * g.sh + col0;
      }
      cp_async16(buf + nchw_at(c, r, 4 * j) * 4, src, bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A fragments of shift (SR, SC) from a staged block, split into hi and lo:
// a[kk][h + 2 e] is K position t + 4 e of step kk at fragment row g + 8 h,
// i.e. tile position (2 warp + h + SR, g + SC).
template <bool kNhwc, int SR, int SC>
__device__ __forceinline__ void load_a(const float* buf, int warp, int g,
                                       int t, uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 2 * warp + h + 1 + SR;
    float v[8];
    if (kNhwc) {
      const int pos = row * kHalo + g + 1 + SC;
      const float4 u = *reinterpret_cast<const float4*>(buf + nhwc_at(pos, 2 * t));
      const float4 w = *reinterpret_cast<const float4*>(buf + nhwc_at(pos, 2 * t + 1));
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = buf[nchw_at(8 * t + j, row, g + 4 + SC)];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = v[2 * kk + e];
        const uint32_t xh = to_tf32(x);
        hi[kk][h + 2 * e] = xh;
        lo[kk][h + 2 * e] = to_tf32(x - __uint_as_float(xh));
      }
  }
}

// one tap's twelve products (small terms first; the first overwrites d)
template <int NS>
__device__ __forceinline__ void tap_products(float (&d)[NS / 2],
                                             const uint32_t (&hi)[4][4],
                                             const uint32_t (&lo)[4][4],
                                             uint32_t b_hi) {
  constexpr uint32_t kLo = NS * 128;   // the lo half follows the hi half
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<NS>(d, lo[kk], smem_desc(b_hi + kk * 32), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<NS>(d, hi[kk], smem_desc(b_hi + kLo + kk * 32), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<NS>(d, hi[kk], smem_desc(b_hi + kk * 32), 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void add_into(float (&run)[N], const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) run[i] = __fadd_rn(run[i], part[i]);
}

template <int NS, bool kNhwc>
__global__ void __launch_bounds__(128 * warp_groups<NS>(), 1)
s2_dgrad_kernel(Geometry geo, const float* __restrict__ w, long long swc,
                long long swf, long long swp, long long swq, int features,
                const float* __restrict__ bias, float* __restrict__ out,
                int n_tiles) {
  constexpr int kStage = kNhwc ? kStageNhwc : kStageNchw;
  constexpr int kRows = NS * 128;       // one tap-block's hi (or lo) bytes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t wts = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int slices = features / NS;
  const int slice = blockIdx.x % slices;
  const int kblocks = geo.kblocks;

  // this CTA's slice of the weights: tap-block (tap, kb) holds hi then lo,
  // rows f (NS), K-major, K position (kk, k) at byte 32 kk + 4 k
  constexpr int kWarpGroups = warp_groups<NS>();
  for (int e = tid; e < 9 * kblocks * 8 * NS; e += 128 * kWarpGroups) {
    const int f = e % NS;
    const int j = (e / NS) & 7;
    const int tb = e / (NS * 8);          // tap * kblocks + kb
    const int tap = tb / kblocks;
    const int kb = tb - tap * kblocks;
    const float* src = w + (slice * NS + f) * swf + (tap / 3) * swp +
                       (tap % 3) * swq;
    float hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = kb * kKb + k_channel(j >> 1, 4 * (j & 1) + i);
      const float v = c < geo.channels ? src[c * swc] : 0.f;
      hi[i] = __uint_as_float(to_tf32(v));
      lo[i] = __uint_as_float(to_tf32(v - hi[i]));
    }
    unsigned char* dst = smem + tb * 2 * kRows + f * 128 + ((j ^ (f & 7)) << 4);
    *reinterpret_cast<float4*>(dst) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(dst + kRows) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int workers = gridDim.x / slices * kWarpGroups;
  const int wid = blockIdx.x / slices * kWarpGroups + wg;
  if (wid >= n_tiles) return;
  const int my_tiles = (n_tiles - 1 - wid) / workers + 1;
  const int steps = my_tiles * kblocks;
  unsigned char* bufs = smem + kWBytes + wg * 2 * kStage;
  const uint32_t buf_s = smem_u32(bufs);

  const int g = lane >> 2;
  const int t = lane & 3;
  float bias_v[NS / 4];                 // channels 8 i + 2 t + e of the slice
#pragma unroll
  for (int i = 0; i < NS / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias_v[2 * i + e] = bias ? bias[slice * NS + 8 * i + 2 * t + e] : 0.f;

  // run[phase 2 pr + ps]: the phase's running sums; part: a tap's block
  float run[4][NS / 2], part[4][NS / 2];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) run[p][i] = 0.f;
  uint32_t ahi[2][4][4], alo[2][4][4];

  stage<kNhwc>(geo, buf_s, wid, 0, wtid);
  for (int s = 0; s < steps; ++s) {
    const int k = s / kblocks;
    const int kb = s - k * kblocks;
    const int tile = wid + k * workers;
    if (s + 1 < steps) {
      const int k1 = (s + 1) / kblocks;
      stage<kNhwc>(geo, buf_s + ((s + 1) & 1) * kStage, wid + k1 * workers,
                   (s + 1) - k1 * kblocks, wtid);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    wg_sync(wg);
    const float* buf = reinterpret_cast<const float*>(bufs + (s & 1) * kStage);
    // tap-block (tap, kb)'s hi rows
    auto b_at = [&](int tap) {
      return wts + (tap * kblocks + kb) * 2 * kRows;
    };

    // shift (0, 0): taps (0, 0), (0, 1), (1, 0), (1, 1) -> phases 0..3
    load_a<kNhwc, 0, 0>(buf, warp, g, t, ahi[0], alo[0]);
    wgmma_fence();
    tap_products<NS>(part[0], ahi[0], alo[0], b_at(0));
    tap_products<NS>(part[1], ahi[0], alo[0], b_at(1));
    tap_products<NS>(part[2], ahi[0], alo[0], b_at(3));
    tap_products<NS>(part[3], ahi[0], alo[0], b_at(4));
    wgmma_commit();
    // shift (-1, 0): taps (2, 0), (2, 1) -> phases 0, 1
    load_a<kNhwc, -1, 0>(buf, warp, g, t, ahi[1], alo[1]);
    wgmma_wait();
#pragma unroll
    for (int p = 0; p < 4; ++p) add_into(run[p], part[p]);
    wgmma_fence();
    tap_products<NS>(part[0], ahi[1], alo[1], b_at(6));
    tap_products<NS>(part[1], ahi[1], alo[1], b_at(7));
    wgmma_commit();
    // shift (0, -1): taps (0, 2), (1, 2) -> phases 0, 2
    load_a<kNhwc, 0, -1>(buf, warp, g, t, ahi[0], alo[0]);
    wgmma_wait();
    add_into(run[0], part[0]);
    add_into(run[1], part[1]);
    wgmma_fence();
    tap_products<NS>(part[0], ahi[0], alo[0], b_at(2));
    tap_products<NS>(part[2], ahi[0], alo[0], b_at(5));
    wgmma_commit();
    // shift (-1, -1): tap (2, 2) -> phase 0
    load_a<kNhwc, -1, -1>(buf, warp, g, t, ahi[1], alo[1]);
    wgmma_wait();
    add_into(run[0], part[0]);
    add_into(run[2], part[2]);
    wgmma_fence();
    tap_products<NS>(part[0], ahi[1], alo[1], b_at(8));
    wgmma_commit();
    wgmma_wait();
    add_into(run[0], part[0]);
    // every thread is done with this buffer before it is staged again
    wg_sync(wg);
    if (kb + 1 < kblocks) continue;

    // Epilogue.  run[p][4 i + 2 h + e] is channel 8 i + 2 t + e of the
    // slice at tile position (2 warp + h, g), phase p = 2 pr + ps.
    const int b = tile / geo.tiles_per_image;
    const int tin = tile - b * geo.tiles_per_image;
    const int ty = tin / geo.tiles_x;
    const int n = (tin - ty * geo.tiles_x) * kT + g;
    const int oh = 2 * geo.height, ow = 2 * geo.width;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = ty * kT + 2 * warp + h;
      if (m < geo.height && n < geo.width) {
#pragma unroll
        for (int i = 0; i < NS / 8; ++i)
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int r = 2 * m + pr;
            if (kNhwc) {
#pragma unroll
              for (int ps = 0; ps < 2; ++ps) {
                const int p = 2 * pr + ps;
                float* dst = out + ((static_cast<size_t>(b) * oh + r) * ow +
                                    2 * n + ps) * features +
                             slice * NS + 8 * i + 2 * t;
                *reinterpret_cast<float2*>(dst) = make_float2(
                    __fadd_rn(run[p][4 * i + 2 * h], bias_v[2 * i]),
                    __fadd_rn(run[p][4 * i + 2 * h + 1], bias_v[2 * i + 1]));
              }
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int f = slice * NS + 8 * i + 2 * t + e;
                float* dst = out + ((static_cast<size_t>(b) * features + f) * oh +
                                    r) * ow + 2 * n;
                *reinterpret_cast<float2*>(dst) = make_float2(
                    __fadd_rn(run[2 * pr][4 * i + 2 * h + e], bias_v[2 * i + e]),
                    __fadd_rn(run[2 * pr + 1][4 * i + 2 * h + e], bias_v[2 * i + e]));
              }
            }
          }
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) run[p][i] = 0.f;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int NS, bool kNhwc>
int launch(const Geometry& geo, const float* w, long long swc, long long swf,
           long long swp, long long swq, int features, const float* bias,
           float* out, int n_tiles, cudaStream_t stream) {
  auto kernel = s2_dgrad_kernel<NS, kNhwc>;
  constexpr int kWarpGroups = warp_groups<NS>();
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes(kNhwc, kWarpGroups));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int sms = sm_count();
  const int slices = features / NS;
  if (sms < slices) return static_cast<int>(cudaErrorInvalidDevice);
  const long long want =
      static_cast<long long>(slices) * ((n_tiles + kWarpGroups - 1) / kWarpGroups);
  const int full = sms / slices * slices;
  const int grid = static_cast<int>(want < full ? want : full);
  kernel<<<grid, 128 * kWarpGroups, kSmemBytes(kNhwc, kWarpGroups), stream>>>(
      geo, w, swc, swf, swp, swq, features, bias, out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, C, H, W) at element strides (sb, sc, sh, sw): channels-last
// (nhwc = 1: sc = 1) or NCHW (nhwc = 0: sw = 1), every other stride and x
// itself 16-byte aligned; w (C, F, 3, 3) at strides (swc, swf, swp, swq);
// bias (F) or null -> out (B, F, 2H, 2W), dense, channels-last when nhwc
// (memory (B, 2H, 2W, F)), NCHW otherwise.  C <= 128, F in {32, 64}.
extern "C" int tpuvae_s2_dgrad(const void* x, int batch, int channels,
                               int height, int width, long long sb,
                               long long sc, long long sh, long long sw,
                               int nhwc, const void* w, int features,
                               long long swc, long long swf, long long swp,
                               long long swq, const void* bias, void* out,
                               void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (channels <= 0 || channels > 128 || (features != 32 && features != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long inner = nhwc ? sc : sw;
  if (inner != 1 || sb % 4 || sh % 4 || (nhwc ? sw % 4 : sc % 4) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (width + kT - 1) / kT;
  const long long per_image =
      static_cast<long long>((height + kT - 1) / kT) * tiles_x;
  if (per_image * batch > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo{static_cast<const float*>(x), sb, sc, sh, sw, channels, height,
               width, (channels + kKb - 1) / kKb, tiles_x,
               static_cast<int>(per_image)};
  const int n_tiles = static_cast<int>(per_image * batch);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (channels <= 64)
    return nhwc ? launch<32, true>(geo, wp, swc, swf, swp, swq, features, bp,
                                   op, n_tiles, st)
                : launch<32, false>(geo, wp, swc, swf, swp, swq, features, bp,
                                    op, n_tiles, st);
  return nhwc ? launch<16, true>(geo, wp, swc, swf, swp, swq, features, bp, op,
                                 n_tiles, st)
              : launch<16, false>(geo, wp, swc, swf, swp, swq, features, bp,
                                  op, n_tiles, st);
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
