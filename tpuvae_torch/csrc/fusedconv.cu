// Fused conv + BatchNorm-statistics pair for the conv trunk's first two
// layers (kernel 6).
//
// Replaces the Pallas kernels tpuvae/ops/fusedconv.py:67 (_conv0_kernel)
// and :88 (_conv1_kernel), launched by _fused_pair (:116):
//   conv0: y0[b,i,j,f] = b0[f] + sum_{p,q} x[b,2i+p,2j+q] w0[p,q,f]
//   conv1: z = leaky_relu(y0 * scale + shift, 0.01), zero outside the image,
//          y1[b,i,j,f] = b1[f] + sum_{p,q,c} z[b,2i+p,2j+q,c] w1[p,q,c,f]
// both 3 x 3, stride 2, SAME on even dims (pads (0, 1): the halo is at the
// high edge only), NHWC, fp32.  Each also returns the per-image sum and
// sum of squares of its RAW output per channel, so that BatchNorm's batch
// statistics cost no further pass; y0 is written once and normalised on
// load, the normalised activation never exists in device memory.  Two
// kernels, as on the TPU: all of y0's statistics must exist before any of
// y0 is normalised.
//
// Bounds on the H100 at 32 x 128 x 1024: conv0 by bytes (16.8 MB read,
// 134.2 MB written, 0.045 ms at 3.35 TB/s; 0.6 GFLOP).  conv1 moves 201 MB
// (0.060 ms) and does 9.66 GFLOP: 0.144 ms on the CUDA cores' 67 TFLOP/s,
// but as three TF32 products on the tensor cores (495 TFLOP/s) 0.059 ms,
// so on them it is bound by bytes and operations alike.
//
// conv0: one 256-thread CTA per 8 x 32 output pixels (4,096 CTAs at the
// main shape).  The 17 x 65 input tile is staged in shared memory,
// zero-filled past the image, which is also the SAME padding.  A thread
// owns 4 channels and keeps their 36 weights in registers; the 8 lanes of a
// pixel store 128 contiguous bytes, a warp 4 neighbouring pixels.
//
// conv1 is an implicit GEMM on the tensor cores: M = the output pixels,
// N = 64 channels, K = 9 taps x 32 channels, one tap per 32-channel K
// block.  One TF32 product keeps ~10 mantissa bits; THREE keep fp32's
// accuracy (x = hi + lo, hi = tf32(x), lo = tf32(x - hi): lo*hi + hi*lo +
// hi*hi drops only lo*lo, 2^-22 of the product), as the Pallas body's
// dots at Precision.HIGHEST do.
// * Persistent CTAs, one per SM, of two warpgroups.  The CTA splits all
//   3 x 3 x 32 x 64 weights into hi and lo ONCE and keeps them in shared
//   memory (144 KB), K-major (wgmma takes TF32 operands K-major only) in
//   the 128-byte-swizzled layout its descriptors name: one tap's 64 x 32
//   block is one 8 KB swizzle tile.  Each warpgroup then walks a
//   contiguous range of 8 x 8-pixel output tiles (64 rows of wgmma
//   m64n64k8).
// * A warpgroup copies its tile's 17 x 17 x 32 raw y0 input (37 KB) with
//   cp.async into its own buffer, zero past the image, and normalises it
//   in place (affine + LeakyReLU, the padding stays zero AFTER the affine).
//   A pixel's 8 16-byte chunks are stored XOR-swizzled by the pixel index,
//   so that the A-fragment reads of a stride-2 tap (8 pixels 256 bytes
//   apart) hit 32 different banks.  A is split into hi and lo in registers
//   and fed to wgmma from registers.  While one warpgroup loads or
//   finishes a tile, the other keeps the tensor cores busy.
// * The tensor cores' fp32 accumulator truncates (kernel 4 lost 4e-5 of
//   its maximum to one long sum).  Each tap's twelve products (4 k-steps x
//   3) build a partial sum whose first product overwrites it; the CUDA
//   cores add it, rounded to nearest, into the fp32 running sums.  Never
//   all 108 products in one accumulator.
// * The epilogue adds the bias, stores y1 (each lane 8 bytes of a pixel's
//   256) and adds the values and their squares into per-thread sums that
//   run over the warpgroup's tiles of one image.  Only where that run (a
//   segment) ends are they reduced: a reduce-scatter over the 8 lanes of a
//   column group (28 shuffles for 32 values), then the 4 warps in order
//   through shared memory, into one partial row per segment.  That keeps
//   the reduction, a fence and a ticket off every tile's critical path:
//   with only two warpgroups on an SM, per-tile publishing left the tensor
//   cores idle longer than the products kept them busy.
//
// Statistics of both kernels: partial rows in global memory (conv0: one
// per CTA; conv1: one per segment, at the row of its first tile), then the
// last CTA (conv1: segment) to finish an image -- an integer ticket, taken
// after a fence -- adds that image's partial rows in a fixed order (conv0:
// tile order, eight interleaved sums; conv1: worker order) into its (sum,
// sum of squares).  No float atomics: two runs on one card give the same
// bits.  The last one also sets its ticket back to 0, so the wrapper's
// ticket buffer needs no clearing launch.  The image reducer that
// finishes the batch (a second ticket, tickets[B]) then finalises
// BatchNorm's batch statistics: it adds the per-image sums one image after
// another, in image order, and takes mean = S / n, var = max(SS / n -
// mean^2, 0) as ops/fusedconv.py's _finalize does.  _finalize adds the
// images in PyTorch's own reduction order, so the two agree within the
// variance tolerance, not bit for bit.  conv0 folds the statistics with
// gamma / beta into the scale and shift that conv1 applies: the pair's
// forward is two launches, not two and twenty small reductions.
//
// A line of conv1 marked `// ablate: NAME` is one that tools/kernel_ab.py
// --ablate replaces to time the kernel without that part of its work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kSlope = 0.01f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// sum over the tiles of image b, in tile order: 8 interleaved partial sums
// added in a fixed tree.  src points at the image's first partial row's
// entry for this thread, rows `stride` floats apart.
__device__ __forceinline__ float image_sum(const float* src, int tiles,
                                           int stride) {
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < tiles; k += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (k + j < tiles) s[j] += __ldcg(src + static_cast<size_t>(k + j) * stride);
    }
  }
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// BatchNorm's batch statistics of channel `ch` from the per-image sums
// `sums` (2, B, F), the images added one after another: mean = S / n,
// var = max(SS / n - mean^2, 0), no contraction into FMAs; with kFold, the
// fold of _fold: scale = gamma / sqrt(var + eps), shift = beta - mean *
// scale.  stats: (2, F) mean, var, then (kFold) (2, F) scale, shift, then
// (F) the unclamped SS / n - mean^2, whose sign is the clamp's gradient
// mask in the backward.
template <bool kFold>
__device__ __forceinline__ void finalize_channel(
    const float* sums, int batch, int features, int ch, float n,
    const float* gamma, const float* beta, float eps, float* stats) {
  float s = 0.f, ss = 0.f;
  for (int b = 0; b < batch; ++b) {
    s = __fadd_rn(s, __ldcg(sums + static_cast<size_t>(b) * features + ch));
    ss = __fadd_rn(ss, __ldcg(sums + (static_cast<size_t>(batch) + b) *
                                        features + ch));
  }
  const float mean = __fdiv_rn(s, n);
  const float raw = __fsub_rn(__fdiv_rn(ss, n), __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;
  stats[ch] = mean;
  stats[features + ch] = var;
  stats[(kFold ? 4 : 2) * features + ch] = raw;
  if (kFold) {
    const float scale = __fmul_rn(gamma[ch], rsqrtf(__fadd_rn(var, eps)));
    stats[2 * features + ch] = scale;
    stats[3 * features + ch] = __fsub_rn(beta[ch], __fmul_rn(mean, scale));
  }
}

// ---- conv0 -----------------------------------------------------------------
constexpr int kF0 = 32;              // output channels
constexpr int kT0H = 8;              // output rows per CTA (one per warp)
constexpr int kT0W = 32;             // output columns per CTA
constexpr int kIn0H = 2 * kT0H + 1;
constexpr int kIn0W = 2 * kT0W + 1;
constexpr int kThreads0 = 256;
constexpr int kWarps0 = kThreads0 / 32;

static_assert(kWarps0 == kT0H, "one warp per output row");

__global__ void __launch_bounds__(kThreads0)
conv0_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, int height, int width,
             float* __restrict__ y, float* __restrict__ part,
             float* __restrict__ sums, int* __restrict__ tickets,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             float eps, float* __restrict__ stats) {
  __shared__ float xs[kIn0H][kIn0W + 1];
  __shared__ float red[2][kWarps0][kF0];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cg = lane % 8;           // channels 4 cg .. 4 cg + 3
  const int pl = lane / 8;           // pixel within a group of 4
  const int h2 = height / 2;
  const int w2 = width / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kT0H;
  const int c0 = blockIdx.x * kT0W;

  const float* xb = x + static_cast<size_t>(b) * height * width;
  for (int e = tid; e < kIn0H * kIn0W; e += kThreads0) {
    const int r = e / kIn0W;
    const int c = e % kIn0W;
    const int gr = 2 * r0 + r;
    const int gc = 2 * c0 + c;
    xs[r][c] = (gr < height && gc < width)
                   ? xb[static_cast<size_t>(gr) * width + gc] : 0.f;
  }
  float wr[9][4];
  float bs[4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) wr[t][k] = w[t * kF0 + cg * 4 + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) bs[k] = bias[cg * 4 + k];
  __syncthreads();

  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float ss[4] = {0.f, 0.f, 0.f, 0.f};
  const int orow = r0 + warp;
  for (int it = 0; it < kT0W / 4; ++it) {
    const int pc = it * 4 + pl;
    const int ocol = c0 + pc;
    float acc[4] = {bs[0], bs[1], bs[2], bs[3]};
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float v = xs[2 * warp + p][2 * pc + q];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(v, wr[p * 3 + q][k], acc[k]);
      }
    if (orow < h2 && ocol < w2) {
      float* dst = y + ((static_cast<size_t>(b) * h2 + orow) * w2 + ocol) * kF0
                   + cg * 4;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k] += acc[k];
        ss[k] = fmaf(acc[k], acc[k], ss[k]);
      }
    }
  }
  // the 4 pixel lanes of a channel group, then the 8 warps, in fixed order
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] += __shfl_xor_sync(0xffffffffu, s[k], 8);
    s[k] += __shfl_xor_sync(0xffffffffu, s[k], 16);
    ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], 8);
    ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], 16);
  }
  if (pl == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      red[0][warp][cg * 4 + k] = s[k];
      red[1][warp][cg * 4 + k] = ss[k];
    }
  }
  __syncthreads();
  const int tiles = gridDim.x * gridDim.y;
  if (tid < 2 * kF0) {
    const int which = tid / kF0;
    const int ch = tid % kF0;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps0; ++i) t += red[which][i][ch];
    const size_t tile = static_cast<size_t>(b) * tiles +
                        blockIdx.y * gridDim.x + blockIdx.x;
    part[(tile * 2 + which) * kF0 + ch] = t;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + b, 1) == tiles - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    if (tid < 2 * kF0) {
      const int which = tid / kF0;
      const int ch = tid % kF0;
      sums[(static_cast<size_t>(which) * gridDim.z + b) * kF0 + ch] =
          image_sum(part + (static_cast<size_t>(b) * tiles * 2 + which) * kF0
                        + ch, tiles, 2 * kF0);
      __threadfence();
    }
    if (tid == 0) tickets[b] = 0;
    const int batch = gridDim.z;
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + batch, 1) == batch - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      if (tid < kF0) {
        finalize_channel<true>(sums, batch, kF0, tid,
                               static_cast<float>(static_cast<long long>(batch) *
                                                  (height / 2) * (width / 2)),
                               gamma, beta, eps, stats);
      }
      if (tid == 0) tickets[batch] = 0;
    }
  }
}

// ---- conv1 -----------------------------------------------------------------
constexpr int kC = 32;               // input channels
constexpr int kF = 64;               // output channels
constexpr int kT1 = 8;               // output tile: 8 x 8 pixels, one m64 tile
constexpr int kIn1 = 2 * kT1 + 1;    // 17 x 17 input pixels
constexpr int kInPix = kIn1 * kIn1;
constexpr int kTileBytes = kInPix * kC * 4;       // 36,992
constexpr int kTapBytes = kF * kC * 4;            // one tap, hi or lo: 8 KB
constexpr int kWBytes = 9 * 2 * kTapBytes;        // 147,456
constexpr int kWarpGroups = 2;
constexpr int kThreads1 = 128 * kWarpGroups;
constexpr int kRedFloats = 4 * 2 * kF;            // a warpgroup's 4 warps
constexpr int kSmem1Bytes = 1024 + kWBytes +
                            kWarpGroups * (kTileBytes + kRedFloats * 4) + 16;

static_assert(kTapBytes % 1024 == 0, "swizzled tiles on 1024-byte boundaries");
static_assert(kTileBytes % 16 == 0, "16-byte cp.async chunks");
static_assert(kSmem1Bytes <= 232448, "one CTA's shared memory");

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

// the 128 threads of warpgroup `wg` (named barrier 1 + wg; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// K-major operand tile in the 128-byte-swizzled layout: rows of 128 bytes,
// groups of 8 rows 1024 bytes apart, the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;             // leading offset (unused)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;     // stride between groups
  d |= static_cast<uint64_t>(1) << 62;             // 128-byte swizzle
  return d;
}

#define TPUVAE_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TPUVAE_D16(i) \
  TPUVAE_D4(i), TPUVAE_D4(i + 4), TPUVAE_D4(i + 8), TPUVAE_D4(i + 12)

// d (64 x 64, fp32, this warpgroup's fragment) = a (64 x 8, TF32, from
// registers) x b (8 x 64, TF32, K-major in shared memory) + (keep ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : TPUVAE_D16(0), TPUVAE_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

#undef TPUVAE_D16
#undef TPUVAE_D4

// the 16-byte chunk `ch` (channels 4 ch .. 4 ch + 3) of pixel p of a staged
// input tile, in floats: XOR-swizzled so that 8 pixels two apart fall in
// different banks
__device__ __forceinline__ int tile_at(int p, int ch) {
  return p * kC + ((ch ^ ((p >> 1) & 7)) << 2);
}

// tiles [seg_start(w), seg_start(w + 1)) go to worker w of `workers`
// (workers <= n: every worker has at least one tile)
__device__ __forceinline__ int seg_start(int w, int n, int workers) {
  return static_cast<int>(static_cast<long long>(w) * n / workers);
}

// the worker that owns tile i
__device__ __forceinline__ int worker_of(int i, int n, int workers) {
  return static_cast<int>((static_cast<long long>(i + 1) * workers - 1) / n);
}

__global__ void __launch_bounds__(kThreads1, 1)
conv1_kernel(const float* __restrict__ y0, const float* __restrict__ scale,
             const float* __restrict__ shift, const float* __restrict__ w,
             const float* __restrict__ bias, int batch, int height, int width,
             int tiles_x, int tiles, float* __restrict__ y1,
             float* __restrict__ part, float* __restrict__ sums,
             int* __restrict__ tickets, float* __restrict__ stats) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t wts = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;         // warp within the warpgroup
  const int lane = tid & 31;
  float* tile = reinterpret_cast<float*>(smem + kWBytes + wg * kTileBytes);
  float* red = reinterpret_cast<float*>(smem + kWBytes +
                                        kWarpGroups * kTileBytes) +
               wg * kRedFloats;
  int* flag = reinterpret_cast<int*>(
                  smem + kWBytes + kWarpGroups * (kTileBytes + kRedFloats * 4)) +
              wg;

  // all nine taps, split into hi and lo, K-major: row f of tap t holds
  // w[t, 0..31, f]; a warp reads 32 neighbouring f of one channel
  for (int e = tid; e < 9 * 8 * kF; e += kThreads1) {
    const int tap = e / (8 * kF);
    const int chunk = (e / kF) % 8;
    const int f = e % kF;
    const float* src = w + (tap * kC + chunk * 4) * kF + f;
    float hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = src[j * kF];
      hi[j] = __uint_as_float(to_tf32(v));
      lo[j] = __uint_as_float(to_tf32(v - hi[j]));
    }
    unsigned char* dst = smem + tap * 2 * kTapBytes + f * 128 +
                         ((chunk ^ (f & 7)) << 4);
    *reinterpret_cast<float4*>(dst) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(dst + kTapBytes) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  // the weights are read by wgmma (the async proxy) after these stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int g = lane >> 2;            // fragment row group
  const int t = lane & 3;             // fragment column pair
  // fragment rows 16 warp + g (+ 8): tile pixel (2 warp (+ 1), g); its
  // input pixel for tap (0, 0)
  const int pix0 = 4 * warp * kIn1 + 2 * g;
  // the thread's chunk in the staging loops: channels 4 (wtid % 8) .. + 3
  const int my_ch = wtid & 7;
  const float4 sc = make_float4(scale[my_ch * 4], scale[my_ch * 4 + 1],
                                scale[my_ch * 4 + 2], scale[my_ch * 4 + 3]);
  const float4 sh = make_float4(shift[my_ch * 4], shift[my_ch * 4 + 1],
                                shift[my_ch * 4 + 2], shift[my_ch * 4 + 3]);

  float part_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part_acc[i] = 0.f;

  // This warpgroup's tiles: a contiguous range (worker `wid` of `workers`),
  // so that it meets at most a few images.  Its statistics are summed in
  // registers over its run of tiles in one image (a segment) and leave the
  // warpgroup once per segment.
  const int h2 = height / 2;
  const int w2 = width / 2;
  const int n_tiles = batch * tiles;
  const int workers = min(static_cast<int>(gridDim.x) * kWarpGroups, n_tiles);
  const int wid = blockIdx.x * kWarpGroups + wg;
  if (wid >= workers) return;
  const int t_begin = seg_start(wid, n_tiles, workers);
  const int t_end = seg_start(wid + 1, n_tiles, workers);
  const uint32_t tile_s = smem_u32(tile);
  // sv[c] / sv[16 + c]: the sum / sum of squares of the thread's column
  // c = 2 i + e (channel 8 i + 2 t + e) over the segment's valid pixels
  float sv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sv[i] = 0.f;
  for (int tile_id = t_begin; tile_id < t_end; ++tile_id) {
    const int b = tile_id / tiles;
    const int tin = tile_id - b * tiles;
    const int ty = tin / tiles_x;
    const int tx = tin - ty * tiles_x;
    const int r0 = 2 * kT1 * ty;
    const int c0 = 2 * kT1 * tx;
    const float* yb = y0 + static_cast<size_t>(b) * height * width * kC;

    // raw input tile, zero past the image
    for (int e = wtid; e < kInPix * 8; e += 128) {  // ablate: no_tile_loads
      const int p = e >> 3;
      const int r = p / kIn1;
      const int gr = r0 + r;
      const int gc = c0 + p - r * kIn1;
      const bool ok = gr < height && gc < width;
      cp_async16(tile_s + tile_at(p, my_ch) * 4,
                 ok ? yb + (static_cast<size_t>(gr) * width + gc) * kC +
                          my_ch * 4
                    : yb,
                 ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    wg_sync(wg);
    // affine + LeakyReLU in place; the padding stays zero
    for (int e = wtid; e < kInPix * 8; e += 128) {  // ablate: no_normalisation
      const int p = e >> 3;
      const int r = p / kIn1;
      if (r0 + r < height && c0 + p - r * kIn1 < width) {
        float4* a = reinterpret_cast<float4*>(tile + tile_at(p, my_ch));
        const float4 v = *a;
        float4 z;
        z.x = fmaf(v.x, sc.x, sh.x);
        z.y = fmaf(v.y, sc.y, sh.y);
        z.z = fmaf(v.z, sc.z, sh.z);
        z.w = fmaf(v.w, sc.w, sh.w);
        z.x = z.x > 0.f ? z.x : kSlope * z.x;
        z.y = z.y > 0.f ? z.y : kSlope * z.y;
        z.z = z.z > 0.f ? z.z : kSlope * z.z;
        z.w = z.w > 0.f ? z.w : kSlope * z.w;
        *a = z;
      }
    }
    wg_sync(wg);

    // nine taps: twelve products into the partial sum (small terms first,
    // the first overwrites it), then into the running sums on the CUDA cores
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {  // ablate: no_products
      const int p = tap / 3;
      const int q = tap % 3;
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // the m64k8 TF32 A fragment: (row, k), (row + 8, k), (row, k + 4),
        // (row + 8, k + 4); k = 8 kk + t is channel 4 (2 kk) + t
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pix = pix0 + (2 * (r & 1) + p) * kIn1 + q;
          const float x = tile[tile_at(pix, 2 * kk + (r >> 1)) + t];
          a_hi[kk][r] = to_tf32(x);
          a_lo[kk][r] = to_tf32(x - __uint_as_float(a_hi[kk][r]));
        }
      }
      const uint32_t hi_b = wts + tap * 2 * kTapBytes;
      const uint32_t lo_b = hi_b + kTapBytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k8(part_acc, a_lo[kk], smem_desc(hi_b + kk * 32), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k8(part_acc, a_hi[kk], smem_desc(lo_b + kk * 32), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k8(part_acc, a_hi[kk], smem_desc(hi_b + kk * 32), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part_acc[i];
    }

    // Epilogue.  acc[4 i + 2 h + e] is channel 8 i + 2 t + e of tile pixel
    // (2 warp + h, g).
    const int ox = tx * kT1 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oy = ty * kT1 + 2 * warp + h;
      if (oy < h2 && ox < w2) {
        float* dst = y1 + ((static_cast<size_t>(b) * h2 + oy) * w2 + ox) * kF +
                     2 * t;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v0 = acc[4 * i + 2 * h] + __ldg(bias + 8 * i + 2 * t);
          const float v1 = acc[4 * i + 2 * h + 1] +
                           __ldg(bias + 8 * i + 2 * t + 1);
          *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(v0, v1);
          sv[2 * i] += v0;
          sv[2 * i + 1] += v1;
          sv[16 + 2 * i] = fmaf(v0, v0, sv[16 + 2 * i]);
          sv[16 + 2 * i + 1] = fmaf(v1, v1, sv[16 + 2 * i + 1]);
        }
      }
    }
    if (tile_id + 1 < t_end && tin + 1 < tiles) continue;  // ablate: no_statistics

    // The segment ends.  Reduce-scatter over the 8 lanes of column pair t
    // (lane bits 4, 3, 2): lane (g, t) ends with sv[4 g .. 4 g + 3] summed
    // over those lanes; then the 4 warps in order through shared memory.
    float r16[16], r8[8], r4[4];
    const bool up4 = lane & 16, up3 = lane & 8, up2 = lane & 4;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float send = up4 ? sv[k] : sv[16 + k];
      r16[k] = (up4 ? sv[16 + k] : sv[k]) +
               __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float send = up3 ? r16[k] : r16[8 + k];
      r8[k] = (up3 ? r16[8 + k] : r16[k]) +
              __shfl_xor_sync(0xffffffffu, send, 8);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float send = up2 ? r8[k] : r8[4 + k];
      r4[k] = (up2 ? r8[4 + k] : r8[k]) + __shfl_xor_sync(0xffffffffu, send, 4);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) sv[i] = 0.f;
    {
      const int which = g >> 2;       // 0: sums, 1: sums of squares
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * (g & 3) + k;
        red[(warp * 2 + which) * kF + 8 * (c >> 1) + 2 * t + (c & 1)] = r4[k];
      }
    }
    wg_sync(wg);
    const int which = wtid >> 6;
    const int ch = wtid & 63;
    {
      // the segment's row: that of its first tile
      const int row = max(t_begin, b * tiles);
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) v += red[(i * 2 + which) * kF + ch];
      part[(static_cast<size_t>(row) * 2 + which) * kF + ch] = v;
      __threadfence();
    }
    // the image's segments: those of workers w_first .. w_last
    const int w_first = worker_of(b * tiles, n_tiles, workers);
    const int w_last = worker_of((b + 1) * tiles - 1, n_tiles, workers);
    wg_sync(wg);
    if (wtid == 0) *flag = atomicAdd(tickets + b, 1) == w_last - w_first;
    wg_sync(wg);
    if (!*flag) continue;
    __threadfence();
    float total = 0.f;
    for (int wk = w_first; wk <= w_last; ++wk) {
      const int row = max(seg_start(wk, n_tiles, workers), b * tiles);
      total += __ldcg(part + (static_cast<size_t>(row) * 2 + which) * kF + ch);
    }
    sums[(static_cast<size_t>(which) * batch + b) * kF + ch] = total;
    if (wtid == 0) tickets[b] = 0;
    __threadfence();
    wg_sync(wg);
    if (wtid == 0) *flag = atomicAdd(tickets + batch, 1) == batch - 1;
    wg_sync(wg);
    if (!*flag) continue;
    __threadfence();
    if (wtid < kF) {
      finalize_channel<false>(sums, batch, kF, wtid,
                              static_cast<float>(static_cast<long long>(batch) *
                                                 h2 * w2),
                              nullptr, nullptr, 0.f, stats);
    }
    if (wtid == 0) tickets[batch] = 0;
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

}  // namespace

// x (B, H, W), w (3, 3, 32), bias (32) -> y (B, H/2, W/2, 32) and the
// per-image sums / sums of squares `sums` (2, B, 32).  `part` is scratch of
// B * tiles * 2 * 32 floats, `tickets` B + 1 ints that are 0 (and are 0
// again when the kernel ends); `tiles` is the wrapper's count of CTAs per
// image and must be this file's.  `stats` (5, 32): the batch mean and
// variance, their fold with gamma, beta and eps into scale and shift, and
// the variance before its clamp at 0.
extern "C" int tpuvae_fusedconv_conv0(const void* x, const void* w,
                                      const void* bias, int batch, int height,
                                      int width, int features, int tiles,
                                      void* y, void* part, void* sums,
                                      void* tickets, const void* gamma,
                                      const void* beta, float eps, void* stats,
                                      void* stream) {
  if (batch <= 0) return 0;
  if (features != kF0 || height <= 0 || width <= 0 || height % 2 || width % 2 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h2 = height / 2, w2 = width / 2;
  const dim3 grid((w2 + kT0W - 1) / kT0W, (h2 + kT0H - 1) / kT0H, batch);
  if (static_cast<int>(grid.x * grid.y) != tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  conv0_kernel<<<grid, kThreads0, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), height, width, static_cast<float*>(y),
      static_cast<float*>(part), static_cast<float*>(sums),
      static_cast<int*>(tickets), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// y0 (B, H, W, 32), scale / shift (32), w (3, 3, 32, 64), bias (64) ->
// y1 (B, H/2, W/2, 64) and the per-image sums / sums of squares `sums`
// (2, B, 64).  `part` is scratch of B * tiles * 2 * 64 floats, `tickets` as
// for conv0; `tiles` is the count of 8 x 8 output tiles per image.
// `stats` (3, 64): the batch mean and variance, and the variance before
// its clamp at 0.
extern "C" int tpuvae_fusedconv_conv1(const void* y0, const void* scale,
                                      const void* shift, const void* w,
                                      const void* bias, int batch, int height,
                                      int width, int channels, int features,
                                      int tiles, void* y1, void* part,
                                      void* sums, void* tickets, void* stats,
                                      void* stream) {
  if (batch <= 0) return 0;
  if (channels != kC || features != kF || height <= 0 || width <= 0 ||
      height % 2 || width % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h2 = height / 2, w2 = width / 2;
  const int tiles_x = (w2 + kT1 - 1) / kT1;
  const long long n_tiles = static_cast<long long>(tiles) * batch;
  if (tiles_x * ((h2 + kT1 - 1) / kT1) != tiles || n_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1Bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long want = (n_tiles + kWarpGroups - 1) / kWarpGroups;
  const int grid = static_cast<int>(want < sms ? want : sms);
  conv1_kernel<<<grid, kThreads1, kSmem1Bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y0), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(w),
      static_cast<const float*>(bias), batch, height, width, tiles_x, tiles,
      static_cast<float*>(y1), static_cast<float*>(part),
      static_cast<float*>(sums), static_cast<int*>(tickets),
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
