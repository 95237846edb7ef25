// Fused conv + BatchNorm-statistics pair for the conv trunk's first two
// layers (kernel 6).
//
// Replaces the Pallas kernels tpuvae/ops/fusedconv.py:67 (_conv0_kernel)
// and :88 (_conv1_kernel), launched by _fused_pair (:116):
//   conv0: y0[b,i,j,f] = b0[f] + sum_{p,q} x[b,2i+p,2j+q] w0[p,q,f]
//   conv1: z = leaky_relu(y0 * scale + shift, 0.01), zero outside the image,
//          y1[b,i,j,f] = b1[f] + sum_{p,q,c} z[b,2i+p,2j+q,c] w1[p,q,c,f]
// both 3 x 3, stride 2, SAME on even dims (pads (0, 1): the halo is at the
// high edge only), NHWC, fp32.  Each also returns the per-channel sum and
// sum of squares of its RAW output, so that BatchNorm's batch statistics
// cost no further pass; y0 is written once and normalised on load, the
// normalised activation never exists in device memory.  Two kernels, as
// on the TPU: all of y0's statistics must exist before any of y0 is
// normalised.
//
// Bounds on the H100 at 32 x 128 x 1024: conv0 by bytes (16.8 MB read,
// 134.2 MB written, 0.045 ms at 3.35 TB/s; 0.6 GFLOP), conv1 by fp32
// operations (2*9*32*64 per output pixel, 9.66 GFLOP, 0.144 ms at the
// card's 67 TFLOP/s outside the tensor cores; 201 MB of traffic, 0.060
// ms).  No tensor cores: the Pallas body runs its dots at
// Precision.HIGHEST, and TF32 keeps ~10 mantissa bits.
//
// Design (not the TPU's: no parity planes, no whole image per grid step):
// * conv0: one 256-thread CTA per 8 x 32 output pixels (4,096 CTAs at the
//   main shape).  The 17 x 65 input tile is staged in shared memory,
//   zero-filled past the image, which is also the SAME padding.  A thread
//   owns 4 channels and keeps their 36 weights in registers; the 8 lanes
//   of a pixel store 128 contiguous bytes, a warp 4 neighbouring pixels.
// * conv1: one 128-thread CTA per 8 x 16 output pixels x all 64 channels
//   (2,048 CTAs), two CTAs per SM.  The 17 x 33 x 32 input tile is loaded
//   once with the affine and LeakyReLU applied, and zero AFTER the affine
//   outside the image; each pixel's 32 channels are padded to 36 floats so
//   that the four rows a warp reads fall in different banks.  The weights
//   are staged one kernel row (3 x 32 x 64) at a time.  A thread
//   accumulates 8 pixels x 8 channels in registers: per 4 input channels
//   it makes 8 + 8 16-byte shared loads for 256 FMAs.
// * statistics: per-thread sums over the thread's pixels, then a fixed-
//   order reduction through shuffles and shared memory to one partial row
//   per CTA.  No float atomics: two runs give the same bits.  The wrapper
//   sums the partials per image and finalises (C,) values in PyTorch.
#include <cuda_runtime.h>

namespace {

constexpr float kSlope = 0.01f;

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
             float* __restrict__ y, float* __restrict__ s_part,
             float* __restrict__ ss_part) {
  __shared__ float xs[kIn0H][kIn0W + 1];
  __shared__ float red[2][kWarps0][kF0];

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
  if (tid < 2 * kF0) {
    const int which = tid / kF0;
    const int ch = tid % kF0;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps0; ++i) t += red[which][i][ch];
    const size_t cta = (static_cast<size_t>(b) * gridDim.y + blockIdx.y)
                       * gridDim.x + blockIdx.x;
    (which ? ss_part : s_part)[cta * kF0 + ch] = t;
  }
}

// ---- conv1 -----------------------------------------------------------------
constexpr int kC = 32;               // input channels
constexpr int kF = 64;               // output channels
constexpr int kT1H = 8;              // output rows per CTA
constexpr int kT1W = 16;             // output columns per CTA
constexpr int kIn1H = 2 * kT1H + 1;
constexpr int kIn1W = 2 * kT1W + 1;
constexpr int kPix = kC + 4;         // floats per staged pixel (16-byte rows)
constexpr int kThreads1 = 128;
constexpr int kPixPerThread = 8;
constexpr int kZFloats = kIn1H * kIn1W * kPix;
constexpr int kWFloats = 3 * kC * kF;          // one kernel row of taps
constexpr int kSmem1Bytes = (kZFloats + kWFloats) * 4;
constexpr int kPixGroups = kT1H * kT1W / kPixPerThread;   // 16

static_assert(kPixGroups * 8 == kThreads1, "16 pixel groups x 8 channel groups");
static_assert(2 * kPixGroups * kF <= kWFloats, "statistics scratch fits");
static_assert(kZFloats % 4 == 0, "weights stay 16-byte aligned");

__global__ void __launch_bounds__(kThreads1, 2)
conv1_kernel(const float* __restrict__ y0, const float* __restrict__ scale,
             const float* __restrict__ shift, const float* __restrict__ w,
             const float* __restrict__ bias, int height, int width,
             float* __restrict__ y1, float* __restrict__ s_part,
             float* __restrict__ ss_part) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;
  float* ws = smem + kZFloats;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cg = lane % 8;            // channels 4 cg .. + 3 and 32 + 4 cg .. + 3
  const int row = (warp / 2) * 4 + lane / 8;   // output row in the tile
  const int half = warp % 2;          // output columns 8 half .. 8 half + 7
  const int h2 = height / 2;
  const int w2 = width / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kT1H;
  const int c0 = blockIdx.x * kT1W;

  // stage the input tile: affine + LeakyReLU on load, zero past the image
  {
    const int k4 = tid % 8;           // the same 4 channels on every trip
    const float4 sc = *reinterpret_cast<const float4*>(scale + k4 * 4);
    const float4 sh = *reinterpret_cast<const float4*>(shift + k4 * 4);
    const float* yb = y0 + static_cast<size_t>(b) * height * width * kC;
    for (int e = tid; e < kIn1H * kIn1W * 8; e += kThreads1) {
      const int pix = e / 8;
      const int r = pix / kIn1W;
      const int c = pix % kIn1W;
      const int gr = 2 * r0 + r;
      const int gc = 2 * c0 + c;
      float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < height && gc < width) {
        const float4 v = *reinterpret_cast<const float4*>(
            yb + (static_cast<size_t>(gr) * width + gc) * kC + k4 * 4);
        z.x = fmaf(v.x, sc.x, sh.x);
        z.y = fmaf(v.y, sc.y, sh.y);
        z.z = fmaf(v.z, sc.z, sh.z);
        z.w = fmaf(v.w, sc.w, sh.w);
        z.x = z.x > 0.f ? z.x : kSlope * z.x;
        z.y = z.y > 0.f ? z.y : kSlope * z.y;
        z.z = z.z > 0.f ? z.z : kSlope * z.z;
        z.w = z.w > 0.f ? z.w : kSlope * z.w;
      }
      *reinterpret_cast<float4*>(zs + pix * kPix + k4 * 4) = z;
    }
  }

  float acc[kPixPerThread][8];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  const int zbase = ((2 * row) * kIn1W + 2 * (half * kPixPerThread)) * kPix;
  for (int p = 0; p < 3; ++p) {
    __syncthreads();                  // the previous row's taps are consumed
    const float4* wg = reinterpret_cast<const float4*>(w + p * kWFloats);
    for (int e = tid; e < kWFloats / 4; e += kThreads1)
      reinterpret_cast<float4*>(ws)[e] = wg[e];
    __syncthreads();                  // tile (first trip) and taps are staged
#pragma unroll 1
    for (int q = 0; q < 3; ++q) {
      const float* zq = zs + zbase + (p * kIn1W + q) * kPix;
      const float* wq = ws + q * kC * kF + cg * 4;
#pragma unroll 2
      for (int c4 = 0; c4 < kC / 4; ++c4) {
        float4 zv[kPixPerThread];
#pragma unroll
        for (int j = 0; j < kPixPerThread; ++j)
          zv[j] = *reinterpret_cast<const float4*>(zq + j * 2 * kPix + c4 * 4);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* wc = wq + (c4 * 4 + cc) * kF;
          const float4 wa = *reinterpret_cast<const float4*>(wc);
          const float4 wb = *reinterpret_cast<const float4*>(wc + 32);
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j) {
            const float z = cc == 0 ? zv[j].x : cc == 1 ? zv[j].y
                          : cc == 2 ? zv[j].z : zv[j].w;
            acc[j][0] = fmaf(z, wa.x, acc[j][0]);
            acc[j][1] = fmaf(z, wa.y, acc[j][1]);
            acc[j][2] = fmaf(z, wa.z, acc[j][2]);
            acc[j][3] = fmaf(z, wa.w, acc[j][3]);
            acc[j][4] = fmaf(z, wb.x, acc[j][4]);
            acc[j][5] = fmaf(z, wb.y, acc[j][5]);
            acc[j][6] = fmaf(z, wb.z, acc[j][6]);
            acc[j][7] = fmaf(z, wb.w, acc[j][7]);
          }
        }
      }
    }
  }

  // bias, store, per-thread statistics over the thread's valid pixels
  const float4 ba = *reinterpret_cast<const float4*>(bias + cg * 4);
  const float4 bb = *reinterpret_cast<const float4*>(bias + 32 + cg * 4);
  const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
  float s[8], ss[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = ss[k] = 0.f;
  const int orow = r0 + row;
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int ocol = c0 + half * kPixPerThread + j;
    if (orow < h2 && ocol < w2) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = acc[j][k] + bv[k];
        s[k] += v[k];
        ss[k] = fmaf(v[k], v[k], ss[k]);
      }
      float* dst = y1 + ((static_cast<size_t>(b) * h2 + orow) * w2 + ocol) * kF
                   + cg * 4;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 32) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();                    // the taps are consumed: reuse as scratch
  {
    const int pg = warp * 4 + lane / 8;
    float* sp = ws + pg * kF;
    float* ssp = ws + (kPixGroups + pg) * kF;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sp[cg * 4 + k] = s[k];
      sp[32 + cg * 4 + k] = s[4 + k];
      ssp[cg * 4 + k] = ss[k];
      ssp[32 + cg * 4 + k] = ss[4 + k];
    }
  }
  __syncthreads();
  {
    const int which = tid / kF;
    const int ch = tid % kF;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kPixGroups; ++i) t += ws[(which * kPixGroups + i) * kF + ch];
    const size_t cta = (static_cast<size_t>(b) * gridDim.y + blockIdx.y)
                       * gridDim.x + blockIdx.x;
    (which ? ss_part : s_part)[cta * kF + ch] = t;
  }
}

}  // namespace

// x (B, H, W), w (3, 3, 32), bias (32) -> y (B, H/2, W/2, 32) and partial
// sums / sums of squares (B, tiles, 32); `tiles` is the wrapper's count of
// CTAs per image and must be this file's.
extern "C" int tpuvae_fusedconv_conv0(const void* x, const void* w,
                                      const void* bias, int batch, int height,
                                      int width, int features, int tiles,
                                      void* y, void* s_part, void* ss_part,
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
      static_cast<float*>(s_part), static_cast<float*>(ss_part));
  return static_cast<int>(cudaGetLastError());
}

// y0 (B, H, W, 32), scale / shift (32), w (3, 3, 32, 64), bias (64) ->
// y1 (B, H/2, W/2, 64) and partial sums / sums of squares (B, tiles, 64).
extern "C" int tpuvae_fusedconv_conv1(const void* y0, const void* scale,
                                      const void* shift, const void* w,
                                      const void* bias, int batch, int height,
                                      int width, int channels, int features,
                                      int tiles, void* y1, void* s_part,
                                      void* ss_part, void* stream) {
  if (batch <= 0) return 0;
  if (channels != kC || features != kF || height <= 0 || width <= 0 ||
      height % 2 || width % 2 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1Bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int h2 = height / 2, w2 = width / 2;
  const dim3 grid((w2 + kT1W - 1) / kT1W, (h2 + kT1H - 1) / kT1H, batch);
  if (static_cast<int>(grid.x * grid.y) != tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  conv1_kernel<<<grid, kThreads1, kSmem1Bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y0), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(w),
      static_cast<const float*>(bias), height, width, static_cast<float*>(y1),
      static_cast<float*>(s_part), static_cast<float*>(ss_part));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
