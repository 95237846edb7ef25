// Tiled pairwise squared Euclidean distances (kernel 5).
//
// Replaces the Pallas kernel tpuvae/ops/pairwise.py:27 (_kernel), launched
// by _pairwise_padded (:40) from squared_distances_pallas (:84) and
// self_distances_pallas (:118):
//   out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0)   fp32, x (N, D),
//   y (M, D) -> (N, M).
// With self_mode (y is x) the epilogue also takes the square root and
// writes an exactly-zero diagonal, which self_distances_pallas leaves to
// two more passes over the (N, N) matrix.
//
// Bound on the H100 at the main path's D = 32: bytes, narrowly.  Each
// output element costs 4 bytes written and 2*D + 3 = 67 fp32 operations;
// the card does 67e12 / 3.35e12 = 20 fp32 operations (outside the tensor
// cores) per byte of HBM, so the N*M*4 bytes of the output are the floor.
// Design: one 256-thread CTA per 64 x 64 output tile, each thread a 4 x 4
// register micro-tile of fp32 FMAs at rows ty + 16 i and columns
// tx + 16 j, so that each store instruction of a half-warp writes 16
// consecutive floats.  The x and y row blocks are staged through shared
// memory in chunks of 32 along D, transposed and padded by one word
// against bank conflicts, and zero-filled past N, M and D: nothing is
// padded in HBM and D is arbitrary.  The row norms are summed from the
// same staged rows.  No tensor cores: TF32 keeps ~10 mantissa bits, and
// the cross term cancels against the norms.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 32;
constexpr int kSide = 16;                 // threads per tile side
constexpr int kThreads = kSide * kSide;
constexpr int kMicro = kTile / kSide;     // 4 x 4 outputs per thread

__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                long long n, long long m, long long d,
                float* __restrict__ out, int self_mode) {
  __shared__ float xs[kChunk][kTile + 1];
  __shared__ float ys[kChunk][kTile + 1];
  __shared__ float xn_s[kTile];
  __shared__ float yn_s[kTile];

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
  // threads [0, 64) sum |x_row|^2, threads [64, 128) sum |y_row|^2
  float norm = 0.f;

  for (long long k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int c = e % kChunk;
      const long long gc = k0 + c;
      const long long xr = row0 + r;
      const long long yr = col0 + r;
      xs[c][r] = (xr < n && gc < d) ? x[xr * d + gc] : 0.f;
      ys[c][r] = (yr < m && gc < d) ? y[yr * d + gc] : 0.f;
    }
    __syncthreads();
    if (tid < kTile) {
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) norm = fmaf(xs[c][tid], xs[c][tid], norm);
    } else if (tid < 2 * kTile) {
      const int r = tid - kTile;
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) norm = fmaf(ys[c][r], ys[c][r], norm);
    }
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = xs[c][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = ys[c][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTile) {
    xn_s[tid] = norm;
  } else if (tid < 2 * kTile) {
    yn_s[tid - kTile] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long r = row0 + ty + kSide * i;
    if (r >= n) continue;
    const float xr = xn_s[ty + kSide * i];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long c = col0 + tx + kSide * j;
      if (c >= m) continue;
      float v = fmaxf(xr + yn_s[tx + kSide * j] - 2.f * acc[i][j], 0.f);
      if (self_mode) v = (r == c) ? 0.f : sqrtf(v);
      out[r * m + c] = v;
    }
  }
}

}  // namespace

extern "C" int tpuvae_pairwise_distances(const void* x, const void* y,
                                         long long n, long long m, long long d,
                                         void* out, int self_mode,
                                         void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((m + kTile - 1) / kTile),
                  static_cast<unsigned>((n + kTile - 1) / kTile));
  pairwise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), n, m, d,
      static_cast<float*>(out), self_mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
