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
//
// Design: a persistent grid (two 256-thread CTAs an SM) walks over
// T x T output tiles, T = 128 (64 where 128-wide tiles would leave SMs
// idle: ops/pairwise.py:tile_size).
// * Each thread computes an 8 x 8 register micro-tile (4 x 4 at T = 64)
//   as runs of 4 rows by 4 columns (Geometry): per step along D, four
//   float4 shared loads, one wavefront each, feed 64 FMAs, so the loads no
//   longer set the pace of the FMAs.
//   The x and y row blocks are staged through shared memory transposed,
//   in chunks of 32 along D, zero-filled past N, M and D: nothing is
//   padded in HBM and D is arbitrary.  They are read from HBM with 16-byte
//   loads, 8 lanes along a row, and stored through an XOR swizzle
//   (op_index) that keeps the transposing stores and both operand reads
//   free of bank conflicts.  The row norms are summed from the same staged
//   rows, by one code path for x and y.
// * The epilogue writes the tile straight from the registers with 16-byte
//   streaming stores: a warp instruction writes four rows' full 128-byte
//   lines.  Stores do not wait, so the tile's stores drain while the CTA
//   (and the SM's other CTA) computes the next tile.  Rows not 16-byte
//   aligned (M % 4 != 0) take four scalar stores.
// * self_mode computes only the tiles on or above the diagonal
//   (row-major over the upper triangle).  An off-diagonal tile is also
//   staged in shared memory transposed (a row per output column, float4
//   writes of four rows, a stride of an odd number of float4s: no bank
//   conflict) and written as the mirror tile, T / 4 lanes per output row,
//   again in full lines.  The result is exactly symmetric: the mirror is a
//   copy, and in a diagonal tile (i, j) and (j, i) are the same sums over
//   D in the same order (a*b = b*a and a + b = b + a in IEEE).
// No tensor cores: TF32 keeps ~10 mantissa bits, and the cross term
// cancels against the norms.
//
// A line marked `// ablate: NAME` is one that tools/kernel_ab.py --ablate
// replaces to time the kernel without that part of its work.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kChunk = 32;                // along D

template <int kTile>
struct Geometry {
  // A thread's micro-tile: kGroups x kGroups runs of 4 rows by 4 columns
  // (8 x 8 outputs at kTile 128, 4 x 4 at 64).  Lane = 4 lc + lr, warp =
  // 4 wc + wr: rows wr 16 kGroups + 16 ii + 4 lr + [0, 4), columns
  // wc 32 kGroups + 32 jj + 4 lc + [0, 4).
  static constexpr int kGroups = kTile / 64;
  static constexpr int kAcc = 4 * kGroups;       // micro-tile side
  // the transposed stage: a row per output column, float4-aligned, its
  // stride an odd number of float4s
  static constexpr int kStageStride = kTile + 4;
  static constexpr int kOperandFloats = 2 * kChunk * kTile + 2 * kTile;
  static constexpr int kStageFloats = kTile * kStageStride;
  // float4 loads of the x and y blocks a thread makes per chunk
  static constexpr int kLoads = kTile * (kChunk / 4) / kThreads;
};

// Where element (k, r) of a transposed (kChunk x kTile) operand block lies:
// row k, its column r XOR-swizzled in units of four floats by bits 2-4 of
// k.  A warp's transposing stores (8 lanes along k, 4 rows) then hit 32
// distinct banks, while a run of four columns from a multiple of 4 stays
// one aligned float4 and eight such runs of an aligned 32 stay 8 distinct
// float4 slots: a micro-tile's float4 reads take one wavefront.
template <int kTile>
__device__ __forceinline__ int op_index(int k, int r) {
  return k * kTile + (r ^ (((k >> 2) & 7) << 2));
}

// x[row, k .. k + 4) of an (n, d) matrix, zero past n and d: one 16-byte
// load where rows are 16-byte aligned (vec), else four.
__device__ __forceinline__ float4 load_quad(const float* __restrict__ x,
                                            long long row, long long n,
                                            long long k, long long d,
                                            bool vec) {
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= n || k >= d) return q;
  const float* p = x + row * d + k;
  if (vec) return *reinterpret_cast<const float4*>(p);
  q.x = p[0];
  if (k + 1 < d) q.y = p[1];
  if (k + 2 < d) q.z = p[2];
  if (k + 3 < d) q.w = p[3];
  return q;
}

__device__ __forceinline__ float get(const float4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// streaming stores of the output (evict-first: nothing here reads it back;
// write-back stores measured slower, tools/kernel_ab.py --ablate)
__device__ __forceinline__ void st1(float* p, float v) { __stcs(p, v); }  // ablate: st1
__device__ __forceinline__ void st4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);  // ablate: st4
}

// out[0 .. 4) = q where those of `valid` columns exist: one 16-byte store
// where the row is 16-byte aligned (vec), else four.
__device__ __forceinline__ void store_quad(float* p, const float4& q,
                                           long long valid, bool vec) {
  if (valid >= 4 && vec) {
    st4(p, q);
    return;
  }
  if (valid > 0) st1(p, q.x);
  if (valid > 1) st1(p + 1, q.y);
  if (valid > 2) st1(p + 2, q.z);
  if (valid > 3) st1(p + 3, q.w);
}

template <int kTile>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                long long n, long long m, long long d,
                float* __restrict__ out, int self_mode, int vec_in,
                int vec_out) {
  using G = Geometry<kTile>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                  // op_index layout
  float* ys = xs + kChunk * kTile;
  float* xn_s = ys + kChunk * kTile;                 // [kTile]
  float* yn_s = xn_s + kTile;
  float* stage = yn_s + kTile;                       // self_mode only

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int lr = lane & 3;
  const int lc = lane >> 2;
  const int wr = (tid >> 5) & 3;
  const int wc = tid >> 7;
  const int rbase = wr * 16 * G::kGroups + 4 * lr;   // + 16 ii + [0, 4)
  const int cbase = wc * 32 * G::kGroups + 4 * lc;   // + 32 jj + [0, 4)
  const long long nbr = (n + kTile - 1) / kTile;
  const long long nbc = (m + kTile - 1) / kTile;
  const long long total = self_mode ? nbr * (nbr + 1) / 2 : nbr * nbc;
  // self_mode: tile t lies in block row bi, whose tiles are [row_beg, row_end)
  long long bi = 0, row_beg = 0, row_end = nbr;

  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    long long bj;
    if (self_mode) {
      while (t >= row_end) {
        ++bi;
        row_beg = row_end;
        row_end += nbr - bi;
      }
      bj = bi + (t - row_beg);
    } else {
      bi = t / nbc;
      bj = t % nbc;
    }
    const long long row0 = bi * kTile;
    const long long col0 = bj * kTile;

    float acc[G::kAcc][G::kAcc];
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i)
#pragma unroll
      for (int j = 0; j < G::kAcc; ++j) acc[i][j] = 0.f;
    // threads [0, kTile) sum |x_row|^2, threads [kTile, 2 kTile) |y_row|^2
    float norm = 0.f;

    // The last tile's reads of xs / ys ended before its norms barrier, and
    // its reads of the norms and the stage end before this tile's first
    // barrier below: the operand stores need no barrier of their own,
    // unless there is no chunk (D = 0) and the norms are written at once.
    if (d == 0) __syncthreads();
    for (long long k0 = 0; k0 < d; k0 += kChunk) {
      // 8 lanes along a row's 32 values of the chunk (128 bytes), 4 rows a
      // warp instruction; a block's loads in flight before its stores
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const float* src = side == 0 ? x : y;
        const long long src_row0 = side == 0 ? row0 : col0;
        const long long src_rows = side == 0 ? n : m;
        float* dst = side == 0 ? xs : ys;
        float4 q[G::kLoads];
#pragma unroll
        for (int u = 0; u < G::kLoads; ++u) {
          const int e = tid + kThreads * u;
          q[u] = load_quad(src, src_row0 + (e >> 3), src_rows,
                           k0 + 4 * (e & 7), d, vec_in);
        }
#pragma unroll
        for (int u = 0; u < G::kLoads; ++u) {
          const int e = tid + kThreads * u;
          const int r = e >> 3;
          const int c = 4 * (e & 7);
          dst[op_index<kTile>(c, r)] = q[u].x;
          dst[op_index<kTile>(c + 1, r)] = q[u].y;
          dst[op_index<kTile>(c + 2, r)] = q[u].z;
          dst[op_index<kTile>(c + 3, r)] = q[u].w;
        }
      }
      __syncthreads();
      if (tid < 2 * kTile) {
        const float* blk = tid < kTile ? xs : ys;
        const int r = tid < kTile ? tid : tid - kTile;
#pragma unroll 8
        for (int c = 0; c < kChunk; ++c) {
          const float v = blk[op_index<kTile>(c, r)];
          norm = fmaf(v, v, norm);
        }
      }
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {  // ablate: products
        float4 a[G::kGroups], b[G::kGroups];
#pragma unroll
        for (int g = 0; g < G::kGroups; ++g) {
          a[g] = *reinterpret_cast<const float4*>(
              xs + op_index<kTile>(c, rbase + 16 * g));
          b[g] = *reinterpret_cast<const float4*>(
              ys + op_index<kTile>(c, cbase + 32 * g));
        }
#pragma unroll
        for (int i = 0; i < G::kAcc; ++i)
#pragma unroll
          for (int j = 0; j < G::kAcc; ++j) {
            acc[i][j] = fmaf(get(a[i / 4], i % 4), get(b[j / 4], j % 4),
                             acc[i][j]);
          }
      }
      // this chunk's reads are done before the next chunk's stores (the
      // last chunk's: the norms barrier below)
      if (k0 + kChunk < d) __syncthreads();
    }
    if (tid < kTile) {
      xn_s[tid] = norm;
    } else if (tid < 2 * kTile) {
      yn_s[tid - kTile] = norm;
    }
    __syncthreads();

    // ---- epilogue: the tile from registers, the mirror through `stage` ----
    const bool mirror = self_mode && bi != bj;  // ablate: mirror
    const bool diag = self_mode && bi == bj;
    float4 yn[G::kGroups];
#pragma unroll
    for (int g = 0; g < G::kGroups; ++g) {
      yn[g] = *reinterpret_cast<const float4*>(yn_s + cbase + 32 * g);
    }
#pragma unroll
    for (int ii = 0; ii < G::kGroups; ++ii) {
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g) {
        // a 4 x 4 block: rows rbase + 16 ii + [0, 4), columns
        // cbase + 32 g + [0, 4)
        const int rl0 = rbase + 16 * ii;
        const int cl0 = cbase + 32 * g;
        const long long c = col0 + cl0;
        float v[4][4];
#pragma unroll
        for (int qr = 0; qr < 4; ++qr) {
          const float xr = xn_s[rl0 + qr];
#pragma unroll
          for (int qc = 0; qc < 4; ++qc) {
            float s = fmaxf(xr + get(yn[g], qc)
                            - 2.f * acc[4 * ii + qr][4 * g + qc], 0.f);
            v[qr][qc] = self_mode ? sqrtf(s) : s;  // ablate: sqrt
          }
          if (diag) {
#pragma unroll
            for (int qc = 0; qc < 4; ++qc) {
              if (rl0 + qr == cl0 + qc) v[qr][qc] = 0.f;
            }
          }
          const long long r = row0 + rl0 + qr;
          const float4 row4 = make_float4(v[qr][0], v[qr][1], v[qr][2],
                                          v[qr][3]);
          if (r < n) store_quad(out + r * m + c, row4, m - c, vec_out);  // ablate: direct_stores
        }
        if (mirror) {
          // stage row = output column: the block's four rows as a float4
#pragma unroll
          for (int qc = 0; qc < 4; ++qc) {
            *reinterpret_cast<float4*>(stage + (cl0 + qc) * G::kStageStride +
                                       rl0) =
                make_float4(v[0][qc], v[1][qc], v[2][qc], v[3][qc]);
          }
        }
      }
    }
    if (mirror) {
      __syncthreads();
      // out[col0 + cl, row0 + ...] = stage[cl, ...]: kTile / 4 lanes per
      // output row, 16 bytes a lane
      constexpr int kLanesPerRow = kTile / 4;
      constexpr int kRowsPerPass = kThreads / kLanesPerRow;
      const int l4 = tid % kLanesPerRow;
      for (int cl = tid / kLanesPerRow; cl < kTile; cl += kRowsPerPass) {
        const long long orow = col0 + cl;
        if (orow >= n) break;             // the same for a row's lanes
        const float4 v4 = *reinterpret_cast<const float4*>(
            stage + cl * G::kStageStride + 4 * l4);
        const long long c = row0 + 4 * l4;
        store_quad(out + orow * m + c, v4, n - c, vec_out);
      }
    }
  }
}

// Dynamic shared memory of a CTA, and CTAs an SM, per device and tile;
// the kernel's attributes are set once per device.
struct LaunchInfo {
  int blocks_per_sm[2][2];                // [tile 64 | 128][self_mode]
  int sms;
  bool ready;
};
constexpr int kMaxDevices = 64;
LaunchInfo g_info[kMaxDevices];

template <int kTile>
size_t smem_bytes(int self_mode) {
  using G = Geometry<kTile>;
  return sizeof(float) *
         static_cast<size_t>(G::kOperandFloats + (self_mode ? G::kStageFloats : 0));
}

template <int kTile>
cudaError_t prepare(LaunchInfo* info, int slot) {
  cudaError_t rc = cudaFuncSetAttribute(
      pairwise_kernel<kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<kTile>(1)));
  if (rc != cudaSuccess) return rc;
  // two CTAs of ~100 KB an SM need the largest carveout
  rc = cudaFuncSetAttribute(pairwise_kernel<kTile>,
                            cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (rc != cudaSuccess) return rc;
  for (int self_mode = 0; self_mode < 2; ++self_mode) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info->blocks_per_sm[slot][self_mode], pairwise_kernel<kTile>,
        kThreads, smem_bytes<kTile>(self_mode));
    if (rc != cudaSuccess) return rc;
    if (info->blocks_per_sm[slot][self_mode] < 1) return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

template <int kTile>
cudaError_t launch(const LaunchInfo& info, int slot, const float* x,
                   const float* y, long long n, long long m, long long d,
                   float* out, int self_mode, int vec_in, int vec_out,
                   cudaStream_t stream) {
  const long long nbr = (n + kTile - 1) / kTile;
  const long long nbc = (m + kTile - 1) / kTile;
  const long long tiles = self_mode ? nbr * (nbr + 1) / 2 : nbr * nbc;
  const long long grid = std::min<long long>(
      tiles, static_cast<long long>(info.sms) * info.blocks_per_sm[slot][self_mode]);
  pairwise_kernel<kTile><<<static_cast<unsigned>(grid), kThreads,
                           smem_bytes<kTile>(self_mode), stream>>>(
      x, y, n, m, d, out, self_mode, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// `tile`: 64 or 128 (ops/pairwise.py:tile_size).  self_mode needs y == x.
extern "C" int tpuvae_pairwise_distances(const void* x, const void* y,
                                         long long n, long long m, long long d,
                                         void* out, int self_mode, int tile,
                                         void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if ((tile != 64 && tile != 128) || d < 0 || (self_mode && (x != y || n != m)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  LaunchInfo& info = g_info[dev];
  if (!info.ready) {
    rc = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess) rc = prepare<64>(&info, 0);
    if (rc == cudaSuccess) rc = prepare<128>(&info, 1);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    info.ready = true;
  }
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads and stores where every row starts 16-byte aligned
  const int vec_in = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int vec_out = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  rc = tile == 128
           ? launch<128>(info, 1, xf, yf, n, m, d, of, self_mode, vec_in,
                         vec_out, s)
           : launch<64>(info, 0, xf, yf, n, m, d, of, self_mode, vec_in,
                        vec_out, s);
  return static_cast<int>(rc);
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
