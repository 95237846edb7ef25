// Dense-DFT STFT power (kernel 4).
//
// Replaces the Pallas kernel tpuvae/ops/stft.py:73 (_make_kernel), launched
// by _stft_pallas_padded (:103) from stft_power_pallas (:137):
//   power[b, k, t] = (sum_n y_pad[b, t*hop + n] * w[n] * cos(2 pi k n / N))^2
//                  + (sum_n y_pad[b, t*hop + n] * w[n] * -sin(2 pi k n / N))^2
// for k = 0 .. N/2, fp32, (B, N/2 + 1, T).  The Hann window w is folded
// into the two bases on the host; y_pad is the centre-padded signal.
//
// Bound on the H100: operations.  One GEMM of M = B*T frames by N/2 + 1
// bins by K = N samples against two bases is 4*M*K*(N/2+1) fp32
// operations (347 GFLOP at 32 clips of 30 s) against 271 MB of traffic
// (0.08 ms).  On the CUDA cores that is 5.2 ms at the card's 67 TFLOP/s,
// and an fp32 FMA kernel reaches about two thirds of that rate (measured:
// 7.7 ms).  One TF32 tensor-core product keeps 10 mantissa bits, too
// few for a spectrum that feeds power_to_db with an 80 dB floor; THREE do:
// with x = hi + lo, hi = tf32(x), lo = tf32(x - hi), the sum
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi drops only the lo*lo term, 2^-22 of
// the product.  Three times the operations at the tensor cores' 495 TFLOP/s
// is 2.1 ms: this is what the TPU's matrix unit does for an fp32 dot.
//
// Design (3xTF32 on wgmma):
// * the frames of all clips are one flattened M axis (41,344 = 323 tiles
//   of 128 at 32 clips); a CTA of two warpgroups owns 128 frames x 128
//   packed bins, each warpgroup 64 frames x 256 basis rows: 128 fp32
//   running sums a thread;
// * the tensor cores add into their fp32 accumulator with truncation: kept
//   there for all 768 products of a 2,048-sample frame, the sums came out
//   low by 4e-5 of the maximum power (measured; the bias grows linearly
//   with n_fft).  So the twelve products of a 32-sample stage (wgmma
//   m64n64k8, the small terms first, the first one overwriting) build a
//   partial sum in 32 registers, and the CUDA cores add it, rounded to
//   nearest, into the running sums, 64 basis rows at a time: 4e-6 of the
//   maximum.  The partial sum is ONE array that the first product of every
//   chunk reads: zeroing it instead lets the compiler rename it per chunk
//   and spill the running sums (255 registers, 5.1 ms against 3.6);
// * the bases are constants: the host splits them into hi and lo and
//   stores them K-major, (2 * bins, K), cos and sin of a bin as ADJACENT
//   rows.  wgmma takes TF32 operands K-major only, and its accumulator
//   fragment gives a thread adjacent column pairs, so re and im of a bin
//   meet in one thread and re^2 + im^2 happens in registers;
// * the basis rows hold N/2 "packed" bins: -sin(0) is identically 0, so
//   the sin row of bin 0 carries the Nyquist bin's cosine (whose own sine
//   is 0 too).  1,025 bins become exactly 1,024 bins, 8 tiles;
// * a K step is 32 samples, one 128-byte row of the 128-byte-swizzled
//   shared layout the wgmma descriptors name.  Two stages: while one is
//   multiplied, one thread asks the TMA unit for the other's two basis
//   tiles (256 rows x 32 samples of hi and of lo, 2-D tensor maps encoded
//   at launch, completion counted on an mbarrier), and every thread copies
//   its share of the A tile with cp.async (16 bytes; 4 bytes when hop or
//   the row stride is not a multiple of 4 samples);
// * the A tile is gathered from the waveform on load: element (frame m,
//   sample n) is y_pad[b(m), t(m)*hop + n].  The (B, T, N) frame tensor
//   never exists.  A is staged as fp32 (row stride 36 floats: the fragment
//   reads are bank-conflict free), split into hi and lo in registers
//   (cvt.rna.tf32.f32) and fed to wgmma from registers, so only the bases
//   pay shared memory for both halves: 82 KB a stage, 166 KB a CTA, one
//   CTA of 201 registers a thread per SM;
// * CTAs that run together share a frame tile and walk the bin tiles
//   (bin tile fastest in the grid): the 33.6 MB of split bases stay in L2
//   and a frame tile's samples are fetched from HBM once.  The 13.2 GB
//   that cross from L2 to the SMs per launch at 32 clips cost ~0.35 of the
//   measured 3.5 ms (timed with the basis loads disabled); the barrier and
//   the four waits of every stage, and a clock that the 700 W limit holds
//   near 1.7 GHz, are the rest of the way to 2.1 ms;
// * the epilogue squares and adds in registers and stores (B, N/2+1, T)
//   directly, transposed through shared memory so that consecutive threads
//   store consecutive frames of one bin row.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int kTM = 128;            // frames per CTA, 64 per warpgroup
constexpr int kTN = 128;            // packed bins per CTA
constexpr int kCols = 2 * kTN;      // basis rows per CTA: cos, sin interleaved
constexpr int kKC = 32;             // samples per stage = one 128-byte row
constexpr int kThreads = 256;
constexpr int kAStride = 36;        // floats per staged A row
constexpr int kBBytes = kCols * 128;             // one of hi / lo, a stage
constexpr int kABytes = kTM * kAStride * 4;
constexpr int kStageBytes = 2 * kBBytes + kABytes;
constexpr int kStages = 2;
constexpr int kEpiStride = kTM + 8; // bank-conflict-free transposing writes
constexpr int kSmemBytes = 1024 + kStages * kStageBytes +
                           (kTM + kStages) * static_cast<int>(sizeof(long long));

static_assert(kStageBytes % 1024 == 0 && kBBytes % 1024 == 0,
              "swizzled tiles start on 1024-byte boundaries");
static_assert(kTN * kEpiStride * 4 <= kStages * kStageBytes,
              "epilogue tile fits the stage buffers");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one thread asks the TMA unit for a box of a 2-D tensor; the bytes that
// land are counted on the barrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
stft_dense_kernel(const float* __restrict__ y_pad, long long n_pad,
                  long long n_rows, int n_fft, int k_pad, int hop,
                  int n_frames, const __grid_constant__ CUtensorMap map_hi,
                  const __grid_constant__ CUtensorMap map_lo, int n_bin_tiles,
                  float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t smem_base = smem_u32(smem);
  // row_off[r]: offset in y_pad of the first sample of frame row r, -1
  // past the end
  long long* row_off =
      reinterpret_cast<long long*>(smem + kStages * kStageBytes);
  // full[stage]: the stage's two basis tiles have landed
  const uint32_t full = smem_u32(row_off + kTM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bin_tile = blockIdx.x % n_bin_tiles;
  const long long m0 = static_cast<long long>(blockIdx.x / n_bin_tiles) * kTM;
  const int bin0 = bin_tile * kTN;
  const int n_half = n_fft / 2;

  if (tid < kTM) {
    const long long m = m0 + tid;
    row_off[tid] = m < n_rows ? (m / n_frames) * n_pad +
                                    (m % n_frames) * static_cast<long long>(hop)
                              : -1;
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this thread's share of a stage's A tile: chunk c of rows br + 32 i
  // (16-byte path).  Thread 0 also asks the TMA unit for the two basis
  // tiles, 256 rows x 32 samples each, written in the swizzled layout.
  const int c = tid & 7;
  const int br = tid >> 3;

  auto fill = [&](int stage, int k0) {
    const uint32_t sb = smem_base + stage * kStageBytes;
    if (tid == 0) {
      mbar_expect_tx(full + 8 * stage, 2 * kBBytes);
      tma_load_2d(sb, &map_hi, k0, bin_tile * kCols, full + 8 * stage);
      tma_load_2d(sb + kBBytes, &map_lo, k0, bin_tile * kCols,
                  full + 8 * stage);
    }
    const uint32_t sa = sb + 2 * kBBytes;
    if (kVec) {
      const bool k_ok = k0 + 4 * c < n_fft;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long off = row_off[br + 32 * i];
        const bool ok = k_ok && off >= 0;
        cp_async16(sa + ((br + 32 * i) * kAStride + 4 * c) * 4,
                   ok ? y_pad + off + k0 + 4 * c : y_pad, ok ? 16 : 0);
      }
    } else {
      const bool k_ok = k0 + lane < n_fft;
#pragma unroll
      for (int i = 0; i < kTM / 8; ++i) {
        const int r = warp + 8 * i;
        const long long off = row_off[r];
        const bool ok = k_ok && off >= 0;
        cp_async4(sa + (r * kAStride + lane) * 4,
                  ok ? y_pad + off + k0 + lane : y_pad, ok ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[128], part[32];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.0f;

  // fragment rows of this thread within the CTA's 128 frames
  const int frag_row = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int frag_k = lane & 3;

  const int n_stages = k_pad / kKC;
  fill(0, 0);
  for (int s = 0; s < n_stages; ++s) {
    // stage s has landed for every thread, and every warpgroup is done
    // with stage s - 1, whose buffer the next loads overwrite
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    mbar_wait(full + 8 * (s & 1), (s >> 1) & 1);
    __syncthreads();
    if (s + 1 < n_stages) fill((s + 1) & 1, (s + 1) * kKC);

    const unsigned char* stage = smem + (s & 1) * kStageBytes;
    const float* a_tile = reinterpret_cast<const float*>(stage + 2 * kBBytes);
    uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // the m64k8 TF32 A fragment: (row, k), (row + 8, k), (row, k + 4),
      // (row + 8, k + 4)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = a_tile[(frag_row + (q & 1) * 8) * kAStride + kk * 8 +
                               frag_k + (q >> 1) * 4];
        a_hi[kk][q] = to_tf32(x);
        a_lo[kk][q] = to_tf32(x - __uint_as_float(a_hi[kk][q]));
      }
    }
    // A chunk of 64 basis rows at a time: twelve products into the partial
    // sum (small terms first; the first overwrites it), then the CUDA cores
    // add it into the running sums, rounded to nearest.
    const uint32_t sb = smem_base + (s & 1) * kStageBytes;
#pragma unroll
    for (int q = 0; q < kCols / 64; ++q) {
      const uint32_t rows = sb + q * 64 * 128;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k8(part, a_lo[kk], smem_desc(rows + kk * 32), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k8(part, a_hi[kk], smem_desc(rows + kBBytes + kk * 32),
                       1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k8(part, a_hi[kk], smem_desc(rows + kk * 32), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[q * 32 + i] += part[i];
    }
  }
  __syncthreads();

  // Epilogue.  Accumulator 4 i + {0, 1} is (re, im) of local bin
  // 4 i + lane % 4 for frame row frag_row, 4 i + {2, 3} for frag_row + 8.
  // The Nyquist bin rides in the sin row of packed bin 0: its power is
  // im^2 there, and bin 0's own power is re^2 alone.
  const long long n_bins = n_half + 1;
  float* tile = reinterpret_cast<float*>(smem);    // [kTN][kEpiStride]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float re = acc[4 * i + 2 * h];
      float im = acc[4 * i + 2 * h + 1];
      const int fl = frag_row + 8 * h;
      if (i == 0 && bin0 == 0 && frag_k == 0) {
        const long long m = m0 + fl;
        if (m < n_rows) {
          out[((m / n_frames) * n_bins + n_half) * n_frames + m % n_frames] =
              im * im;
        }
        im = 0.0f;
      }
      tile[(4 * i + frag_k) * kEpiStride + fl] = re * re + im * im;
    }
  }
  __syncthreads();
  const int st_f = tid % kTM;                      // this thread's frame row
  const long long st_m = m0 + st_f;
  if (st_m < n_rows) {
    float* dst = out + (st_m / n_frames) * n_bins * n_frames + st_m % n_frames;
    for (int bl = tid / kTM; bl < kTN; bl += kThreads / kTM) {
      const int kbin = bin0 + bl;
      if (kbin < n_half) {
        dst[static_cast<long long>(kbin) * n_frames] =
            tile[bl * kEpiStride + st_f];
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in the libcuda that the process has
// loaded already: the build links nothing beyond the CUDA runtime
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return reinterpret_cast<EncodeTiledFn>(
        lib == nullptr ? nullptr : dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// (rows, k_pad) fp32, row-major: boxes of 256 rows x 32 samples, written
// to shared memory in the 128-byte-swizzled layout
bool basis_map(CUtensorMap* map, const float* base, int rows, int k_pad) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad) * 4};
  const cuuint32_t box[2] = {kKC, kCols};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kVec>
int launch(const float* y_pad, long long n_pad, long long n_rows, int n_fft,
           int k_pad, int hop, int n_frames, const CUtensorMap& map_hi,
           const CUtensorMap& map_lo, int n_bin_tiles, float* out,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stft_dense_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_ctas = (n_rows + kTM - 1) / kTM * n_bin_tiles;
  if (n_ctas > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  stft_dense_kernel<kVec><<<static_cast<unsigned>(n_ctas), kThreads,
                            kSmemBytes, stream>>>(
      y_pad, n_pad, n_rows, n_fft, k_pad, hop, n_frames, map_hi, map_lo,
      n_bin_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y_pad (batch, n_pad) fp32, the centre-padded signal with
// n_pad >= (n_frames - 1) * hop + n_fft; b_hi, b_lo (2 * nb_pad, k_pad)
// fp32 holding TF32 values: the split window-folded bases, K-major, cos and
// sin of packed bin k in rows 2 k and 2 k + 1; nb_pad a multiple of 128
// that covers the n_fft / 2 packed bins and k_pad a multiple of 32 that
// covers n_fft, rows and columns past them zero; out (batch, n_fft / 2 + 1,
// n_frames) fp32.  n_fft must be a multiple of 16.
extern "C" int tpuvae_stft_dense(const void* y_pad, long long batch,
                                 long long n_pad, int n_fft, int hop,
                                 int n_frames, const void* b_hi,
                                 const void* b_lo, int nb_pad, int k_pad,
                                 void* out, void* stream) {
  const long long n_rows = batch * n_frames;
  if (n_rows <= 0) return 0;
  if (n_fft % 16 != 0 || nb_pad % kTN != 0 || nb_pad < n_fft / 2 ||
      k_pad % kKC != 0 || k_pad < n_fft ||
      n_pad < static_cast<long long>(n_frames - 1) * hop + n_fft)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* y = static_cast<const float*>(y_pad);
  CUtensorMap map_hi, map_lo;
  if (!basis_map(&map_hi, static_cast<const float*>(b_hi), 2 * nb_pad, k_pad) ||
      !basis_map(&map_lo, static_cast<const float*>(b_lo), 2 * nb_pad, k_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = hop % 4 == 0 && n_pad % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return vec ? launch<true>(y, n_pad, n_rows, n_fft, k_pad, hop, n_frames,
                            map_hi, map_lo, nb_pad / kTN, o, s)
             : launch<false>(y, n_pad, n_rows, n_fft, k_pad, hop, n_frames,
                             map_hi, map_lo, nb_pad / kTN, o, s);
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
