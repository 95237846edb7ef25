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
// operations (347 GFLOP at 32 clips of 30 s, 5.2 ms at the card's 67
// TFLOP/s outside the tensor cores) against 271 MB of traffic (0.08 ms).
// No tensor cores: TF32 keeps ~10 mantissa bits and the spectrum feeds
// power_to_db with an 80 dB floor.
//
// Design:
// * the frames of all clips are one flattened M axis (41,344 = 323 tiles
//   of 128 at 32 clips: no ragged frame tile per clip);
// * the A tile is gathered from the waveform on load: element (frame m,
//   sample n) is y_pad[b(m), t(m)*hop + n].  The (B, T, N) frame tensor
//   never exists; the 75% overlap of neighbouring frames is served by L2;
// * both accumulators of a bin live in the same thread: an 8 x 8 micro-
//   tile of (re, im) pairs per thread, 128 frames x 128 bins per 256-thread
//   CTA, so re^2 + im^2 happens in registers.  Per sample step a thread
//   makes 6 16-byte shared loads for 128 FMAs;
// * the basis columns hold N/2 "packed" bins: -sin(0) is identically 0, so
//   the sin column of bin 0 carries the Nyquist bin's cosine (whose own
//   sine is 0 too).  1,025 bins become exactly 1,024 columns, 8 tiles;
// * the next chunk of 16 samples is fetched into registers while the
//   current one is multiplied (one shared buffer, two barriers a chunk);
// * the epilogue squares and adds in registers and stores (B, N/2+1, T)
//   directly, transposed through shared memory 32 bins at a time so that
//   consecutive threads store consecutive frames of one bin row.
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 128;            // frames per tile
constexpr int kTN = 128;            // packed bins per tile
constexpr int kKC = 16;             // samples per staged chunk
constexpr int kThreads = 256;
constexpr int kSide = 16;           // threads per tile side
constexpr int kAStride = kTM + 4;   // keeps rows 16-byte aligned
constexpr int kARegs = kTM * kKC / kThreads;            // 8 scalars
constexpr int kBVecs = kKC * kTN / 4 / kThreads;        // 2 float4 per basis
constexpr int kEpiBins = 32;        // bin rows staged per epilogue pass
constexpr int kEpiStride = kTM + 1;
constexpr int kSmemFloats = kKC * kAStride + 2 * kKC * kTN;

static_assert(kEpiBins * kEpiStride <= kSmemFloats, "epilogue tile fits");
static_assert((kKC * kAStride) % 4 == 0, "basis tiles stay 16-byte aligned");

__global__ void __launch_bounds__(kThreads, 1)
stft_dense_kernel(const float* __restrict__ y_pad, long long n_pad,
                  long long n_rows, int n_fft, int hop, int n_frames,
                  const float* __restrict__ cos_b,
                  const float* __restrict__ sin_b, int nb_pad,
                  float* __restrict__ out) {
  __shared__ __align__(16) float smem[kSmemFloats];
  __shared__ int row_b[kTM];        // clip of each frame row, -1 past the end
  __shared__ int row_t[kTM];        // frame index within its clip
  float* As = smem;                          // [kKC][kAStride], transposed
  float* Cs = smem + kKC * kAStride;         // [kKC][kTN]
  float* Ss = Cs + kKC * kTN;                // [kKC][kTN]

  const int tid = threadIdx.x;
  const int tx = tid % kSide;       // bins tx*4 + j and 64 + tx*4 + j
  const int ty = tid / kSide;       // frames ty*4 + i and 64 + ty*4 + i
  const long long m0 = static_cast<long long>(blockIdx.x) * kTM;
  const int bin0 = blockIdx.y * kTN;
  const int n_half = n_fft / 2;

  if (tid < kTM) {
    const long long m = m0 + tid;
    if (m < n_rows) {
      row_b[tid] = static_cast<int>(m / n_frames);
      row_t[tid] = static_cast<int>(m % n_frames);
    } else {
      row_b[tid] = -1;
      row_t[tid] = 0;
    }
  }
  __syncthreads();

  // this thread's share of a chunk: 8 samples of the A tile (sample
  // a_j of rows a_r + 16 i), 2 + 2 float4 of the bases
  const int a_j = tid % kKC;
  const int a_r = tid / kKC;
  long long a_off[kARegs];
#pragma unroll
  for (int i = 0; i < kARegs; ++i) {
    const int r = a_r + i * (kThreads / kKC);
    a_off[i] = row_b[r] < 0
                   ? -1
                   : static_cast<long long>(row_b[r]) * n_pad +
                         static_cast<long long>(row_t[r]) * hop + a_j;
  }
  float a_pf[kARegs];
  float4 c_pf[kBVecs], s_pf[kBVecs];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kARegs; ++i)
      a_pf[i] = a_off[i] < 0 ? 0.f : y_pad[a_off[i] + k0];
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int f = tid + i * kThreads;
      const int kk = f / (kTN / 4);
      const int c4 = f % (kTN / 4);
      const long long g =
          static_cast<long long>(k0 + kk) * nb_pad + bin0 + c4 * 4;
      c_pf[i] = *reinterpret_cast<const float4*>(cos_b + g);
      s_pf[i] = *reinterpret_cast<const float4*>(sin_b + g);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kARegs; ++i)
      As[a_j * kAStride + a_r + i * (kThreads / kKC)] = a_pf[i];
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int f = tid + i * kThreads;
      const int kk = f / (kTN / 4);
      const int c4 = f % (kTN / 4);
      *reinterpret_cast<float4*>(Cs + kk * kTN + c4 * 4) = c_pf[i];
      *reinterpret_cast<float4*>(Ss + kk * kTN + c4 * 4) = s_pf[i];
    }
  };

  float re[8][8], im[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }

  fetch(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < n_fft; k0 += kKC) {
    const bool more = k0 + kKC < n_fft;
    if (more) fetch(k0 + kKC);
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(As + kk * kAStride + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * kAStride + 64 + ty * 4);
      const float4 c0 = *reinterpret_cast<const float4*>(Cs + kk * kTN + tx * 4);
      const float4 c1 =
          *reinterpret_cast<const float4*>(Cs + kk * kTN + 64 + tx * 4);
      const float4 s0 = *reinterpret_cast<const float4*>(Ss + kk * kTN + tx * 4);
      const float4 s1 =
          *reinterpret_cast<const float4*>(Ss + kk * kTN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          re[i][j] = fmaf(a[i], c[j], re[i][j]);
          im[i][j] = fmaf(a[i], s[j], im[i][j]);
        }
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  // The Nyquist bin rides in the sin column of packed bin 0: its power is
  // im^2 there, and bin 0's own power is re^2 alone.
  const long long n_bins = n_half + 1;
  if (bin0 == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int fl = (i / 4) * 64 + ty * 4 + (i % 4);
      if (row_b[fl] >= 0)
        out[(static_cast<long long>(row_b[fl]) * n_bins + n_half) * n_frames +
            row_t[fl]] = im[i][0] * im[i][0];
      im[i][0] = 0.f;
    }
  }

  // Epilogue: power, transposed through shared memory 32 bin rows at a
  // time; pass q covers the tile's bins [32 q, 32 q + 32), which the
  // threads with tx / 8 == q % 2 hold in columns (q / 2) * 4 + j.
  float* tile = smem;                        // [kEpiBins][kEpiStride]
  const int st_f = tid % kTM;                // this thread's frame row
  const int st_b = row_b[st_f];
  const int st_t = row_t[st_f];
#pragma unroll
  for (int q = 0; q < kTN / kEpiBins; ++q) {
    if (tx / 8 == q % 2) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int fl = (i / 4) * 64 + ty * 4 + (i % 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = (q / 2) * 4 + j;
          const int bl = (tx % 8) * 4 + j;
          tile[bl * kEpiStride + fl] =
              re[i][col] * re[i][col] + im[i][col] * im[i][col];
        }
      }
    }
    __syncthreads();
    if (st_b >= 0) {
      for (int bl = tid / kTM; bl < kEpiBins; bl += kThreads / kTM) {
        const int kbin = bin0 + q * kEpiBins + bl;
        if (kbin < n_half)
          out[(static_cast<long long>(st_b) * n_bins + kbin) * n_frames +
              st_t] = tile[bl * kEpiStride + st_f];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// y_pad (batch, n_pad) fp32, the centre-padded signal with
// n_pad >= (n_frames - 1) * hop + n_fft; cos_b, sin_b (n_fft, nb_pad) fp32,
// nb_pad a multiple of 128 that covers the n_fft / 2 packed bins, columns
// past them zero; out (batch, n_fft / 2 + 1, n_frames) fp32.  n_fft must be
// a multiple of 16.
extern "C" int tpuvae_stft_dense(const void* y_pad, long long batch,
                                 long long n_pad, int n_fft, int hop,
                                 int n_frames, const void* cos_b,
                                 const void* sin_b, int nb_pad, void* out,
                                 void* stream) {
  const long long n_rows = batch * n_frames;
  if (n_rows <= 0) return 0;
  if (n_fft % kKC != 0 || nb_pad % kTN != 0 || nb_pad < n_fft / 2 ||
      n_pad < static_cast<long long>(n_frames - 1) * hop + n_fft)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_rows + kTM - 1) / kTM),
                  static_cast<unsigned>(nb_pad / kTN));
  stft_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_pad), n_pad, n_rows, n_fft, hop, n_frames,
      static_cast<const float*>(cos_b), static_cast<const float*>(sin_b),
      nb_pad, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
