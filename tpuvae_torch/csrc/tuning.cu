// Fused per-clip chroma tuning estimation, one CTA per clip (kernel 2).
//
// Replaces the Pallas kernels tpuvae/ops/tuning.py:352 (_make_tuning_kernel)
// and :367 (_make_tuning_kernel_dma), body _tuning_body :139 — librosa's
// estimate_tuning per clip:
//   1. piptrack on the 8-aligned candidate band (rows lo8 .. lo8+r8 of the
//      clip's power spectrogram, fmask selecting 150-4000 Hz): local maxima
//      above 0.1 * colmax, parabolic shift and magnitude;
//   2. the exact masked median of the candidate magnitudes;
//   3. a 100-bin histogram vote over the pitch residuals of the candidates
//      at or above that median -> edges[first argmax] (0 when none).
//
// Bound on the H100: bytes.  The function must read the band once
// (368 x 1292 bf16 per clip at the main path, ~0.95 MB) plus colmax.  The
// band does not fit shared memory, so the CTA makes six passes over it
// (four radix digits, one rank-neighbour pass, one vote pass), recomputing
// piptrack in each instead of storing keys: a whole 32-clip batch of band
// rows (~30 MB) stays resident in the 50 MB L2, so HBM sees it about once
// and the recompute is a few dozen flops per element.
//
// Bit-exactness: this file is compiled with -fmad=false so every multiply
// and add rounds on its own, in the order of the plain PyTorch version
// (tpuvae_torch/dsp/chroma.py) and of the JAX reference.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "radix_select.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxVoteBins = 256;
constexpr float kTiny = 1.17549435e-38f;  // np.finfo(np.float32).tiny

__device__ __forceinline__ float load_power(const float* p) { return *p; }
__device__ __forceinline__ float load_power(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Params {
  const float* colmax;   // (B, T)
  const float* fmask;    // (r8,)
  const float* binsb;    // (r8,) global bin index of each band row
  const float* edges;    // (n_bins,)
  float* out;            // (B,)
  long long n_rows;      // rows of the power input (n_fft // 2 + 1)
  int t;                 // frames
  int lo8, r8;
  int n_bins;
  float binw, scale, bins_per_octave, threshold;
};

template <typename T>
struct Band {
  const T* p;            // this clip's (n_rows, t) power
  const float* colmax;   // this clip's (t,)
  Params prm;

  __device__ float s(int r, int c) const {
    return load_power(p + static_cast<long long>(prm.lo8 + r) * prm.t + c);
  }

  // piptrack at band row r, frame c: candidate mask, pitch (Hz), magnitude
  __device__ void pip(int r, int c, bool& m, float& pitch, float& mag) const {
    const int R = prm.r8;
    const float refmax = prm.threshold * colmax[c];
    const float sc = s(r, c);
    const float sl = r > 0 ? s(r - 1, c) : sc;
    const float sr = r < R - 1 ? s(r + 1, c) : sc;
    const float st = sc > refmax ? sc : 0.0f;
    const float stl = sl > refmax ? sl : 0.0f;
    const float str = sr > refmax ? sr : 0.0f;
    m = (st > stl) && (st >= str) && (prm.fmask[r] > 0.5f);
    float avg = 0.0f;
    float shift = 0.0f;
    if (r > 0 && r < R - 1) {
      avg = 0.5f * (sr - sl);
      const float den = 2.0f * sc - sr - sl;
      shift = avg / (den + (fabsf(den) < kTiny ? 1.0f : 0.0f));
    }
    const float dskew = 0.5f * avg * shift;
    pitch = m ? (prm.binsb[r] + shift) * prm.scale : 0.0f;
    mag = m ? sc + dskew : 0.0f;
  }

  // biased int32 key of the candidate magnitude; sentinel off the mask
  __device__ int32_t operator()(long long i, bool& counted) const {
    const int r = static_cast<int>(i / prm.t);
    const int c = static_cast<int>(i - static_cast<long long>(r) * prm.t);
    float pitch, mag;
    pip(r, c, counted, pitch, mag);
    return counted ? tpuvae::float_order_key(mag) : tpuvae::kKeySentinel;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
tuning_kernel(const T* __restrict__ power, Params prm) {
  __shared__ tpuvae::SelectScratch sc;
  __shared__ uint32_t vote[kMaxVoteBins];
  __shared__ float thresh_s;

  const int b = blockIdx.x;
  const Band<T> band{power + static_cast<long long>(b) * prm.n_rows * prm.t,
                     prm.colmax + static_cast<long long>(b) * prm.t, prm};
  const long long n_elems = static_cast<long long>(prm.r8) * prm.t;

  // exact masked median of the candidate magnitudes
  int n = 0;
  const int32_t key_lo = tpuvae::block_median_rank_key(band, n_elems, &sc, &n);
  int cnt_le = 0;
  int32_t min_above = 0;
  tpuvae::block_rank_neighbours(band, n_elems, key_lo, &sc, &cnt_le, &min_above);
  if (threadIdx.x == 0) {
    const int k_lo = n > 0 ? (n - 1) / 2 : 0;
    const int k_hi = n / 2;
    const float v_lo = tpuvae::key_to_float(key_lo);
    const float v_next = tpuvae::key_to_float(min_above);
    const float v_hi = (k_hi == k_lo || cnt_le >= k_hi + 1) ? v_lo : v_next;
    thresh_s = n > 0 ? 0.5f * (v_lo + v_hi) : 0.0f;
  }
  for (int i = threadIdx.x; i < kMaxVoteBins; i += blockDim.x) vote[i] = 0;
  if (threadIdx.x == 0) sc.count = 0;
  __syncthreads();
  const float thresh = thresh_s;

  // residual histogram vote over candidates with magnitude >= median
  int n_sel = 0;
  for (long long base = 0; base < n_elems; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    bool sel = false;
    uint32_t bucket = 0;
    if (i < n_elems) {
      const int r = static_cast<int>(i / prm.t);
      const int c = static_cast<int>(i - static_cast<long long>(r) * prm.t);
      bool m;
      float pitch, mag;
      band.pip(r, c, m, pitch, mag);
      sel = m && (mag >= thresh);
      const float safe_p = sel ? pitch : 440.0f;
      const float octs = log2f(16.0f * safe_p / 440.0f);
      float res = fmodf(prm.bins_per_octave * octs, 1.0f);
      if (res != 0.0f && res < 0.0f) res = res + 1.0f;
      if (res >= 0.5f) res = res - 1.0f;
      float q = floorf((res + 0.5f) / prm.binw);
      q = fminf(fmaxf(q, 0.0f), static_cast<float>(prm.n_bins - 1));
      bucket = static_cast<uint32_t>(q);
      n_sel += sel ? 1 : 0;
    }
    tpuvae::hist_add(vote, bucket, sel);
  }
  n_sel = tpuvae::warp_sum(n_sel);
  if ((threadIdx.x & 31) == 0) atomicAdd(&sc.count, n_sel);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t best = 0;
    int arg = 0;
    for (int j = 0; j < prm.n_bins; ++j) {
      if (vote[j] > best) {
        best = vote[j];
        arg = j;
      }
    }
    prm.out[b] = sc.count > 0 ? prm.edges[arg] : 0.0f;
  }
}

}  // namespace

extern "C" int tpuvae_tuning(const void* power, int power_bf16,
                             const void* colmax, long long batch,
                             long long n_rows, int t, int lo8, int r8,
                             const void* fmask, const void* binsb,
                             const void* edges, int n_bins, float binw,
                             float scale, float bins_per_octave,
                             float threshold, void* out, void* stream) {
  if (batch <= 0) return 0;
  if (n_bins > kMaxVoteBins) return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.colmax = static_cast<const float*>(colmax);
  prm.fmask = static_cast<const float*>(fmask);
  prm.binsb = static_cast<const float*>(binsb);
  prm.edges = static_cast<const float*>(edges);
  prm.out = static_cast<float*>(out);
  prm.n_rows = n_rows;
  prm.t = t;
  prm.lo8 = lo8;
  prm.r8 = r8;
  prm.n_bins = n_bins;
  prm.binw = binw;
  prm.scale = scale;
  prm.bins_per_octave = bins_per_octave;
  prm.threshold = threshold;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(batch);
  if (power_bf16) {
    tuning_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(power), prm);
  } else {
    tuning_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(power), prm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
