// Fused per-clip chroma tuning estimation on a thread block cluster per
// clip (kernel 2).
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
// (368 x 1292 bf16 per clip at the main path, ~0.95 MB) plus colmax: 30.6
// MB, 0.009 ms at 32 clips.
//
// Design: a cluster of 8 CTAs of 1024 threads per clip, CTA r owning the
// frames [r F, (r + 1) F), F = ceil(T / 8), so that 32 clips fill 256 SMs'
// worth of CTAs where one CTA per clip left three quarters of the card idle.
// * piptrack runs ONCE per band element: a thread walks down the rows of
//   one frame (a chunk of them) with a sliding window of three magnitudes,
//   one load per element, kRowsAhead of them in flight at once, the frames
//   of a warp neighbours in memory.  The
//   parabolic shift, pitch, order key and vote bucket are computed for the
//   candidates only.
// * Candidates are compacted into the CTA's shared memory as (int32 order
//   key, uint8 vote bucket), a warp's at once (ballot, one atomic).  The
//   capacity is exact, not a guess: a candidate at row r needs st[r] >
//   st[r-1] and st[r] >= st[r+1], so rows r and r+1 are never both
//   candidates and row 0 never is, and a frame holds at most ceil(r8 / 2).
//   F ceil(r8 / 2) entries of 5 bytes are 149 KB at the main path.  When a
//   clip's frames need more than a CTA's shared memory, the wrapper hands a
//   global buffer of the same layout and the same code writes there.
// * The median is a radix select over the compacted keys only, its digit
//   histograms merged across the cluster through distributed shared memory
//   (cluster_select.cuh); the vote counts the compacted candidates whose
//   magnitude, compared as a float as the plain version does (+0 and -0
//   order differently as keys), reaches the median, and rank 0 merges the
//   cluster's vote histograms and takes the first argmax in parallel.
// * The median is an order statistic and the vote a count: neither depends
//   on the order in which candidates are compacted or counted, and all
//   merges add integers.
//
// Bit-exactness: this file is compiled with -fmad=false so every multiply
// and add rounds on its own, in the order of the plain PyTorch version
// (tpuvae_torch/dsp/chroma.py) and of the JAX reference.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster_select.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kMaxVoteBins = 256;
constexpr int kRowsAhead = 8;            // band rows a thread loads at once
constexpr float kTiny = 1.17549435e-38f;  // np.finfo(np.float32).tiny
// the largest compacted list a CTA keeps in shared memory (5 bytes an
// entry), beside its static scratch; ops/tuning.py holds the same number
constexpr int kSmemListEntries = 44000;

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
  int32_t* keys_g;       // (B * kCluster, capacity) or null: shared memory
  uint8_t* buckets_g;
  long long n_rows;      // rows of the power input (n_fft // 2 + 1)
  int t;                 // frames
  int lo8, r8;
  int frames_per_cta;    // F
  int capacity;          // list entries a CTA may need: F * ceil(r8 / 2)
  int n_bins;
  float binw, scale, bins_per_octave, threshold;
};

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
tuning_kernel(const T* __restrict__ power, Params prm) {
  extern __shared__ __align__(16) unsigned char list_smem[];
  __shared__ tpuvae::ClusterSelectScratch sc;
  __shared__ uint32_t vote[kMaxVoteBins];
  __shared__ int n_local;
  __shared__ unsigned long long best;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  int32_t* keys;
  uint8_t* buckets;
  if (prm.keys_g != nullptr) {
    keys = prm.keys_g + static_cast<size_t>(blockIdx.x) * prm.capacity;
    buckets = prm.buckets_g + static_cast<size_t>(blockIdx.x) * prm.capacity;
  } else {
    keys = reinterpret_cast<int32_t*>(list_smem);
    buckets = list_smem + static_cast<size_t>(prm.capacity) * 4;
  }
  for (int i = tid; i < kMaxVoteBins; i += kThreads) vote[i] = 0;
  if (tid == 0) {
    n_local = 0;
    best = 0;
  }
  __syncthreads();

  // ---- piptrack over this CTA's frames, candidates compacted -------------
  const int R = prm.r8;
  const int F = prm.frames_per_cta;
  const int f0 = rank * F;
  const int nf = max(0, min(F, prm.t - f0));
  const int n_chunks = max(1, kThreads / F);       // row chunks of a frame
  const int rows_per = (R + n_chunks - 1) / n_chunks;
  const int items = F * n_chunks;
  const T* band = power + static_cast<size_t>(b) * prm.n_rows * prm.t +
                  static_cast<size_t>(prm.lo8) * prm.t;
  const float* colmax = prm.colmax + static_cast<size_t>(b) * prm.t;
  for (int base = 0; base < items; base += kThreads) {
    const int item = base + tid;
    const int fi = item % F;
    const int chunk = item / F;
    const int c = f0 + fi;
    const int r_beg = chunk * rows_per;
    const bool col_ok = item < items && fi < nf && r_beg < R;
    const T* col = band + c;
    float refmax = 0.0f, sl = 0.0f, sc_ = 0.0f;
    if (col_ok) {
      refmax = prm.threshold * colmax[c];
      sc_ = load_power(col + static_cast<size_t>(r_beg) * prm.t);
      sl = r_beg > 0 ? load_power(col + static_cast<size_t>(r_beg - 1) * prm.t)
                     : sc_;
    }
    for (int it0 = 0; it0 < rows_per; it0 += kRowsAhead) {
      // the next kRowsAhead rows' loads in flight together
      float ahead[kRowsAhead];
#pragma unroll
      for (int j = 0; j < kRowsAhead; ++j) {
        const int r = r_beg + it0 + j;
        ahead[j] = (col_ok && it0 + j < rows_per && r < R - 1)
                       ? load_power(col + static_cast<size_t>(r + 1) * prm.t)
                       : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kRowsAhead; ++j) {
        if (it0 + j >= rows_per) break;     // the same for every thread
        const int r = r_beg + it0 + j;
        const bool ok = col_ok && r < R;
        const float sr = (ok && r < R - 1) ? ahead[j] : sc_;
        bool m = false;
        int32_t key = 0;
        uint32_t bucket = 0;
        if (ok) {
          const float st = sc_ > refmax ? sc_ : 0.0f;
          const float stl = sl > refmax ? sl : 0.0f;
          const float str = sr > refmax ? sr : 0.0f;
          m = (st > stl) && (st >= str) && (prm.fmask[r] > 0.5f);
          if (m) {
            float avg = 0.0f;
            float shift = 0.0f;
            if (r > 0 && r < R - 1) {
              avg = 0.5f * (sr - sl);
              const float den = 2.0f * sc_ - sr - sl;
              shift = avg / (den + (fabsf(den) < kTiny ? 1.0f : 0.0f));
            }
            const float dskew = 0.5f * avg * shift;
            const float pitch = (prm.binsb[r] + shift) * prm.scale;
            const float mag = sc_ + dskew;
            key = tpuvae::float_order_key(mag);
            const float octs = log2f(16.0f * pitch / 440.0f);
            float res = fmodf(prm.bins_per_octave * octs, 1.0f);
            if (res != 0.0f && res < 0.0f) res = res + 1.0f;
            if (res >= 0.5f) res = res - 1.0f;
            float q = floorf((res + 0.5f) / prm.binw);
            q = fminf(fmaxf(q, 0.0f), static_cast<float>(prm.n_bins - 1));
            bucket = static_cast<uint32_t>(q);
          }
        }
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, m);
        if (ballot != 0u) {
          int at = 0;
          if (lane == 0) at = atomicAdd(&n_local, __popc(ballot));
          at = __shfl_sync(0xFFFFFFFFu, at, 0) +
               __popc(ballot & ((1u << lane) - 1u));
          if (m) {
            keys[at] = key;
            buckets[at] = static_cast<uint8_t>(bucket);
          }
        }
        sl = sc_;
        sc_ = sr;
      }
    }
  }
  __syncthreads();
  const int n_mine = n_local;

  // ---- exact masked median across the cluster ----------------------------
  const tpuvae::MedianRank med = tpuvae::cluster_median_rank(keys, n_mine, &sc);
  if (med.n == 0) {
    if (rank == 0 && tid == 0) prm.out[b] = 0.0f;
    return;                         // no CTA reads another's memory any more
  }
  const int k_lo = (med.n - 1) / 2;
  const int k_hi = med.n / 2;
  const float v_lo = tpuvae::key_to_float(med.key_lo);
  const float v_next = tpuvae::key_to_float(med.min_above);
  const float v_hi = (k_hi == k_lo || med.cnt_le >= k_hi + 1) ? v_lo : v_next;
  const float thresh = 0.5f * (v_lo + v_hi);

  // ---- residual histogram vote over candidates with magnitude >= median --
  for (int base = 0; base < n_mine; base += kThreads) {
    const int i = base + tid;
    bool sel = false;
    uint32_t bucket = 0;
    if (i < n_mine) {
      sel = tpuvae::key_to_float(keys[i]) >= thresh;
      bucket = buckets[i];
    }
    tpuvae::hist_add(vote, bucket, sel);
  }
  __syncthreads();
  cluster.sync();                   // every CTA's vote is complete
  if (rank == 0) {
    // the first argmax of the merged vote: the largest (count, -bin)
    unsigned long long v = 0;
    if (tid < prm.n_bins) {
      uint32_t count = 0;
      for (int r = 0; r < kCluster; ++r) count += cluster.map_shared_rank(vote, r)[tid];
      v = (static_cast<unsigned long long>(count) << 32) |
          static_cast<unsigned long long>(kMaxVoteBins - 1 - tid);
    }
    if (tid < kMaxVoteBins) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, v, o);
        v = other > v ? other : v;
      }
      if (lane == 0) atomicMax(&best, v);
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t count = static_cast<uint32_t>(best >> 32);
      const int arg = kMaxVoteBins - 1 - static_cast<int>(best & 0xFFFFFFFFull);
      prm.out[b] = count > 0 ? prm.edges[arg] : 0.0f;
    }
  }
  cluster.sync();                   // rank 0 has read every CTA's vote
}

}  // namespace

// `keys_g` / `buckets_g`: null (lists in shared memory) or the global lists
// of `list_entries` entries each, at least batch * kCluster * capacity.
extern "C" int tpuvae_tuning(const void* power, int power_bf16,
                             const void* colmax, long long batch,
                             long long n_rows, int t, int lo8, int r8,
                             const void* fmask, const void* binsb,
                             const void* edges, int n_bins, float binw,
                             float scale, float bins_per_octave,
                             float threshold, int frames_per_cta, int capacity,
                             void* keys_g, void* buckets_g,
                             long long list_entries, void* out, void* stream) {
  if (batch <= 0) return 0;
  if (n_bins <= 0 || n_bins > kMaxVoteBins || r8 <= 0 || t < 0 ||
      frames_per_cta <= 0 ||
      static_cast<long long>(frames_per_cta) * kCluster < t ||
      static_cast<long long>(capacity) <
          static_cast<long long>(frames_per_cta) * ((r8 + 1) / 2) ||
      (keys_g == nullptr) != (buckets_g == nullptr) ||
      (keys_g == nullptr && capacity > kSmemListEntries) ||
      (keys_g != nullptr &&
       list_entries < batch * kCluster * static_cast<long long>(capacity)) ||
      batch * kCluster > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.colmax = static_cast<const float*>(colmax);
  prm.fmask = static_cast<const float*>(fmask);
  prm.binsb = static_cast<const float*>(binsb);
  prm.edges = static_cast<const float*>(edges);
  prm.out = static_cast<float*>(out);
  prm.keys_g = static_cast<int32_t*>(keys_g);
  prm.buckets_g = static_cast<uint8_t*>(buckets_g);
  prm.n_rows = n_rows;
  prm.t = t;
  prm.lo8 = lo8;
  prm.r8 = r8;
  prm.frames_per_cta = frames_per_cta;
  prm.capacity = capacity;
  prm.n_bins = n_bins;
  prm.binw = binw;
  prm.scale = scale;
  prm.bins_per_octave = bins_per_octave;
  prm.threshold = threshold;
  const size_t smem = keys_g == nullptr ? static_cast<size_t>(capacity) * 5 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(batch * kCluster);
  cudaError_t rc;
  if (power_bf16) {
    rc = cudaFuncSetAttribute(tuning_kernel<__nv_bfloat16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    tuning_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(power), prm);
  } else {
    rc = cudaFuncSetAttribute(tuning_kernel<float>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    tuning_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(power), prm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
