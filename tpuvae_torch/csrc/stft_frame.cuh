// What kernel 1's plans share (csrc/stft_features.cu, csrc/stft_small.cu,
// csrc/stft_large.cuh):
// the parameters, the stored-type tile, the warp reductions, the
// power-of-two FFT in registers, the real-input split's arithmetic, the
// frame loader of the plans that take n_fft / 2 = 32 n points (zcr, rms,
// window), the 32-point DFT across a warp's lanes, the per-frame epilogue
// (statistics, mel projection, rolloff) over a warp's or a group's fp32
// power row and the T-contiguous power store.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kTiny = 1.17549435e-38f;  // np.finfo(np.float32).tiny
constexpr float kRollPercent = 0.85f;
constexpr float kZcrThreshold = 1e-10f;

constexpr size_t kSmemPerSm = 233472;         // 228 KB of shared memory
constexpr size_t kSmemPerCta = 232448;        // 227 KB, one CTA an SM
constexpr size_t kSmemTwoCtas = 115712;       // (228 KB - 2 x 1 KB) / 2

template <typename TOut>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kFrames = 32;
  static __device__ __forceinline__ __nv_bfloat16 cast(float v) {
    return __float2bfloat16(v);
  }
};
template <>
struct Tile<float> {
  static constexpr int kFrames = 16;
  static __device__ __forceinline__ float cast(float v) { return v; }
};

struct Params {
  const float* y;          // (B, n_samples) waveform, or its padded rows
  const float* window;     // (n_fft,) periodic Hann
  const float2* twiddle;   // (m + 1,) exp(-2 pi i k / n_fft): the split
  const float2* xtw;       // 2048: (32, 32) [k1][l] exp(-2 pi i l k1 / 1024);
                           // m = 32 r: (r + 5, 32), exp(-2 pi i l k1 / m)
                           // then the lane twiddles; shared: (m,)
                           // exp(-2 pi i k / m)
  const int* iperm;        // shared plan: (m,) position of point n
  const float* freqs;      // (n_bins,) bin centre frequencies
  const float* mel_w;      // (mel_nnz,) each filter's non-zero weights
  const int* mel_meta;     // (n_mels, 3) first bin, one past last, offset
  void* power;             // (B, n_bins, n_frames) bf16 or fp32
  float* mel;              // (B, n_mels, n_frames) or null (power only)
  float* stats;            // (6, B, n_frames): centroid, bandwidth,
                           // rolloff, zcr, rms, colmax; or null
  long long n_samples;     // samples a row of y holds (padded or not)
  long long origin;        // where a row's first true sample sits
  long long n_true;        // true samples a row (zcr's range)
  int n_frames;
  int hop;
  int n_mels;
  int mel_nnz;
  int vec2;                // frames start 8-byte aligned
  int m;                   // complex points, n_fft / 2
  int frames;              // frames a CTA (a power of two <= 32)
  long long plan;          // shared plan: the radices, 6 bits each
};

// The C entry points' arguments, checked, as Params; returns 0 or a CUDA
// error code.
inline int make_params(Params& p, const void* y, long long batch,
                       long long n_samples, long long origin,
                       long long n_true, int n_fft, int hop, int n_frames,
                       const void* window, const void* twiddle,
                       const void* xtw, const void* iperm, long long plan,
                       const void* freqs, const void* mel_w,
                       const void* mel_meta, int n_mels, int mel_nnz,
                       void* power, void* mel, void* stats) {
  if (batch > 65535 || hop <= 0 || mel_nnz < 0 || mel_nnz > 16384 ||
      n_fft < 256 || n_fft > 5888 || n_fft % 256 != 0 || origin < 0 ||
      n_true <= 0 || origin + n_true > n_samples) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.y = static_cast<const float*>(y);
  p.window = static_cast<const float*>(window);
  p.twiddle = static_cast<const float2*>(twiddle);
  p.xtw = static_cast<const float2*>(xtw);
  p.iperm = static_cast<const int*>(iperm);
  p.freqs = static_cast<const float*>(freqs);
  p.mel_w = static_cast<const float*>(mel_w);
  p.mel_meta = static_cast<const int*>(mel_meta);
  p.power = power;
  p.mel = static_cast<float*>(mel);
  p.stats = static_cast<float*>(stats);
  p.n_samples = n_samples;
  p.origin = origin;
  p.n_true = n_true;
  p.n_frames = n_frames;
  p.hop = hop;
  p.n_mels = stats != nullptr ? n_mels : 0;
  p.mel_nnz = stats != nullptr ? mel_nnz : 0;
  p.vec2 = ((n_samples | hop | origin) & 1) == 0 &&
           reinterpret_cast<uintptr_t>(y) % 8 == 0;
  p.m = n_fft / 2;
  p.frames = 0;
  p.plan = plan;
  return 0;
}

// Sets a kernel's dynamic shared memory and asks for the carveout that
// `resident` bytes of CTAs take and no more: the rest of the SM's 256 KB
// stays L1 for the tables read through the read-only path.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem, size_t resident) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int carveout = static_cast<int>(
      (resident * 100 + kSmemPerSm - 1) / kSmemPerSm);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              carveout < 100 ? carveout : 100);
}

__device__ __forceinline__ bool zcr_sign(float x) {
  return signbit(fabsf(x) <= kZcrThreshold ? 0.0f : x);
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

__host__ __device__ constexpr int brev5(int k) {
  return ((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) |
         ((k & 16) >> 4);
}

__host__ __device__ constexpr int brev_bits(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

template <int R>
struct Log2 {
  static constexpr int value = 1 + Log2<R / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// A frame's points sit one word of padding per 32 apart, so that the
// first stage's reads at a stride of the radix spread over the 32 banks.
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// One radix-2 decimation-in-frequency stage of an R-point FFT held in
// registers, R a power of two <= 32: W_R^t = W_32^(t 32 / R).  Every index
// and twiddle is a compile-time constant after unrolling.  After stages
// 0 .. log2(R) - 1 register i holds X[brev(i)].
template <int R, int S>
__device__ __forceinline__ void fftp2_stage(float (&re)[R], float (&im)[R]) {
  constexpr float kC[16] = {
      1.0f, 0.98078528040323043f, 0.92387953251128674f, 0.83146961230254524f,
      0.70710678118654752f, 0.55557023301960218f, 0.38268343236508978f,
      0.19509032201612825f, 0.0f, -0.19509032201612825f,
      -0.38268343236508978f, -0.55557023301960218f, -0.70710678118654752f,
      -0.83146961230254524f, -0.92387953251128674f, -0.98078528040323043f};
  constexpr float kS[16] = {
      0.0f, 0.19509032201612825f, 0.38268343236508978f, 0.55557023301960218f,
      0.70710678118654752f, 0.83146961230254524f, 0.92387953251128674f,
      0.98078528040323043f, 1.0f, 0.98078528040323043f, 0.92387953251128674f,
      0.83146961230254524f, 0.70710678118654752f, 0.55557023301960218f,
      0.38268343236508978f, 0.19509032201612825f};
  constexpr int half = (R / 2) >> S;
#pragma unroll
  for (int g = 0; g < (1 << S); ++g) {
#pragma unroll
    for (int q = 0; q < half; ++q) {
      const int i0 = g * 2 * half + q;
      const int i1 = i0 + half;
      const int t = (q << S) * (32 / R);
      const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
      const float dr = ar - br, di = ai - bi;
      re[i0] = ar + br;
      im[i0] = ai + bi;
      if (t == 0) {
        re[i1] = dr;
        im[i1] = di;
      } else if (t == 8) {
        re[i1] = di;
        im[i1] = -dr;
      } else {
        re[i1] = dr * kC[t] + di * kS[t];
        im[i1] = di * kC[t] - dr * kS[t];
      }
    }
  }
}

template <int R, int S = 0>
__device__ __forceinline__ void fftp2(float (&re)[R], float (&im)[R]) {
  if constexpr ((1 << S) < R) {
    fftp2_stage<R, S>(re, im);
    fftp2<R, S + 1>(re, im);
  }
}

// Power of bin k of the real-input split from Z[k] and its partner
// Z[m - k]: X[k] = E[k] + W_N^k O[k] (the register plan's arithmetic).
__device__ __forceinline__ float split_power(float zkr, float zki, float zmr,
                                             float zmi, float2 w) {
  const float er = 0.5f * (zkr + zmr);
  const float ei = 0.5f * (zki - zmi);
  const float orr = 0.5f * (zki + zmi);
  const float oi = -0.5f * (zkr - zmr);
  const float xr = er + (w.x * orr - w.y * oi);
  const float xi = ei + (w.x * oi + w.y * orr);
  return xr * xr + xi * xi;
}

// The 32-point DFT over the lanes of each of a lane's R values: radix-2
// decimation in frequency, stage s pairing lane l with l ^ d, d = 16 >> s;
// the lower lane keeps the sum, the upper one the difference times
// ltw[s][l] (1 for the lower).  Lane l ends holding X[brev5(l)].
template <int R>
__device__ __forceinline__ void lane_fft32(float (&re)[R], float (&im)[R],
                                           const float2* __restrict__ ltw,
                                           int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int d = 16 >> s;
    const float2 w = __ldg(ltw + 32 * s + lane);
    const float sg = (lane & d) ? -1.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float pr = __shfl_xor_sync(kFull, re[k], d);
      const float pi = __shfl_xor_sync(kFull, im[k], d);
      const float tr = pr + sg * re[k];
      const float ti = pi + sg * im[k];
      re[k] = tr * w.x - ti * w.y;
      im[k] = tr * w.y + ti * w.x;
    }
  }
}

// Loads the frame of clip row y (n_s samples) that starts at sample
// `start` over the kStride threads of the frame (a warp, or the group of four
// warps of the register plan of csrc/stft_large.cuh): thread `thread` takes
// the complex points n = thread + kStride it, it < m / kStride (samples 2 n
// and 2 n + 1), coalesced, four a thread in flight; `interior`: the frame
// lies inside the row.  With the epilogue it counts the zero crossings
// (pairs inside the true samples, which start at start_t and end at
// last_t: librosa's edges) and sums the squares for rms.  Each windowed
// point goes to put(it, pos(n), re, im); pos is read with the loads.  The
// loop unrolls where m is a compile-time constant (the points then stay in
// registers) and not at all where it is not, as the shared-memory plan's
// own loop did.  A warp's frame gets zcr and rms; a group's frame gets its
// warp's crossings and sum of squares, which the group adds up.
template <int kStride = 32, typename Pos, typename Put>
__device__ __forceinline__ void load_frame(
    const Params& p, const float* y, long long n_s, const float2* win2,
    long long start, long long start_t, long long last_t, bool interior,
    int m, int thread, bool fused, Pos pos, Put put, float& zcr,
    float& rms) {
  const int lane = kStride == 32 ? thread : (thread & 31);
  float sumsq = 0.0f;
  int crossings = 0, prev_sign = 0;
#pragma unroll
  for (int it0 = 0; it0 < m / kStride; it0 += 4) {
    float av[4], cv[4];
    float2 wv[4];
    int posv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (kStride != 32 && it0 + u >= m / kStride) break;
      const int n = thread + kStride * (it0 + u);
      const long long s0 = start + 2 * n;
      if (interior && p.vec2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(y + s0));
        av[u] = v.x;
        cv[u] = v.y;
      } else {
        av[u] = (s0 >= 0 && s0 < n_s) ? __ldg(y + s0) : 0.0f;
        cv[u] = (s0 + 1 >= 0 && s0 + 1 < n_s) ? __ldg(y + s0 + 1) : 0.0f;
      }
      wv[u] = __ldg(win2 + n);
      posv[u] = pos(n);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = it0 + u;
      if (kStride != 32 && it >= m / kStride) break;
      const int n = thread + kStride * it;
      const float a = av[u], c = cv[u];
      if (fused) {
        // pairs (s, s + 1) count only inside the true samples
        sumsq += a * a + c * c;
        const int sa = zcr_sign(a), sc = zcr_sign(c);
        const long long st = start_t + 2 * n;
        crossings += sa != sc && st >= 0 && st + 1 <= last_t;
        const int next = __shfl_down_sync(kFull, sa, 1);
        if constexpr (kStride == 32) {
          const int first = __shfl_sync(kFull, sa, 0);
          if (lane < 31) {
            crossings += sc != next && st + 1 >= 0 && st + 2 <= last_t;
          } else if (it > 0) {
            // the pair after lane 31's previous point: lane 0's first sample
            const long long sp = st - 63;
            crossings += prev_sign != first && sp >= 0 && sp + 1 <= last_t;
          }
          prev_sign = sc;
        } else {
          if (lane < 31) {
            crossings += sc != next && st + 1 >= 0 && st + 2 <= last_t;
          } else if (n + 1 < m) {
            // point n + 1 is another warp's: its first sample read again
            const long long s2 = start + 2 * n + 2;
            const float a2 = (s2 >= 0 && s2 < n_s) ? __ldg(y + s2) : 0.0f;
            crossings +=
                sc != zcr_sign(a2) && st + 1 >= 0 && st + 2 <= last_t;
          }
        }
      }
      put(it, posv[u], a * wv[u].x, c * wv[u].y);
    }
  }
  zcr = 0.0f;
  rms = 0.0f;
  if (fused) {
    sumsq = warp_sum_f(sumsq);
    for (int o = 16; o > 0; o >>= 1) {
      crossings += __shfl_xor_sync(kFull, crossings, o);
    }
    if constexpr (kStride == 32) {
      zcr = static_cast<float>(crossings) / static_cast<float>(2 * m);
      rms = sqrtf(sumsq / static_cast<float>(2 * m));
    } else {
      zcr = static_cast<float>(crossings);
      rms = sumsq;
    }
  }
}

// The epilogue of frame f of clip b from the warp's fp32 power row pw (bin
// k at pad32(k), nb bins): centroid, bandwidth, colmax, the mel projection
// over each filter's non-zero bins, and the 85% rolloff (magnitudes replace
// the powers; a contiguous chunk per lane, then a warp scan).  Lane 0
// writes the six statistics.
__device__ __forceinline__ void frame_epilogue(float* pw, int nb,
                                               const Params& p,
                                               const float* melw, int b,
                                               int f, float zcr, float rms,
                                               int lane, long long plane) {
  // ---- magnitude statistics from the fp32 power row -----------------------
  float den = 0.0f, num = 0.0f, cmax = 0.0f;
#pragma unroll 4
  for (int k = lane; k < nb; k += 32) {
    const float pwk = pw[pad32(k)];
    const float mg = sqrtf(pwk);
    den += mg;
    num += mg * __ldg(p.freqs + k);
    cmax = fmaxf(cmax, pwk);
  }
  den = warp_sum_f(den);
  num = warp_sum_f(num);
  cmax = warp_max_f(cmax);
  const float cent = num / fmaxf(den, kTiny);
  float dev2 = 0.0f;
#pragma unroll 4
  for (int k = lane; k < nb; k += 32) {
    const float dev = fabsf(__ldg(p.freqs + k) - cent);
    dev2 += sqrtf(pw[pad32(k)]) * dev * dev;
  }
  dev2 = warp_sum_f(dev2);
  const float bw = sqrtf(dev2 / fmaxf(den, kTiny));

  // ---- mel projection over each filter's non-zero bins --------------------
  const long long mbase =
      static_cast<long long>(b) * p.n_mels * p.n_frames + f;
  for (int mi = lane; mi < p.n_mels; mi += 32) {
    const int k0 = __ldg(p.mel_meta + 3 * mi);
    const int k1 = __ldg(p.mel_meta + 3 * mi + 1);
    const int off = __ldg(p.mel_meta + 3 * mi + 2) - k0;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) acc += melw[off + k] * pw[pad32(k)];
    p.mel[mbase + static_cast<long long>(mi) * p.n_frames] = acc;
  }
  __syncwarp();

  // ---- rolloff: magnitudes replace the powers; a contiguous chunk per
  //      lane, then a warp scan --------------------------------------------
  for (int k0 = lane; k0 < nb; k0 += 128) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 32 * u;
      v[u] = k < nb ? pw[pad32(k)] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 32 * u;
      if (k < nb) pw[pad32(k)] = sqrtf(v[u]);
    }
  }
  __syncwarp();
  const int chunk = (nb + 31) / 32;
  const int kb = lane * chunk;
  float csum = 0.0f;
#pragma unroll 4
  for (int i = 0; i < chunk; ++i) {
    csum += kb + i < nb ? pw[pad32(kb + i)] : 0.0f;
  }
  float incl = csum;
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  const float thresh = kRollPercent * den;
  float run = incl - csum;
  int found = nb;
#pragma unroll 4
  for (int i = 0; i < chunk; ++i) {
    const bool in = kb + i < nb;
    run += in ? pw[pad32(kb + i)] : 0.0f;
    if (found == nb && in && run >= thresh) found = kb + i;
  }
  for (int o = 16; o > 0; o >>= 1) {
    found = min(found, __shfl_xor_sync(kFull, found, o));
  }
  if (lane == 0) {
    float* st = p.stats + static_cast<long long>(b) * p.n_frames + f;
    st[0] = cent;
    st[plane] = bw;
    st[2 * plane] = found < nb ? __ldg(p.freqs + found) : FLT_MAX;
    st[3 * plane] = zcr;
    st[4 * plane] = rms;
    st[5 * plane] = cmax;
  }
  __syncwarp();
}

// ---- a frame over a group of four warps (csrc/stft_large.cuh) -------------

constexpr int kGroupThreads = 128;
// shared words a group reduces through: per warp its magnitude total, mel
// numerator, colmax, crossings, sum of squares, bandwidth sum, rolloff bin
constexpr int kGroupRed = 32;

// The group's named barrier: its 128 threads, not the CTA's.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kGroupThreads) : "memory");
}

// The epilogue of frame f of clip b over the group's 128 threads from its
// fp32 power row pw (bin k at pad32(k), NB bins); red: the group's
// kGroupRed shared words, of which the loader's per-warp crossings and sums
// of squares already sit in red[12 + w] and red[16 + w]; bar: the group's
// barrier, gw: the warp in the group.  Thread t takes the contiguous chunk
// of bins t C .. t C + C - 1 and keeps their magnitudes in registers: one
// pass gives the centroid's sums, colmax and the chunk sums of the rolloff
// scan (a warp scan, then the warps' offsets); the mel is one filter a
// thread; a second pass over the registers gives the bandwidth and the
// rolloff bin.  Two group barriers; thread 0 writes the six statistics.
template <int NB>
__device__ __forceinline__ void group_epilogue(const float* pw,
                                               const Params& p,
                                               const float* melw, float* red,
                                               int b, int f, int gt, int gw,
                                               int bar, long long plane) {
  constexpr int C = (NB + kGroupThreads - 1) / kGroupThreads;
  const int lane = gt & 31;
  const int kb = gt * C;
  float mg[C];
  float csum = 0.0f, num = 0.0f, cmax = 0.0f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = kb + i;
    const bool in = k < NB;
    const float pwk = in ? pw[pad32(k)] : 0.0f;
    mg[i] = sqrtf(pwk);
    csum += mg[i];
    num += in ? mg[i] * __ldg(p.freqs + k) : 0.0f;
    cmax = fmaxf(cmax, pwk);
  }
  float incl = csum;
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  num = warp_sum_f(num);
  cmax = warp_max_f(cmax);
  if (lane == 31) {
    red[gw] = incl;
    red[4 + gw] = num;
    red[8 + gw] = cmax;
  }

  // ---- mel projection, one filter a thread ---------------------------------
  const long long mbase =
      static_cast<long long>(b) * p.n_mels * p.n_frames + f;
  for (int mi = gt; mi < p.n_mels; mi += kGroupThreads) {
    const int k0 = __ldg(p.mel_meta + 3 * mi);
    const int k1 = __ldg(p.mel_meta + 3 * mi + 1);
    const int off = __ldg(p.mel_meta + 3 * mi + 2) - k0;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) acc += melw[off + k] * pw[pad32(k)];
    p.mel[mbase + static_cast<long long>(mi) * p.n_frames] = acc;
  }
  group_sync(bar);

  float den = 0.0f, before = 0.0f;
  num = 0.0f;
  cmax = 0.0f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    den += red[w];
    num += red[4 + w];
    cmax = fmaxf(cmax, red[8 + w]);
    if (w < gw) before += red[w];
  }
  const float cent = num / fmaxf(den, kTiny);
  const float thresh = kRollPercent * den;
  float run = before + (incl - csum);
  int found = NB;
  float dev2 = 0.0f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = kb + i;
    const bool in = k < NB;
    run += mg[i];
    if (found == NB && in && run >= thresh) found = k;
    if (in) {
      const float dev = fabsf(__ldg(p.freqs + k) - cent);
      dev2 += mg[i] * dev * dev;
    }
  }
  dev2 = warp_sum_f(dev2);
  for (int o = 16; o > 0; o >>= 1) {
    found = min(found, __shfl_xor_sync(kFull, found, o));
  }
  if (lane == 0) {
    red[20 + gw] = dev2;
    red[24 + gw] = __int_as_float(found);
  }
  group_sync(bar);
  if (gt == 0) {
    float crossings = 0.0f, sumsq = 0.0f;
    dev2 = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      crossings += red[12 + w];
      sumsq += red[16 + w];
      dev2 += red[20 + w];
      found = min(found, __float_as_int(red[24 + w]));
    }
    constexpr float n_fft = static_cast<float>(2 * (NB - 1));
    float* st = p.stats + static_cast<long long>(b) * p.n_frames + f;
    st[0] = cent;
    st[plane] = sqrtf(dev2 / fmaxf(den, kTiny));
    st[2 * plane] = found < NB ? __ldg(p.freqs + found) : FLT_MAX;
    st[3 * plane] = crossings / n_fft;
    st[4 * plane] = sqrtf(sumsq / n_fft);
    st[5 * plane] = cmax;
  }
}

// The power store, T-contiguous: a warp instruction writes `frames`
// consecutive frames of 32 / frames bins from the CTA's tile (row stride
// `row`).
template <typename TOut>
__device__ __forceinline__ void store_power_tile(const TOut* tile, int frames,
                                                 int row, int nb,
                                                 const Params& p, int b,
                                                 int f0, int warp,
                                                 int n_warps, int lane) {
  const int n_valid = min(frames, p.n_frames - f0);
  const int lf = lane % frames;
  const int bins = 32 / frames;
  TOut* out = static_cast<TOut*>(p.power) +
              static_cast<long long>(b) * nb * p.n_frames + f0 + lf;
  if (lf < n_valid) {
    for (int k = warp * bins + lane / frames; k < nb; k += n_warps * bins) {
      out[static_cast<long long>(k) * p.n_frames] =
          tile[static_cast<size_t>(lf) * row + k];
    }
  }
}

}  // namespace
