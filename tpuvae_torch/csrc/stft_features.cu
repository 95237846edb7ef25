// Fused STFT power + feature epilogue (kernel 1).
//
// Replaces the Pallas kernel tpuvae/ops/stft.py:418 (_make_ct_kernel) with
// its epilogue _fused_stats_epilogue (:274), reached through
// _ct_inner_pallas_fused (:689) and, without the epilogue, _ct_inner_pallas
// (:654).  Per clip and frame of a centred, Hann-windowed n_fft-point STFT
// it computes the power spectrum and, from the fp32 power while it sits in
// shared memory: the mel projection, spectral centroid, bandwidth, 85%
// rolloff and the per-frame max power (colmax).  zcr (librosa edge
// semantics: only sample pairs inside [0, n_samples) count) and rms (zero
// padding) come from the unwindowed samples as the frame is loaded.
//
// Design.  One CTA takes one clip and a tile of kFrames frames; each warp
// runs whole frames through an fp32 radix-2 FFT in shared memory: the
// 2048-point real FFT is a 1024-point complex FFT of the even/odd sample
// pairs followed by the real-input split.  Twiddles come from a table built
// in float64 on the host.  Centre zero padding is index arithmetic.  The
// tile's (kFrames, 1025) fp32 power stays in dynamic shared memory for the
// epilogue; power is stored T-contiguous, as bf16 (round-to-nearest-even)
// or fp32.  The mel filterbank is applied over each filter's non-zero bin
// range only (its triangles overlap pairwise, ~2 non-zeros per bin).
//
// Bound on the H100: bytes.  The function must read the waveform (4 B per
// sample) and write the power (2 B per bin and frame in bf16), mel and six
// statistics; its arithmetic (~56 kflop of FFT per frame plus the sparse
// mel and the statistics) is far below the fp32 rate per byte moved.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 16;
constexpr float kTiny = 1.17549435e-38f;  // np.finfo(np.float32).tiny
constexpr float kRollPercent = 0.85f;
constexpr float kZcrThreshold = 1e-10f;

struct Params {
  const float* y;          // (B, n_samples) waveform
  const float* window;     // (n_fft,) periodic Hann
  const float2* twiddle;   // (n_fft/2 + 1,) exp(-2 pi i k / n_fft)
  const float* freqs;      // (n_fft/2 + 1,) bin centre frequencies
  const float* mel_fb;     // (n_mels, n_fft/2 + 1)
  const int* mel_range;    // (n_mels, 2) first / one-past-last non-zero bin
  void* power;             // (B, n_fft/2 + 1, n_frames) bf16 or fp32
  float* mel;              // (B, n_mels, n_frames) or null (power only)
  float* stats;            // (6, B, n_frames): centroid, bandwidth,
                           // rolloff, zcr, rms, colmax; or null
  long long n_samples;
  int n_frames;
  int hop;
  int n_mels;
  int power_bf16;
};

__device__ __forceinline__ bool zcr_sign(float x) {
  return signbit(fabsf(x) <= kZcrThreshold ? 0.0f : x);
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  return v;
}

template <int N>
struct Log2 {
  static constexpr int value = 1 + Log2<N / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

template <int N>
struct Layout {
  static constexpr int M = N / 2;        // complex FFT length
  static constexpr int NB = M + 1;       // real bins
  static constexpr size_t tw = 0;
  static constexpr size_t win = tw + sizeof(float2) * NB;
  static constexpr size_t freqs = win + sizeof(float) * N;
  static constexpr size_t pt = (freqs + sizeof(float) * NB + 15) / 16 * 16;
  static constexpr size_t buf = (pt + sizeof(float) * kFrames * NB + 15) / 16 * 16;
  static constexpr size_t frame_stats = buf + sizeof(float2) * kWarps * M;
  static constexpr size_t bytes = frame_stats + sizeof(float) * 2 * kFrames;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
stft_features_kernel(Params p) {
  using L = Layout<N>;
  constexpr int M = L::M;
  constexpr int NB = L::NB;
  constexpr int LOGM = Log2<M>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* tw = reinterpret_cast<float2*>(smem + L::tw);
  float* win = reinterpret_cast<float*>(smem + L::win);
  float* freqs = reinterpret_cast<float*>(smem + L::freqs);
  float* pt = reinterpret_cast<float*>(smem + L::pt);
  float2* bufs = reinterpret_cast<float2*>(smem + L::buf);
  float* fstat = reinterpret_cast<float*>(smem + L::frame_stats);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const bool fused = p.stats != nullptr;

  for (int i = tid; i < NB; i += kThreads) {
    tw[i] = p.twiddle[i];
    if (fused) freqs[i] = p.freqs[i];
  }
  for (int i = tid; i < N; i += kThreads) win[i] = p.window[i];
  __syncthreads();

  const float* y = p.y + static_cast<long long>(b) * p.n_samples;
  const long long n_s = p.n_samples;

  // ---- per-warp frames: load (+ zcr/rms), FFT, power ---------------------
  for (int lf = warp; lf < kFrames; lf += kWarps) {
    const int f = f0 + lf;
    if (f >= p.n_frames) break;
    float2* buf = bufs + warp * M;
    const long long start = static_cast<long long>(f) * p.hop - N / 2;
    float sumsq = 0.0f;
    int crossings = 0;
    for (int m = lane; m < M; m += 32) {
      const long long s0 = start + 2 * m;
      const long long s1 = s0 + 1;
      const long long s2 = s0 + 2;
      const float x0 = (s0 >= 0 && s0 < n_s) ? y[s0] : 0.0f;
      const float x1 = (s1 >= 0 && s1 < n_s) ? y[s1] : 0.0f;
      sumsq += x0 * x0 + x1 * x1;
      if (fused) {
        // pair (s0, s1), and pair (s1, s2) unless s1 is the frame's last
        if (s0 >= 0 && s1 <= n_s - 1 && zcr_sign(x0) != zcr_sign(x1)) ++crossings;
        if (m < M - 1 && s1 >= 0 && s2 <= n_s - 1) {
          if (zcr_sign(x1) != zcr_sign(y[s2])) ++crossings;
        }
      }
      const unsigned rev = __brev(static_cast<unsigned>(m)) >> (32 - LOGM);
      buf[rev] = make_float2(x0 * win[2 * m], x1 * win[2 * m + 1]);
    }
    if (fused) {
      sumsq = warp_sum_f(sumsq);
      for (int o = 16; o > 0; o >>= 1) {
        crossings += __shfl_xor_sync(0xFFFFFFFFu, crossings, o);
      }
      if (lane == 0) {
        fstat[lf] = static_cast<float>(crossings) / static_cast<float>(N);
        fstat[kFrames + lf] = sqrtf(sumsq / static_cast<float>(N));
      }
    }
    __syncwarp();
    // iterative radix-2 DIT over bit-reversed input -> natural order
    for (int s = 1; s <= LOGM; ++s) {
      const int half = 1 << (s - 1);
      const int tw_step = N >> s;        // W_len^pos = W_N^(pos * N / len)
      for (int bi = lane; bi < M / 2; bi += 32) {
        const int pos = bi & (half - 1);
        const int i0 = ((bi >> (s - 1)) << s) + pos;
        const int i1 = i0 + half;
        const float2 w = tw[pos * tw_step];
        const float2 a = buf[i0];
        const float2 c = buf[i1];
        const float tr = w.x * c.x - w.y * c.y;
        const float ti = w.x * c.y + w.y * c.x;
        buf[i0] = make_float2(a.x + tr, a.y + ti);
        buf[i1] = make_float2(a.x - tr, a.y - ti);
      }
      __syncwarp();
    }
    // real-input split: X[k] = E[k] + W_N^k O[k], k = 0 .. M
    float* prow = pt + lf * NB;
    for (int k = lane; k <= M; k += 32) {
      const float2 zk = buf[k & (M - 1)];
      const float2 zm = buf[(M - k) & (M - 1)];
      const float er = 0.5f * (zk.x + zm.x);
      const float ei = 0.5f * (zk.y - zm.y);
      const float orr = 0.5f * (zk.y + zm.y);
      const float oi = -0.5f * (zk.x - zm.x);
      const float2 w = tw[k];
      const float xr = er + (w.x * orr - w.y * oi);
      const float xi = ei + (w.x * oi + w.y * orr);
      prow[k] = xr * xr + xi * xi;
    }
    __syncwarp();
  }
  __syncthreads();

  const int n_valid = min(kFrames, p.n_frames - f0);

  // ---- power store, T-contiguous ----------------------------------------
  const long long pbase = static_cast<long long>(b) * NB * p.n_frames + f0;
  for (int idx = tid; idx < NB * kFrames; idx += kThreads) {
    const int k = idx / kFrames;
    const int lf = idx - k * kFrames;
    if (lf >= n_valid) continue;
    const float v = pt[lf * NB + k];
    const long long o = pbase + static_cast<long long>(k) * p.n_frames + lf;
    if (p.power_bf16) {
      static_cast<__nv_bfloat16*>(p.power)[o] = __float2bfloat16(v);
    } else {
      static_cast<float*>(p.power)[o] = v;
    }
  }
  if (!fused) return;

  // ---- mel projection over each filter's non-zero bins ----------------------
  const long long mbase = static_cast<long long>(b) * p.n_mels * p.n_frames + f0;
  for (int idx = tid; idx < p.n_mels * kFrames; idx += kThreads) {
    const int mi = idx / kFrames;
    const int lf = idx - mi * kFrames;
    if (lf >= n_valid) continue;
    const int k0 = p.mel_range[2 * mi];
    const int k1 = p.mel_range[2 * mi + 1];
    const float* fb = p.mel_fb + static_cast<long long>(mi) * NB;
    const float* prow = pt + lf * NB;
    float acc = 0.0f;
    for (int k = k0; k < k1; ++k) acc += fb[k] * prow[k];
    p.mel[mbase + static_cast<long long>(mi) * p.n_frames + lf] = acc;
  }

  // ---- magnitude statistics, one warp per frame -----------------------------
  constexpr int kChunk = (NB + 31) / 32;
  const long long plane = static_cast<long long>(gridDim.y) * p.n_frames;
  const long long sbase = static_cast<long long>(b) * p.n_frames + f0;
  for (int lf = warp; lf < n_valid; lf += kWarps) {
    const float* prow = pt + lf * NB;
    float den = 0.0f, num = 0.0f, cmax = 0.0f;
    for (int k = lane; k < NB; k += 32) {
      const float pw = prow[k];
      const float mag = sqrtf(pw);
      den += mag;
      num += mag * freqs[k];
      cmax = fmaxf(cmax, pw);
    }
    den = warp_sum_f(den);
    num = warp_sum_f(num);
    cmax = warp_max_f(cmax);
    const float cent = num / fmaxf(den, kTiny);
    float dev2 = 0.0f;
    for (int k = lane; k < NB; k += 32) {
      const float mag = sqrtf(prow[k]);
      const float dev = fabsf(freqs[k] - cent);
      dev2 += mag * dev * dev;
    }
    dev2 = warp_sum_f(dev2);
    const float bw = sqrtf(dev2 / fmaxf(den, kTiny));
    // rolloff: first bin whose prefix sum of magnitudes reaches 85%
    const int kb = lane * kChunk;
    const int ke = min(kb + kChunk, NB);
    float csum = 0.0f;
    for (int k = kb; k < ke; ++k) csum += sqrtf(prow[k]);
    float incl = csum;
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += v;
    }
    const float thresh = kRollPercent * den;
    float run = incl - csum;
    int found = NB;
    for (int k = kb; k < ke; ++k) {
      run += sqrtf(prow[k]);
      if (run >= thresh) {
        found = k;
        break;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      found = min(found, __shfl_xor_sync(0xFFFFFFFFu, found, o));
    }
    if (lane == 0) {
      float* st = p.stats + sbase + lf;
      st[0] = cent;
      st[plane] = bw;
      st[2 * plane] = found < NB ? freqs[found] : FLT_MAX;
      st[3 * plane] = fstat[lf];
      st[4 * plane] = fstat[kFrames + lf];
      st[5 * plane] = cmax;
    }
  }
}

template <int N>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = Layout<N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      stft_features_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_frames + kFrames - 1) / kFrames, batch);
  stft_features_kernel<N><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpuvae_stft_features(
    const void* y, long long batch, long long n_samples, int n_fft, int hop,
    int n_frames, const void* window, const void* twiddle, const void* freqs,
    const void* mel_fb, const void* mel_range, int n_mels, void* power,
    int power_bf16, void* mel, void* stats, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.y = static_cast<const float*>(y);
  p.window = static_cast<const float*>(window);
  p.twiddle = static_cast<const float2*>(twiddle);
  p.freqs = static_cast<const float*>(freqs);
  p.mel_fb = static_cast<const float*>(mel_fb);
  p.mel_range = static_cast<const int*>(mel_range);
  p.power = power;
  p.mel = static_cast<float*>(mel);
  p.stats = static_cast<float*>(stats);
  p.n_samples = n_samples;
  p.n_frames = n_frames;
  p.hop = hop;
  p.n_mels = n_mels;
  p.power_bf16 = power_bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 2048: return launch<2048>(p, static_cast<int>(batch), s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
