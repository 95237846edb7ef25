// Fused STFT power + feature epilogue (kernel 1).
//
// Replaces the Pallas kernel tpuvae/ops/stft.py:418 (_make_ct_kernel) with
// its epilogue _fused_stats_epilogue (:274), reached through
// _ct_inner_pallas_fused (:689) and, without the epilogue, _ct_inner_pallas
// (:654).  Per clip and frame of a centred, Hann-windowed n_fft-point STFT
// (n_fft = 256 q, q = 1 .. 23: the JAX kernel's sizes) it
// computes the power spectrum and, from the fp32 power: the mel projection,
// spectral centroid, bandwidth, 85% rolloff and the per-frame max power
// (colmax).  zcr (librosa edge semantics: only sample pairs inside
// [0, n_samples) count) and rms (zero padding) come from the unwindowed
// samples as the frame is loaded.
//
// Bound on the H100: bytes.  The function must read the waveform (4 B per
// sample) and write the power (2 B per bin and frame in bf16), mel and six
// statistics; its arithmetic (~56 kflop of FFT per frame plus the sparse
// mel and the statistics) is far below the fp32 rate per byte moved.  What
// a kernel of this shape really pays for is shared-memory traffic and
// occupancy, so the design keeps the FFT in registers:
//
// * One warp per frame.  The 2048-point real FFT is a 1024-point complex
//   FFT of the even/odd sample pairs followed by the real-input split, and
//   1024 = 32 x 32: lane l loads points l + 32 j (coalesced 8-byte loads
//   straight from the waveform, window through the read-only path), runs a
//   32-point FFT over j in registers with compile-time W_32 constants,
//   multiplies by W_1024^(l k1) from a host-built table, exchanges ONCE
//   through a padded 32 x 33 per-warp shared buffer (real parts, then
//   imaginary parts), and runs the second 32-point FFT.  Lane c then holds
//   bins c + 32 k2; the partner bin M - k of the split comes by shuffle.
//   Bit reversal is register renaming at compile time.  All twiddles are
//   built in float64 on the host; the kernel calls no sincosf.
// * No fp32 power tile.  A frame's 1025 fp32 powers live in its warp's
//   4.2 KB exchange buffer just long enough for the statistics, the mel
//   projection (each filter over its non-zero bins, weights staged once per
//   CTA in compressed form) and the rolloff prefix (a contiguous chunk per
//   lane, then a warp scan).  Only a tile in the STORED type waits for the
//   transposed store: 32 frames x 1025 bf16 (64-byte runs) or 16 frames x
//   1025 fp32, 65.7 KB either way, row stride 1026 so the transposing reads
//   are bank-conflict free.
// * Shared memory per CTA: 65,664 (tile) + 33,792 (8 exchange buffers) +
//   4 x nnz (mel weights, 8,072 B at 128 mels) = 107,528 B, so two CTAs of
//   8 warps fit an SM once the largest shared-memory carveout is asked
//   for; __launch_bounds__(256, 2)
//   holds the kernel to 128 registers a thread (ptxas: 128, no spill in
//   fast mode, 24 bytes in exact mode).
// * What is left to pay is the instruction stream itself: ~3,500 a frame
//   for the FFT, split and store, and as many again for the epilogue, whose
//   mel and rolloff loops run at one lane-private shared load per FMA.  So
//   zero crossings are counted on 32-bit sign masks (two shuffles a frame,
//   not 64), the rolloff scan is unrolled without an early exit, and the
//   warp index is read through a shuffle so that the compiler knows the
//   frame loop is warp-uniform and emits plain shuffles.
// * The power-only entry (stats == nullptr) is the same kernel without the
//   epilogue.
//
// n_fft 256 .. 1,792 run the register plan of csrc/stft_small.cu.  Every
// larger size runs the general plan (stft_general_kernel), a simple kernel
// that is right first:
// * Still one warp per frame, but the frame's m = n_fft / 2 complex points
//   live in the warp's shared memory (two planes, one pad word per 32), not
//   in registers: m = 128 q holds an odd factor up to 23 and reaches 2,944
//   points, 184 floats a lane.  The host factors m into radices (ops/stft.py
//   _radix_plan: the odd primes first, then powers of two up to 16 and up to
//   m / 32 so every lane has a butterfly) and tabulates the digit reversal
//   and W_m^k in float64.  Lanes load points n = lane + 32 i coalesced (four
//   in flight), window them and scatter each to its digit-reversed place;
//   each stage then runs in place (a butterfly reads and writes the same
//   points): power-of-two radices as the W_32 stages above, odd primes as
//   direct DFTs with the points r and R - r paired.  The split, the
//   statistics, the mel projection and the rolloff scan are the register
//   plan's, over runtime bin counts, from the same buffer.
// * Shared memory: the stored-type tile (up to 32 frames), 8 (m + m / 32)
//   bytes a warp and the mel weights.  Two CTAs of 8 warps an SM where a tile
//   of 8 or more frames fits 113 KB; else one CTA with the most warps that
//   fit 227 KB (5 to 8 at n_fft 5,376 and up).  The carveout asks for that
//   much and leaves the rest of the SM's 256 KB to L1 for the tables.
// * Two instantiations by register class: radices up to 16 at 128 registers
//   (two CTAs an SM), and the plans with an odd prime of 11 .. 23 at 255.
#include "stft_frame.cuh"

namespace {

constexpr int kN = 2048;             // n_fft
constexpr int kM = kN / 2;           // complex FFT length, 32 x 32
constexpr int kNB = kM + 1;          // real bins
constexpr int kRow = kNB + 1;        // tile row stride, elements
constexpr int kXbuf = 32 * 33;       // floats per warp: exchange / power row

static_assert(kXbuf >= kNB, "a frame's power row fits its exchange buffer");

constexpr size_t kTileBytes = static_cast<size_t>(32) * kRow * 2;
static_assert(kTileBytes == static_cast<size_t>(16) * kRow * 4, "one size");
static_assert(kTileBytes % 16 == 0, "exchange buffers stay aligned");

// One radix-2 decimation-in-frequency stage of a 32-point FFT held in
// registers.  Every index and twiddle is a compile-time constant after
// unrolling.  After stages 0..4 register i holds X[brev5(i)].
template <int S>
__device__ __forceinline__ void fft32_stage(float (&re)[32], float (&im)[32]) {
  // cos / sin of 2 pi t / 32, t = 0 .. 15; W_32^t = cos - i sin
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
  constexpr int half = 16 >> S;
#pragma unroll
  for (int g = 0; g < (1 << S); ++g) {
#pragma unroll
    for (int q = 0; q < half; ++q) {
      const int i0 = g * 2 * half + q;
      const int i1 = i0 + half;
      const int t = q << S;
      const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
      const float dr = ar - br, di = ai - bi;
      re[i0] = ar + br;
      im[i0] = ai + bi;
      if (t == 0) {
        re[i1] = dr;
        im[i1] = di;
      } else if (t == 8) {            // times -i
        re[i1] = di;
        im[i1] = -dr;
      } else {
        re[i1] = dr * kC[t] + di * kS[t];
        im[i1] = di * kC[t] - dr * kS[t];
      }
    }
  }
}

__device__ __forceinline__ void fft32(float (&re)[32], float (&im)[32]) {
  fft32_stage<0>(re, im);
  fft32_stage<1>(re, im);
  fft32_stage<2>(re, im);
  fft32_stage<3>(re, im);
  fft32_stage<4>(re, im);
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
stft_features_kernel(Params p) {
  constexpr int kFrames = Tile<TOut>::kFrames;
  extern __shared__ __align__(16) unsigned char smem[];
  TOut* tile = reinterpret_cast<TOut*>(smem);           // [kFrames][kRow]
  float* xbufs = reinterpret_cast<float*>(smem + kTileBytes);
  float* melw = xbufs + kWarps * kXbuf;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // read through a shuffle so that the compiler knows it is warp-uniform
  // (the frame loop below holds warp-wide shuffles)
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const bool fused = p.stats != nullptr;

  if (fused) {
    for (int i = tid; i < p.mel_nnz; i += kThreads) melw[i] = p.mel_w[i];
  }
  __syncthreads();

  const float* y = p.y + static_cast<long long>(b) * p.n_samples;
  const long long n_s = p.n_samples;
  float* xb = xbufs + warp * kXbuf;
  const float2* win2 = reinterpret_cast<const float2*>(p.window);
  const long long plane = static_cast<long long>(gridDim.y) * p.n_frames;

  for (int lf = warp; lf < kFrames; lf += kWarps) {
    const int f = f0 + lf;
    if (f >= p.n_frames) break;
    const long long start =
        static_cast<long long>(f) * p.hop - kN / 2 + p.origin;
    const bool interior = start >= 0 && start + kN <= n_s;
    // every sample pair of the frame lies inside the true samples
    const long long start_t = start - p.origin;
    const bool zcr_interior = start_t >= 0 && start_t + kN <= p.n_true;

    // ---- load: lane l takes complex points l + 32 j -----------------------
    float re[32], im[32];
    if (interior && p.vec2) {
      const float2* src = reinterpret_cast<const float2*>(y + start) + lane;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 v = __ldg(src + 32 * j);
        re[j] = v.x;
        im[j] = v.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const long long s0 = start + 2 * (lane + 32 * j);
        const long long s1 = s0 + 1;
        re[j] = (s0 >= 0 && s0 < n_s) ? y[s0] : 0.0f;
        im[j] = (s1 >= 0 && s1 < n_s) ? y[s1] : 0.0f;
      }
    }
    float zcr = 0.0f, rms = 0.0f;
    if (fused) {
      // Bit j of sign0 / sign1: the zcr sign of this lane's samples
      // s0 = start + 2 (lane + 32 j) and s0 + 1; bit j of ok01 / ok12: the
      // pair (s0, s0 + 1) / (s0 + 1, s0 + 2) lies inside the signal.
      float sumsq = 0.0f;
      unsigned sign0 = 0, sign1 = 0, ok01 = kFull, ok12 = kFull;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        sumsq += re[j] * re[j] + im[j] * im[j];
        sign0 |= static_cast<unsigned>(zcr_sign(re[j])) << j;
        sign1 |= static_cast<unsigned>(zcr_sign(im[j])) << j;
      }
      if (!zcr_interior) {
        ok01 = 0;
        ok12 = 0;
        const long long n_t = p.n_true;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const long long s0 = start_t + 2 * (lane + 32 * j);
          ok01 |= static_cast<unsigned>(s0 >= 0 && s0 + 1 <= n_t - 1) << j;
          ok12 |= static_cast<unsigned>(s0 + 1 >= 0 && s0 + 2 <= n_t - 1) << j;
        }
      }
      // the sample after a pair: the next lane's s0 of the same j, or for
      // lane 31 lane 0's s0 of j + 1; the frame's last sample has none
      const unsigned up = __shfl_down_sync(kFull, sign0, 1);
      const unsigned wrap = __shfl_sync(kFull, sign0, 0) >> 1;
      const unsigned next0 = lane == 31 ? wrap : up;
      if (lane == 31) ok12 &= 0x7FFFFFFFu;
      int crossings = __popc((sign0 ^ sign1) & ok01) +
                      __popc((sign1 ^ next0) & ok12);
      sumsq = warp_sum_f(sumsq);
      for (int o = 16; o > 0; o >>= 1) {
        crossings += __shfl_xor_sync(kFull, crossings, o);
      }
      zcr = static_cast<float>(crossings) / static_cast<float>(kN);
      rms = sqrtf(sumsq / static_cast<float>(kN));
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 w = __ldg(win2 + lane + 32 * j);
      re[j] *= w.x;
      im[j] *= w.y;
    }

    // ---- 32-point FFTs over j, twiddle, exchange, 32-point FFTs over l ----
    fft32(re, im);
#pragma unroll
    for (int k1 = 0; k1 < 32; ++k1) {
      const float2 w = __ldg(p.xtw + k1 * 32 + lane);
      const float ar = re[brev5(k1)], ai = im[brev5(k1)];
      re[brev5(k1)] = ar * w.x - ai * w.y;
      im[brev5(k1)] = ar * w.y + ai * w.x;
    }
#pragma unroll
    for (int k1 = 0; k1 < 32; ++k1) xb[k1 * 33 + lane] = re[brev5(k1)];
    __syncwarp();
#pragma unroll
    for (int l = 0; l < 32; ++l) re[l] = xb[lane * 33 + l];
    __syncwarp();
#pragma unroll
    for (int k1 = 0; k1 < 32; ++k1) xb[k1 * 33 + lane] = im[brev5(k1)];
    __syncwarp();
#pragma unroll
    for (int l = 0; l < 32; ++l) im[l] = xb[lane * 33 + l];
    __syncwarp();
    fft32(re, im);
    // register brev5(k2) of lane c now holds Z[c + 32 k2]

    // ---- real-input split: X[k] = E[k] + W_N^k O[k]; power ----------------
    TOut* trow = tile + lf * kRow;
    const int partner = (32 - lane) & 31;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int k = lane + 32 * r;
      const float zkr = re[brev5(r)], zki = im[brev5(r)];
      // Z[M - k]: lane 32 - c, register 31 - r; lane 0 keeps its own 32 - r
      float zmr = __shfl_sync(kFull, re[brev5(31 - r)], partner);
      float zmi = __shfl_sync(kFull, im[brev5(31 - r)], partner);
      if (lane == 0) {
        zmr = re[brev5((32 - r) & 31)];
        zmi = im[brev5((32 - r) & 31)];
      }
      const float er = 0.5f * (zkr + zmr);
      const float ei = 0.5f * (zki - zmi);
      const float orr = 0.5f * (zki + zmi);
      const float oi = -0.5f * (zkr - zmr);
      const float2 w = __ldg(p.twiddle + k);
      const float xr = er + (w.x * orr - w.y * oi);
      const float xi = ei + (w.x * oi + w.y * orr);
      const float pw = xr * xr + xi * xi;
      xb[k] = pw;
      trow[k] = Tile<TOut>::cast(pw);
    }
    if (lane == 0) {
      // the Nyquist bin: Z[M] = Z[0], W_N^M = -1
      const float2 w = __ldg(p.twiddle + kM);
      const float xr = re[0] + w.x * im[0];
      const float xi = w.y * im[0];
      const float pw = xr * xr + xi * xi;
      xb[kM] = pw;
      trow[kM] = Tile<TOut>::cast(pw);
    }
    __syncwarp();
    if (!fused) continue;

    // ---- magnitude statistics from the warp's fp32 power row --------------
    float mag[32];
    float den = 0.0f, num = 0.0f, cmax = 0.0f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int k = lane + 32 * r;
      const float pw = xb[k];
      mag[r] = sqrtf(pw);
      den += mag[r];
      num += mag[r] * __ldg(p.freqs + k);
      cmax = fmaxf(cmax, pw);
    }
    float mag_ny = 0.0f;
    if (lane == 0) {
      const float pw = xb[kM];
      mag_ny = sqrtf(pw);
      den += mag_ny;
      num += mag_ny * __ldg(p.freqs + kM);
      cmax = fmaxf(cmax, pw);
    }
    den = warp_sum_f(den);
    num = warp_sum_f(num);
    cmax = warp_max_f(cmax);
    const float cent = num / fmaxf(den, kTiny);
    float dev2 = 0.0f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float dev = fabsf(__ldg(p.freqs + lane + 32 * r) - cent);
      dev2 += mag[r] * dev * dev;
    }
    if (lane == 0) {
      const float dev = fabsf(__ldg(p.freqs + kM) - cent);
      dev2 += mag_ny * dev * dev;
    }
    dev2 = warp_sum_f(dev2);
    const float bw = sqrtf(dev2 / fmaxf(den, kTiny));

    // ---- mel projection over each filter's non-zero bins ------------------
    const long long mbase =
        static_cast<long long>(b) * p.n_mels * p.n_frames + f;
    for (int mi = lane; mi < p.n_mels; mi += 32) {
      const int k0 = __ldg(p.mel_meta + 3 * mi);
      const int k1 = __ldg(p.mel_meta + 3 * mi + 1);
      const int off = __ldg(p.mel_meta + 3 * mi + 2) - k0;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) acc += melw[off + k] * xb[k];
      p.mel[mbase + static_cast<long long>(mi) * p.n_frames] = acc;
    }
    __syncwarp();

    // ---- rolloff: first bin whose prefix sum of magnitudes reaches 85%;
    //      magnitudes replace the powers so each lane scans a contiguous chunk
#pragma unroll
    for (int r = 0; r < 32; ++r) xb[lane + 32 * r] = mag[r];
    if (lane == 0) xb[kM] = mag_ny;
    __syncwarp();
    constexpr int kChunk = (kNB + 31) / 32;
    const int kb = lane * kChunk;
    float v[kChunk];
    float csum = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      v[i] = kb + i < kNB ? xb[kb + i] : 0.0f;
      csum += v[i];
    }
    float incl = csum;
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    const float thresh = kRollPercent * den;
    float run = incl - csum;
    int found = kNB;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      // the same prefix order without the early exit: the first hit stays
      run += v[i];
      if (found == kNB && kb + i < kNB && run >= thresh) found = kb + i;
    }
    for (int o = 16; o > 0; o >>= 1) {
      found = min(found, __shfl_xor_sync(kFull, found, o));
    }
    if (lane == 0) {
      float* st = p.stats + static_cast<long long>(b) * p.n_frames + f;
      st[0] = cent;
      st[plane] = bw;
      st[2 * plane] = found < kNB ? __ldg(p.freqs + found) : FLT_MAX;
      st[3 * plane] = zcr;
      st[4 * plane] = rms;
      st[5 * plane] = cmax;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- power store, T-contiguous: a warp instruction writes kFrames
  //      consecutive frames of 32 / kFrames bins ------------------------------
  const int n_valid = min(kFrames, p.n_frames - f0);
  const int lf = lane % kFrames;
  constexpr int kBins = 32 / kFrames;
  TOut* out = static_cast<TOut*>(p.power) +
              static_cast<long long>(b) * kNB * p.n_frames + f0 + lf;
  if (lf < n_valid) {
    for (int k = warp * kBins + lane / kFrames; k < kNB; k += kWarps * kBins) {
      out[static_cast<long long>(k) * p.n_frames] = tile[lf * kRow + k];
    }
  }
}

template <typename TOut>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kFrames = Tile<TOut>::kFrames;
  const size_t smem = kTileBytes + sizeof(float) * kWarps * kXbuf +
                      sizeof(float) * static_cast<size_t>(p.mel_nnz);
  cudaError_t err = cudaFuncSetAttribute(
      stft_features_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // two CTAs per SM need the largest shared-memory carveout
  err = cudaFuncSetAttribute(stft_features_kernel<TOut>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_frames + kFrames - 1) / kFrames, batch);
  stft_features_kernel<TOut><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}


// ---- the general plan: n_fft = 256 q, 9 <= q <= 23 -------------------------

// A direct R-point DFT for odd R, the points r and R - r paired:
// v_r W^(rk) + v_(R-r) W^(-rk) = c (v_r + v_(R-r)) + i s (v_r - v_(R-r))
// with W^(rk) = c + i s, (wr, wi)[t] = W_R^t.
// (wr, wi)[t] = W_R^t = tw_m[t m / R], read once a butterfly.
template <int R>
__device__ __forceinline__ void dft_odd(float (&re)[R], float (&im)[R],
                                        const float2* __restrict__ tw_m,
                                        int stride) {
  constexpr int H = (R - 1) / 2;
  float wr[R], wi[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const float2 w = __ldg(tw_m + t * stride);
    wr[t] = w.x;
    wi[t] = w.y;
  }
  float sr[H], si[H], dr[H], di[H];
  const float r0 = re[0], i0 = im[0];
  float a0r = r0, a0i = i0;
#pragma unroll
  for (int r = 1; r <= H; ++r) {
    sr[r - 1] = re[r] + re[R - r];
    si[r - 1] = im[r] + im[R - r];
    dr[r - 1] = re[r] - re[R - r];
    di[r - 1] = im[r] - im[R - r];
    a0r += sr[r - 1];
    a0i += si[r - 1];
  }
  re[0] = a0r;
  im[0] = a0i;
#pragma unroll
  for (int k = 1; k < R; ++k) {
    float ar = r0, ai = i0;
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const int t = (r * k) % R;
      ar += wr[t] * sr[r - 1] - wi[t] * di[r - 1];
      ai += wr[t] * si[r - 1] + wi[t] * dr[r - 1];
    }
    re[k] = ar;
    im[k] = ai;
  }
}

// One in-place decimation-in-time stage of radix R over a warp's frame:
// blocks of L R points; butterfly (block, k1 < L) takes the points
// base + r L, twiddles them by W_(L R)^(r k1) = W_m^(r k1 m / (L R)), runs
// the R-point DFT and writes output k2 back to base + k2 L.  The points
// it reads are the points it writes, so a stage needs no second buffer.
// A lane reads the points of U butterflies before it computes any (they
// are disjoint), so that their shared-memory loads are in flight together;
// the block index is j / L in fp32 (exact: j < 2^12, and (j + 0.5) / L
// stays 0.5 / L from an integer).
template <int R>
__device__ __forceinline__ void gen_stage(float* bre, float* bim, int m, int L,
                                          const float2* __restrict__ tw_m,
                                          int lane) {
  constexpr int U = R <= 8 ? 8 / R : 1;
  const int block = L * R;
  const int tstep = m / block;
  const int n_bfly = m / R;
  const float inv_l = 1.0f / static_cast<float>(L);
  for (int j0 = lane; j0 < n_bfly; j0 += 32 * U) {
    float re[U][R], im[U][R];
    int base[U], k1s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + 32 * u;
      const int blk = __float2int_rz((static_cast<float>(j) + 0.5f) * inv_l);
      k1s[u] = j - blk * L;
      base[u] = blk * block + k1s[u];
      if (j < n_bfly) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          re[u][r] = bre[pad32(base[u] + r * L)];
          im[u][r] = bim[pad32(base[u] + r * L)];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + 32 * u >= n_bfly) break;
      if (k1s[u] != 0) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 w = __ldg(tw_m + r * k1s[u] * tstep);
          const float ar = re[u][r], ai = im[u][r];
          re[u][r] = ar * w.x - ai * w.y;
          im[u][r] = ar * w.y + ai * w.x;
        }
      }
      if constexpr (R % 2 == 1) {
        dft_odd<R>(re[u], im[u], tw_m, m / R);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          bre[pad32(base[u] + k * L)] = re[u][k];
          bim[pad32(base[u] + k * L)] = im[u][k];
        }
      } else {
        fftp2<R>(re[u], im[u]);
        constexpr int kBits = Log2<R>::value;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          bre[pad32(base[u] + k * L)] = re[u][brev_bits(k, kBits)];
          bim[pad32(base[u] + k * L)] = im[u][brev_bits(k, kBits)];
        }
      }
    }
  }
}

// The plan's stages.  kLarge instantiates the odd radices 11 .. 23 as
// well (n_fft 256 q for q = 11, 13, 17, 19, 22, 23): their butterflies
// hold up to 23 points and their sums, so that kernel is given 255
// registers (one CTA an SM; their shared memory allows no more); the rest
// keep to 128 (two CTAs an SM).
template <bool kLarge>
__device__ __forceinline__ void gen_fft(float* bre, float* bim,
                                        const Params& p, int lane) {
  int L = 1;
  for (long long code = p.plan; code != 0; code >>= 6) {
    const int r = static_cast<int>(code & 63);
    switch (r) {
      case 2: gen_stage<2>(bre, bim, p.m, L, p.xtw, lane); break;
      case 4: gen_stage<4>(bre, bim, p.m, L, p.xtw, lane); break;
      case 8: gen_stage<8>(bre, bim, p.m, L, p.xtw, lane); break;
      case 16: gen_stage<16>(bre, bim, p.m, L, p.xtw, lane); break;
      case 3: gen_stage<3>(bre, bim, p.m, L, p.xtw, lane); break;
      case 5: gen_stage<5>(bre, bim, p.m, L, p.xtw, lane); break;
      case 7: gen_stage<7>(bre, bim, p.m, L, p.xtw, lane); break;
      default:
        if constexpr (kLarge) {
          switch (r) {
            case 11: gen_stage<11>(bre, bim, p.m, L, p.xtw, lane); break;
            case 13: gen_stage<13>(bre, bim, p.m, L, p.xtw, lane); break;
            case 17: gen_stage<17>(bre, bim, p.m, L, p.xtw, lane); break;
            case 19: gen_stage<19>(bre, bim, p.m, L, p.xtw, lane); break;
            default: gen_stage<23>(bre, bim, p.m, L, p.xtw, lane); break;
          }
        }
        break;
    }
    __syncwarp();
    L *= r;
  }
}

template <typename TOut, bool kLarge>
__global__ void __launch_bounds__(kThreads, kLarge ? 1 : 2)
stft_general_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = p.m;
  const int nb = m + 1;
  const int row = nb + 1;
  const int frames = p.frames;
  const int n_warps = blockDim.x >> 5;
  TOut* tile = reinterpret_cast<TOut*>(smem);            // [frames][row]
  const size_t tile_bytes =
      (static_cast<size_t>(frames) * row * sizeof(TOut) + 15) & ~size_t{15};
  float* xbufs = reinterpret_cast<float*>(smem + tile_bytes);
  const int plane_m = pad32(m);              // a padded plane of m points
  float* melw = xbufs + static_cast<size_t>(n_warps) * 2 * plane_m;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * frames;
  const bool fused = p.stats != nullptr;

  if (fused) {
    for (int i = tid; i < p.mel_nnz; i += blockDim.x) melw[i] = p.mel_w[i];
  }
  __syncthreads();

  const float* y = p.y + static_cast<long long>(b) * p.n_samples;
  const long long n_s = p.n_samples;
  const long long last_t = p.n_true - 1;
  float* bre = xbufs + static_cast<size_t>(warp) * 2 * plane_m;
  float* bim = bre + plane_m;
  const float2* win2 = reinterpret_cast<const float2*>(p.window);
  const long long plane = static_cast<long long>(gridDim.y) * p.n_frames;

  for (int lf = warp; lf < frames; lf += n_warps) {
    const int f = f0 + lf;
    if (f >= p.n_frames) break;
    const long long start =
        static_cast<long long>(f) * p.hop - m + p.origin;
    const bool interior = start >= 0 && start + 2 * m <= n_s;
    const long long start_t = start - p.origin;

    // ---- load point n = lane + 32 it (coalesced), zcr / rms, window, and
    //      scatter to its digit-reversed position
    float zcr, rms;
    load_frame(
        p, y, n_s, win2, start, start_t, last_t, interior, m, lane, fused,
        [&](int n) { return pad32(__ldg(p.iperm + n)); },
        [&](int, int pos, float a, float c) {
          bre[pos] = a;
          bim[pos] = c;
        },
        zcr, rms);
    __syncwarp();
    gen_fft<kLarge>(bre, bim, p, lane);

    // ---- real-input split, in place: the lane of bin k also takes bin
    //      m - k, so each reads and then overwrites its own two slots; the
    //      powers land in bre at pad32(k) and, for the Nyquist bin, at
    //      pad32(m), bim's first word
    TOut* trow = tile + static_cast<size_t>(lf) * row;
    float* pw = bre;
    const int n_split = m / 2 + 1;               // bins 0 .. m / 2
    for (int k0 = lane; k0 < n_split; k0 += 64) {
      float zr[2], zi[2], mr[2], mi[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = k0 + 32 * u;
        if (k < n_split) {
          const int pk_i = pad32(k), pm_i = pad32(k == 0 ? 0 : m - k);
          zr[u] = bre[pk_i];
          zi[u] = bim[pk_i];
          mr[u] = bre[pm_i];
          mi[u] = bim[pm_i];
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = k0 + 32 * u;
        if (k >= n_split) break;
        const int km = k == 0 ? 0 : m - k;
        const float pk =
            split_power(zr[u], zi[u], mr[u], mi[u], __ldg(p.twiddle + k));
        if (k == 0) {
          const float pm =
              split_power(zr[u], zi[u], zr[u], zi[u], __ldg(p.twiddle + m));
          pw[plane_m] = pm;
          trow[m] = Tile<TOut>::cast(pm);
        } else if (k != m / 2) {
          const float pmk =
              split_power(mr[u], mi[u], zr[u], zi[u], __ldg(p.twiddle + km));
          pw[pad32(km)] = pmk;
          trow[km] = Tile<TOut>::cast(pmk);
        }
        pw[pad32(k)] = pk;
        trow[k] = Tile<TOut>::cast(pk);
      }
    }
    __syncwarp();
    if (!fused) continue;
    frame_epilogue(pw, nb, p, melw, b, f, zcr, rms, lane, plane);
  }
  __syncthreads();
  store_power_tile<TOut>(tile, frames, row, nb, p, b, f0, warp, n_warps,
                         lane);
}

size_t general_smem(const Params& p, int frames, int warps, size_t out_size) {
  const size_t tile = (static_cast<size_t>(frames) * (p.m + 2) * out_size +
                       15) & ~size_t{15};
  const size_t plane = p.m + p.m / 32;
  return tile + sizeof(float) * (static_cast<size_t>(warps) * 2 * plane +
                                 static_cast<size_t>(p.mel_nnz));
}

// Two CTAs of 8 warps an SM where a tile of at least 8 frames allows it;
// else one CTA with the most warps (then the largest tile) that fit.
template <typename TOut, bool kLarge>
int launch_general(Params p, int batch, cudaStream_t stream) {
  int frames = 0, warps = 0;
  for (int f = Tile<TOut>::kFrames; f >= 8 && frames == 0 && !kLarge;
       f /= 2) {
    if (general_smem(p, f, kWarps, sizeof(TOut)) <= kSmemTwoCtas) {
      frames = f;
      warps = kWarps;
    }
  }
  if (frames == 0) {
    for (int f = Tile<TOut>::kFrames; f >= 1; f /= 2) {
      int w = f < kWarps ? f : kWarps;
      while (w > warps && general_smem(p, f, w, sizeof(TOut)) > kSmemPerCta) {
        --w;
      }
      if (w > warps) {
        frames = f;
        warps = w;
      }
    }
  }
  if (frames == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = general_smem(p, frames, warps, sizeof(TOut));
  p.frames = frames;
  const auto kernel = stft_general_kernel<TOut, kLarge>;
  // the shared memory the resident CTAs take and no more: the rest stays L1
  // for the twiddles, window, digit reversal and freqs
  const size_t resident = (warps == kWarps && smem <= kSmemTwoCtas ? 2 : 1) *
                          (smem + 1024);
  const cudaError_t err = set_smem(kernel, smem, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_frames + frames - 1) / frames, batch);
  kernel<<<grid, 32 * warps, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool radix_supported(int r) {
  switch (r) {
    case 2: case 4: case 8: case 16: case 3: case 5: case 7: case 11:
    case 13: case 17: case 19: case 23:
      return true;
    default:
      return false;
  }
}

}  // namespace

// y (batch, n_samples) fp32, or rows padded by n_fft / 2 a side with the
// true samples from `origin` on (n_true of them); window (n_fft,), twiddle
// (m + 1, 2) fp32 with m = n_fft / 2; xtw (32, 32, 2) for the register plan
// (n_fft 2048), else (m, 2) with iperm (m,) int32 and the radices packed 6
// bits each in `plan` (any other size; n_fft <= 1,792 runs
// tpuvae_stft_small); freqs (m + 1,) fp32; mel_w (mel_nnz,) fp32 with
// mel_meta (n_mels, 3) int32 = first bin, one past the last, offset into
// mel_w; power (batch, m + 1, n_frames) bf16 or fp32; mel (batch, n_mels,
// n_frames) and stats (6, batch, n_frames) fp32, both null for the
// power-only entry.
extern "C" int tpuvae_stft_features(
    const void* y, long long batch, long long n_samples, long long origin,
    long long n_true, int n_fft, int hop, int n_frames, const void* window,
    const void* twiddle, const void* xtw, const void* iperm, long long plan,
    const void* freqs, const void* mel_w, const void* mel_meta, int n_mels,
    int mel_nnz, void* power, int power_bf16, void* mel, void* stats,
    void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  Params p;
  const int bad = make_params(p, y, batch, n_samples, origin, n_true, n_fft,
                              hop, n_frames, window, twiddle, xtw, iperm,
                              plan, freqs, mel_w, mel_meta, n_mels, mel_nnz,
                              power, mel, stats);
  if (bad != 0) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_fft == kN) {
    return power_bf16 ? launch<__nv_bfloat16>(p, static_cast<int>(batch), s)
                      : launch<float>(p, static_cast<int>(batch), s);
  }
  long long prod = 1;
  bool large = false;
  for (long long code = plan; code != 0; code >>= 6) {
    const int r = static_cast<int>(code & 63);
    if (!radix_supported(r)) return static_cast<int>(cudaErrorInvalidValue);
    prod *= r;
    large = large || r >= 11;
  }
  if (prod != p.m || iperm == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = static_cast<int>(batch);
  if (large) {
    return power_bf16 ? launch_general<__nv_bfloat16, true>(p, nb, s)
                      : launch_general<float, true>(p, nb, s);
  }
  return power_bf16 ? launch_general<__nv_bfloat16, false>(p, nb, s)
                    : launch_general<float, false>(p, nb, s);
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
