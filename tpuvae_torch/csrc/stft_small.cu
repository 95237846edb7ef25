// Kernel 1's register plan at n_fft = 256 q, q = 1 .. 7 (256 .. 1,792):
// the fused STFT power + feature epilogue of csrc/stft_features.cu (which
// replaces the Pallas kernel tpuvae/ops/stft.py:418, _make_ct_kernel) for
// the sizes whose frame one warp's registers hold.
//
// A frame's m = n_fft / 2 = 32 r complex points (r = 4 q <= 28) stay in
// registers from the load to the split; the shared-memory plan's scatter,
// its in-place stages and their per-butterfly twiddle reads are gone.  The
// four-step split m = r x 32, the lane index as the 32-point axis:
//
// 1. Load: lane l takes points n = l + 32 j, j < r (the shared loader of
//    stft_frame.cuh: coalesced 8-byte loads, four in flight, zcr and rms).
// 2. An r-point DFT over j in registers, r = P S with P = 4, 8 or 16 and
//    S = 1, 3, 5 or 7: P-point FFTs over j = S jp + js (fftp2), the
//    twiddles W_r^(js kp), then direct S-point DFTs with the points t and
//    S - t paired; every constant is a literal and every index a
//    compile-time constant after unrolling.  Register k1 ends holding
//    Y_l[k1].
// 3. Y_l[k1] times W_m^(l k1) from a host-built float64 table cast to fp32
//    (r x 32 values, read through L1; the kernel calls no sincosf).
// 4. The 32-point DFT over l across the lanes: five radix-2
//    decimation-in-frequency stages of __shfl_xor_sync on each of the r
//    values (10 r shuffles a frame); a lane's twiddle at a stage is the same
//    for all r values, read once a stage from a (5, 32) host table.  Lane l
//    then holds Z[k1 + r brev5(l)] in register k1.
// 5. The real-input split by shuffles as well: Z[m - k] of register k1 >= 1
//    sits in register r - k1 of lane l ^ 31, of register 0 in register 0
//    of lane brev5((32 - brev5(l)) & 31).  The powers go once to the warp's
//    padded fp32 row (bin k at pad32(k): at most two-way bank conflicts at
//    every r), then, in bin order, to the CTA's stored-type tile; the
//    epilogue and the T-contiguous store are stft_frame.cuh's, the
//    shared-memory plan's.
//
// Budgets: __launch_bounds__(256, 2) holds each instantiation to 128
// registers (56 data floats at r = 28), so two CTAs of 8 warps share an SM;
// ptxas gives 57 .. 128 registers, no spill and no stack at every r.  Shared
// memory per CTA: the tile (32 bf16 or 16 fp32 frames of m + 2 values) + 8
// rows of pad32(m) + 1 floats + the mel weights: 94,132 B at n_fft 1,792
// with 128 mels, 13,580 B at 256.  Fourteen instantiations (7 sizes x 2
// stored types) in this translation unit, built beside stft_features.cu.
#include "stft_frame.cuh"

namespace {

// cos and sin of 2 pi e / R, e < R: the r-point DFTs' twiddles and their
// odd factors' roots (W_S^t = W_R^(t R / S)).
template <int R>
__device__ __forceinline__ void root(int e, float& c, float& s) {
  if constexpr (R == 12) {
    constexpr float kC[12] = {
        1.0f, 0.86602540378443871f, 0.50000000000000011f, 0.0f,
        -0.49999999999999978f, -0.86602540378443871f, -1.0f,
        -0.86602540378443882f, -0.50000000000000044f, 0.0f,
        0.50000000000000011f, 0.86602540378443837f};
    constexpr float kS[12] = {
        0.0f, 0.49999999999999994f, 0.8660254037844386f, 1.0f,
        0.86602540378443871f, 0.49999999999999994f, 0.0f,
        -0.49999999999999972f, -0.86602540378443837f, -1.0f,
        -0.8660254037844386f, -0.50000000000000044f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (R == 20) {
    constexpr float kC[20] = {
        1.0f, 0.95105651629515353f, 0.80901699437494745f,
        0.58778525229247314f, 0.30901699437494745f, 0.0f,
        -0.30901699437494734f, -0.58778525229247303f, -0.80901699437494734f,
        -0.95105651629515353f, -1.0f, -0.95105651629515375f,
        -0.80901699437494756f, -0.58778525229247325f, -0.30901699437494756f,
        0.0f, 0.30901699437494723f, 0.58778525229247292f,
        0.80901699437494734f, 0.95105651629515353f};
    constexpr float kS[20] = {
        0.0f, 0.3090169943749474f, 0.58778525229247314f,
        0.80901699437494745f, 0.95105651629515353f, 1.0f,
        0.95105651629515364f, 0.80901699437494745f, 0.58778525229247325f,
        0.30901699437494751f, 0.0f, -0.3090169943749469f,
        -0.58778525229247303f, -0.80901699437494734f, -0.95105651629515353f,
        -1.0f, -0.95105651629515364f, -0.80901699437494756f,
        -0.58778525229247336f, -0.30901699437494762f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (R == 24) {
    constexpr float kC[24] = {
        1.0f, 0.96592582628906831f, 0.86602540378443871f,
        0.70710678118654757f, 0.50000000000000011f, 0.25881904510252074f,
        0.0f, -0.25881904510252063f, -0.49999999999999978f,
        -0.70710678118654746f, -0.86602540378443871f, -0.9659258262890682f,
        -1.0f, -0.96592582628906831f, -0.86602540378443882f,
        -0.70710678118654791f, -0.50000000000000044f, -0.25881904510252063f,
        0.0f, 0.2588190451025203f, 0.50000000000000011f,
        0.70710678118654735f, 0.86602540378443837f, 0.96592582628906809f};
    constexpr float kS[24] = {
        0.0f, 0.25881904510252074f, 0.49999999999999994f,
        0.70710678118654746f, 0.8660254037844386f, 0.96592582628906831f,
        1.0f, 0.96592582628906831f, 0.86602540378443871f,
        0.70710678118654757f, 0.49999999999999994f, 0.25881904510252102f,
        0.0f, -0.25881904510252079f, -0.49999999999999972f,
        -0.70710678118654713f, -0.86602540378443837f, -0.96592582628906831f,
        -1.0f, -0.96592582628906842f, -0.8660254037844386f,
        -0.70710678118654768f, -0.50000000000000044f, -0.25881904510252157f};
    c = kC[e];
    s = kS[e];
  } else {
    static_assert(R == 28, "roots are tabulated for R = 12, 20, 24, 28");
    constexpr float kC[28] = {
        1.0f, 0.97492791218182362f, 0.90096886790241915f,
        0.7818314824680298f, 0.62348980185873359f, 0.43388373911755818f,
        0.22252093395631445f, 0.0f, -0.22252093395631434f,
        -0.43388373911755806f, -0.62348980185873348f, -0.78183148246802947f,
        -0.90096886790241903f, -0.97492791218182373f, -1.0f,
        -0.97492791218182373f, -0.90096886790241915f, -0.78183148246802958f,
        -0.62348980185873371f, -0.43388373911755829f, -0.22252093395631459f,
        0.0f, 0.22252093395631334f, 0.43388373911755795f,
        0.62348980185873337f, 0.78183148246802969f, 0.90096886790241937f,
        0.97492791218182351f};
    constexpr float kS[28] = {
        0.0f, 0.22252093395631439f, 0.43388373911755812f,
        0.62348980185873348f, 0.7818314824680298f, 0.90096886790241915f,
        0.97492791218182362f, 1.0f, 0.97492791218182362f,
        0.90096886790241915f, 0.78183148246802991f, 0.62348980185873393f,
        0.43388373911755823f, 0.22252093395631409f, 0.0f,
        -0.22252093395631384f, -0.43388373911755801f, -0.62348980185873382f,
        -0.78183148246802969f, -0.90096886790241903f, -0.97492791218182362f,
        -1.0f, -0.97492791218182384f, -0.90096886790241926f,
        -0.78183148246802991f, -0.62348980185873371f, -0.43388373911755751f,
        -0.22252093395631464f};
    c = kC[e];
    s = kS[e];
  }
}

// A direct S-point DFT (S odd) in registers, the points t and S - t paired
// (csrc/stft_features.cu's dft_odd with literal roots):
// v_t W^(tk) + v_(S-t) W^(-tk) = c (v_t + v_(S-t)) - i s (v_t - v_(S-t))
// with W^(tk) = c - i s = W_R^e, e = (t k mod S) R / S.
template <int S, int R>
__device__ __forceinline__ void dft_odd_const(float (&re)[S], float (&im)[S]) {
  if constexpr (S > 1) {
    constexpr int H = (S - 1) / 2;
    float sr[H], si[H], dr[H], di[H];
    const float r0 = re[0], i0 = im[0];
    float a0r = r0, a0i = i0;
#pragma unroll
    for (int t = 1; t <= H; ++t) {
      sr[t - 1] = re[t] + re[S - t];
      si[t - 1] = im[t] + im[S - t];
      dr[t - 1] = re[t] - re[S - t];
      di[t - 1] = im[t] - im[S - t];
      a0r += sr[t - 1];
      a0i += si[t - 1];
    }
    re[0] = a0r;
    im[0] = a0i;
#pragma unroll
    for (int k = 1; k < S; ++k) {
      float ar = r0, ai = i0;
#pragma unroll
      for (int t = 1; t <= H; ++t) {
        float c, s;
        root<R>(((t * k) % S) * (R / S), c, s);
        ar += c * sr[t - 1] + s * di[t - 1];
        ai += c * si[t - 1] - s * dr[t - 1];
      }
      re[k] = ar;
      im[k] = ai;
    }
  }
}

// The r-point DFT over a lane's points, in place and in natural order:
// register k1 = kp + P ks ends holding sum_j v_j W_R^(j k1).
template <int R>
__device__ __forceinline__ void fft_points(float (&re)[R], float (&im)[R]) {
  constexpr int P = R & -R;          // 4, 8 or 16
  constexpr int S = R / P;           // 1, 3, 5 or 7
  constexpr int kShift = 5 - Log2<P>::value;   // brev over log2(P) bits
  float ar[S][P], ai[S][P];
#pragma unroll
  for (int js = 0; js < S; ++js) {
#pragma unroll
    for (int jp = 0; jp < P; ++jp) {
      ar[js][jp] = re[S * jp + js];
      ai[js][jp] = im[S * jp + js];
    }
    fftp2<P>(ar[js], ai[js]);        // ar[js][i] = A_js[brev(i)]
  }
#pragma unroll
  for (int kp = 0; kp < P; ++kp) {
    float vr[S], vi[S];
#pragma unroll
    for (int js = 0; js < S; ++js) {
      // brev5 is closed-form, so the index folds to a constant (a loop
      // form left the arrays in local memory)
      const float xr = ar[js][brev5(kp) >> kShift];
      const float xi = ai[js][brev5(kp) >> kShift];
      vr[js] = xr;
      vi[js] = xi;
      if constexpr (S > 1) {
        if (js * kp != 0) {
          float c, s;
          root<R>(js * kp, c, s);     // times W_R^(js kp) = c - i s
          vr[js] = xr * c + xi * s;
          vi[js] = xi * c - xr * s;
        }
      }
    }
    dft_odd_const<S, R>(vr, vi);       // vr[ks] = Y[kp + P ks]
#pragma unroll
    for (int ks = 0; ks < S; ++ks) {
      re[kp + P * ks] = vr[ks];
      im[kp + P * ks] = vi[ks];
    }
  }
}

template <typename TOut, int R>
__host__ __device__ constexpr size_t register_tile_bytes() {
  return (static_cast<size_t>(Tile<TOut>::kFrames) * (32 * R + 2) *
              sizeof(TOut) + 15) & ~size_t{15};
}

// floats of a warp's power row: bins 0 .. m at pad32(k)
template <int R>
struct PowerRow {
  static constexpr int kLen = 32 * R + R + 1;
};

template <typename TOut, int R>
__global__ void __launch_bounds__(kThreads, 2)
stft_register_kernel(Params p) {
  constexpr int m = 32 * R;
  constexpr int nb = m + 1;
  constexpr int row = nb + 1;
  constexpr int frames = Tile<TOut>::kFrames;
  extern __shared__ __align__(16) unsigned char smem[];
  TOut* tile = reinterpret_cast<TOut*>(smem);            // [frames][row]
  float* rows = reinterpret_cast<float*>(
      smem + register_tile_bytes<TOut, R>());
  float* melw = rows + kWarps * PowerRow<R>::kLen;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // read through a shuffle so that the compiler knows it is warp-uniform
  // (the frame loop below holds warp-wide shuffles)
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * frames;
  const bool fused = p.stats != nullptr;

  if (fused) {
    for (int i = tid; i < p.mel_nnz; i += kThreads) melw[i] = p.mel_w[i];
  }
  __syncthreads();

  const float* y = p.y + static_cast<long long>(b) * p.n_samples;
  const long long n_s = p.n_samples;
  const float2* win2 = reinterpret_cast<const float2*>(p.window);
  float* pw = rows + warp * PowerRow<R>::kLen;
  const int bl = brev5(lane);
  const int src0 = brev5((32 - bl) & 31);   // the lane of Z[m - r bl]

  for (int lf = warp; lf < frames; lf += kWarps) {
    const int f = f0 + lf;
    if (f >= p.n_frames) break;
    const long long start = static_cast<long long>(f) * p.hop - m + p.origin;
    const bool interior = start >= 0 && start + 2 * m <= n_s;

    // ---- 1. load: lane l keeps points l + 32 j in registers ----------------
    float re[R], im[R];
    float zcr, rms;
    load_frame(
        p, y, n_s, win2, start, start - p.origin, p.n_true - 1, interior, m,
        lane, fused, [](int) { return 0; },
        [&](int it, int, float a, float c) {
          re[it] = a;
          im[it] = c;
        },
        zcr, rms);

    // ---- 2. r-point DFT over j; 3. twiddle W_m^(l k1) ------------------------
    fft_points<R>(re, im);
#pragma unroll
    for (int k1 = 1; k1 < R; ++k1) {
      const float2 w = __ldg(p.xtw + 32 * k1 + lane);
      const float ar = re[k1], ai = im[k1];
      re[k1] = ar * w.x - ai * w.y;
      im[k1] = ar * w.y + ai * w.x;
    }

    // ---- 4. 32-point DFT over the lanes: register k1 = Z[k1 + R bl] ---------
    lane_fft32<R>(re, im, p.xtw + 32 * R, lane);

    // ---- 5. real-input split, partners by shuffle; powers to the row ---------
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) {
      const int k = k1 + R * bl;
      const int src = k1 == 0 ? src0 : lane ^ 31;
      const float zmr = __shfl_sync(kFull, re[(R - k1) % R], src);
      const float zmi = __shfl_sync(kFull, im[(R - k1) % R], src);
      pw[pad32(k)] =
          split_power(re[k1], im[k1], zmr, zmi, __ldg(p.twiddle + k));
    }
    if (lane == 0) {
      // the Nyquist bin: Z[m] = Z[0]
      pw[pad32(m)] =
          split_power(re[0], im[0], re[0], im[0], __ldg(p.twiddle + m));
    }
    __syncwarp();
    // the stored-type tile row from the fp32 row, bins in lane order: no
    // bank conflicts either side (stored from the split, bin r bl + k1
    // conflicted up to 8-way at r = 16), and no tile stores while the
    // frame's 2 r values are live
    TOut* trow = tile + static_cast<size_t>(lf) * row;
    for (int k = lane; k < nb; k += 32) {
      trow[k] = Tile<TOut>::cast(pw[pad32(k)]);
    }
    if (!fused) continue;
    // the plane stride computed here, not kept across the frame loop: one
    // register less where r = 24 and 28 are at the 128-register edge
    frame_epilogue(pw, nb, p, melw, b, f, zcr, rms, lane,
                   static_cast<long long>(gridDim.y) * p.n_frames);
  }
  __syncthreads();
  store_power_tile<TOut>(tile, frames, row, nb, p, b, f0, warp, kWarps, lane);
}

// One CTA of 8 warps a `frames`-frame tile; two share an SM.
template <typename TOut, int R>
int launch_register(Params p, int batch, cudaStream_t stream) {
  constexpr int frames = Tile<TOut>::kFrames;
  const size_t smem = register_tile_bytes<TOut, R>() +
                      sizeof(float) * (static_cast<size_t>(kWarps) *
                                           PowerRow<R>::kLen +
                                       static_cast<size_t>(p.mel_nnz));
  p.frames = frames;
  const auto kernel = stft_register_kernel<TOut, R>;
  const size_t resident = (smem <= kSmemTwoCtas ? 2 : 1) * (smem + 1024);
  const cudaError_t err = set_smem(kernel, smem, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_frames + frames - 1) / frames, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_size(const Params& p, bool bf16, int batch, cudaStream_t stream) {
  return bf16 ? launch_register<__nv_bfloat16, R>(p, batch, stream)
              : launch_register<float, R>(p, batch, stream);
}

}  // namespace

// tpuvae_stft_features's arguments (csrc/stft_features.cu) at n_fft = 256 q,
// q = 1 .. 7: xtw (r + 5, 32, 2) fp32 with r = n_fft / 64, rows k1 < r
// exp(-2 pi i l k1 / m) and rows r .. r + 4 the lane twiddles of the five
// stages; iperm and plan unused.  Any other n_fft is refused.
extern "C" int tpuvae_stft_small(
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
  const bool bf16 = power_bf16 != 0;
  const int nb = static_cast<int>(batch);
  switch (n_fft) {
    case 256: return launch_size<4>(p, bf16, nb, s);
    case 512: return launch_size<8>(p, bf16, nb, s);
    case 768: return launch_size<12>(p, bf16, nb, s);
    case 1024: return launch_size<16>(p, bf16, nb, s);
    case 1280: return launch_size<20>(p, bf16, nb, s);
    case 1536: return launch_size<24>(p, bf16, nb, s);
    case 1792: return launch_size<28>(p, bf16, nb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
