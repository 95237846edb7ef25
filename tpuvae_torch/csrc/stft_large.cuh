// Kernel 1's register plan at n_fft = 256 q, q = 9 .. 23 (2,304 .. 5,888):
// the fused STFT power + feature epilogue of csrc/stft_features.cu (which
// replaces the Pallas kernel tpuvae/ops/stft.py:418, _make_ct_kernel) for
// the sizes whose frame the registers of a group of four warps hold.  The
// translation units stft_large_a.cu, stft_large_b.cu and stft_large_c.cu
// instantiate it for five sizes each, so that they build in parallel.
//
// A frame's m = n_fft / 2 = 128 q complex points stay in the registers of
// 128 threads, q a thread, from the load to the split.  The four-step split
// m = q x 128, the group's thread t = 32 w + l as the 128-point axis:
//
// 1. Load: thread t takes points n = t + 128 j, j < q (the shared loader of
//    stft_frame.cuh at a stride of 128: coalesced 8-byte loads, four in
//    flight; lane 31's zcr partner, the next warp's first sample, is read
//    again from the waveform), and keeps them in registers.
// 2. Pass A: the q-point DFT over j in registers, q = P S with P = 1, 2, 4
//    or 16 and S odd: P-point FFTs over j = S jp + js (fftp2), the twiddles
//    W_q^(js kp), then direct S-point DFTs with literal roots, the points t
//    and S - t paired and the outputs k and S - k too.  Each output k1 = kp
//    + P ks is multiplied as it is produced by W_m^(t k1) from a host-built
//    float64 table cast to fp32 (q x 128 values read through L1; the kernel
//    calls no sincosf) and stored at row k1, column t of the group's padded
//    plane (pad32(128 k1 + t): no bank conflicts).
// 3. Group barrier (bar.sync over the group's 128 threads, not the CTA's).
// 4. Pass B: q 128-point DFTs over t, warp w taking rows k1 = w mod 4.  Lane
//    l reads points t = l + 32 a of each of its rows (no bank conflicts),
//    then a group barrier: every row is read before any bin is written.  A
//    4-point DFT over a, the twiddle W_128^(l c), the 32-point DFT over the
//    lanes by shuffles (lane_fft32, all the warp's rows at once); lane l
//    then holds X[k1 + q (c + 4 brev5(l))] and stores it at pad32 of that bin
//    (natural order: at most two-way bank conflicts, three-way at q = 15).
// 5. Group barrier; the real-input split in place over 128 threads (bin k
//    and its partner m - k), the powers to the plane and to the CTA's
//    stored-type tile; group barrier; the group epilogue of stft_frame.cuh
//    (two more barriers); the T-contiguous store of stft_frame.cuh.  A group
//    barrier before pass A's stores keeps the next frame off the plane until
//    the epilogue has read it.
//
// Every thread of a group takes the same frames and the same branches, so
// every group barrier is reached by all 128; the group and the warp in it
// are read through shuffles so that the compiler knows they are
// warp-uniform (the frame loop holds warp-wide shuffles).
//
// Budgets: __launch_bounds__(512, 1) holds each instantiation to 128
// registers, so 16 warps (four frames in flight) an SM; ptxas gives 126 ..
// 128, no spill and no stack at every q.  The direct DFT must pair its
// outputs: computing k and S - k apart spilled 64 .. 504 B at q = 17 .. 23.
// Shared memory: a padded plane a group (8 (m + m / 32) B, 24,288 B at
// 5,888), a stored-type tile of 16 bf16 or 8 fp32 frames (32-byte runs in
// the store; 94,272 B at 5,888), 128 B of reduction words a group and the
// mel weights.  Two CTAs of two groups an SM where one takes at most 113 KB
// (q <= 15 with 128 mels), else one CTA of the most groups, up to four,
// that fit 227 KB.
#pragma once

#include "stft_frame.cuh"

namespace {

// cos and sin of 2 pi e / Q, e < Q: the q-point DFT's twiddles and its odd
// factor's roots (W_S^t = W_Q^(t Q / S)).
template <int Q>
__device__ __forceinline__ void qroot(int e, float& c, float& s) {
  if constexpr (Q == 9) {
    constexpr float kC[9] = {1.0f, 0.766044443118978f, 0.17364817766693041f,
        -0.4999999999999998f, -0.9396926207859083f, -0.9396926207859084f,
        -0.5000000000000004f, 0.17364817766692997f, 0.7660444431189778f};
    constexpr float kS[9] = {0.0f, 0.6427876096865393f, 0.984807753012208f,
        0.8660254037844387f, 0.3420201433256689f, -0.34202014332566866f,
        -0.8660254037844384f, -0.9848077530122081f, -0.6427876096865396f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 10) {
    constexpr float kC[10] = {1.0f, 0.8090169943749475f, 0.30901699437494745f,
        -0.30901699437494734f, -0.8090169943749473f, -1.0f,
        -0.8090169943749476f, -0.30901699437494756f, 0.30901699437494723f,
        0.8090169943749473f};
    constexpr float kS[10] = {0.0f, 0.5877852522924731f, 0.9510565162951535f,
        0.9510565162951536f, 0.5877852522924732f, 0.0f, -0.587785252292473f,
        -0.9510565162951535f, -0.9510565162951536f, -0.5877852522924734f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 11) {
    constexpr float kC[11] = {1.0f, 0.8412535328311812f, 0.41541501300188644f,
        -0.142314838273285f, -0.654860733945285f, -0.9594929736144974f,
        -0.9594929736144975f, -0.6548607339452852f, -0.14231483827328523f,
        0.41541501300188605f, 0.8412535328311812f};
    constexpr float kS[11] = {0.0f, 0.5406408174555976f, 0.9096319953545183f,
        0.9898214418809328f, 0.7557495743542583f, 0.28173255684142967f,
        -0.2817325568414294f, -0.7557495743542582f, -0.9898214418809327f,
        -0.9096319953545186f, -0.5406408174555974f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 12) {
    constexpr float kC[12] = {1.0f, 0.8660254037844387f, 0.5000000000000001f,
        0.0f, -0.4999999999999998f, -0.8660254037844387f, -1.0f,
        -0.8660254037844388f, -0.5000000000000004f, 0.0f, 0.5000000000000001f,
        0.8660254037844384f};
    constexpr float kS[12] = {0.0f, 0.49999999999999994f, 0.8660254037844386f,
        1.0f, 0.8660254037844387f, 0.49999999999999994f, 0.0f,
        -0.4999999999999997f, -0.8660254037844384f, -1.0f,
        -0.8660254037844386f, -0.5000000000000004f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 13) {
    constexpr float kC[13] = {1.0f, 0.8854560256532099f, 0.5680647467311559f,
        0.120536680255323f, -0.35460488704253545f, -0.7485107481711012f,
        -0.970941817426052f, -0.9709418174260521f, -0.7485107481711013f,
        -0.3546048870425359f, 0.1205366802553232f, 0.5680647467311548f,
        0.88545602565321f};
    constexpr float kS[13] = {0.0f, 0.4647231720437685f, 0.8229838658936564f,
        0.992708874098054f, 0.9350162426854148f, 0.6631226582407952f,
        0.23931566428755768f, -0.23931566428755743f, -0.663122658240795f,
        -0.9350162426854147f, -0.992708874098054f, -0.822983865893657f,
        -0.4647231720437684f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 14) {
    constexpr float kC[14] = {1.0f, 0.9009688679024191f, 0.6234898018587336f,
        0.22252093395631445f, -0.22252093395631434f, -0.6234898018587335f,
        -0.900968867902419f, -1.0f, -0.9009688679024191f,
        -0.6234898018587337f, -0.2225209339563146f, 0.22252093395631334f,
        0.6234898018587334f, 0.9009688679024194f};
    constexpr float kS[14] = {0.0f, 0.4338837391175581f, 0.7818314824680298f,
        0.9749279121818236f, 0.9749279121818236f, 0.7818314824680299f,
        0.43388373911755823f, 0.0f, -0.433883739117558f, -0.7818314824680297f,
        -0.9749279121818236f, -0.9749279121818238f, -0.7818314824680299f,
        -0.4338837391175575f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 15) {
    constexpr float kC[15] = {1.0f, 0.9135454576426009f, 0.6691306063588582f,
        0.30901699437494745f, -0.10452846326765333f, -0.4999999999999998f,
        -0.8090169943749473f, -0.9781476007338057f, -0.9781476007338057f,
        -0.8090169943749476f, -0.5000000000000004f, -0.10452846326765423f,
        0.30901699437494723f, 0.6691306063588585f, 0.913545457642601f};
    constexpr float kS[15] = {0.0f, 0.40673664307580015f, 0.7431448254773941f,
        0.9510565162951535f, 0.9945218953682734f, 0.8660254037844387f,
        0.5877852522924732f, 0.20791169081775931f, -0.20791169081775907f,
        -0.587785252292473f, -0.8660254037844384f, -0.9945218953682733f,
        -0.9510565162951536f, -0.743144825477394f, -0.40673664307580015f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 17) {
    constexpr float kC[17] = {1.0f, 0.9324722294043558f, 0.7390089172206591f,
        0.4457383557765383f, 0.09226835946330202f, -0.2736629900720829f,
        -0.6026346363792563f, -0.850217135729614f, -0.9829730996839018f,
        -0.9829730996839018f, -0.8502171357296141f, -0.6026346363792572f,
        -0.2736629900720831f, 0.09226835946330243f, 0.4457383557765377f,
        0.7390089172206585f, 0.9324722294043558f};
    constexpr float kS[17] = {0.0f, 0.3612416661871529f, 0.6736956436465572f,
        0.8951632913550623f, 0.9957341762950345f, 0.961825643172819f,
        0.7980172272802396f, 0.5264321628773561f, 0.18374951781657037f,
        -0.18374951781657012f, -0.5264321628773558f, -0.7980172272802389f,
        -0.961825643172819f, -0.9957341762950345f, -0.8951632913550626f,
        -0.6736956436465578f, -0.36124166618715303f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 18) {
    constexpr float kC[18] = {1.0f, 0.9396926207859084f, 0.766044443118978f,
        0.5000000000000001f, 0.17364817766693041f, -0.1736481776669303f,
        -0.4999999999999998f, -0.7660444431189779f, -0.9396926207859083f,
        -1.0f, -0.9396926207859084f, -0.7660444431189783f,
        -0.5000000000000004f, -0.17364817766693033f, 0.17364817766692997f,
        0.49999999999999933f, 0.7660444431189778f, 0.9396926207859084f};
    constexpr float kS[18] = {0.0f, 0.3420201433256687f, 0.6427876096865393f,
        0.8660254037844386f, 0.984807753012208f, 0.984807753012208f,
        0.8660254037844387f, 0.6427876096865395f, 0.3420201433256689f, 0.0f,
        -0.34202014332566866f, -0.6427876096865389f, -0.8660254037844384f,
        -0.984807753012208f, -0.9848077530122081f, -0.866025403784439f,
        -0.6427876096865396f, -0.3420201433256686f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 19) {
    constexpr float kC[19] = {1.0f, 0.9458172417006346f, 0.7891405093963936f,
        0.5469481581224269f, 0.24548548714079924f, -0.08257934547233227f,
        -0.4016954246529694f, -0.6772815716257409f, -0.879473751206489f,
        -0.9863613034027223f, -0.9863613034027224f, -0.8794737512064893f,
        -0.6772815716257411f, -0.40169542465296904f, -0.08257934547233274f,
        0.2454854871407988f, 0.5469481581224266f, 0.7891405093963939f,
        0.9458172417006346f};
    constexpr float kS[19] = {0.0f, 0.32469946920468346f, 0.6142127126896678f,
        0.8371664782625285f, 0.9694002659393304f, 0.9965844930066698f,
        0.9157733266550574f, 0.7357239106731318f, 0.4759473930370737f,
        0.16459459028073403f, -0.16459459028073378f, -0.4759473930370731f,
        -0.7357239106731316f, -0.9157733266550576f, -0.9965844930066698f,
        -0.9694002659393305f, -0.8371664782625288f, -0.6142127126896674f,
        -0.32469946920468373f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 20) {
    constexpr float kC[20] = {1.0f, 0.9510565162951535f, 0.8090169943749475f,
        0.5877852522924731f, 0.30901699437494745f, 0.0f,
        -0.30901699437494734f, -0.587785252292473f, -0.8090169943749473f,
        -0.9510565162951535f, -1.0f, -0.9510565162951538f,
        -0.8090169943749476f, -0.5877852522924732f, -0.30901699437494756f,
        0.0f, 0.30901699437494723f, 0.5877852522924729f, 0.8090169943749473f,
        0.9510565162951535f};
    constexpr float kS[20] = {0.0f, 0.3090169943749474f, 0.5877852522924731f,
        0.8090169943749475f, 0.9510565162951535f, 1.0f, 0.9510565162951536f,
        0.8090169943749475f, 0.5877852522924732f, 0.3090169943749475f, 0.0f,
        -0.3090169943749469f, -0.587785252292473f, -0.8090169943749473f,
        -0.9510565162951535f, -1.0f, -0.9510565162951536f,
        -0.8090169943749476f, -0.5877852522924734f, -0.3090169943749476f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 21) {
    constexpr float kC[21] = {1.0f, 0.9555728057861407f, 0.8262387743159949f,
        0.6234898018587336f, 0.365341024366395f, 0.07473009358642439f,
        -0.22252093395631434f, -0.4999999999999998f, -0.7330518718298263f,
        -0.900968867902419f, -0.9888308262251285f, -0.9888308262251286f,
        -0.9009688679024191f, -0.7330518718298262f, -0.5000000000000004f,
        -0.2225209339563146f, 0.07473009358642436f, 0.3653410243663954f,
        0.6234898018587334f, 0.8262387743159945f, 0.9555728057861406f};
    constexpr float kS[21] = {0.0f, 0.2947551744109042f, 0.5633200580636221f,
        0.7818314824680298f, 0.9308737486442042f, 0.9972037971811801f,
        0.9749279121818236f, 0.8660254037844387f, 0.6801727377709194f,
        0.43388373911755823f, 0.14904226617617472f, -0.14904226617617403f,
        -0.433883739117558f, -0.6801727377709195f, -0.8660254037844384f,
        -0.9749279121818236f, -0.9972037971811801f, -0.9308737486442041f,
        -0.7818314824680299f, -0.5633200580636227f, -0.2947551744109047f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 22) {
    constexpr float kC[22] = {1.0f, 0.9594929736144974f, 0.8412535328311812f,
        0.6548607339452851f, 0.41541501300188644f, 0.14231483827328512f,
        -0.142314838273285f, -0.4154150130018863f, -0.654860733945285f,
        -0.8412535328311811f, -0.9594929736144974f, -1.0f,
        -0.9594929736144975f, -0.8412535328311812f, -0.6548607339452852f,
        -0.41541501300188716f, -0.14231483827328523f, 0.14231483827328487f,
        0.41541501300188605f, 0.6548607339452845f, 0.8412535328311812f,
        0.9594929736144974f};
    constexpr float kS[22] = {0.0f, 0.28173255684142967f, 0.5406408174555976f,
        0.7557495743542583f, 0.9096319953545183f, 0.9898214418809327f,
        0.9898214418809328f, 0.9096319953545184f, 0.7557495743542583f,
        0.5406408174555978f, 0.28173255684142967f, 0.0f, -0.2817325568414294f,
        -0.5406408174555976f, -0.7557495743542582f, -0.909631995354518f,
        -0.9898214418809327f, -0.9898214418809328f, -0.9096319953545186f,
        -0.7557495743542587f, -0.5406408174555974f, -0.2817325568414298f};
    c = kC[e];
    s = kS[e];
  } else if constexpr (Q == 23) {
    constexpr float kC[23] = {1.0f, 0.9629172873477992f, 0.8544194045464886f,
        0.6825531432186541f, 0.4600650377311522f, 0.20345601305263375f,
        -0.06824241336467088f, -0.33487961217098616f, -0.5766803221148671f,
        -0.7757112907044197f, -0.917211301505453f, -0.9906859460363306f,
        -0.9906859460363308f, -0.9172113015054529f, -0.7757112907044198f,
        -0.5766803221148672f, -0.3348796121709864f, -0.06824241336467046f,
        0.2034560130526333f, 0.4600650377311516f, 0.6825531432186542f,
        0.8544194045464886f, 0.962917287347799f};
    constexpr float kS[23] = {0.0f, 0.2697967711570243f, 0.5195839500354336f,
        0.730835964278124f, 0.8878852184023752f, 0.9790840876823229f,
        0.9976687691905392f, 0.9422609221188205f, 0.8169698930104421f,
        0.631087944326053f, 0.3984010898462414f, 0.1361666490962471f,
        -0.1361666490962464f, -0.39840108984624156f, -0.6310879443260528f,
        -0.816969893010442f, -0.9422609221188204f, -0.9976687691905393f,
        -0.979084087682323f, -0.8878852184023756f, -0.730835964278124f,
        -0.5195839500354336f, -0.2697967711570252f};
    c = kC[e];
    s = kS[e];
  } else {
    static_assert(Q == 0, "roots are tabulated for Q = 9 .. 23 but 16");
  }
}

// A direct S-point DFT (S odd) of v in registers, the points t and S - t
// paired, and the outputs k and S - k too; each output goes to emit(k, re,
// im) as it is produced, so that the outputs never live beside the pairs'
// sums:
// v_t W^(tk) + v_(S-t) W^(-tk) = c (v_t + v_(S-t)) - i s (v_t - v_(S-t))
// with W^(tk) = c - i s = W_Q^e, e = (t k mod S) Q / S; output S - k takes
// the same c and -s, so X[k], X[S - k] = (sum c sums) -/+ i (sum s diffs).
template <int S, int Q, typename Emit>
__device__ __forceinline__ void dft_odd_emit(const float (&re)[S],
                                             const float (&im)[S],
                                             Emit emit) {
  if constexpr (S == 1) {
    emit(0, re[0], im[0]);
  } else {
    constexpr int H = (S - 1) / 2;
    float sr[H], si[H], dr[H], di[H];
    float a0r = re[0], a0i = im[0];
#pragma unroll
    for (int t = 1; t <= H; ++t) {
      sr[t - 1] = re[t] + re[S - t];
      si[t - 1] = im[t] + im[S - t];
      dr[t - 1] = re[t] - re[S - t];
      di[t - 1] = im[t] - im[S - t];
      a0r += sr[t - 1];
      a0i += si[t - 1];
    }
    emit(0, a0r, a0i);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float cr = re[0], ci = im[0], sdi = 0.0f, sdr = 0.0f;
#pragma unroll
      for (int t = 1; t <= H; ++t) {
        float c, s;
        qroot<Q>(((t * k) % S) * (Q / S), c, s);
        cr += c * sr[t - 1];
        ci += c * si[t - 1];
        sdi += s * di[t - 1];
        sdr += s * dr[t - 1];
      }
      emit(k, cr + sdi, ci - sdr);
      emit(S - k, cr - sdi, ci + sdr);
    }
  }
}

// The q-point DFT over a thread's points: emit(k1, re, im) receives
// sum_j v_j W_Q^(j k1) for k1 = kp + P ks, each k1 once, by kp.
template <int Q, typename Emit>
__device__ __forceinline__ void dft_points_emit(float (&re)[Q],
                                                float (&im)[Q], Emit emit) {
  constexpr int P = Q & -Q;          // 1, 2, 4 or 16
  constexpr int S = Q / P;           // odd
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
      const float xr = ar[js][brev5(kp) >> kShift];
      const float xi = ai[js][brev5(kp) >> kShift];
      vr[js] = xr;
      vi[js] = xi;
      if constexpr (S > 1) {
        if (js * kp != 0) {
          float c, s;
          qroot<Q>(js * kp, c, s);    // times W_Q^(js kp) = c - i s
          vr[js] = xr * c + xi * s;
          vi[js] = xi * c - xr * s;
        }
      }
    }
    dft_odd_emit<S, Q>(vr, vi, [&](int ks, float xr, float xi) {
      emit(kp + P * ks, xr, xi);
    });
  }
}

template <typename TOut>
struct GroupTile;
template <>
struct GroupTile<__nv_bfloat16> {
  static constexpr int kFrames = 16;
};
template <>
struct GroupTile<float> {
  static constexpr int kFrames = 8;
};

template <int Q>
struct Group {
  static constexpr int m = 128 * Q;
  static constexpr int nb = m + 1;
  static constexpr int row = nb + 1;             // tile row stride
  static constexpr int plane = m + m / 32;       // pad32(m)
  static constexpr int rows = (Q + 3) / 4;       // pass-B rows of warp 0
};

template <typename TOut, int Q>
__host__ __device__ constexpr size_t group_tile_bytes() {
  return (static_cast<size_t>(GroupTile<TOut>::kFrames) * Group<Q>::row *
              sizeof(TOut) + 15) & ~size_t{15};
}

// Pass B of a warp with NR rows k1 = gw + 4 i: read, group barrier, the
// 128-point DFTs, the bins stored in natural order.  ptw: W_128^(l c),
// (4, 32); ltw: the lane stages' twiddles, (5, 32).
template <int Q, int NR>
__device__ __forceinline__ void pass_b(float* bre, float* bim,
                                       const float2* __restrict__ ptw,
                                       const float2* __restrict__ ltw,
                                       int gw, int lane, int bar) {
  float vr[4 * NR], vi[4 * NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int idx = pad32(128 * (gw + 4 * i) + lane + 32 * a);
      vr[4 * i + a] = bre[idx];
      vi[4 * i + a] = bim[idx];
    }
  }
  group_sync(bar);
  float2 w[4];
#pragma unroll
  for (int c = 1; c < 4; ++c) w[c] = __ldg(ptw + 32 * c + lane);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int j = 4 * i;
    // 4-point DFT over a: X[c] = sum_a v_a W_4^(a c), W_4 = -i
    const float s0r = vr[j] + vr[j + 2], s0i = vi[j] + vi[j + 2];
    const float d0r = vr[j] - vr[j + 2], d0i = vi[j] - vi[j + 2];
    const float s1r = vr[j + 1] + vr[j + 3], s1i = vi[j + 1] + vi[j + 3];
    const float d1r = vr[j + 1] - vr[j + 3], d1i = vi[j + 1] - vi[j + 3];
    const float x1r = d0r + d1i, x1i = d0i - d1r;
    const float x2r = s0r - s1r, x2i = s0i - s1i;
    const float x3r = d0r - d1i, x3i = d0i + d1r;
    vr[j] = s0r + s1r;
    vi[j] = s0i + s1i;
    vr[j + 1] = x1r * w[1].x - x1i * w[1].y;
    vi[j + 1] = x1r * w[1].y + x1i * w[1].x;
    vr[j + 2] = x2r * w[2].x - x2i * w[2].y;
    vi[j + 2] = x2r * w[2].y + x2i * w[2].x;
    vr[j + 3] = x3r * w[3].x - x3i * w[3].y;
    vi[j + 3] = x3r * w[3].y + x3i * w[3].x;
  }
  lane_fft32<4 * NR>(vr, vi, ltw, lane);
  const int col = Q * 4 * brev5(lane);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = gw + 4 * i + Q * c + col;
      bre[pad32(k)] = vr[4 * i + c];
      bim[pad32(k)] = vi[4 * i + c];
    }
  }
}

template <typename TOut, int Q>
__global__ void __launch_bounds__(4 * kGroupThreads, 1)
stft_large_kernel(Params p) {
  using G = Group<Q>;
  constexpr int m = G::m;
  constexpr int nb = G::nb;
  constexpr int row = G::row;
  constexpr int frames = GroupTile<TOut>::kFrames;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_groups = blockDim.x / kGroupThreads;
  TOut* tile = reinterpret_cast<TOut*>(smem);             // [frames][row]
  float* planes =
      reinterpret_cast<float*>(smem + group_tile_bytes<TOut, Q>());
  float* reds = planes + static_cast<size_t>(n_groups) * 2 * G::plane;
  float* melw = reds + n_groups * kGroupRed;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gt = tid & (kGroupThreads - 1);
  // read through shuffles so that the compiler knows they are warp-uniform
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int group = __shfl_sync(kFull, tid >> 7, 0);
  const int gw = warp & 3;
  const int bar = 1 + group;                 // barrier 0 is __syncthreads'
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * frames;
  const bool fused = p.stats != nullptr;

  if (fused) {
    for (int i = tid; i < p.mel_nnz; i += blockDim.x) melw[i] = p.mel_w[i];
  }
  __syncthreads();

  const float* y = p.y + static_cast<long long>(b) * p.n_samples;
  const long long n_s = p.n_samples;
  const float2* win2 = reinterpret_cast<const float2*>(p.window);
  float* bre = planes + static_cast<size_t>(group) * 2 * G::plane;
  float* bim = bre + G::plane;
  float* red = reds + group * kGroupRed;

  for (int lf = group; lf < frames; lf += n_groups) {
    const int f = f0 + lf;
    if (f >= p.n_frames) break;
    const long long start = static_cast<long long>(f) * p.hop - m + p.origin;
    const bool interior = start >= 0 && start + 2 * m <= n_s;

    // ---- 1. load: thread t keeps points t + 128 j in registers -------------
    float re[Q], im[Q];
    float crossings, sumsq;
    load_frame<kGroupThreads>(
        p, y, n_s, win2, start, start - p.origin, p.n_true - 1, interior, m,
        gt, fused, [&](int it, float a, float c) {
          re[it] = a;
          im[it] = c;
        },
        crossings, sumsq);
    group_sync(bar);              // the last frame's epilogue is done
    if (fused && lane == 0) {
      red[12 + gw] = crossings;
      red[16 + gw] = sumsq;
    }

    // ---- 2. pass A: q-point DFT over j, twiddle W_m^(t k1), to the plane ---
    dft_points_emit<Q>(re, im, [&](int k1, float xr, float xi) {
      if (k1 != 0) {
        const float2 w = __ldg(p.xtw + 128 * k1 + gt);
        const float tr = xr * w.x - xi * w.y;
        xi = xr * w.y + xi * w.x;
        xr = tr;
      }
      const int idx = pad32(128 * k1 + gt);
      bre[idx] = xr;
      bim[idx] = xi;
    });
    group_sync(bar);

    // ---- 4. pass B: 128-point DFTs over t, bins in natural order -----------
    const float2* ptw = p.xtw + 128 * Q;
    if constexpr (Q % 4 == 0) {
      pass_b<Q, G::rows>(bre, bim, ptw, ptw + 128, gw, lane, bar);
    } else if (gw < Q % 4) {
      pass_b<Q, G::rows>(bre, bim, ptw, ptw + 128, gw, lane, bar);
    } else {
      pass_b<Q, G::rows - 1>(bre, bim, ptw, ptw + 128, gw, lane, bar);
    }
    group_sync(bar);

    // ---- 5. real-input split, in place: the thread of bin k also takes bin
    //      m - k; the powers land in bre at pad32(k) and, for the Nyquist
    //      bin, at pad32(m), bim's first word
    TOut* trow = tile + static_cast<size_t>(lf) * row;
    float* pw = bre;
    constexpr int n_split = m / 2 + 1;               // bins 0 .. m / 2
#pragma unroll
    for (int k0 = 0; k0 < n_split; k0 += 2 * kGroupThreads) {
      float zr[2], zi[2], mr[2], mi[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = k0 + gt + kGroupThreads * u;
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
        const int k = k0 + gt + kGroupThreads * u;
        if (k >= n_split) break;
        const int km = k == 0 ? 0 : m - k;
        const float pk =
            split_power(zr[u], zi[u], mr[u], mi[u], __ldg(p.twiddle + k));
        if (k == 0) {
          const float pm =
              split_power(zr[u], zi[u], zr[u], zi[u], __ldg(p.twiddle + m));
          pw[G::plane] = pm;
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
    if (!fused) continue;
    group_sync(bar);
    group_epilogue<nb>(pw, p, melw, red, b, f, gt, gw, bar,
                       static_cast<long long>(gridDim.y) * p.n_frames);
  }
  __syncthreads();
  store_power_tile<TOut>(tile, frames, row, nb, p, b, f0, warp,
                         blockDim.x >> 5, lane);
}

// Shared memory of a CTA of `groups` groups.
template <typename TOut, int Q>
size_t group_smem(int groups, int mel_nnz) {
  return group_tile_bytes<TOut, Q>() +
         sizeof(float) * (static_cast<size_t>(groups) *
                              (2 * Group<Q>::plane + kGroupRed) +
                          static_cast<size_t>(mel_nnz));
}

// Two CTAs of two groups (8 warps) an SM where one takes at most 113 KB;
// else one CTA of the most groups, up to four, that fit 227 KB.
template <typename TOut, int Q>
int launch_large(const Params& p, int batch, cudaStream_t stream) {
  constexpr int frames = GroupTile<TOut>::kFrames;
  int groups = 2;
  size_t smem = group_smem<TOut, Q>(groups, p.mel_nnz);
  const bool two = smem <= kSmemTwoCtas;
  if (!two) {
    for (groups = 4; groups > 0; --groups) {
      smem = group_smem<TOut, Q>(groups, p.mel_nnz);
      if (smem <= kSmemPerCta) break;
    }
    if (groups == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = stft_large_kernel<TOut, Q>;
  const size_t resident = (two ? 2 : 1) * (smem + 1024);
  const cudaError_t err = set_smem(kernel, smem, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_frames + frames - 1) / frames, batch);
  kernel<<<grid, groups * kGroupThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch_q(const Params& p, bool bf16, int batch, cudaStream_t stream) {
  return bf16 ? launch_large<__nv_bfloat16, Q>(p, batch, stream)
              : launch_large<float, Q>(p, batch, stream);
}

// tpuvae_stft_features's arguments (csrc/stft_features.cu) at n_fft = 256 q,
// q = 9 .. 23: xtw (128 q + 288, 2) fp32, rows k1 < q of 128 the pass-A
// twiddles exp(-2 pi i t k1 / m), then (4, 32) exp(-2 pi i l c / 128) and
// the (5, 32) lane twiddles of the five stages.
// `launch(q, ...)` runs the sizes of one translation unit and refuses the
// rest.
template <typename Launch>
int large_entry(const void* y, long long batch, long long n_samples,
                long long origin, long long n_true, int n_fft, int hop,
                int n_frames, const void* window, const void* twiddle,
                const void* xtw, const void* freqs, const void* mel_w,
                const void* mel_meta, int n_mels, int mel_nnz, void* power,
                int power_bf16, void* mel, void* stats, void* stream,
                Launch launch) {
  if (batch <= 0 || n_frames <= 0) return 0;
  Params p;
  const int bad = make_params(p, y, batch, n_samples, origin, n_true, n_fft,
                              hop, n_frames, window, twiddle, xtw, freqs,
                              mel_w, mel_meta, n_mels, mel_nnz, power, mel,
                              stats);
  if (bad != 0) return bad;
  return launch(n_fft / 256, p, power_bf16 != 0, static_cast<int>(batch),
                static_cast<cudaStream_t>(stream));
}

}  // namespace
