// Kernel 1's register plan of csrc/stft_large.cuh at n_fft = 256 q,
// q = 14 .. 18 (3,584 .. 4,608): ten instantiations (five sizes x two stored
// types), built in parallel with the other two translation units.
#include "stft_large.cuh"

// tpuvae_stft_features's arguments (csrc/stft_features.cu) with xtw as
// stft_large.cuh's large_entry says; any other n_fft is refused.
extern "C" int tpuvae_stft_large_b(
    const void* y, long long batch, long long n_samples, long long origin,
    long long n_true, int n_fft, int hop, int n_frames, const void* window,
    const void* twiddle, const void* xtw, const void* freqs,
    const void* mel_w, const void* mel_meta, int n_mels, int mel_nnz,
    void* power, int power_bf16, void* mel, void* stats, void* stream) {
  return large_entry(
      y, batch, n_samples, origin, n_true, n_fft, hop, n_frames, window,
      twiddle, xtw, freqs, mel_w, mel_meta, n_mels, mel_nnz, power,
      power_bf16, mel, stats, stream,
      [](int q, const Params& p, bool bf16, int n_clips,
         cudaStream_t s) {
        switch (q) {
          case 14: return launch_q<14>(p, bf16, n_clips, s);
          case 15: return launch_q<15>(p, bf16, n_clips, s);
          case 16: return launch_q<16>(p, bf16, n_clips, s);
          case 17: return launch_q<17>(p, bf16, n_clips, s);
          case 18: return launch_q<18>(p, bf16, n_clips, s);
          default: return static_cast<int>(cudaErrorInvalidValue);
        }
      });
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
