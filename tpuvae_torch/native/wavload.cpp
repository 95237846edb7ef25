// Native audio loader: RIFF/WAVE + FLAC decode (flac.cpp) + mono mixdown
// + polyphase windowed-sinc resampling + truncate/zero-pad.
//
// First-party equivalent of the reference's librosa.load path
// (src/1_preprocessing.py:137-153), whose decoding/resampling runs in
// third-party C (soundfile/audioread + soxr/resampy).  Exposed as a C ABI
// consumed via ctypes from tpuvae_torch.io.native_loader; the Python
// numpy/scipy implementation in tpuvae_torch.io.wav / tpuvae_torch.io.flac
// is the behavioral reference.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -o libwavload.so \
//            wavload.cpp flac.cpp     (tpuvae_torch/io/native_loader.py
// builds it at first use)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

#include "audio.h"

namespace {

bool read_wav(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
      std::fread(&riff_size, 4, 1, f) != 1 ||
      std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) {
    std::fclose(f);
    return false;
  }
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  std::vector<uint8_t> data;
  bool have_fmt = false, have_data = false;
  char cid[4];
  uint32_t csize;
  while (std::fread(cid, 1, 4, f) == 4 && std::fread(&csize, 4, 1, f) == 1) {
    if (!std::memcmp(cid, "fmt ", 4)) {
      uint8_t buf[40];
      const uint32_t take = csize < sizeof(buf) ? csize : sizeof(buf);
      if (csize < 16 || std::fread(buf, 1, take, f) != take) break;
      std::memcpy(&fmt_code, buf + 0, 2);
      std::memcpy(&channels, buf + 2, 2);
      std::memcpy(&sr, buf + 4, 4);
      std::memcpy(&bits, buf + 14, 2);
      if (fmt_code == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: real code = first 2 bytes of SubFormat GUID
        if (take >= 26) {
          std::memcpy(&fmt_code, buf + 24, 2);
        } else {
          std::fclose(f);
          return false;
        }
      }
      if (csize > take) std::fseek(f, csize - take, SEEK_CUR);
      if (csize & 1) std::fseek(f, 1, SEEK_CUR);
      have_fmt = true;
    } else if (!std::memcmp(cid, "data", 4)) {
      // never trust the header size: cap by the actual remaining bytes
      const long here = std::ftell(f);
      std::fseek(f, 0, SEEK_END);
      const long remain = std::ftell(f) - here;
      std::fseek(f, here, SEEK_SET);
      const uint32_t take = csize < uint32_t(std::max(0L, remain))
                                ? csize
                                : uint32_t(std::max(0L, remain));
      data.resize(take);
      if (take && std::fread(data.data(), 1, take, f) != take) break;
      if (csize & 1) std::fseek(f, 1, SEEK_CUR);
      have_data = true;
    } else {
      std::fseek(f, csize + (csize & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  if (!have_fmt || !have_data || channels == 0 || sr == 0) return false;

  size_t n = 0;
  std::vector<float> s;
  if (fmt_code == 1 && bits == 16) {
    n = data.size() / 2;
    s.resize(n);
    const int16_t* p = reinterpret_cast<const int16_t*>(data.data());
    for (size_t i = 0; i < n; ++i) s[i] = p[i] / 32768.0f;
  } else if (fmt_code == 1 && bits == 8) {
    n = data.size();
    s.resize(n);
    for (size_t i = 0; i < n; ++i) s[i] = (data[i] - 128.0f) / 128.0f;
  } else if (fmt_code == 1 && bits == 24) {
    n = data.size() / 3;
    s.resize(n);
    for (size_t i = 0; i < n; ++i) {
      int32_t v = data[3 * i] | (data[3 * i + 1] << 8) |
                  (data[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      s[i] = v / float(1 << 23);
    }
  } else if (fmt_code == 1 && bits == 32) {
    n = data.size() / 4;
    s.resize(n);
    const int32_t* p = reinterpret_cast<const int32_t*>(data.data());
    for (size_t i = 0; i < n; ++i) s[i] = p[i] / 2147483648.0f;
  } else if (fmt_code == 3 && bits == 32) {
    n = data.size() / 4;
    s.resize(n);
    std::memcpy(s.data(), data.data(), n * 4);
  } else {
    return false;
  }
  out->samples = std::move(s);
  out->channels = channels;
  out->sample_rate = int(sr);
  return true;
}

double sinc(double x) {
  if (std::fabs(x) < 1e-12) return 1.0;
  const double px = M_PI * x;
  return std::sin(px) / px;
}

double i0(double x) {
  // modified Bessel I0 (series), for the Kaiser window
  double sum = 1.0, term = 1.0;
  const double y = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= y / (double(k) * k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

// Polyphase windowed-sinc resampling mono `in` from sr_in to sr_out.
std::vector<float> resample(const std::vector<float>& in, int sr_in,
                            int sr_out) {
  if (sr_in == sr_out) return in;
  const int g = int(std::gcd(sr_in, sr_out));
  const int up = sr_out / g, down = sr_in / g;
  // Kaiser(5.0)-windowed sinc low-pass at min(sr_in, sr_out)/2 in the
  // upsampled domain, 10 zero-crossings half-width, DC-normalized —
  // the scipy.signal.resample_poly default the Python fallback uses.
  const int half_zeros = 10;
  const double cutoff = 1.0 / std::max(up, down);
  const double beta = 5.0;
  const int L = 2 * half_zeros * std::max(up, down) + 1;
  std::vector<double> h(L, 0.0);
  const int mid = L / 2;
  const double denom = i0(beta);
  double dc = 0.0;
  for (int i = 0; i < L; ++i) {
    const double t = double(i - mid);
    const double w =
        i0(beta * std::sqrt(std::max(0.0, 1.0 - (t / mid) * (t / mid)))) /
        denom;
    h[i] = cutoff * sinc(cutoff * t) * w;
    dc += h[i];
  }
  for (int i = 0; i < L; ++i) h[i] *= up / dc;  // firwin scale + up gain
  const int64_t n_in = int64_t(in.size());
  const int64_t n_out = (n_in * up + down - 1) / down;
  std::vector<float> out(size_t(n_out), 0.0f);

  // Polyphase banks: output j uses taps t ≡ (j*down + mid) (mod up), and
  // input index i = (j*down + mid - t) / up — a reversed contiguous dot
  // per phase.  Banks are stored reversed (ascending input order) in
  // float so the hot loop is a plain vectorizable mul-add over
  // consecutive samples, instead of the per-tap int64 index arithmetic
  // of the naive form (~5x on the 44.1k→22.05k path).
  const size_t n_phases = size_t(up);
  std::vector<std::vector<float>> bank(n_phases);
  for (int p = 0; p < up; ++p) {
    const int nk = (L - p + up - 1) / up;  // taps p, p+up, ... < L
    bank[size_t(p)].resize(size_t(nk));
    for (int k = 0; k < nk; ++k)
      bank[size_t(p)][size_t(nk - 1 - k)] = float(h[size_t(p + k * up)]);
  }
  for (int64_t j = 0; j < n_out; ++j) {
    const int64_t center = j * down;
    const int r = int((center + mid) % up);
    const std::vector<float>& hb = bank[size_t(r)];
    const int nk = int(hb.size());
    const int64_t ibase = (center + mid - r) / up;   // input for tap r
    const int64_t i0 = ibase - nk + 1;               // input for last tap
    if (i0 >= 0 && ibase < n_in) {
      // float accumulation in 8 partials: SIMD-friendly; error is ~1e-7
      // relative over <=41 taps of 16/24-bit-quantized audio
      const float* x = in.data() + i0;
      const float* hc = hb.data();
      float a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int k = 0;
      for (; k + 8 <= nk; k += 8)
        for (int u = 0; u < 8; ++u) a[u] += x[k + u] * hc[k + u];
      float acc = ((a[0] + a[1]) + (a[2] + a[3])) +
                  ((a[4] + a[5]) + (a[6] + a[7]));
      for (; k < nk; ++k) acc += x[k] * hc[k];
      out[size_t(j)] = acc;
    } else {  // filter overlaps the signal edge: clamped scalar form
      double acc = 0.0;
      const int64_t lo = std::max<int64_t>(0, i0);
      const int64_t hi = std::min<int64_t>(n_in - 1, ibase);
      for (int64_t i = lo; i <= hi; ++i)
        acc += double(in[size_t(i)]) * hb[size_t(nk - 1 - (ibase - i))];
      out[size_t(j)] = float(acc);
    }
  }
  return out;
}

}  // namespace

namespace {

// Decode + mono + resample + truncate/pad into out[0..out_len).  The body
// of tpuvae_load_audio, factored out so tpuvae_load_audio_rows can write
// the samples at an offset inside a larger (pre-rowed) destination.
int load_audio_into(const char* path, int target_sr, double duration,
                    float* out, int64_t out_len) try {
  WavData w;
  // dispatch on container magic, not extension
  bool decoded = false;
  if (FILE* f = std::fopen(path, "rb")) {
    char magic[4] = {0, 0, 0, 0};
    const size_t got = std::fread(magic, 1, 4, f);
    std::fclose(f);
    if (got == 4 && !std::memcmp(magic, "fLaC", 4))
      decoded = read_flac(path, &w);
    else
      decoded = read_wav(path, &w);
  }
  if (!decoded) return 1;
  // mono mixdown
  const size_t frames = w.samples.size() / size_t(w.channels);
  std::vector<float> mono(frames);
  if (w.channels == 1) {
    mono = std::move(w.samples);
  } else {
    for (size_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < w.channels; ++c)
        acc += w.samples[i * w.channels + c];
      mono[i] = float(acc / w.channels);
    }
  }
  // truncate at native rate first (librosa truncates at load)
  if (duration > 0) {
    const size_t keep =
        size_t(std::llround(duration * double(w.sample_rate)));
    if (mono.size() > keep) mono.resize(keep);
  }
  if (w.sample_rate == target_sr) {
    // already at rate: place directly, skipping resample()'s return copy
    const size_t n = size_t(out_len);
    const size_t have = mono.size() < n ? mono.size() : n;
    std::memcpy(out, mono.data(), have * sizeof(float));
    if (have < n) std::memset(out + have, 0, (n - have) * sizeof(float));
    return 0;
  }
  std::vector<float> res = resample(mono, w.sample_rate, target_sr);
  const size_t n = size_t(out_len);
  for (size_t i = 0; i < n; ++i) out[i] = (i < res.size()) ? res[i] : 0.0f;
  return 0;
} catch (...) {
  // never let bad_alloc etc. cross the C ABI into the Python process
  return 2;
}

}  // namespace

extern "C" {

// Decode + mono + resample + truncate/pad.  Returns 0 on success.
// out must hold out_len floats (= target_sr * duration).
int tpuvae_load_audio(const char* path, int target_sr, double duration,
                      float* out, int64_t out_len) {
  return load_audio_into(path, target_sr, duration, out, out_len);
}

// Decode one clip directly into a pre-rowed STFT destination: zeros
// [0, offset), the decoded clip at [offset, offset + sr*duration), zeros
// up to total_len (offset n_fft//2 pre-pads a centred STFT; the port's
// pipelines pass offset 0 and total_len = sr*duration), so a loader
// thread fills one row of the device batch buffer in a single pass — no
// intermediate clip array, no host re-stack.
int tpuvae_load_audio_rows(const char* path, int target_sr, double duration,
                           float* out, int64_t total_len, int64_t offset) {
  if (offset < 0 || offset > total_len) return 3;
  int64_t n = int64_t(std::llround(double(target_sr) * duration));
  if (n > total_len - offset) n = total_len - offset;
  std::memset(out, 0, size_t(offset) * sizeof(float));
  const int rc = load_audio_into(path, target_sr, duration, out + offset, n);
  std::memset(out + offset + n, 0,
              size_t(total_len - offset - n) * sizeof(float));
  return rc;
}

// Like tpuvae_load_audio_rows but emitting int16 PCM (the device widens
// with x * 2^-15): halves the host->device transfer bytes.
// Round-to-nearest with clamp; int16 sources at the target rate round-trip
// BIT-EXACTLY (k/32768 * 32768 == k in float32), so the fast-mode default
// loses nothing on the reference's own WAV data; resampled/float sources
// see one <= 1.5e-5 quantization, far below fast mode's bf16 tolerances.
int tpuvae_load_audio_rows_i16(const char* path, int target_sr,
                               double duration, int16_t* out,
                               int64_t total_len, int64_t offset) try {
  if (offset < 0 || offset > total_len) return 3;
  int64_t n = int64_t(std::llround(double(target_sr) * duration));
  if (n > total_len - offset) n = total_len - offset;
  std::vector<float> tmp(static_cast<size_t>(n), 0.0f);
  const int rc = load_audio_into(path, target_sr, duration, tmp.data(), n);
  if (rc != 0) return rc;
  std::memset(out, 0, size_t(offset) * sizeof(int16_t));
  int16_t* dst = out + offset;
  for (int64_t i = 0; i < n; ++i) {
    float v = tmp[size_t(i)] * 32768.0f;
    v = v < -32768.0f ? -32768.0f : (v > 32767.0f ? 32767.0f : v);
    dst[i] = int16_t(std::lrintf(v));
  }
  std::memset(out + offset + n, 0,
              size_t(total_len - offset - n) * sizeof(int16_t));
  return 0;
} catch (...) {
  return 2;
}

// Batch variant: decode `count` paths (NUL-separated) into a contiguous
// (count, out_len) buffer.  Per-file failures zero-fill and set status[i]=1.
int tpuvae_load_audio_batch(const char* paths, int count, int target_sr,
                            double duration, float* out, int64_t out_len,
                            int* status) {
  const char* p = paths;
  for (int i = 0; i < count; ++i) {
    float* row = out + int64_t(i) * out_len;
    status[i] = tpuvae_load_audio(p, target_sr, duration, row, out_len);
    if (status[i] != 0) std::memset(row, 0, size_t(out_len) * sizeof(float));
    p += std::strlen(p) + 1;
  }
  return 0;
}

int tpuvae_native_version() { return 3; }
}
