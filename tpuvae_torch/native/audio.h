// Shared decode target for the native audio loaders (wavload.cpp, flac.cpp).
#ifndef TPUVAE_NATIVE_AUDIO_H_
#define TPUVAE_NATIVE_AUDIO_H_

#include <vector>

struct WavData {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sample_rate = 0;
};

// flac.cpp: decode a FLAC file (CONSTANT/VERBATIM/FIXED/LPC subframes,
// RICE/RICE2 partitioned residuals, wasted bits, stereo decorrelation,
// CRC-8/16 verification).  Returns false on any parse/CRC error.
bool read_flac(const char* path, WavData* out);

#endif  // TPUVAE_NATIVE_AUDIO_H_
