// Native FLAC decoder for the production audio loader.
//
// First-party equivalent of the FLAC leg of the reference's librosa.load
// path (src/1_preprocessing.py:137-153 — librosa decodes FLAC through the
// third-party soundfile/libsndfile C library).  Behavioral reference:
// tpuvae_torch/io/flac.py (pure-Python decoder, bit-identical output; both
// verified against each other and against round-trips of the first-party
// encoder).  Subset: everything real encoders emit — CONSTANT / VERBATIM /
// FIXED 0-4 / LPC 1-32 subframes, RICE and RICE2 partitioned residuals
// incl. escape codes, wasted bits, all four stereo modes, CRC-8/CRC-16
// verification.  Format per RFC 9639.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "audio.h"

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos = 0)
      : data_(data), size_(size), byte_(pos), bit_(0), fail_(false) {}

  bool eof() const { return byte_ >= size_; }
  bool failed() const { return fail_; }
  size_t byte_pos() const { return byte_; }

  uint64_t read(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_ >= size_) {
        fail_ = true;
        return 0;
      }
      const int avail = 8 - bit_;
      const int take = n < avail ? n : avail;
      const uint8_t cur = data_[byte_];
      v = (v << take) | ((cur >> (avail - take)) & ((1u << take) - 1));
      bit_ += take;
      n -= take;
      if (bit_ == 8) {
        bit_ = 0;
        ++byte_;
      }
    }
    return v;
  }

  int64_t read_signed(int n) {
    const uint64_t v = read(n);
    if (n == 0) return 0;
    return (v >= (uint64_t(1) << (n - 1))) ? int64_t(v) - (int64_t(1) << n)
                                           : int64_t(v);
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!fail_ && read(1) == 0) {
      ++q;
      if (q > (1u << 24)) {  // corrupt-stream guard
        fail_ = true;
        return 0;
      }
    }
    return q;
  }

  void align() {
    if (bit_) {
      bit_ = 0;
      ++byte_;
    }
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t byte_;
  int bit_;
  bool fail_;
};

uint8_t crc8(const uint8_t* p, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= p[i];
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x80) ? uint8_t((crc << 1) ^ 0x07) : uint8_t(crc << 1);
  }
  return crc;
}

uint16_t crc16(const uint8_t* p, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= uint16_t(p[i]) << 8;
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x8000) ? uint16_t((crc << 1) ^ 0x8005)
                           : uint16_t(crc << 1);
  }
  return crc;
}

const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool read_utf8_number(BitReader* r, uint64_t* out) {
  const uint32_t b0 = uint32_t(r->read(8));
  if (r->failed()) return false;
  if (b0 < 0x80) {
    *out = b0;
    return true;
  }
  int n_follow = 0;
  uint64_t value = 0;
  if ((b0 & 0xE0) == 0xC0) { n_follow = 1; value = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { n_follow = 2; value = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { n_follow = 3; value = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { n_follow = 4; value = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { n_follow = 5; value = b0 & 0x01; }
  else if (b0 == 0xFE) { n_follow = 6; value = 0; }
  else return false;
  for (int i = 0; i < n_follow; ++i) {
    const uint32_t b = uint32_t(r->read(8));
    if (r->failed() || (b & 0xC0) != 0x80) return false;
    value = (value << 6) | (b & 0x3F);
  }
  *out = value;
  return true;
}

bool decode_residual(BitReader* r, int block_size, int order,
                     std::vector<int64_t>* res) {
  const int method = int(r->read(2));
  if (r->failed() || method > 1) return false;
  const int plen = method == 0 ? 4 : 5;
  const uint32_t escape = (1u << plen) - 1;
  const int po = int(r->read(4));
  const int n_part = 1 << po;
  if (block_size % n_part) return false;
  res->clear();
  res->reserve(size_t(block_size - order));
  for (int p = 0; p < n_part; ++p) {
    int count = (block_size >> po) - (p == 0 ? order : 0);
    if (count < 0) return false;
    const uint32_t param = uint32_t(r->read(plen));
    if (param == escape) {
      const int nbits = int(r->read(5));
      for (int i = 0; i < count; ++i)
        res->push_back(nbits ? r->read_signed(nbits) : 0);
    } else {
      for (int i = 0; i < count; ++i) {
        const uint64_t q = r->read_unary();
        const uint64_t u = (q << param) | (param ? r->read(int(param)) : 0);
        res->push_back(int64_t(u >> 1) ^ -int64_t(u & 1));  // un-zigzag
      }
    }
    if (r->failed()) return false;
  }
  return true;
}

bool decode_subframe(BitReader* r, int block_size, int depth,
                     std::vector<int64_t>* x) {
  if (r->read(1)) return false;  // padding bit must be 0
  const int sf_type = int(r->read(6));
  int wasted = 0;
  if (r->read(1)) wasted = int(r->read_unary()) + 1;
  if (r->failed()) return false;
  depth -= wasted;
  if (depth <= 0 || depth > 33) return false;

  x->clear();
  x->reserve(size_t(block_size));
  std::vector<int64_t> res;
  if (sf_type == 0) {  // CONSTANT
    const int64_t v = r->read_signed(depth);
    x->assign(size_t(block_size), v);
  } else if (sf_type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) x->push_back(r->read_signed(depth));
  } else if (sf_type >= 8 && sf_type <= 12) {  // FIXED
    const int order = sf_type - 8;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) x->push_back(r->read_signed(depth));
    if (!decode_residual(r, block_size, order, &res)) return false;
    for (size_t i = 0; i < res.size(); ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += int64_t(kFixedCoeffs[order][j]) *
                (*x)[x->size() - 1 - size_t(j)];
      x->push_back(pred + res[i]);
    }
  } else if (sf_type >= 32) {  // LPC
    const int order = sf_type - 31;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) x->push_back(r->read_signed(depth));
    const int precision = int(r->read(4)) + 1;
    if (precision == 16) return false;
    const int shift = int(r->read_signed(5));
    if (shift < 0) return false;
    std::vector<int64_t> coefs(static_cast<size_t>(order));
    for (int i = 0; i < order; ++i) coefs[size_t(i)] = r->read_signed(precision);
    if (!decode_residual(r, block_size, order, &res)) return false;
    for (size_t i = 0; i < res.size(); ++i) {
      int64_t acc = 0;  // 64-bit accumulation per spec
      for (int j = 0; j < order; ++j)
        acc += coefs[size_t(j)] * (*x)[x->size() - 1 - size_t(j)];
      x->push_back((acc >> shift) + res[i]);
    }
  } else {
    return false;  // reserved type
  }
  if (r->failed()) return false;
  if (wasted)
    for (auto& v : *x) v = int64_t(uint64_t(v) << wasted);
  return true;
}

}  // namespace

bool read_flac(const char* path, WavData* out) try {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 42) {  // magic + block header + STREAMINFO
    std::fclose(f);
    return false;
  }
  std::vector<uint8_t> data(static_cast<size_t>(fsize));
  const bool ok = std::fread(data.data(), 1, data.size(), f) == data.size();
  std::fclose(f);
  if (!ok || std::memcmp(data.data(), "fLaC", 4)) return false;

  // metadata blocks
  size_t pos = 4;
  const uint8_t* streaminfo = nullptr;
  while (pos + 4 <= data.size()) {
    const uint8_t hdr = data[pos];
    const bool last = hdr & 0x80;
    const int btype = hdr & 0x7F;
    const size_t size = (size_t(data[pos + 1]) << 16) |
                        (size_t(data[pos + 2]) << 8) | data[pos + 3];
    if (pos + 4 + size > data.size()) return false;
    if (btype == 0 && size >= 34) streaminfo = data.data() + pos + 4;
    pos += 4 + size;
    if (last) break;
  }
  if (!streaminfo) return false;
  BitReader si(streaminfo, 34);
  si.read(16);  // min block size
  si.read(16);  // max block size
  si.read(24);  // min frame size
  si.read(24);  // max frame size
  const int sr = int(si.read(20));
  const int channels = int(si.read(3)) + 1;
  const int bps = int(si.read(5)) + 1;
  const uint64_t total = si.read(36);
  if (sr == 0 || channels == 0) return false;

  std::vector<float> samples;
  if (total) samples.reserve(size_t(total) * size_t(channels));
  const float scale = float(uint64_t(1) << (bps - 1));
  BitReader r(data.data(), data.size(), pos);
  uint64_t n_done = 0;
  std::vector<int64_t> ch_a, ch_b;
  std::vector<std::vector<int64_t>> chans;
  while (!r.eof() && (total == 0 || n_done < total)) {
    const size_t frame_start = r.byte_pos();
    if (r.read(14) != 0x3FFE) return false;  // sync
    r.read(1);  // reserved
    r.read(1);  // blocking strategy
    const int bs_code = int(r.read(4));
    const int sr_code = int(r.read(4));
    const int ch_code = int(r.read(4));
    const int ss_code = int(r.read(3));
    r.read(1);  // reserved
    uint64_t fnum;
    if (!read_utf8_number(&r, &fnum)) return false;
    int block_size;
    switch (bs_code) {
      case 0: return false;
      case 1: block_size = 192; break;
      case 6: block_size = int(r.read(8)) + 1; break;
      case 7: block_size = int(r.read(16)) + 1; break;
      default:
        block_size = bs_code <= 5 ? 576 << (bs_code - 2)
                                  : 256 << (bs_code - 8);
    }
    if (sr_code == 12) r.read(8);
    else if (sr_code == 13 || sr_code == 14) r.read(16);
    else if (sr_code == 15) return false;
    static const int kSampleSize[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    const int depth = kSampleSize[ss_code] ? kSampleSize[ss_code] : bps;
    if (r.failed()) return false;
    const uint8_t want_crc8 = uint8_t(r.read(8));
    if (crc8(data.data() + frame_start,
             r.byte_pos() - 1 - frame_start) != want_crc8)
      return false;

    int n_ch;
    if (ch_code < 8) {
      n_ch = ch_code + 1;
      chans.assign(size_t(n_ch), {});
      for (int c = 0; c < n_ch; ++c)
        if (!decode_subframe(&r, block_size, depth, &chans[size_t(c)]))
          return false;
    } else if (ch_code <= 10) {
      n_ch = 2;
      const int extra_a = (ch_code == 9) ? 1 : 0;
      const int extra_b = (ch_code == 9) ? 0 : 1;
      if (!decode_subframe(&r, block_size, depth + extra_a, &ch_a) ||
          !decode_subframe(&r, block_size, depth + extra_b, &ch_b))
        return false;
      chans.assign(2, {});
      chans[0].resize(size_t(block_size));
      chans[1].resize(size_t(block_size));
      for (int i = 0; i < block_size; ++i) {
        if (ch_code == 8) {  // left/side
          chans[0][size_t(i)] = ch_a[size_t(i)];
          chans[1][size_t(i)] = ch_a[size_t(i)] - ch_b[size_t(i)];
        } else if (ch_code == 9) {  // side/right
          chans[0][size_t(i)] = ch_b[size_t(i)] + ch_a[size_t(i)];
          chans[1][size_t(i)] = ch_b[size_t(i)];
        } else {  // mid/side
          const int64_t m = ch_a[size_t(i)], s = ch_b[size_t(i)];
          const int64_t sum = (m << 1) | (s & 1);
          chans[0][size_t(i)] = (sum + s) >> 1;
          chans[1][size_t(i)] = (sum - s) >> 1;
        }
      }
    } else {
      return false;  // reserved channel assignment
    }
    if (n_ch != channels) return false;
    r.align();
    const uint16_t body_crc =
        crc16(data.data() + frame_start, r.byte_pos() - frame_start);
    if (uint16_t(r.read(16)) != body_crc || r.failed()) return false;

    for (int i = 0; i < block_size; ++i)
      for (int c = 0; c < channels; ++c)
        samples.push_back(float(chans[size_t(c)][size_t(i)]) / scale);
    n_done += uint64_t(block_size);
  }
  if (total && n_done > total)
    samples.resize(size_t(total) * size_t(channels));
  out->samples = std::move(samples);
  out->channels = channels;
  out->sample_rate = sr;
  return true;
} catch (...) {
  return false;
}
