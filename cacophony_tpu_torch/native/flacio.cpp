// Native FLAC decoder for the host IO path.
//
// Completes the soundfile/libsndfile replacement (the reference reads
// eval audio through soundfile, src/eval/eval_utils.py:6-16, whose
// libsndfile backend also decodes FLAC).  Implemented from the public
// FLAC format specification (RFC 9639): STREAMINFO parsing, frame sync,
// all four subframe types (constant / verbatim / fixed 0-4 / LPC up to
// order 32), Rice and Rice2 partitioned residuals with escape codes,
// wasted bits, and left-side / right-side / mid-side stereo
// decorrelation.  CRCs are read but not verified (decode integrity is
// checked end-to-end by the round-trip tests).  Output contract matches
// the WAV decoder: mono-mixed float32 in [-1, 1) + native sample rate.
//
// Compiled with wavio.cpp into one library (native/wavio.py); dispatched by file magic
// in wavio.cpp's decode_audio_buffer.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace cacoph_flac {

struct BitReader {
  const uint8_t* buf;
  size_t len;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0 = MSB next
  bool fail = false;

  BitReader(const uint8_t* b, size_t l) : buf(b), len(l) {}

  bool eof() const { return byte_pos >= len; }

  uint32_t bit() {
    if (byte_pos >= len) { fail = true; return 0; }
    uint32_t v = (buf[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return v;
  }

  uint64_t bits(int n) {  // n <= 57
    uint64_t v = 0;
    // fast path: byte-aligned whole bytes
    while (n >= 8 && bit_pos == 0) {
      if (byte_pos >= len) { fail = true; return 0; }
      v = (v << 8) | buf[byte_pos++];
      n -= 8;
    }
    for (; n > 0; --n) v = (v << 1) | bit();
    return v;
  }

  int64_t sbits(int n) {  // signed, two's complement
    if (n == 0) return 0;
    uint64_t v = bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint32_t unary() {  // n zero bits then a one
    uint32_t n = 0;
    while (!fail && bit() == 0) {
      ++n;
      if (n > 1u << 24) { fail = true; break; }  // corrupt stream guard
    }
    return n;
  }

  void align() { if (bit_pos) { bit_pos = 0; ++byte_pos; } }
};

// UTF-8-style coded frame/sample number (up to 36/48 bits)
bool read_coded_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.bits(8);
  int extra;
  uint64_t v;
  if (b0 < 0x80) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint32_t b = (uint32_t)br.bits(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return !br.fail;
}

bool read_residual(BitReader& br, int blocksize, int order,
                   int32_t* res /* blocksize-order entries */) {
  uint32_t method = (uint32_t)br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  uint32_t po = (uint32_t)br.bits(4);
  uint32_t nparts = 1u << po;
  if (blocksize % nparts != 0) return false;
  int idx = 0;
  for (uint32_t p = 0; p < nparts; ++p) {
    int count = (int)(blocksize >> po) - (p == 0 ? order : 0);
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.bits(plen);
    if (param == escape) {
      uint32_t width = (uint32_t)br.bits(5);
      for (int i = 0; i < count; ++i) res[idx++] = (int32_t)br.sbits((int)width);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.unary();
        uint64_t lo = br.bits((int)param);
        uint64_t u = ((uint64_t)q << param) | lo;
        res[idx++] = (u & 1) ? -(int32_t)(u >> 1) - 1 : (int32_t)(u >> 1);
        if (br.fail) return false;
      }
    }
  }
  return !br.fail;
}

bool read_subframe(BitReader& br, int blocksize, int bps,
                   std::vector<int64_t>& out) {
  if (br.bit() != 0) return false;  // mandatory zero pad
  uint32_t type = (uint32_t)br.bits(6);
  int wasted = 0;
  if (br.bit() == 1) wasted = (int)br.unary() + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  out.assign(blocksize, 0);
  std::vector<int32_t> res;

  if (type == 0) {  // constant
    int64_t v = br.sbits(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < blocksize; ++i) out[i] = br.sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 7) <= 4) {  // fixed
    int order = (int)(type & 7);
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    res.resize(blocksize - order);
    if (!read_residual(br, blocksize, order, res.data())) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t p;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = out[i - 1]; break;
        case 2: p = 2 * out[i - 1] - out[i - 2]; break;
        case 3: p = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        default: p = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                     - out[i - 4]; break;
      }
      out[i] = p + res[i - order];
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1F) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    uint32_t prec = (uint32_t)br.bits(4);
    if (prec == 15) return false;
    int precision = (int)prec + 1;
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(precision);
    res.resize(blocksize - order);
    if (!read_residual(br, blocksize, order, res.data())) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
      out[i] = (acc >> shift) + res[i - order];
    }
  } else {
    return false;  // reserved
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return !br.fail;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

// → mono float32 samples; true on success.
bool decode(const uint8_t* buf, size_t len, float** out_data, int64_t* out_n,
            int32_t* out_rate) {
  if (len < 8 || memcmp(buf, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  StreamInfo si;
  bool have_si = false, last = false;
  while (!last && pos + 4 <= len) {
    uint8_t hdr = buf[pos];
    last = (hdr & 0x80) != 0;
    uint32_t btype = hdr & 0x7F;
    uint32_t blen = ((uint32_t)buf[pos + 1] << 16) |
                    ((uint32_t)buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (pos + blen > len) return false;
    if (btype == 0 && blen >= 34) {
      BitReader br(buf + pos, blen);
      br.bits(16); br.bits(16); br.bits(24); br.bits(24);
      si.sample_rate = (uint32_t)br.bits(20);
      si.channels = (int)br.bits(3) + 1;
      si.bps = (int)br.bits(5) + 1;
      si.total_samples = br.bits(36);
      have_si = true;
    }
    pos += blen;
  }
  if (!have_si || si.sample_rate == 0 || si.channels < 1 || si.channels > 8)
    return false;

  std::vector<float> mono;
  if (si.total_samples) mono.reserve((size_t)si.total_samples);
  std::vector<int64_t> ch[8];

  BitReader br(buf + pos, len - pos);
  while (!br.eof() && !br.fail &&
         (si.total_samples == 0 || mono.size() < si.total_samples)) {
    br.align();
    if (br.byte_pos + 2 > br.len) break;
    // frame sync: 11111111 111110xx
    if ((uint32_t)br.bits(14) != 0x3FFE) break;
    br.bit();                        // reserved
    br.bit();                        // blocking strategy
    uint32_t bs_code = (uint32_t)br.bits(4);
    uint32_t sr_code = (uint32_t)br.bits(4);
    uint32_t ch_code = (uint32_t)br.bits(4);
    uint32_t ss_code = (uint32_t)br.bits(3);
    br.bit();                        // reserved
    uint64_t num;
    if (!read_coded_number(br, &num)) return false;

    int blocksize;
    switch (bs_code) {
      case 0: return false;  // reserved
      case 1: blocksize = 192; break;
      case 6: blocksize = (int)br.bits(8) + 1; break;
      case 7: blocksize = (int)br.bits(16) + 1; break;
      default:
        blocksize = bs_code <= 5 ? 576 << (bs_code - 2) : 256 << (bs_code - 8);
    }
    switch (sr_code) {
      case 12: br.bits(8); break;
      case 13: case 14: br.bits(16); break;
      case 15: return false;
      default: break;  // coded or from streaminfo; streaminfo rules
    }
    int bps;
    switch (ss_code) {
      case 0: bps = si.bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return false;
    }
    br.bits(8);  // header CRC-8 (not verified)

    int nch;
    if (ch_code < 8) {
      nch = (int)ch_code + 1;
      if (nch != si.channels) return false;
      for (int c = 0; c < nch; ++c)
        if (!read_subframe(br, blocksize, bps, ch[c])) return false;
    } else if (ch_code <= 10) {
      nch = 2;
      if (si.channels != 2) return false;
      // the side channel carries one extra bit
      int bps0 = bps + (ch_code == 9 ? 1 : 0);
      int bps1 = bps + (ch_code == 9 ? 0 : 1);
      if (!read_subframe(br, blocksize, bps0, ch[0])) return false;
      if (!read_subframe(br, blocksize, bps1, ch[1])) return false;
      if (ch_code == 8) {        // left/side: right = left - side
        for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
      } else if (ch_code == 9) { // right/side: left = side + right
        for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[0][i] + ch[1][i];
      } else {                   // mid/side
        for (int i = 0; i < blocksize; ++i) {
          int64_t side = ch[1][i];
          int64_t mid = (ch[0][i] << 1) | (side & 1);
          ch[0][i] = (mid + side) >> 1;
          ch[1][i] = (mid - side) >> 1;
        }
      }
    } else {
      return false;
    }
    br.align();
    br.bits(16);  // frame CRC-16 (not verified)
    if (br.fail) return false;

    double scale = 1.0 / (double)(1ll << (bps - 1));
    int64_t remaining = si.total_samples
        ? (int64_t)si.total_samples - (int64_t)mono.size() : blocksize;
    int take = blocksize < remaining ? blocksize : (int)remaining;
    for (int i = 0; i < take; ++i) {
      double acc = 0.0;
      for (int c = 0; c < (ch_code < 8 ? nch : 2); ++c)
        acc += (double)ch[c][i] * scale;
      mono.push_back((float)(acc / (ch_code < 8 ? nch : 2)));
    }
  }
  if (mono.empty()) return false;
  if (si.total_samples && mono.size() < si.total_samples) return false;

  *out_data = (float*)malloc(sizeof(float) * mono.size());
  memcpy(*out_data, mono.data(), sizeof(float) * mono.size());
  *out_n = (int64_t)mono.size();
  *out_rate = (int32_t)si.sample_rate;
  return true;
}

}  // namespace cacoph_flac
