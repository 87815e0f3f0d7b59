// Native WAV/FLAC decoder + batch loader for the host IO path.
//
// Replaces the reference's soundfile/libsndfile dependency
// (src/eval/eval_utils.py:6-16) on the decode side: RIFF/WAVE parsing for
// PCM 8/16/24/32-bit and IEEE float32/64, FLAC (flacio.cpp, dispatched by
// file magic), mono mixdown, and a pthread pool for decoding evaluation
// batches in parallel with device compute.  Exposed to Python via a plain
// C ABI (ctypes) — no pybind11 dependency.
//
// Built at first use by cacophony_tpu_torch/native/wavio.py (g++ -O3 -shared
// -fPIC, with flacio.cpp) into cacophony_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace cacoph_flac {
bool decode(const uint8_t* buf, size_t len, float** out_data, int64_t* out_n,
            int32_t* out_rate);
}

namespace {

struct Decoded {
  float* data = nullptr;  // mono samples, malloc'd
  int64_t n = 0;
  int32_t sample_rate = 0;
  int32_t ok = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

bool decode_wav_buffer(const uint8_t* buf, size_t len, Decoded* out) {
  if (len < 44 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;

  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= len) {
    const uint8_t* chunk = buf + pos;
    uint32_t chunk_len = rd_u32(chunk + 4);
    if (memcmp(chunk, "fmt ", 4) == 0 && chunk_len >= 16 && pos + 8 + 16 <= len) {
      format = rd_u16(chunk + 8);
      channels = rd_u16(chunk + 10);
      sample_rate = rd_u32(chunk + 12);
      bits = rd_u16(chunk + 22);
      // WAVE_FORMAT_EXTENSIBLE: the sub-format lives 24 bytes into the fmt
      // body — bound-check against the BUFFER, not just the declared
      // chunk_len (truncated files lie about chunk_len)
      if (format == 0xFFFE && chunk_len >= 40 && pos + 8 + 26 <= len)
        format = rd_u16(chunk + 8 + 24);
    } else if (memcmp(chunk, "data", 4) == 0) {
      data = chunk + 8;
      data_len = chunk_len;
      if ((size_t)(data - buf) + data_len > len) data_len = len - (data - buf);
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!data || !channels || !sample_rate) return false;

  int64_t frames;
  switch (format) {
    case 1: {  // PCM
      if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return false;
      int bytes = bits / 8;
      frames = data_len / (bytes * channels);
      out->data = (float*)malloc(sizeof(float) * frames);
      for (int64_t i = 0; i < frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c) {
          const uint8_t* s = data + (i * channels + c) * bytes;
          double v = 0.0;
          if (bits == 8) {
            v = ((double)s[0] - 128.0) / 128.0;
          } else if (bits == 16) {
            int16_t x = (int16_t)((uint16_t)s[0] | ((uint16_t)s[1] << 8));
            v = (double)x / 32768.0;
          } else if (bits == 24) {
            int32_t x = (int32_t)(((uint32_t)s[0] << 8) | ((uint32_t)s[1] << 16) |
                                  ((uint32_t)s[2] << 24)) >> 8;
            v = (double)x / 8388608.0;
          } else {
            int32_t x = (int32_t)rd_u32(s);
            v = (double)x / 2147483648.0;
          }
          acc += v;
        }
        out->data[i] = (float)(acc / channels);
      }
      break;
    }
    case 3: {  // IEEE float
      if (bits != 32 && bits != 64) return false;
      int bytes = bits / 8;
      frames = data_len / (bytes * channels);
      out->data = (float*)malloc(sizeof(float) * frames);
      for (int64_t i = 0; i < frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c) {
          const uint8_t* s = data + (i * channels + c) * bytes;
          if (bits == 32) {
            float f;
            memcpy(&f, s, 4);
            acc += f;
          } else {
            double d;
            memcpy(&d, s, 8);
            acc += d;
          }
        }
        out->data[i] = (float)(acc / channels);
      }
      break;
    }
    default:
      return false;
  }
  out->n = frames;
  out->sample_rate = (int32_t)sample_rate;
  out->ok = 1;
  return true;
}

bool decode_audio_buffer(const uint8_t* buf, size_t len, Decoded* out) {
  if (len >= 4 && memcmp(buf, "fLaC", 4) == 0) {
    out->ok = cacoph_flac::decode(buf, len, &out->data, &out->n,
                                  &out->sample_rate) ? 1 : 0;
    return out->ok != 0;
  }
  return decode_wav_buffer(buf, len, out);
}

bool decode_wav_file(const char* path, Decoded* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)len);
  size_t got = fread(buf.data(), 1, (size_t)len, f);
  fclose(f);
  if (got != (size_t)len) return false;
  return decode_audio_buffer(buf.data(), buf.size(), out);
}

}  // namespace

extern "C" {

// Decode one file (WAV or FLAC, by magic). Returns 1 on success; caller
// must free with cacoph_free.  The name predates FLAC support; kept for
// ABI stability.
int cacoph_decode_wav(const char* path, float** data, int64_t* n,
                      int32_t* sample_rate) {
  Decoded d;
  if (!decode_wav_file(path, &d)) return 0;
  *data = d.data;
  *n = d.n;
  *sample_rate = d.sample_rate;
  return 1;
}

// Batch decode with a thread pool straight into caller-provided fixed-size
// buffers (zero-padded / truncated): out shape (count, buffer_samples),
// lengths (count,), rates (count,). ok[i] = 1 on success.
void cacoph_decode_batch(const char** paths, int32_t count,
                         float* out, int64_t buffer_samples,
                         int32_t* lengths, int32_t* rates, int32_t* ok,
                         int32_t num_threads) {
  if (num_threads <= 0) num_threads = (int32_t)std::thread::hardware_concurrency();
  if (num_threads > count) num_threads = count;
  if (num_threads < 1) num_threads = 1;

  std::vector<std::thread> workers;
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([=]() {
      for (int32_t i = t; i < count; i += num_threads) {
        Decoded d;
        float* row = out + (int64_t)i * buffer_samples;
        memset(row, 0, sizeof(float) * buffer_samples);
        if (decode_wav_file(paths[i], &d)) {
          int64_t n = d.n < buffer_samples ? d.n : buffer_samples;
          memcpy(row, d.data, sizeof(float) * n);
          lengths[i] = (int32_t)n;
          rates[i] = d.sample_rate;
          ok[i] = 1;
          free(d.data);
        } else {
          lengths[i] = 0;
          rates[i] = 0;
          ok[i] = 0;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
}

void cacoph_free(float* p) { free(p); }

}  // extern "C"
