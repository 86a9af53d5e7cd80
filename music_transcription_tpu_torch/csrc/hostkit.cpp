// hostkit: native host-side loops of the data loader (C++, not a device
// kernel).
//
// WAV window decode with mono mixdown, and the velocity-summed piano-roll
// fill. A plain C interface, bound with ctypes by
// music_transcription_tpu_torch/native.py, which builds this file with the
// system C++ compiler at first use into build/host/ (it is not one of the
// nvcc sources of ops/_build.py). The numpy versions in data/audio.py and
// data/midi.py stay as the fallback and as the tests' oracle.
//
// Build by hand: g++ -O3 -shared -fPIC hostkit.cpp -o libhostkit.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t format;     // 1 = PCM, 3 = IEEE float
  int32_t channels;
  int32_t sample_rate;
  int32_t bits;
  int64_t data_offset;
  int64_t n_frames;
};

// Parse the RIFF header. Returns 0 on success, negative error code otherwise.
static int parse_header(FILE* f, WavInfo* info) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return -1;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0) return -2;
  bool have_fmt = false, have_data = false;
  while (!have_fmt || !have_data) {
    unsigned char chunk[8];
    if (fread(chunk, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      std::vector<unsigned char> fmt(size);
      if (fread(fmt.data(), 1, size, f) != size) return -3;
      uint16_t code, channels, bits;
      uint32_t sr;
      memcpy(&code, fmt.data(), 2);
      memcpy(&channels, fmt.data() + 2, 2);
      memcpy(&sr, fmt.data() + 4, 4);
      memcpy(&bits, fmt.data() + 14, 2);
      if (code == 0xFFFE && size >= 26) memcpy(&code, fmt.data() + 24, 2);
      info->format = code;
      info->channels = channels;
      info->sample_rate = (int32_t)sr;
      info->bits = bits;
      have_fmt = true;
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (memcmp(chunk, "data", 4) == 0) {
      info->data_offset = ftell(f);
      // n_frames filled after fmt known; store byte size temporarily
      info->n_frames = (int64_t)size;
      have_data = true;
      fseek(f, (long)(size + (size & 1)), SEEK_CUR);
    } else {
      fseek(f, (long)(size + (size & 1)), SEEK_CUR);
    }
  }
  if (!have_fmt || !have_data) return -4;
  int bytes_per_frame = info->channels * (info->bits / 8);
  if (bytes_per_frame <= 0) return -5;
  info->n_frames /= bytes_per_frame;
  return 0;
}

// Fill *info for a WAV file. Returns 0 on success.
int mt_wav_info(const char* path, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  int rc = parse_header(f, info);
  fclose(f);
  return rc;
}

// Decode [start_frame, start_frame + n_frames) to float32 mono (channel
// mean). Returns frames written, or a negative error code.
int64_t mt_decode_wav(const char* path, int64_t start_frame, int64_t n_frames,
                      float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  WavInfo info;
  int rc = parse_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  start_frame = std::min(start_frame, info.n_frames);
  n_frames = std::min(n_frames, info.n_frames - start_frame);
  if (n_frames <= 0) { fclose(f); return 0; }

  const int ch = info.channels;
  const int bytes_per_sample = info.bits / 8;
  const int64_t bytes_per_frame = (int64_t)ch * bytes_per_sample;
  fseek(f, (long)(info.data_offset + start_frame * bytes_per_frame), SEEK_SET);

  std::vector<unsigned char> buf((size_t)(n_frames * bytes_per_frame));
  size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  int64_t frames = (int64_t)(got / bytes_per_frame);
  const float inv_ch = 1.0f / (float)ch;

  if (info.format == 1 && info.bits == 16) {
    const int16_t* s = (const int16_t*)buf.data();
    for (int64_t i = 0; i < frames; i++) {
      float acc = 0.f;
      for (int c = 0; c < ch; c++) acc += (float)s[i * ch + c];
      out[i] = acc * inv_ch * (1.0f / 32768.0f);
    }
  } else if (info.format == 1 && info.bits == 24) {
    const unsigned char* s = buf.data();
    for (int64_t i = 0; i < frames; i++) {
      float acc = 0.f;
      for (int c = 0; c < ch; c++) {
        const unsigned char* p = s + (i * ch + c) * 3;
        int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
        v -= (v & 0x800000) << 1;  // sign extend
        acc += (float)v;
      }
      out[i] = acc * inv_ch * (1.0f / 8388608.0f);
    }
  } else if (info.format == 1 && info.bits == 32) {
    const int32_t* s = (const int32_t*)buf.data();
    for (int64_t i = 0; i < frames; i++) {
      float acc = 0.f;
      for (int c = 0; c < ch; c++) acc += (float)s[i * ch + c];
      out[i] = acc * inv_ch * (1.0f / 2147483648.0f);
    }
  } else if (info.format == 1 && info.bits == 8) {
    const unsigned char* s = buf.data();
    for (int64_t i = 0; i < frames; i++) {
      float acc = 0.f;
      for (int c = 0; c < ch; c++) acc += ((float)s[i * ch + c] - 128.0f);
      out[i] = acc * inv_ch * (1.0f / 128.0f);
    }
  } else if (info.format == 3 && info.bits == 32) {
    const float* s = (const float*)buf.data();
    for (int64_t i = 0; i < frames; i++) {
      float acc = 0.f;
      for (int c = 0; c < ch; c++) acc += s[i * ch + c];
      out[i] = acc * inv_ch;
    }
  } else if (info.format == 3 && info.bits == 64) {
    const double* s = (const double*)buf.data();
    for (int64_t i = 0; i < frames; i++) {
      double acc = 0.0;
      for (int c = 0; c < ch; c++) acc += s[i * ch + c];
      out[i] = (float)(acc * inv_ch);
    }
  } else {
    return -20;  // unsupported encoding
  }
  return frames;
}

// ---------------------------------------------------------------------------
// Piano-roll fill: the pretty_midi inner loop
// (velocity-summed note fill over an fs-spaced grid, 128 pitches)
// ---------------------------------------------------------------------------

// notes: arrays of length n; roll: (128, n_cols) row-major float64.
void mt_fill_roll(int64_t n, const int32_t* pitches, const double* starts,
                  const double* ends, const int32_t* velocities, double fs,
                  int64_t n_cols, double* roll) {
  for (int64_t i = 0; i < n; i++) {
    int p = pitches[i];
    if (p < 0 || p > 127) continue;
    int64_t a = (int64_t)(starts[i] * fs);
    int64_t b = (int64_t)(ends[i] * fs);
    a = std::max<int64_t>(0, std::min(a, n_cols));
    b = std::max<int64_t>(0, std::min(b, n_cols));
    double* row = roll + (int64_t)p * n_cols;
    for (int64_t t = a; t < b; t++) row[t] += (double)velocities[i];
  }
}

}  // extern "C"
