// hostops — native host-side data ops of the data pipeline.
//
// A copy of multimodal_av_model_tpu/runtime/hostops.cpp (the port reads no
// file of the JAX package).  It covers the host side that the reference
// delegated to third-party native code:
//   * levenshtein        — WER/CER edit distance
//   * resize_bilinear_f32 — cv2 INTER_LINEAR-exact resize of lip crops
//   * pcm16_to_f32       — WAV PCM decode
//   * resample_linear_f32 — sample-rate conversion
//   * mix_and_mask_f32   — two-speaker mix + peak-norm + speaker masks
//
// Build: g++ -O3 -shared -fPIC, driven by runtime/native.py at first use.
// Plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Edit distance between two int32 token sequences (two-row DP).
int64_t levenshtein_i32(const int32_t* a, int64_t n, const int32_t* b, int64_t m) {
  if (n < m) { std::swap(a, b); std::swap(n, m); }
  if (m == 0) return n;
  std::vector<int64_t> prev(m + 1), cur(m + 1);
  for (int64_t j = 0; j <= m; ++j) prev[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = i;
    const int32_t ca = a[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t sub = prev[j - 1] + (ca != b[j - 1]);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// cv2 INTER_LINEAR resize of `count` independent [in_h, in_w] f32 images to
// [out_h, out_w] (half-pixel centers, edge clamp).
void resize_bilinear_f32(const float* src, float* dst, int64_t count,
                         int64_t in_h, int64_t in_w, int64_t out_h, int64_t out_w) {
  std::vector<int64_t> xlo(out_w), xhi(out_w), ylo(out_h), yhi(out_h);
  std::vector<float> xf(out_w), yf(out_h);
  const double sx = static_cast<double>(in_w) / out_w;
  const double sy = static_cast<double>(in_h) / out_h;
  for (int64_t x = 0; x < out_w; ++x) {
    double s = std::min(std::max((x + 0.5) * sx - 0.5, 0.0), static_cast<double>(in_w - 1));
    xlo[x] = static_cast<int64_t>(std::floor(s));
    xhi[x] = std::min(xlo[x] + 1, in_w - 1);
    xf[x] = static_cast<float>(s - xlo[x]);
  }
  for (int64_t y = 0; y < out_h; ++y) {
    double s = std::min(std::max((y + 0.5) * sy - 0.5, 0.0), static_cast<double>(in_h - 1));
    ylo[y] = static_cast<int64_t>(std::floor(s));
    yhi[y] = std::min(ylo[y] + 1, in_h - 1);
    yf[y] = static_cast<float>(s - ylo[y]);
  }
  for (int64_t c = 0; c < count; ++c) {
    const float* im = src + c * in_h * in_w;
    float* out = dst + c * out_h * out_w;
    for (int64_t y = 0; y < out_h; ++y) {
      const float* r0 = im + ylo[y] * in_w;
      const float* r1 = im + yhi[y] * in_w;
      const float fy = yf[y];
      float* orow = out + y * out_w;
      for (int64_t x = 0; x < out_w; ++x) {
        const float top = r0[xlo[x]] + (r0[xhi[x]] - r0[xlo[x]]) * xf[x];
        const float bot = r1[xlo[x]] + (r1[xhi[x]] - r1[xlo[x]]) * xf[x];
        orow[x] = top + (bot - top) * fy;
      }
    }
  }
}

// Little-endian PCM16 → f32 in [-1, 1); optional channel-mean downmix.
void pcm16_to_f32(const int16_t* src, float* dst, int64_t frames, int64_t channels) {
  const float scale = 1.0f / 32768.0f;
  if (channels == 1) {
    for (int64_t i = 0; i < frames; ++i) dst[i] = src[i] * scale;
  } else {
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int64_t c = 0; c < channels; ++c) acc += src[i * channels + c];
      dst[i] = acc * scale / channels;
    }
  }
}

// Linear-interpolation resampler (index mapping j -> j * in_rate / out_rate).
void resample_linear_f32(const float* src, int64_t n_in, float* dst, int64_t n_out,
                         double in_rate, double out_rate) {
  const double step = in_rate / out_rate;
  for (int64_t j = 0; j < n_out; ++j) {
    double s = j * step;
    int64_t lo = static_cast<int64_t>(s);
    if (lo >= n_in - 1) { dst[j] = src[n_in - 1]; continue; }
    float frac = static_cast<float>(s - lo);
    dst[j] = src[lo] + (src[lo + 1] - src[lo]) * frac;
  }
}

// Mix two utterances (lengths n1, n2) into `mixed` of length max(n1, n2);
// peak-normalize by max|mixed| + 1e-6; emit per-speaker masks with the code
// 0 = other-solo, 1 = overlap, 2 = target-solo (pad value 3 is the
// collator's concern).  Returns the mixed length.
int64_t mix_and_mask_f32(const float* a1, int64_t n1, const float* a2, int64_t n2,
                         float* mixed, int32_t* mask1, int32_t* mask2) {
  const int64_t n = std::max(n1, n2);
  float peak = 0.f;
  for (int64_t i = 0; i < n; ++i) {
    const float v1 = i < n1 ? a1[i] : 0.f;
    const float v2 = i < n2 ? a2[i] : 0.f;
    mixed[i] = v1 + v2;
    peak = std::max(peak, std::fabs(mixed[i]));
  }
  const float inv = 1.0f / (peak + 1e-6f);
  for (int64_t i = 0; i < n; ++i) mixed[i] *= inv;
  const int64_t lo = std::min(n1, n2);
  for (int64_t i = 0; i < lo; ++i) { mask1[i] = 1; mask2[i] = 1; }
  for (int64_t i = lo; i < n; ++i) {
    mask1[i] = (i < n1) ? 2 : 0;
    mask2[i] = (i < n2) ? 2 : 0;
  }
  return n;
}

}  // extern "C"
