// stereoio: the host-side data readers of the PyTorch port (its copy of the
// JAX package's native readers and photometric pass, code unchanged).
//
// GT file parsing (PFM, FLO) and the fused photometric transform applied to
// every training frame, loaded with ctypes by
// ppmstereo_tpu_torch/data/native.py. kernels/_build.py compiles it with
// g++ at first use into build/ppmstereo_tpu_torch/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- PFM ----
// Returns 0 on success. Two-phase: call with data=nullptr to query dims.
// Output is top-down (the file stores bottom-up for positive... negative
// scale little-endian as written by SceneFlow tooling).
int read_pfm(const char* path, float* data, int* height, int* width,
             int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  char header[3] = {0};
  if (std::fscanf(f, "%2s", header) != 1) { std::fclose(f); return -2; }
  int ch;
  if (std::strcmp(header, "PF") == 0) ch = 3;
  else if (std::strcmp(header, "Pf") == 0) ch = 1;
  else { std::fclose(f); return -3; }

  int w, h;
  double scale;
  if (std::fscanf(f, "%d %d %lf", &w, &h, &scale) != 3) {
    std::fclose(f);
    return -4;
  }
  std::fgetc(f);  // single whitespace after the scale line

  *height = h; *width = w; *channels = ch;
  if (data == nullptr) { std::fclose(f); return 0; }

  const size_t n = (size_t)w * h * ch;
  std::vector<float> raw(n);
  if (std::fread(raw.data(), sizeof(float), n, f) != n) {
    std::fclose(f);
    return -5;
  }
  std::fclose(f);

  const bool little = scale < 0;
  if (!little) {  // big-endian file: byteswap
    auto* p = reinterpret_cast<uint32_t*>(raw.data());
    for (size_t i = 0; i < n; ++i) p[i] = __builtin_bswap32(p[i]);
  }
  // flip vertically (PFM is bottom-up)
  const size_t row = (size_t)w * ch;
  for (int y = 0; y < h; ++y)
    std::memcpy(data + (size_t)y * row, raw.data() + (size_t)(h - 1 - y) * row,
                row * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------- FLO ----
int read_flo(const char* path, float* data, int* height, int* width) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  float magic;
  int32_t w, h;
  if (std::fread(&magic, 4, 1, f) != 1 || magic != 202021.25f) {
    std::fclose(f);
    return -3;
  }
  if (std::fread(&w, 4, 1, f) != 1 || std::fread(&h, 4, 1, f) != 1) {
    std::fclose(f);
    return -4;
  }
  *height = h; *width = w;
  if (data == nullptr) { std::fclose(f); return 0; }
  const size_t n = (size_t)w * h * 2;
  const int ok = std::fread(data, sizeof(float), n, f) == n ? 0 : -5;
  std::fclose(f);
  return ok;
}

// --------------------------------------------- fused photometric pass ----
// One pass over uint8 RGB pixels applying brightness/contrast/saturation/
// gamma with precomputed per-channel LUT composition where possible.
// order: the 3 blend ops run in caller-specified order; hue is handled in
// Python (needs HSV) — in practice hue jitter is tiny (±0.16 rev).
//
// img: (n_pixels, 3) uint8 in-place. gray_mean: mean gray for contrast.
void photometric_fused(uint8_t* img, int64_t n_pixels, float brightness,
                       float contrast, float saturation, float gamma,
                       float gain, float gray_mean, const int32_t* order) {
  // gamma LUT (256 entries) applied last
  uint8_t lut[256];
  for (int i = 0; i < 256; ++i) {
    float v = 255.0f * gain * std::pow(i / 255.0f, gamma);
    lut[i] = (uint8_t)std::min(255.0f, std::max(0.0f, v + 0.5f));
  }

  const int nthreads =
      std::max(1u, std::min(4u, std::thread::hardware_concurrency()));
  std::vector<std::thread> threads;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; ++p) {
      float r = img[p * 3 + 0], g = img[p * 3 + 1], b = img[p * 3 + 2];
      for (int s = 0; s < 3; ++s) {
        switch (order[s]) {
          case 0:  // brightness
            r *= brightness; g *= brightness; b *= brightness;
            break;
          case 1: {  // contrast around the precomputed gray mean
            r = (r - gray_mean) * contrast + gray_mean;
            g = (g - gray_mean) * contrast + gray_mean;
            b = (b - gray_mean) * contrast + gray_mean;
            break;
          }
          case 2: {  // saturation
            float gray = 0.299f * r + 0.587f * g + 0.114f * b;
            r = gray + (r - gray) * saturation;
            g = gray + (g - gray) * saturation;
            b = gray + (b - gray) * saturation;
            break;
          }
        }
        r = std::min(255.0f, std::max(0.0f, r));
        g = std::min(255.0f, std::max(0.0f, g));
        b = std::min(255.0f, std::max(0.0f, b));
      }
      img[p * 3 + 0] = lut[(uint8_t)(r + 0.5f)];
      img[p * 3 + 1] = lut[(uint8_t)(g + 0.5f)];
      img[p * 3 + 2] = lut[(uint8_t)(b + 0.5f)];
    }
  };
  const int64_t chunk = (n_pixels + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n_pixels, lo + chunk);
    if (lo < hi) threads.emplace_back(work, lo, hi);
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
