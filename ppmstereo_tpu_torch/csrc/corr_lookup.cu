// Correlation-pyramid lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lookup_kernel` of
// ppmstereo_tpu/kernels/corr_lookup.py (reached through
// `corr_lookup_pallas`). For pixel p = (n, h, w1), level l and tap
// t in [-r, r] it linearly interpolates the row corr_l[n, h, w1, :] of
// length W_l at x_p / 2^l + t, with zeros outside [0, W_l):
//   i0 = floor(pos), f = pos - i0,
//   out[p, l (2r+1) + t + r] = corr_l[i0] (1 - f) + corr_l[i0 + 1] f.
// All levels and taps are one launch; the output is (N, H, W1, L (2r+1))
// f32, level-major.
//
// What bounds it: it does ~4 flops per output and reads, per pixel and
// level, a window of 2r + 2 neighbouring f32 values of one row; it is
// bound by memory (bytes, not operations). At the 1/4 stage of a 320x512
// window (N 10, H 80, W1 128, W2 128) it writes 14.7 MB and reads ~10 MB of
// the 98 MB pyramid.
//
// Design (simple first version): one thread per output element, threads
// of consecutive outputs on consecutive addresses, so a warp's stores are
// coalesced and its loads fall in the few rows of one or two pixels; two
// direct loads per output with the bounds test done on the index, not the
// TPU kernel's one-hot reduction over the whole row. The blend is written
// with round-to-nearest intrinsics (no fused multiply-add), in the order of
// the plain version (ops/corr.py::_lookup_level_gather), so the two agree
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int NTHREADS = 256;

struct Levels {
  const float* ptr[MAX_LEVELS];
  int width[MAX_LEVELS];
};

__global__ void __launch_bounds__(NTHREADS)
    corr_lookup_kernel(Levels lv, int num_levels, int radius,
                       const float* __restrict__ coords, float* __restrict__ out,
                       int64_t pixels) {
  const int taps = 2 * radius + 1;
  const int channels = num_levels * taps;
  const int64_t total = pixels * channels;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = i / channels;
    const int c = static_cast<int>(i - p * channels);
    const int l = c / taps;
    const int t = c - l * taps - radius;
    const int w = lv.width[l];
    // x / 2^l is exact; pos = x / 2^l + t as the plain version adds it
    const float pos = __fadd_rn(ldexpf(coords[p], -l), static_cast<float>(t));
    const float i0f = floorf(pos);
    const float frac = __fsub_rn(pos, i0f);
    const int i0 = static_cast<int>(i0f);  // saturates far outside the row
    const float* row = lv.ptr[l] + p * w;
    const float a = (i0 >= 0 && i0 < w) ? row[i0] : 0.f;
    const float b = (i0 >= -1 && i0 < w - 1) ? row[i0 + 1] : 0.f;
    out[i] = __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, frac)), __fmul_rn(b, frac));
  }
}

}  // namespace

// levels: `num_levels` (1..4) pointers to contiguous f32 (pixels, widths[l])
// rows on the current device; coords (pixels) f32; out (pixels,
// num_levels * (2 radius + 1)) f32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int corr_lookup(const void* const* levels, const int* widths, int num_levels,
                           int radius, const void* coords, void* out, int64_t pixels,
                           void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || radius < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = static_cast<const float*>(levels[l]);
    lv.width[l] = widths[l];
  }
  const int64_t total = pixels * num_levels * (2 * radius + 1);
  const int64_t want = (total + NTHREADS - 1) / NTHREADS;
  const int blocks = static_cast<int>(want < 132 * 64 ? (want > 0 ? want : 1) : 132 * 64);
  corr_lookup_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, num_levels, radius, static_cast<const float*>(coords),
      static_cast<float*>(out), pixels);
  return static_cast<int>(cudaGetLastError());
}
