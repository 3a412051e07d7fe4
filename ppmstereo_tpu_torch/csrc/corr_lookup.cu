// Correlation-pyramid lookup for Hopper (sm_90a): kernel 6.
//
// Replaces the Pallas TPU kernel `_lookup_kernel` of
// ppmstereo_tpu/kernels/corr_lookup.py (reached through
// `corr_lookup_pallas`). For pixel p = (n, h, w1), level l and tap
// t in [-r, r] it linearly interpolates the row corr_l[n, h, w1, :] of
// length W_l at x_p / 2^l + t, with zeros outside [0, W_l):
//   pos = x / 2^l + t, i0 = floor(pos), f = pos - i0,
//   out[p, l (2r+1) + t + r] = corr_l[i0] (1 - f) + corr_l[i0 + 1] f,
// the pyramid's values widened to f32 (as the Pallas kernel widens them) and
// the blend in f32. All levels and taps are one launch; the output is
// (N, H, W1, L (2r+1)), level-major, in f32 or bf16. The pyramid is f32 or
// bf16 (the model's main path stores it in bf16: ops/corr.py::corr_volume).
// The radius r is 1..6 (one template instance each; the shipped model's is
// 4) and the level count L 1..6 (a run-time count), as `PPMStereoConfig`'s
// `corr_radius` and `corr_levels` allow.
//
// What bounds it: bytes. It does ~4 flops per output and reads, per pixel
// and level, a window of 2r + 2 neighbouring values of one row. At the 1/4
// stage of a 320x512 window (N 10, H 80, W1 128, W2 128), bf16 in and out,
// it must read ~6.5 MB of the 49 MB pyramid and write 7.4 MB: ~4.3 us at
// 3.35 TB/s. The reads are scattered (each pixel has its own row), and a
// small kernel of this kind is held back by the instructions it issues per
// byte as much as by the bytes.
//
// Design:
//   * one thread per (pixel, level): a block of 64 L threads takes tiles of
//     64 pixels, the L levels in turn over its warps (one level per two
//     warps, so a warp's level and row width are uniform);
//   * the thread reads the 16-byte aligned chunks of its row that hold its
//     window of 2r + 3 values (3 chunks of bf16, 4 of f32; one vector load
//     each; elements of the neighbouring rows are masked), then shifts the
//     window to element 0 with selects by the bits of its offset in the first
//     chunk (a shifter, so the array stays in registers: no register array
//     is indexed at run time), widens it to f32 and masks what lies outside
//     the row;
//   * fl(x/2^l + t) is floor(x/2^l) + t or, where the sum rounds up to the
//     next integer, one more with f = 0, so tap t reads window elements t,
//     t + 1 or t + 1, t + 2, chosen by a compare, from registers;
//   * within a tile every index is 32-bit; the tile's outputs (64 x 36
//     values at the shipped r and L, one contiguous span of the output) are
//     staged in dynamic shared memory and written with 16-byte vector
//     stores;
//   * a grid of (SMs x resident blocks per SM) blocks walks over the tiles;
//   * the blend is written with round-to-nearest intrinsics (no fused
//     multiply-add), in the order of the plain version
//     (ops/corr.py::_lookup_level_gather), so the f32 output equals it bit
//     for bit for both pyramid dtypes, and the bf16 output equals its
//     round-to-nearest cast.
// A first design (16 lanes per (pixel, level), one element each, the taps'
// neighbours by shuffles, each tap's arithmetic once per lane group) took
// 1.9x as long at the 1/4 stage in bf16 (tools/lookup_variants.py,
// "lane_groups").

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 6;
constexpr int MAX_RADIUS = 6;
constexpr int TP = 64;                          // pixels per tile
constexpr int MAX_THREADS = TP * MAX_LEVELS;    // one thread per (pixel, level)
constexpr float LIMIT = 1073741824.f;  // |floor(x / 2^l)| is clamped to 2^30

template <typename T>
struct Levels {
  const T* ptr[MAX_LEVELS];
  int width[MAX_LEVELS];
};

__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// The bits of element i of p, or 0 where i lies outside [0, n).
__device__ __forceinline__ uint32_t bits_of(const float* p, int i, int n) {
  return (i >= 0 && i < n) ? __float_as_uint(p[i]) : 0u;
}
__device__ __forceinline__ uint32_t bits_of(const __nv_bfloat16* p, int i, int n) {
  return (i >= 0 && i < n) ? static_cast<uint32_t>(__bfloat16_as_ushort(p[i])) : 0u;
}

// x[l] for level l (the parameter arrays are not indexed at run time, which
// would copy them to local memory)
template <typename T>
__device__ __forceinline__ T by_level(int l, const T (&x)[MAX_LEVELS]) {
  T v = x[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) v = l == i ? x[i] : v;
  return v;
}

template <int R, typename InT, typename OutT>
__global__ void __launch_bounds__(MAX_THREADS)
    corr_lookup_kernel(Levels<InT> lv, int num_levels, const float* __restrict__ coords,
                       OutT* __restrict__ out, int pixels) {
  constexpr int TAPS = 2 * R + 1;
  constexpr int WINDOW = 2 * R + 3;                        // the values one (pixel, level) may read
  constexpr int V = 16 / static_cast<int>(sizeof(InT));    // elements per 16-byte chunk
  constexpr int NCH = (WINDOW + 2 * (V - 1)) / V;          // chunks that hold a window
  constexpr int WORDS = 4 * NCH;                           // their 32-bit words
  constexpr int EPW = 4 / static_cast<int>(sizeof(InT));   // elements per word
  extern __shared__ __align__(16) unsigned char stage_raw[];  // TP x channels outputs
  OutT* stage = reinterpret_cast<OutT*>(stage_raw);
  const int channels = num_levels * TAPS;
  const int nthreads = TP * num_levels;
  const int l = threadIdx.x / TP;
  const int j = threadIdx.x % TP;  // the thread's pixel in the tile
  const int w = by_level(l, lv.width);
  const InT* level = by_level(l, lv.ptr);
  const float scale = __int_as_float((127 - l) << 23);  // 2^-l: x / 2^l is exact
  const int ntiles = (pixels + TP - 1) / TP;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * TP;
    const int npix = min(TP, pixels - p0);
    if (j < npix) {
      const float xl = __fmul_rn(coords[p0 + j], scale);
      const int base = static_cast<int>(fmaxf(fminf(floorf(xl), LIMIT), -LIMIT));
      const int e0 = base - R;  // the window's first element in the row
      float win[WINDOW];
      if (e0 + WINDOW <= 0 || e0 >= w) {
#pragma unroll
        for (int k = 0; k < WINDOW; ++k) win[k] = 0.f;
      } else {
        const InT* rows = level + static_cast<size_t>(p0) * w;  // the tile's rows
        const int span = npix * w;
        const int a = j * w + e0;
        const int c0 = a & ~(V - 1);  // the first chunk, 16-byte aligned
        const int s = a - c0;         // the window's offset in it
        uint32_t raw[WORDS];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int c = c0 + ch * V;
          if (c >= 0 && c + V <= span) {
            const uint4 q = *reinterpret_cast<const uint4*>(rows + c);
            raw[4 * ch] = q.x;
            raw[4 * ch + 1] = q.y;
            raw[4 * ch + 2] = q.z;
            raw[4 * ch + 3] = q.w;
          } else {  // a chunk across the tile's first or last element
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              raw[4 * ch + m] = EPW == 1 ? bits_of(rows, c + m, span)
                                         : bits_of(rows, c + 2 * m, span) |
                                               (bits_of(rows, c + 2 * m + 1, span) << 16);
            }
          }
        }
        // shift the window to element 0: half a word (bf16), then one and
        // two words, by the bits of s
        int sw = s;
        if constexpr (EPW == 2) {
#pragma unroll
          for (int m = 0; m < WORDS - 1; ++m) {
            raw[m] = (s & 1) ? __funnelshift_r(raw[m], raw[m + 1], 16) : raw[m];
          }
          sw = s >> 1;
        }
#pragma unroll
        for (int m = 0; m < WORDS - 1; ++m) raw[m] = (sw & 1) ? raw[m + 1] : raw[m];
#pragma unroll
        for (int m = 0; m < WORDS - 2; ++m) raw[m] = (sw & 2) ? raw[m + 2] : raw[m];
#pragma unroll
        for (int k = 0; k < WINDOW; ++k) {  // widen exactly
          win[k] = __uint_as_float(EPW == 1 ? raw[k]
                                            : ((k & 1) ? (raw[k / 2] & 0xffff0000u)
                                                       : (raw[k / 2] << 16)));
        }
        if (e0 < 0 || e0 + WINDOW > w) {  // zeros outside the row
#pragma unroll
          for (int k = 0; k < WINDOW; ++k) {
            if (e0 + k < 0 || e0 + k >= w) win[k] = 0.f;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        // pos = x / 2^l + t as the plain version adds it
        const float pos = __fadd_rn(xl, static_cast<float>(t - R));
        const float i0f = floorf(pos);
        const float frac = __fsub_rn(pos, i0f);
        const bool up = i0f != static_cast<float>(base + t - R);  // rounded up: f = 0
        const float lo = up ? win[t + 1] : win[t];
        const float hi = up ? win[t + 2] : win[t + 1];
        put(&stage[j * channels + l * TAPS + t],
            __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, frac)), __fmul_rn(hi, frac)));
      }
    }
    __syncthreads();
    // the tile's span of the output: 16-byte stores, then any tail element
    // (the span starts 16-byte aligned: 64 pixels x an odd number of taps x
    // L x 2 bytes is a multiple of 128 bytes)
    const int n_out = npix * channels;
    const int n_vec = n_out * static_cast<int>(sizeof(OutT)) / 16;
    OutT* dst = out + static_cast<size_t>(p0) * channels;
    for (int c = threadIdx.x; c < n_vec; c += nthreads) {
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(stage)[c];
    }
    for (int e = n_vec * 16 / static_cast<int>(sizeof(OutT)) + threadIdx.x; e < n_out;
         e += nthreads) {
      dst[e] = stage[e];
    }
    __syncthreads();  // the stage is refilled by the next tile
  }
}

// The SM count of the current device, asked of the runtime once a device.
cudaError_t current_sms(int* sms) {
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = sms_of[device];
  return cudaSuccess;
}

template <int R, typename InT, typename OutT>
int launch(const void* const* levels, const int* widths, int num_levels, const void* coords,
           void* out, int pixels, cudaStream_t stream) {
  // resident blocks of this instance per SM, by level count
  static int blocks_per_sm[MAX_LEVELS + 1] = {};
  const int threads = TP * num_levels;
  const size_t smem = static_cast<size_t>(TP) * num_levels * (2 * R + 1) * sizeof(OutT);
  if (blocks_per_sm[num_levels] == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm[num_levels], corr_lookup_kernel<R, InT, OutT>, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int sms = 0;
  const cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Levels<InT> lv{};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = static_cast<const InT*>(levels[l]);
    lv.width[l] = widths[l];
  }
  const int ntiles = (pixels + TP - 1) / TP;
  const int cap = sms * blocks_per_sm[num_levels];
  const int blocks = ntiles < cap ? ntiles : cap;
  corr_lookup_kernel<R, InT, OutT><<<blocks, threads, smem, stream>>>(
      lv, num_levels, static_cast<const float*>(coords), static_cast<OutT*>(out), pixels);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_radius(const void* const* levels, const int* widths, int num_levels,
                  const void* coords, void* out, int pixels, int pyramid_bf16, int out_bf16,
                  cudaStream_t s) {
  if (pyramid_bf16) {
    return out_bf16 ? launch<R, __nv_bfloat16, __nv_bfloat16>(levels, widths, num_levels,
                                                              coords, out, pixels, s)
                    : launch<R, __nv_bfloat16, float>(levels, widths, num_levels, coords, out,
                                                      pixels, s);
  }
  return out_bf16 ? launch<R, float, __nv_bfloat16>(levels, widths, num_levels, coords, out,
                                                    pixels, s)
                  : launch<R, float, float>(levels, widths, num_levels, coords, out, pixels, s);
}

}  // namespace

// level0 .. level<num_levels - 1> (num_levels 1..6): contiguous (pixels,
// width<l>) rows on the current device, 16-byte aligned, f32 (pyramid_bf16
// = 0) or bf16 (1), the rest ignored; coords (pixels) f32; out (pixels,
// num_levels (2 radius + 1)), f32 (out_bf16 = 0) or bf16 (1), 16-byte
// aligned; radius 1..6. Launches on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int corr_lookup(const void* level0, const void* level1, const void* level2,
                           const void* level3, const void* level4, const void* level5,
                           int width0, int width1, int width2, int width3, int width4,
                           int width5, int num_levels, int radius, const void* coords, void* out,
                           int64_t pixels, int pyramid_bf16, int out_bf16, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || radius < 1 || radius > MAX_RADIUS ||
      pixels < 0 || pixels > INT32_MAX - TP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pixels == 0) return 0;
  const void* const levels[MAX_LEVELS] = {level0, level1, level2, level3, level4, level5};
  const int widths[MAX_LEVELS] = {width0, width1, width2, width3, width4, width5};
  const int n = static_cast<int>(pixels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int (*const by_radius[MAX_RADIUS])(const void* const*, const int*, int, const void*,
                                     void*, int, int, int, cudaStream_t) = {
      launch_radius<1>, launch_radius<2>, launch_radius<3>,
      launch_radius<4>, launch_radius<5>, launch_radius<6>};
  return by_radius[radius - 1](levels, widths, num_levels, coords, out, n, pyramid_bf16,
                               out_bf16, s);
}
