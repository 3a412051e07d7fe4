// Play attention ring hop for Hopper (sm_90a): kernel 5, one hop of the ring
// play attention (`play_attention_carry`).
//
// Replaces the Pallas TPU kernel `_flash_carry_kernel` of
// ppmstereo_tpu/kernels/play_attention.py (reached through
// `flash_attend_carry`, called per hop by
// ppmstereo_tpu/parallel/ring_attention.py::_ring_local). Single head,
// non-causal, head dim 128, bf16 q/k/v, an online base-2 softmax in f32. The
// block starts from an incoming unnormalised state instead of an empty one:
// o (B, Lq, D) f32, and m (the base-2 row max) and l (the row sum) as (B, Lq)
// f32, one value per row (not the TPU's 128-lane tiles). It runs the key loop
// and writes the merged state back in place, unnormalised:
//   m' = max(m, rowmax s), alpha = exp2(m - m'),
//   l' = alpha l + rowsum exp2(s - m'), o' = alpha o + exp2(s - m') V.
// The caller divides o by l after the last hop. Keys past Lk are masked.
//
// What bounds it: a hop reads and writes the f32 state besides q, k and v: at
// a 1/4-stage hop of the 2-way ring (10 x 5,120 x 25,600) that is 2 x 26 MB
// against 144 MB of bf16 inputs, far below the compute bound of 6.7e11 FLOP
// (0.68 ms at 989 TFLOP/s): it is bound by the tensor cores.
//
// Design (simple first version, FlashAttention-2 shape; the forward kernels 1
// and 2 moved to wgmma, TMA and warp specialisation in play_attention_fwd.cu,
// and this hop is next to move onto that body):
//   * one thread block per (row b, tile of BM = 128 query rows); 8 warps,
//     each owning 16 query rows, so the softmax state of a row lives in
//     one warp (4 lanes) and needs no shared memory or block barrier;
//   * a loop over key tiles of BN = 64 rows, staged in shared memory with
//     cp.async and double-buffered, so tile j+1 loads while tile j computes;
//   * Q K^T and P V on the tensor cores with mma.sync m16n8k16 bf16 -> f32;
//     the Q fragments stay in registers for the whole key loop, and the
//     f32 logits become the bf16 A operand of P V without leaving registers;
//   * the scale and log2(e) are folded into one multiply; exp2 is ex2.approx;
//   * rows past Lq and keys past Lk are zero-filled by cp.async, and keys past
//     Lk get -inf logits; rows past Lq are neither read nor written;
//   * padded shared-memory rows (136 bf16) keep every fragment load free of
//     bank conflicts.
// The kernel allocates nothing; the caller passes the state buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                // head dim
constexpr int BM = 128;               // query rows per block
constexpr int BN = 64;                // keys per tile
constexpr int NWARPS = BM / 16;       // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;            // padded shared row, in bf16 elements
constexpr int SMEM_BYTES = (BM + 4 * BN) * LDS * 2;  // Q + 2 stages of K and V

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix into shared
// memory; rows at or past `nrows` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g, int row0,
                                          int nrows, int tid) {
  constexpr int CHUNKS = ROWS * (D / 8);  // 16-byte chunks
  static_assert(CHUNKS % NTHREADS == 0, "tile must split evenly");
#pragma unroll
  for (int j = 0; j < CHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const bool valid = row0 + r < nrows;
    const __nv_bfloat16* src = g + static_cast<size_t>(valid ? row0 + r : 0) * D + c;
    cp_async16(s + r * LDS + c, src, valid);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* lo,
                                            const __nv_bfloat16* hi) {
  const uint32_t a = *reinterpret_cast<const unsigned short*>(lo);
  const uint32_t b = *reinterpret_cast<const unsigned short*>(hi);
  return a | (b << 16);
}

// The state (co, cm, cl) is read at the start and written back, merged, at
// the end.
__global__ void __launch_bounds__(NTHREADS)
    play_attention_carry_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                float* __restrict__ co, float* __restrict__ cm,
                                float* __restrict__ cl, int Lq, int Lk,
                                float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LDS;      // two stages of BN rows
  __nv_bfloat16* sV = sK + 2 * BN * LDS;  // two stages of BN rows

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within an 8-row group
  const int t = lane & 3;   // fragment column pair

  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Lq * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Lk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Lk * D;

  const int ntiles = (Lk + BN - 1) / BN;
  load_tile<BM>(sQ, qb, m0, Lq, tid);
  load_tile<BN>(sK, kb, 0, Lk, tid);
  load_tile<BN>(sV, vb, 0, Lk, tid);
  cp_async_commit();

  uint32_t qf[D / 16][4];   // this warp's 16 query rows as A fragments
  float acc[D / 8][4];      // O accumulator: 16 tiles of 8 head columns
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, base 2
  float row_sum[2] = {0.f, 0.f};              // this lane's partial sums
  const int r0 = m0 + warp * 16 + g;
  const int r1 = r0 + 8;
  {
    // start from the incoming state: this lane's columns of o, the row max,
    // and the row sum in the partial sum of the row's first lane
    const float* cob = co + static_cast<size_t>(b) * Lq * D;
    const size_t sb = static_cast<size_t>(b) * Lq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < Lq) {
        const float2 x = *reinterpret_cast<const float2*>(cob + static_cast<size_t>(r0) * D + c);
        acc[n][0] = x.x;
        acc[n][1] = x.y;
      }
      if (r1 < Lq) {
        const float2 x = *reinterpret_cast<const float2*>(cob + static_cast<size_t>(r1) * D + c);
        acc[n][2] = x.x;
        acc[n][3] = x.y;
      }
    }
    if (r0 < Lq) {
      row_max[0] = cm[sb + r0];
      if (t == 0) row_sum[0] = cl[sb + r0];
    }
    if (r1 < Lq) {
      row_max[1] = cm[sb + r1];
      if (t == 0) row_sum[1] = cl[sb + r1];
    }
  }

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_tile<BN>(sK + (st ^ 1) * BN * LDS, kb, (j + 1) * BN, Lk, tid);
      load_tile<BN>(sV + (st ^ 1) * BN * LDS, vb, (j + 1) * BN, Lk, tid);
    }
    cp_async_commit();
    cp_async_wait_one();  // everything but the group just committed
    __syncthreads();

    if (j == 0) {
      const __nv_bfloat16* qs = sQ + (warp * 16 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = ld32(qs + kk * 16);
        qf[kk][1] = ld32(qs + 8 * LDS + kk * 16);
        qf[kk][2] = ld32(qs + kk * 16 + 8);
        qf[kk][3] = ld32(qs + 8 * LDS + kk * 16 + 8);
      }
    }

    const __nv_bfloat16* ks = sK + st * BN * LDS;
    const __nv_bfloat16* vs = sV + st * BN * LDS;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[n], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }

    // scale into base 2, mask keys past Lk, online softmax update
    const bool ragged = (j + 1) * BN > Lk;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale_log2;
        if (ragged && j * BN + n * 8 + 2 * t + (e & 1) >= Lk) s[n][e] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one valid key, so the new maxima are finite
    const float new0 = fmaxf(row_max[0], mx0);
    const float new1 = fmaxf(row_max[1], mx1);
    const float alpha0 = fast_exp2(row_max[0] - new0);
    const float alpha1 = fast_exp2(row_max[1] - new1);
    row_max[0] = new0;
    row_max[1] = new1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = fast_exp2(s[n][0] - new0);
      s[n][1] = fast_exp2(s[n][1] - new0);
      s[n][2] = fast_exp2(s[n][2] - new1);
      s[n][3] = fast_exp2(s[n][3] - new1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    row_sum[0] = row_sum[0] * alpha0 + sum0;
    row_sum[1] = row_sum[1] * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V: the logit accumulators are already laid out as A fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        mma_bf16(acc[n], pa, ld_pair(vc, vc + LDS),
                 ld_pair(vc + 8 * LDS, vc + 9 * LDS));
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }

  // finish: full row sums across the 4 lanes of each row, normalise, store
  float l0 = row_sum[0], l1 = row_sum[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  {
    // the merged state, unnormalised, in place
    float* cob = co + static_cast<size_t>(b) * Lq * D;
    const size_t sb = static_cast<size_t>(b) * Lq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < Lq) {
        *reinterpret_cast<float2*>(cob + static_cast<size_t>(r0) * D + c) =
            make_float2(acc[n][0], acc[n][1]);
      }
      if (r1 < Lq) {
        *reinterpret_cast<float2*>(cob + static_cast<size_t>(r1) * D + c) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
    if (t == 0) {
      if (r0 < Lq) {
        cm[sb + r0] = row_max[0];
        cl[sb + r0] = l0;
      }
      if (r1 < Lq) {
        cm[sb + r1] = row_max[1];
        cl[sb + r1] = l1;
      }
    }
  }
}

int launch(const void* q, const void* k, const void* v, float* co, float* cm,
           float* cl, int B, int Lq, int Lk, float scale_log2, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      play_attention_carry_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BM - 1) / BM, B);
  play_attention_carry_kernel<<<grid, NTHREADS, SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), co, cm, cl, Lq, Lk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One ring hop (kernel 5): q (B, Lq, 128), k and v (B, Lk, 128) bf16; the
// state o (B, Lq, 128), m and l (B, Lq) f32, read and overwritten with the
// merged state (unnormalised; m base 2). All contiguous on the current
// device, 16-byte aligned. Returns cudaGetLastError() (0 on success).
extern "C" int play_attention_carry(const void* q, const void* k, const void* v,
                                    void* o, void* m, void* l, int B, int Lq,
                                    int Lk, float scale_log2, void* stream) {
  return launch(q, k, v, static_cast<float*>(o), static_cast<float*>(m),
                static_cast<float*>(l), B, Lq, Lk, scale_log2, stream);
}
