// Play attention backward for Hopper (sm_90a): the gradients of
// O = softmax(scale * Q K^T) V with respect to q, k and v.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of ppmstereo_tpu/kernels/play_attention.py
// (reached through `_flash_bwd`, the custom VJP of the training forward).
// With P the softmax probabilities, dO the output's gradient and
// Di = rowsum(dO o O) (computed by the caller, as the JAX package computes it
// outside its kernels):
//
//   dS = P o (dO V^T - Di)        dQ = scale dS K
//   dV = P^T dO                   dK = scale dS^T Q
//
// P is recomputed from q, k and the forward's residual lse (one f32 per
// query row, the base-2 log-sum-exp written by play_attention.cu):
// P = exp2(scale log2(e) q.k - lse). Nothing of size Lq x Lk reaches memory.
//
// What bounds it: five products of 2 Lq Lk D FLOP each (S, dP, dQ in the dq
// kernel; S, dP, dV, dK in the dk/dv kernel, so S and dP are computed twice:
// 7 products in all against the 5 the work needs). At the 1/4 training shape
// (10 x 10,240 x 51,200, D 128) the five are 3.4e12 FLOP against ~0.6 GB of
// bf16 inputs and outputs: compute-bound, like the forward.
//
// Design (simple first version, FlashAttention-2 shape, mma.sync bf16 with
// f32 accumulation, cp.async double buffering, padded shared rows):
//   * dq kernel: one block per (row b, tile of 64 query rows), 4 warps of 16
//     rows; the Q and dO fragments stay in registers; a loop over key tiles
//     of 32 rows (K and V staged in shared memory). Each warp computes its
//     S and dP tiles, turns them into dS in registers and accumulates dS K.
//   * dk/dv kernel: one block per (row b, tile of 64 keys), 4 warps of 16
//     keys; K and V stay in shared memory; a loop over query tiles of 32
//     rows (Q, dO, lse and Di staged). Each warp computes S^T = K Q^T and
//     dP^T = V dO^T for its keys, so that P^T and dS^T are A operands in
//     registers, and accumulates P^T dO and dS^T Q.
//   * ragged edges are masked, not padded: cp.async zero-fills rows past Lq
//     and Lk; keys past Lk (dq kernel) and queries past Lq (dk/dv kernel)
//     get P = 0 explicitly, so they contribute exactly 0 (dP is 0 there as
//     well, since dO, V are zero-filled); rows past Lq or Lk are not stored.
// Recomputing S and dP in both kernels (instead of atomics on dq) keeps
// both kernels free of atomics and deterministic. wgmma, TMA and a fused
// single-pass backward are left to the PR that makes it fast.
// The kernels allocate nothing; the caller passes every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;            // head dim
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BR = 16 * NWARPS;   // rows a block owns: 64 queries or keys
constexpr int BT = 32;            // rows of the streamed tile
constexpr int LDS = D + 8;        // padded shared row, in bf16 elements
// two owned tiles of BR rows, two streamed operands x two stages of BT rows
constexpr int SMEM_TILES_BYTES = (2 * BR + 4 * BT) * LDS * 2;
// dk/dv kernel: lse and Di of the streamed query tile, two stages
constexpr int SMEM_DKV_BYTES = SMEM_TILES_BYTES + 2 * 2 * BT * 4;

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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
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

// A fragments (16 rows x 16 columns at column kk*16) of a row-major shared
// tile whose first row is `rows`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* rows, int kk,
                                       int g, int t) {
  const __nv_bfloat16* p = rows + g * LDS + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LDS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LDS + 8);
}

// acc (16 x BT per warp) += A (16 x 128, rows `a_rows` of shared memory)
// times B^T, B (BT x 128) the rows `b_rows` of shared memory: the scores
// of 16 owned rows against BT streamed rows (or the reverse).
__device__ __forceinline__ void rows_dot_rows(float (&acc)[BT / 8][4],
                                              const __nv_bfloat16* a_rows,
                                              const __nv_bfloat16* b_rows,
                                              int g, int t) {
#pragma unroll
  for (int n = 0; n < BT / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_rows, kk, g, t);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const __nv_bfloat16* br = b_rows + (n * 8 + g) * LDS + kk * 16 + 2 * t;
      mma_bf16(acc[n], a, ld32(br), ld32(br + 8));
    }
  }
}

// out (16 x 128 per warp) += X (16 x BT, f32 accumulators of a warp, rounded
// to bf16) times M (BT x 128, rows `m_rows` of shared memory).
__device__ __forceinline__ void acc_times_rows(float (&out)[D / 8][4],
                                               const float (&x)[BT / 8][4],
                                               const __nv_bfloat16* m_rows,
                                               int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* mr = m_rows + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* mc = mr + n * 8;
      mma_bf16(out[n], pa, ld_pair(mc, mc + LDS),
               ld_pair(mc + 8 * LDS, mc + 9 * LDS));
    }
  }
}

// Store a warp's 16 x 128 f32 accumulator, times `mul`, as bf16 rows
// [r0, r0 + 8) and [r0 + 8, r0 + 16) of `dst` (rows at or past nrows skipped).
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[D / 8][4],
                                           float mul, int r0, int nrows,
                                           int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < nrows) {
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r0) * D + c) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    }
    if (r1 < nrows) {
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r1) * D + c) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
    }
  }
}

// dq: one block per (row b, 64 query rows); loop over key tiles of BT.
__global__ void __launch_bounds__(NTHREADS)
    play_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ di,
                                 __nv_bfloat16* __restrict__ dq, int Lq,
                                 int Lk, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + BR * LDS;      // dO
  __nv_bfloat16* sK = sO + BR * LDS;      // two stages of BT rows
  __nv_bfloat16* sV = sK + 2 * BT * LDS;  // two stages of BT rows

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t qoff = static_cast<size_t>(b) * Lq * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Lk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Lk * D;

  const int ntiles = (Lk + BT - 1) / BT;
  load_tile<BR>(sQ, q + qoff, m0, Lq, tid);
  load_tile<BR>(sO, dout + qoff, m0, Lq, tid);
  load_tile<BT>(sK, kb, 0, Lk, tid);
  load_tile<BT>(sV, vb, 0, Lk, tid);
  cp_async_commit();

  const int r0 = m0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const size_t rows = static_cast<size_t>(b) * Lq;
  // rows past Lq: any finite values; their dS is computed but not stored
  const float lse0 = r0 < Lq ? lse[rows + r0] : 0.f;
  const float lse1 = r1 < Lq ? lse[rows + r1] : 0.f;
  const float di0 = r0 < Lq ? di[rows + r0] : 0.f;
  const float di1 = r1 < Lq ? di[rows + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  const __nv_bfloat16* q_rows = sQ + warp * 16 * LDS;
  const __nv_bfloat16* o_rows = sO + warp * 16 * LDS;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_tile<BT>(sK + (st ^ 1) * BT * LDS, kb, (j + 1) * BT, Lk, tid);
      load_tile<BT>(sV + (st ^ 1) * BT * LDS, vb, (j + 1) * BT, Lk, tid);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const __nv_bfloat16* ks = sK + st * BT * LDS;
    const __nv_bfloat16* vs = sV + st * BT * LDS;

    float s[BT / 8][4];
    float dp[BT / 8][4];
    rows_dot_rows(s, q_rows, ks, g, t);    // S = Q K^T
    rows_dot_rows(dp, o_rows, vs, g, t);   // dP = dO V^T
    const bool ragged = (j + 1) * BT > Lk;
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_r = e < 2 ? lse0 : lse1;
        const float di_r = e < 2 ? di0 : di1;
        float p = fast_exp2(s[n][e] * scale_log2 - lse_r);
        if (ragged && j * BT + n * 8 + 2 * t + (e & 1) >= Lk) p = 0.f;
        s[n][e] = p * (dp[n][e] - di_r);  // dS, in place of S
      }
    }
    acc_times_rows(acc, s, ks, g, t);  // dQ += dS K
    __syncthreads();  // stage st is refilled by the next iteration
  }
  store_rows(dq + qoff, acc, scale, r0, Lq, t);
}

// dk, dv: one block per (row b, 64 keys); loop over query tiles of BT.
__global__ void __launch_bounds__(NTHREADS)
    play_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ di,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int Lq,
                                  int Lk, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BR * LDS;
  __nv_bfloat16* sQ = sV + BR * LDS;      // two stages of BT rows
  __nv_bfloat16* sO = sQ + 2 * BT * LDS;  // dO, two stages of BT rows
  float* sL = reinterpret_cast<float*>(sO + 2 * BT * LDS);  // lse, 2 x BT
  float* sD = sL + 2 * BT;                                  // Di, 2 x BT

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t koff = static_cast<size_t>(b) * Lk * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Lq * D;
  const __nv_bfloat16* ob = dout + static_cast<size_t>(b) * Lq * D;
  const float* lb = lse + static_cast<size_t>(b) * Lq;
  const float* db = di + static_cast<size_t>(b) * Lq;

  auto load_rows_stats = [&](int stage, int row0) {
    for (int i = tid; i < 2 * BT; i += NTHREADS) {
      const int r = i % BT;
      const bool valid = row0 + r < Lq;
      const float* src = (i < BT ? lb : db) + (valid ? row0 + r : 0);
      float* dst = (i < BT ? sL : sD) + stage * BT + r;
      cp_async4(dst, src, valid);
    }
  };

  const int ntiles = (Lq + BT - 1) / BT;
  load_tile<BR>(sK, k + koff, n0, Lk, tid);
  load_tile<BR>(sV, v + koff, n0, Lk, tid);
  load_tile<BT>(sQ, qb, 0, Lq, tid);
  load_tile<BT>(sO, ob, 0, Lq, tid);
  load_rows_stats(0, 0);
  cp_async_commit();

  float acc_k[D / 8][4];
  float acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  }
  const __nv_bfloat16* k_rows = sK + warp * 16 * LDS;
  const __nv_bfloat16* v_rows = sV + warp * 16 * LDS;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_tile<BT>(sQ + (st ^ 1) * BT * LDS, qb, (j + 1) * BT, Lq, tid);
      load_tile<BT>(sO + (st ^ 1) * BT * LDS, ob, (j + 1) * BT, Lq, tid);
      load_rows_stats(st ^ 1, (j + 1) * BT);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const __nv_bfloat16* qs = sQ + st * BT * LDS;
    const __nv_bfloat16* os = sO + st * BT * LDS;
    const float* ls = sL + st * BT;
    const float* ds = sD + st * BT;

    float s[BT / 8][4];   // S^T: this warp's 16 keys x BT queries
    rows_dot_rows(s, k_rows, qs, g, t);
    const bool ragged = (j + 1) * BT > Lq;
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float p = fast_exp2(s[n][e] * scale_log2 - ls[c]);
        if (ragged && j * BT + c >= Lq) p = 0.f;
        s[n][e] = p;  // P^T
      }
    }
    acc_times_rows(acc_v, s, os, g, t);  // dV += P^T dO
    float dp[BT / 8][4];  // dP^T = V dO^T
    rows_dot_rows(dp, v_rows, os, g, t);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        dp[n][e] = s[n][e] * (dp[n][e] - ds[c]);  // dS^T
      }
    }
    acc_times_rows(acc_k, dp, qs, g, t);  // dK += dS^T Q
    __syncthreads();  // stage st is refilled by the next iteration
  }
  const int r0 = n0 + warp * 16 + g;
  store_rows(dk + koff, acc_k, scale, r0, Lk, t);
  store_rows(dv + koff, acc_v, 1.f, r0, Lk, t);
}

}  // namespace

// q, dout (B, Lq, 128); k, v (B, Lk, 128): contiguous bf16, 16-byte aligned.
// lse, di (B, Lq) f32: the forward's base-2 log-sum-exp and rowsum(dO o O).
// dq (B, Lq, 128) bf16 is written. scale_log2 = scale * log2(e).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int play_attention_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di, void* dq,
                                     int B, int Lq, int Lk, float scale_log2,
                                     float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      play_attention_bwd_dq_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_TILES_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BR - 1) / BR, B);
  play_attention_bwd_dq_kernel<<<grid, NTHREADS, SMEM_TILES_BYTES,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dq), Lq, Lk,
      scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

// As play_attention_bwd_dq, writing dk and dv (B, Lk, 128) bf16.
extern "C" int play_attention_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dk, void* dv, int B, int Lq,
                                      int Lk, float scale_log2, float scale,
                                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      play_attention_bwd_dkv_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lk + BR - 1) / BR, B);
  play_attention_bwd_dkv_kernel<<<grid, NTHREADS, SMEM_DKV_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Lq, Lk, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
