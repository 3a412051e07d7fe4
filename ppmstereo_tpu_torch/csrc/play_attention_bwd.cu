// Play attention backward for Hopper (sm_90a): the gradients of
// O = softmax(scale * Q K^T) V with respect to q, k and v.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` (kernel 3) and
// `_flash_bwd_dkv_kernel` (kernel 4) of ppmstereo_tpu/kernels/play_attention.py
// (reached through `_flash_bwd`, the custom VJP of the training forward).
// With P the softmax probabilities, dO the output's gradient and
// Di = rowsum(dO o O) (computed by the caller, as the JAX package computes it
// outside its kernels):
//
//   dS = P o (dO V^T - Di)        dQ = scale dS K
//   dV = P^T dO                   dK = scale dS^T Q
//
// P is recomputed from q, k and the forward's residual lse (one f32 per
// query row, the base-2 log-sum-exp written by play_attention_fwd.cu):
// P = exp2(scale log2(e) q.k - lse). P and dS are rounded to bf16 before
// their products, as the JAX kernels do (`ds.astype(k.dtype)`); every sum is
// f32. Nothing of size Lq x Lk reaches memory.
//
// What bounds it: 2 Lq Lk D FLOP a product. The dq kernel computes S, dP and
// dS K (3 products), the dk/dv kernel S^T, dP^T, P^T dO and dS^T Q (4): 7 in
// all against the 5 the work needs, the price of two kernels without atomics.
// At the 1/4 training shape (10 x 10,240 x 51,200, D 128) the 7 are 4.7e12
// FLOP against ~0.3 GB of inputs and outputs: bound by the tensor cores
// (4.1 ms for dq and 5.4 ms for dk/dv at 989 TFLOP/s), with the exp2 of P
// (one per score, 16 a cycle per SM) beside them.
//
// Design (the forward's shape, play_attention_fwd.cu, on the helpers of
// hopper.cuh): 384 threads in three warpgroups. Warpgroup 0 is the producer:
// one thread starts every TMA load; `setmaxnreg` drops the group to 24
// registers. Warpgroups 1 and 2 are consumers of 64 rows each (`setmaxnreg`
// 240). Loads go through a ring of STAGES stages, each with a "full"
// mbarrier (the producer's expect_tx, completed by the copies' bytes) and an
// "empty" one (all 256 consumer threads arrive when done with the stage).
//   * dq kernel (kernel 3): one block per (row b, 128 query rows). Q and dO
//     are loaded once; K and V stream in tiles of DQ_BN = 64 keys. Each
//     consumer holds its rows' lse and Di in registers and, for key tile j:
//       S_j = Q K_j^T, dP_j = dO V_j^T      wgmma m64n64k16, A and B K-major
//       P = exp2(S scale log2(e) - lse), dS = P o (dP - Di)   in registers
//       dQ += dS_j K_j                       wgmma m64n128k16, A = dS from
//                                            registers, B = K MN-major
//                                            (the transpose flag)
//     The products overlap the exponentials inside each warpgroup: S_j, dP_j
//     and dQ += dS_{j-1} K_{j-1} are committed as three groups, and P_j is
//     computed once S_j is done while dP_j and the dQ product still run; dS_j
//     once dP_j is done. Registers: dQ 64 f32, S and dP 32 each, the packed
//     dS 16 (key tiles of 128 would need 64 + 64 for S and dP: too many).
//   * dk/dv kernel (kernel 4): one block per (row b, 128 keys). K and V are
//     loaded once; Q, dO and that tile's lse and Di (1-D maps over B Lq f32,
//     from a 16-byte boundary) stream in tiles of DKV_BM = 64 queries. For query tile j each consumer
//     computes S^T = K Q_j^T and dP^T = V dO_j^T (m64n64k16, K-major), P^T and
//     dS^T in registers (lse and Di lie along the columns: each thread reads
//     the 16 columns it holds from the stage in shared memory), then
//     dV += P^T dO_j and dK += dS^T Q_j (m64n128k16, A from registers, B
//     MN-major). P^T is computed under dP^T's product, and dV lags one tile:
//     dV += P^T_{j-1} dO_{j-1} is committed with S^T_j and dP^T_j and runs
//     under tile j's exponentials (measured: 8 % faster at 1/4 than waiting
//     for both products at the end of each tile). Registers: dK and dV 64 f32
//     each, S^T and dP^T 32 each, the packed P^T and dS^T 16 each (highest
//     register R231 of 240); letting dK lag as well would need 16 more.
// Ragged edges: the 3-D (D, L, B) maps zero-fill rows past Lq or Lk inside
// row b, so S there is 0 and P = exp2(0 - lse) would be NONZERO (the JAX
// docstring's warning). So P is set to 0 explicitly for keys >= Lk (dq
// kernel) and queries >= Lq (dk/dv kernel); the 1-D maps of lse and Di read
// the next row's values (or zeros) there, which the select discards. Rows
// past Lq (dq) or Lk (dk/dv) are computed on zeros and not stored.
// Deterministic: no atomics; each output element is one block's f32 sum in
// a fixed order, so two launches give bit-equal gradients.
// A barrier wait that times out sets the block's abort flag and the block
// writes NaN (hopper.cuh); nothing traps. The kernels allocate nothing; the
// caller passes every buffer. The host side encodes the tensor maps at each
// launch.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = HEAD_DIM;
constexpr int NTHREADS = 384;  // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int ROWS_BYTES_128 = 128 * D * 2;  // a 128-row bf16 tile
constexpr int ROWS_BYTES_64 = 64 * D * 2;    // a 64-row bf16 tile
constexpr int BOX_128 = ROWS_BYTES_128 / 2;  // one 64-column box of each
constexpr int BOX_64 = ROWS_BYTES_64 / 2;
constexpr uint64_t STEP_64 = ROWS_BYTES_64 >> 4;  // a 64-row stage, in descriptor units

// dq kernel: Q and dO (128 rows) once, K and V tiles of 64 keys streamed
constexpr int DQ_BM = 128;
constexpr int DQ_BN = 64;
constexpr int DQ_STAGES = 4;
constexpr int DQ_Q_OFF = 0;
constexpr int DQ_DO_OFF = ROWS_BYTES_128;
constexpr int DQ_K_OFF = 2 * ROWS_BYTES_128;
constexpr int DQ_V_OFF = DQ_K_OFF + DQ_STAGES * ROWS_BYTES_64;
constexpr int DQ_BAR_OFF = DQ_V_OFF + DQ_STAGES * ROWS_BYTES_64;
constexpr int DQ_SMEM = DQ_BAR_OFF + 8 * (1 + 2 * DQ_STAGES) + 8 + 1024;  // + alignment slack

// dk/dv kernel: K and V (128 keys) once, Q, dO, lse and Di tiles of 64 queries
constexpr int DKV_BN = 128;
constexpr int DKV_BM = 64;
constexpr int DKV_STAGES = 4;
// lse or Di of a query tile: TMA starts a 1-D box only at a 16-byte
// boundary of the vector (a start of b Lq + 64 j floats with Lq % 4 != 0 and
// b > 0 raised an illegal instruction on the card), so the box starts at the
// tile's first query rounded down to 4 floats and holds 4 more
constexpr int STAT_BOX = DKV_BM + 4;
constexpr int STAT_BYTES = STAT_BOX * 4;
constexpr int STAT_STRIDE = 384;  // a stage's slot, 128-byte aligned
constexpr int DKV_K_OFF = 0;
constexpr int DKV_V_OFF = ROWS_BYTES_128;
constexpr int DKV_Q_OFF = 2 * ROWS_BYTES_128;
constexpr int DKV_DO_OFF = DKV_Q_OFF + DKV_STAGES * ROWS_BYTES_64;
constexpr int DKV_LSE_OFF = DKV_DO_OFF + DKV_STAGES * ROWS_BYTES_64;
constexpr int DKV_DI_OFF = DKV_LSE_OFF + DKV_STAGES * STAT_STRIDE;
constexpr int DKV_BAR_OFF = DKV_DI_OFF + DKV_STAGES * STAT_STRIDE;
constexpr int DKV_SMEM = DKV_BAR_OFF + 8 * (1 + 2 * DKV_STAGES) + 8 + 1024;

// Initialise the once-loaded tiles' barrier, the ring's full and empty
// barriers and the abort flag (thread 0), then sync the block.
__device__ __forceinline__ void init_barriers(uint32_t bar_once, uint32_t bar_full,
                                              uint32_t bar_empty, int stages,
                                              uint32_t abort_flag) {
  if (threadIdx.x == 0) {
    mbar_init(bar_once, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, CONSUMERS);
    }
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(abort_flag), "r"(0u));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Store this thread's part of a consumer's 64 x 128 f32 accumulator, times
// `mul`, as bf16: rows row0 and row0 + 8 of `dst` (row b's first row);
// rows at or past nrows are not stored.
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, const float (&acc)[64], float mul,
                                          int row0, int nrows, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < nrows) {
      __nv_bfloat16* out = dst + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------- dq
// P of one key tile for this thread's rows g and g + 8 (s[4i + e] is row
// g + 8 (e >> 1), key key0 + 8i + 2t + (e & 1)), in place of S; keys at or
// past Lk get P = 0.
__device__ __forceinline__ void dq_probs(float (&s)[32], const float (&neg_lse)[2], int key0,
                                         int Lk, int t, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_lse[(i >> 1) & 1]));
  if (key0 + DQ_BN > Lk) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= Lk) s[i] = 0.f;
    }
  }
}

// dS = P o (dP - Di), in place of dP.
__device__ __forceinline__ void dq_dscores(float (&dp)[32], const float (&p)[32],
                                           const float (&di)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - di[(i >> 1) & 1]);
}

__global__ void __launch_bounds__(NTHREADS, 1)
    play_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap do_map,
                                 const float* __restrict__ lse, const float* __restrict__ di,
                                 __nv_bfloat16* __restrict__ dq, int Lq, int Lk,
                                 float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t s_base = smem_addr(aligned_smem(smem_raw));
  const uint32_t bar_q = s_base + DQ_BAR_OFF;  // Q and dO
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * DQ_STAGES;
  const uint32_t abort_flag = bar_empty + 8 * DQ_STAGES;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * DQ_BM;
  const int ntiles = (Lk + DQ_BN - 1) / DQ_BN;
  // the warpgroup, broadcast from lane 0 so the compiler knows the role branch
  // is uniform across each warp, as setmaxnreg's .sync.aligned requires
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  init_barriers(bar_q, bar_full, bar_empty, DQ_STAGES, abort_flag);

  if (wg == 0) {
    // ---------------- producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      prefetch_map(&do_map);
      mbar_expect_tx(bar_q, 2 * ROWS_BYTES_128);
      tma_tile_boxes<128>(s_base + DQ_Q_OFF, &q_map, bar_q, m0, b);
      tma_tile_boxes<128>(s_base + DQ_DO_OFF, &do_map, bar_q, m0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % DQ_STAGES;
        mbar_wait(bar_empty + 8 * st, ((j / DQ_STAGES) & 1) ^ 1, abort_flag);  // first pass free
        mbar_expect_tx(bar_full + 8 * st, 2 * ROWS_BYTES_64);
        tma_tile_boxes<64>(s_base + DQ_K_OFF + st * ROWS_BYTES_64, &k_map, bar_full + 8 * st,
                           j * DQ_BN, b);
        tma_tile_boxes<64>(s_base + DQ_V_OFF + st * ROWS_BYTES_64, &v_map, bar_full + 8 * st,
                           j * DQ_BN, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    const int r0 = m0 + c * 64 + warp * 16 + g;  // rows r0 and r0 + 8

    // rows past Lq: any finite values; their dS is computed but not stored
    float neg_lse[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const size_t at = static_cast<size_t>(b) * Lq + row;
      neg_lse[r] = row < Lq ? -lse[at] : 0.f;
      di_r[r] = row < Lq ? di[at] : 0.f;
    }
    // K-major A (Q, dO: this warpgroup's 64 rows of the 128-row tiles) and
    // B (K, V of the stage, 64 keys); K again as the MN-major B of dS K
    const uint64_t desc_q = sw128_desc(s_base + DQ_Q_OFF + c * 64 * 128, 16, 1024);
    const uint64_t desc_do = sw128_desc(s_base + DQ_DO_OFF + c * 64 * 128, 16, 1024);
    const uint64_t desc_k = sw128_desc(s_base + DQ_K_OFF, 16, 1024);
    const uint64_t desc_v = sw128_desc(s_base + DQ_V_OFF, 16, 1024);
    const uint64_t desc_kt = sw128_desc(s_base + DQ_K_OFF, BOX_64, 1024);

    float acc[64], s[32], dp[32];
    uint32_t ds[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

    // tile 0: S_0, dP_0 and dS_0, nothing to overlap with yet
    mbar_wait(bar_q, 0, abort_flag);
    mbar_wait(bar_full, 0, abort_flag);
    pin(s);
    pin(dp);
    wgmma_fence();
    mma_rows_dot_rows(s, desc_q, BOX_128, desc_k, BOX_64);
    wgmma_commit();
    mma_rows_dot_rows(dp, desc_do, BOX_128, desc_v, BOX_64);
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);
    dq_probs(s, neg_lse, 0, Lk, t, scale_log2);
    wgmma_wait<0>();
    pin(dp);
    dq_dscores(dp, s, di_r);

    for (int j = 1; j < ntiles; ++j) {
      const int st = j % DQ_STAGES, prev = (j - 1) % DQ_STAGES;
      pack_acc<32>(ds, dp);  // dS_{j-1}
      mbar_wait(bar_full + 8 * st, (j / DQ_STAGES) & 1, abort_flag);
      pin(s);
      pin(dp);
      pin(ds);
      pin(acc);
      wgmma_fence();
      mma_rows_dot_rows(s, desc_q, BOX_128, desc_k + st * STEP_64, BOX_64);  // S_j
      wgmma_commit();
      mma_rows_dot_rows(dp, desc_do, BOX_128, desc_v + st * STEP_64, BOX_64);  // dP_j
      wgmma_commit();
      mma_regs_times_rows(acc, ds, desc_kt + prev * STEP_64);  // dQ += dS_{j-1} K_{j-1}
      wgmma_commit();
      wgmma_wait<2>();  // S_j is done
      pin(s);
      dq_probs(s, neg_lse, j * DQ_BN, Lk, t, scale_log2);
      wgmma_wait<1>();  // dP_j is done
      pin(dp);
      dq_dscores(dp, s, di_r);
      wgmma_wait<0>();  // dQ += dS_{j-1} K_{j-1} is done: stage j - 1 is free
      pin(acc);
      pin(ds);
      mbar_arrive(bar_empty + 8 * prev);
    }

    const int last = (ntiles - 1) % DQ_STAGES;
    pack_acc<32>(ds, dp);
    pin(ds);
    pin(acc);
    wgmma_fence();
    mma_regs_times_rows(acc, ds, desc_kt + last * STEP_64);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(ds);

    // a wait timed out: write NaN, so no check can pass
    const float mul = block_aborted(abort_flag) ? NAN : scale;
    store_acc(dq + static_cast<size_t>(b) * Lq * D, acc, mul, r0, Lq, t);
  }
}

// ---------------------------------------------------------------- dk, dv
__global__ void __launch_bounds__(NTHREADS, 1)
    play_attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                                  const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map,
                                  const __grid_constant__ CUtensorMap do_map,
                                  const __grid_constant__ CUtensorMap lse_map,
                                  const __grid_constant__ CUtensorMap di_map,
                                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                  int Lq, int Lk, float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_kv = s_base + DKV_BAR_OFF;  // K and V
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * DKV_STAGES;
  const uint32_t abort_flag = bar_empty + 8 * DKV_STAGES;

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * DKV_BN;
  const int ntiles = (Lq + DKV_BM - 1) / DKV_BM;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  init_barriers(bar_kv, bar_full, bar_empty, DKV_STAGES, abort_flag);

  if (wg == 0) {
    // ---------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      prefetch_map(&do_map);
      prefetch_map(&lse_map);
      prefetch_map(&di_map);
      mbar_expect_tx(bar_kv, 2 * ROWS_BYTES_128);
      tma_tile_boxes<128>(s_base + DKV_K_OFF, &k_map, bar_kv, n0, b);
      tma_tile_boxes<128>(s_base + DKV_V_OFF, &v_map, bar_kv, n0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % DKV_STAGES;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((j / DKV_STAGES) & 1) ^ 1, abort_flag);
        mbar_expect_tx(full, 2 * ROWS_BYTES_64 + 2 * STAT_BYTES);
        tma_tile_boxes<64>(s_base + DKV_Q_OFF + st * ROWS_BYTES_64, &q_map, full, j * DKV_BM, b);
        tma_tile_boxes<64>(s_base + DKV_DO_OFF + st * ROWS_BYTES_64, &do_map, full, j * DKV_BM,
                           b);
        // lse and Di of the tile's queries (row b's from b Lq on), from the
        // 16-byte boundary at or before the first
        const int stat0 = (b * Lq + j * DKV_BM) & ~3;
        tma_load_1d(s_base + DKV_LSE_OFF + st * STAT_STRIDE, &lse_map, full, stat0);
        tma_load_1d(s_base + DKV_DI_OFF + st * STAT_STRIDE, &di_map, full, stat0);
      }
    }
  } else {
    // ---------------- consumers: 64 keys per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    const int r0 = n0 + c * 64 + warp * 16 + g;  // keys r0 and r0 + 8
    const int stat_shift = (b * Lq) & 3;  // a tile's first query in its lse/Di box

    // K-major A (K, V: this warpgroup's 64 keys of the 128-key tiles) and B
    // (Q, dO of the stage, 64 queries); Q and dO again as the MN-major B of
    // dS^T Q and P^T dO
    const uint64_t desc_k = sw128_desc(s_base + DKV_K_OFF + c * 64 * 128, 16, 1024);
    const uint64_t desc_v = sw128_desc(s_base + DKV_V_OFF + c * 64 * 128, 16, 1024);
    const uint64_t desc_q = sw128_desc(s_base + DKV_Q_OFF, 16, 1024);
    const uint64_t desc_do = sw128_desc(s_base + DKV_DO_OFF, 16, 1024);
    const uint64_t desc_qt = sw128_desc(s_base + DKV_Q_OFF, BOX_64, 1024);
    const uint64_t desc_dot = sw128_desc(s_base + DKV_DO_OFF, BOX_64, 1024);

    float acc_k[64], acc_v[64], s[32], dp[32];
    uint32_t pp[16] = {}, ds[16] = {};
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

    // Tile j's products: S^T_j and dP^T_j, then dK += dS^T_j Q_j; dV lags one
    // tile: dV += P^T_{j-1} dO_{j-1} is committed with S^T_j and dP^T_j (an
    // empty group at tile 0) and runs under tile j's P^T and dS^T, so stage
    // j - 1 is released during tile j.
    mbar_wait(bar_kv, 0, abort_flag);
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % DKV_STAGES, prev = (j + DKV_STAGES - 1) % DKV_STAGES;
      const int q0 = j * DKV_BM;
      mbar_wait(bar_full + 8 * st, (j / DKV_STAGES) & 1, abort_flag);
      pin(s);
      pin(dp);
      pin(pp);
      pin(acc_v);
      wgmma_fence();
      mma_rows_dot_rows(s, desc_k, BOX_128, desc_q + st * STEP_64, BOX_64);  // S^T_j
      wgmma_commit();
      mma_rows_dot_rows(dp, desc_v, BOX_128, desc_do + st * STEP_64, BOX_64);  // dP^T_j
      wgmma_commit();
      if (j > 0) mma_regs_times_rows(acc_v, pp, desc_dot + prev * STEP_64);  // dV, tile j - 1
      wgmma_commit();
      // this thread's columns (queries q0 + 8i + 2t, + 1) of the stage's lse and Di
      const float* lse_s =
          reinterpret_cast<const float*>(smem + DKV_LSE_OFF + st * STAT_STRIDE) + stat_shift;
      const float* di_s =
          reinterpret_cast<const float*>(smem + DKV_DI_OFF + st * STAT_STRIDE) + stat_shift;
      wgmma_wait<2>();  // S^T_j is done; dP^T_j and dV may still run
      pin(s);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float l2[2] = {lse_s[8 * i + 2 * t], lse_s[8 * i + 2 * t + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], scale_log2, -l2[e & 1]));
        }
      }
      if (q0 + DKV_BM > Lq) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (q0 + 8 * (i / 4) + 2 * t + (i & 1) >= Lq) s[i] = 0.f;
        }
      }
      wgmma_wait<1>();  // dP^T_j is done; dV may still run
      pin(dp);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d2[2] = {di_s[8 * i + 2 * t], di_s[8 * i + 2 * t + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - d2[e & 1]);
        }
      }
      pack_acc<32>(ds, dp);
      pin(ds);
      pin(acc_k);
      wgmma_fence();
      mma_regs_times_rows(acc_k, ds, desc_qt + st * STEP_64);  // dK += dS^T_j Q_j
      wgmma_commit();
      wgmma_wait<1>();  // dV of tile j - 1 is done: stage j - 1 is free
      pin(acc_v);
      pin(pp);
      if (j > 0) mbar_arrive(bar_empty + 8 * prev);
      pack_acc<32>(pp, s);  // P^T_j, for the next tile's dV
      wgmma_wait<0>();
      pin(acc_k);
      pin(ds);
    }
    pin(pp);
    pin(acc_v);
    wgmma_fence();
    mma_regs_times_rows(acc_v, pp, desc_dot + ((ntiles - 1) % DKV_STAGES) * STEP_64);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_v);
    pin(pp);

    const bool aborted = block_aborted(abort_flag);
    const size_t at = static_cast<size_t>(b) * Lk * D;
    store_acc(dk + at, acc_k, aborted ? NAN : scale, r0, Lk, t);
    store_acc(dv + at, acc_v, aborted ? NAN : 1.f, r0, Lk, t);
  }
}

}  // namespace

// q, dout (B, Lq, 128); k, v (B, Lk, 128): contiguous bf16, 16-byte aligned.
// lse, di (B, Lq) f32: the forward's base-2 log-sum-exp and rowsum(dO o O).
// dq (B, Lq, 128) bf16 is written. scale_log2 = scale * log2(e).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when a tensor map cannot be made (or, for dk/dv,
// when B Lq reaches 2^31).
extern "C" int play_attention_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di, void* dq,
                                     int B, int Lq, int Lk, float scale_log2,
                                     float scale, void* stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!make_map(&q_map, q, Lq, B, DQ_BM) || !make_map(&k_map, k, Lk, B, DQ_BN) ||
      !make_map(&v_map, v, Lk, B, DQ_BN) || !make_map(&do_map, dout, Lq, B, DQ_BM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      play_attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + DQ_BM - 1) / DQ_BM, B);
  play_attention_bwd_dq_kernel<<<grid, NTHREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dq), Lq, Lk, scale_log2,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// As play_attention_bwd_dq, writing dk and dv (B, Lk, 128) bf16.
extern "C" int play_attention_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dk, void* dv, int B, int Lq,
                                      int Lk, float scale_log2, float scale,
                                      void* stream) {
  CUtensorMap q_map, k_map, v_map, do_map, lse_map, di_map;
  const long long rows = static_cast<long long>(B) * Lq;  // lse and Di as one vector
  if (rows >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);  // int coordinates
  if (!make_map(&q_map, q, Lq, B, DKV_BM) || !make_map(&k_map, k, Lk, B, DKV_BN) ||
      !make_map(&v_map, v, Lk, B, DKV_BN) || !make_map(&do_map, dout, Lq, B, DKV_BM) ||
      !make_map_1d(&lse_map, lse, rows, STAT_BOX) || !make_map_1d(&di_map, di, rows, STAT_BOX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      play_attention_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lk + DKV_BN - 1) / DKV_BN, B);
  play_attention_bwd_dkv_kernel<<<grid, NTHREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, lse_map, di_map, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Lq, Lk, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
