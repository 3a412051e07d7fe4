// Play attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V.
// Kernel 1 (`play_attention_fwd`, inference) and kernel 2
// (`play_attention_fwd_res`, training's forward, which also writes each row's
// base-2 log-sum-exp) come from one template; the lse store is a compile-time
// flag, so kernel 2's o is kernel 1's bit for bit.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// ppmstereo_tpu/kernels/play_attention.py, reached through
// `_play_attention_pallas` (dispatched by `play_attention`, called from
// `PPMUpdateLoop._play`) and, with `save_residuals=True`, through
// `_flash_fwd_res` (the forward of the custom VJP). It computes what that
// kernel computes: single head, non-causal, head dim 128, bf16 q/k/v, an
// online base-2 softmax in f32, an f32 accumulator, bf16 output, keys past Lk
// masked. With `lse` it writes lse = m + log2(l) per row, one f32 per row
// (B, Lq), where the Pallas kernel writes m and l as (B, Lq, 128) lane tiles;
// the backward kernels (play_attention_bwd.cu) consume it.
//
// What bounds it: one 1/4-stage launch at 320x512 is 10 rows x Lq 10,240 x
// Lk 51,200 x D 128: 2.7e12 FLOP against ~315 MB moved, ~8,500 FLOP a byte,
// far above the card's ~295 bf16 FLOP/byte ridge. It is bound by the tensor
// cores (2.7 ms at 989 TFLOP/s), and by the softmax's exp2 next to them:
// 128 x 128 ex2 per tile take ~1,024 cycles of an SM's 16-a-cycle MUFU
// units against ~2,048 cycles of wgmma for the tile's two products, so the
// exponentials must run under the products, not between them.
//
// Design (FlashAttention-3's shape for D = 128):
//   * one block per (row b, tile of BM = 128 query rows), 384 threads in
//     three warpgroups: warpgroup 0 is the producer (one thread starts every
//     TMA load; `setmaxnreg` drops the group to 24 registers), warpgroups 1
//     and 2 are consumers of 64 query rows each (`setmaxnreg` raises them to
//     240: the O accumulator, S and P take 64 + 64 + 32 registers a thread);
//   * TMA loads: the Q tile once, K and V tiles of BN = 128 keys through a
//     ring of STAGES stages, each with a "full" mbarrier (the producer's
//     expect_tx, completed by the copy's bytes) and an "empty" one (all 256
//     consumer threads arrive when done with the stage). K and V have their
//     own barriers, so S can start before V has landed;
//   * the tensor maps are 3-D (D, L, B), so a tile past Lq or Lk is zero-
//     filled inside its own row b, never read from the next row. A box is
//     64 columns (128 bytes) wide, the widest the 128-byte swizzle takes, so a
//     128 x 128 tile is two boxes, each 128 rows of 128 bytes;
//   * S = Q K^T: wgmma m64n128k16 with A = Q and B = K from shared memory,
//     both K-major with the 128-byte swizzle (descriptor layout type 1, stride
//     1024 bytes between 8-row groups; a k16 step advances the start address by
//     32 bytes inside the swizzle atom, the next box by 16 KB);
//   * O += P V: wgmma m64n128k16 with A = P from registers (the S accumulator
//     of a warp's 16 rows is already the A fragment of the k16 steps once
//     packed to bf16 pairs) and B = V from shared memory with the transpose
//     flag: V is (keys, D), D contiguous, i.e. MN-major for this product
//     (leading byte offset 16 KB between the two 64-column boxes, stride byte
//     offset 1 KB between 8-key groups; a k16 step advances 2 KB);
//   * the overlap is within each consumer warpgroup (FlashAttention-3's
//     intra-warpgroup pipelining): for key tile j it starts S_j = Q K_j^T,
//     then O += P_{j-1} V_{j-1}, waits for S_j only, and runs tile j's softmax
//     (ex2) while P_{j-1} V_{j-1} is still on the tensor cores; it waits for
//     that product before rescaling O by alpha_j and packing P_j. The two
//     consumer warpgroups are not ordered against each other: ping-pong
//     between them (named barriers handing the tensor cores from one to the
//     other) was measured on the card and gained nothing, nor did a third
//     K/V stage;
//   * softmax in registers: the scale and log2(e) folded into one FMA, ex2.approx,
//     row max and sum across the 4 lanes of a row by __shfl_xor_sync; keys at
//     or past Lk get -inf logits, only on the last, ragged tile;
//   * the epilogue normalises by l, stores bf16 pairs straight from the
//     accumulator (rows at or past Lq are not stored) and, for kernel 2, one
//     f32 lse per row.
// Pitfalls this design meets, and what it does about them:
//   * descriptors vs swizzle: a wgmma descriptor whose layout does not match
//     the TMA swizzle gives wrong numbers, not a crash. The shared tiles are
//     1024-byte aligned (base_offset 0), every descriptor uses layout type 1
//     (128-byte swizzle) as the tensor maps do, and the ragged shapes of
//     `chip_smoke.py` (1 x 17 x 5, 3 x 1000 x 4999) check it;
//   * ordering: every wgmma batch is fenced (`wgmma.fence`), committed and
//     waited for; the accumulators are pinned around the waits by empty asm
//     statements, so the compiler cannot move their reads or writes between
//     a wgmma and its wait;
//   * barrier phases: a stage's parity flips on each pass round the ring. A
//     wait that has not completed after WAIT_LIMIT_NS of the global timer
//     aborts the block, which then writes NaN, so a phase error fails the
//     checks instead of hanging the card;
//   * registers: the launch gives each thread 168 (384 threads on one SM);
//     after setmaxnreg the producer holds 24 and the consumers 240, of which
//     they use 184 (the SASS's highest register). ptxas compiles each branch
//     to its setmaxnreg budget only while no no-return path (`__trap()`)
//     leaves the consumers' branch: with one, it held them to 168, spilled P
//     and serialised the wgmma (C7512): 6.0 ms against 4.2 ms at the 1/4
//     shape on an H100.
//     `-Xptxas -v` shows spills; `chip_smoke.py` prints its lines.
// The kernel allocates nothing; the caller passes the output buffers. The
// host side encodes the tensor maps at each launch with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                    // head dim
constexpr int BM = 128;                   // query rows per block
constexpr int BN = 128;                   // keys per tile
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int NTHREADS = 384;             // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int TILE_BYTES = 128 * D * 2;   // a 128-row bf16 tile of Q, K or V
constexpr int BOX_BYTES = TILE_BYTES / 2; // one 64-column box of it
constexpr int BOX_COLS = 64;
constexpr int Q_OFF = 0;
constexpr int K_OFF = TILE_BYTES;
constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
constexpr int ABORT_OFF = BAR_OFF + 8 * (1 + 4 * STAGES);  // the block's abort flag
constexpr int SMEM_BYTES = ABORT_OFF + 8 + 1024;            // + alignment slack
constexpr uint64_t STAGE_STEP = TILE_BYTES >> 4;  // a stage, in descriptor address units
constexpr unsigned long long WAIT_LIMIT_NS = 2000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that has not completed after WAIT_LIMIT_NS sets the block's abort flag
// (a shared word) and returns, and every later wait of the block returns at
// once: the block runs to its end and writes NaN (see the epilogue), so a
// wrong phase fails the checks instead of hanging the card. (Not __trap():
// its no-return path keeps ptxas from giving the consumers the registers
// that setmaxnreg raised, and they spill.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity, uint32_t abort_flag) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    uint32_t aborted;
    asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(aborted) : "r"(abort_flag));
    if (aborted) return;
    if (global_ns() - t0 > WAIT_LIMIT_NS) {
      asm volatile("st.volatile.shared.u32 [%0], %1;\n" ::"r"(abort_flag), "r"(1u));
      return;
    }
  }
}

// ---------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 128 x 128 tile: rows [row, row + 128) of row b, as two 64-column boxes.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int b) {
  mbar_expect_tx(bar, TILE_BYTES);
  tma_load_3d(dst, map, bar, 0, row, b);
  tma_load_3d(dst + BOX_BYTES, map, bar, BOX_COLS, row, b);
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1); the
// byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the program: the compiler may not move their
// reads or writes across it (nor across the wgmma instructions and waits, which are
// volatile asm too).
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void pin(uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(p[i])::"memory");
}

#define WGMMA_D64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define WGMMA_ACC64(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),      \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),      \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),      \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) = [d +] A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, f32) += A B, A (64 x 16 bf16) from registers, B from shared
// memory, MN-major (the transpose flag).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// S = Q K^T over D = 128: eight k16 steps, four in each 64-column box.
__device__ __forceinline__ void mma_qk(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t step = (kk / 4) * (BOX_BYTES >> 4) + (kk % 4) * (32 >> 4);
    wgmma_ss(s, desc_q + step, desc_k + step, kk > 0);
  }
}

// O += P V over the tile's 128 keys: eight k16 steps of 16 keys (2 KB of V).
__device__ __forceinline__ void mma_pv(float (&o)[64], const uint32_t (&p)[32],
                                         uint64_t desc_v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    wgmma_rs_tb(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                desc_v + kk * ((16 * BOX_COLS * 2) >> 4));
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The online softmax of one tile for this thread's two rows (g and g + 8 of
// its warp's 16; s[4i + e] is row g + 8 (e >> 1), key 8i + 2t + (e & 1)).
// Masks keys at or past Lk when the tile is ragged, replaces s by
// exp2(scale_log2 s - m_new), updates the row maxima m and this lane's
// partial row sums l, and returns the factors alpha that rescale O.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int key0, int Lk, int t,
                                             float scale_log2) {
  if (key0 + BN > Lk) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= Lk) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile holds at least one valid key, so the new maxima are finite
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_m[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <bool WITH_LSE>
__global__ void __launch_bounds__(NTHREADS, 1)
    play_attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              __nv_bfloat16* __restrict__ o_out, float* __restrict__ lse,
                              int Lq, int Lk, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment (descriptor base_offset 0)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_q = s_base + BAR_OFF;
  const uint32_t bar_k_full = bar_q + 8;
  const uint32_t bar_k_empty = bar_k_full + 8 * STAGES;
  const uint32_t bar_v_full = bar_k_empty + 8 * STAGES;
  const uint32_t bar_v_empty = bar_v_full + 8 * STAGES;
  const uint32_t abort_flag = s_base + ABORT_OFF;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int ntiles = (Lk + BN - 1) / BN;
  // the warpgroup, broadcast from lane 0 so the compiler knows the role branch
  // is uniform across each warp, as setmaxnreg's .sync.aligned requires
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_k_full + 8 * st, 1);
      mbar_init(bar_k_empty + 8 * st, CONSUMERS);
      mbar_init(bar_v_full + 8 * st, 1);
      mbar_init(bar_v_empty + 8 * st, CONSUMERS);
    }
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(abort_flag), "r"(0u));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&q_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&k_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&v_map))
                   : "memory");
      tma_tile(s_base + Q_OFF, &q_map, bar_q, m0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;  // the first pass is free
        mbar_wait(bar_k_empty + 8 * st, free_parity, abort_flag);
        tma_tile(s_base + K_OFF + st * TILE_BYTES, &k_map, bar_k_full + 8 * st, j * BN, b);
        mbar_wait(bar_v_empty + 8 * st, free_parity, abort_flag);
        tma_tile(s_base + V_OFF + st * TILE_BYTES, &v_map, bar_v_full + 8 * st, j * BN, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x - 128 * wg;  // 0..127 within the warpgroup
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = m0 + (wg - 1) * 64 + warp * 16 + g;  // rows r0 and r0 + 8

    // K-major A and B (Q, K): leading offset unused, 1 KB between 8-row
    // groups; MN-major B (V): 16 KB between the 64-column boxes, 1 KB
    // between 8-key groups
    const uint64_t desc_q = sw128_desc(s_base + Q_OFF + (wg - 1) * 64 * 128, 16, 1024);
    // (stage st: + st * STAGE_STEP; no arrays indexed at run time)
    const uint64_t desc_k = sw128_desc(s_base + K_OFF, 16, 1024);
    const uint64_t desc_v = sw128_desc(s_base + V_OFF, BOX_BYTES, 1024);

    float o[64], s[64];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // base-2 row maxima
    float l[2] = {0.f, 0.f};              // this lane's partial row sums
    float alpha[2];

    // tile 0: S_0 and its softmax, nothing to overlap with yet
    mbar_wait(bar_q, 0, abort_flag);
    mbar_wait(bar_k_full, 0, abort_flag);
    pin(s);
    wgmma_fence();
    mma_qk(s, desc_q, desc_k);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    mbar_arrive(bar_k_empty);
    softmax_tile(s, m, l, alpha, 0, Lk, t, scale_log2);
    pack_p(p, s);

    for (int j = 1; j < ntiles; ++j) {
      const int st = j % STAGES, prev = (j - 1) % STAGES;
      mbar_wait(bar_k_full + 8 * st, (j / STAGES) & 1, abort_flag);
      pin(s);
      pin(o);
      pin(p);
      wgmma_fence();
      mma_qk(s, desc_q, desc_k + st * STAGE_STEP);  // S_j
      wgmma_commit();
      mbar_wait(bar_v_full + 8 * prev, ((j - 1) / STAGES) & 1, abort_flag);
      mma_pv(o, p, desc_v + prev * STAGE_STEP);  // O += P_{j-1} V_{j-1}
      wgmma_commit();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      pin(s);
      mbar_arrive(bar_k_empty + 8 * st);
      softmax_tile(s, m, l, alpha, j * BN, Lk, t, scale_log2);
      wgmma_wait<0>();
      pin(o);
      pin(p);
      mbar_arrive(bar_v_empty + 8 * prev);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(p, s);
    }

    const int last = (ntiles - 1) % STAGES;
    mbar_wait(bar_v_full + 8 * last, ((ntiles - 1) / STAGES) & 1, abort_flag);
    pin(o);
    pin(p);
    wgmma_fence();
    mma_pv(o, p, desc_v + last * STAGE_STEP);
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);

    // epilogue: full row sums across the 4 lanes of each row, normalise, store
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    uint32_t aborted;  // a wait timed out: write NaN, so no check can pass
    asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(aborted) : "r"(abort_flag));
    if (aborted) inv[0] = inv[1] = NAN;
    __nv_bfloat16* ob = o_out + static_cast<size_t>(b) * Lq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < Lq) {
        __nv_bfloat16* orow = ob + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
              o[4 * n + 2 * r] * inv[r], o[4 * n + 2 * r + 1] * inv[r]);
        }
        if (WITH_LSE && t == 0) lse[static_cast<size_t>(b) * Lq + row] = m[r] + log2f(l[r]);
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The 3-D map (D, L, B) of a contiguous (B, L, 128) bf16 tensor, in boxes of
// 64 columns x 128 rows x 1, 128-byte swizzled; reads past L are zeros.
bool make_map(CUtensorMap* map, const void* base, int L, int B) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(L) * D * 2};
  const cuuint32_t box[3] = {BOX_COLS, 128, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool WITH_LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq,
           int Lk, float scale_log2, void* stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, Lq, B) || !make_map(&k_map, k, Lk, B) ||
      !make_map(&v_map, v, Lk, B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(play_attention_fwd_kernel<WITH_LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BM - 1) / BM, B);
  play_attention_fwd_kernel<WITH_LSE>
      <<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, Lq, Lk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq, 128), k and v (B, Lk, 128), o (B, Lq, 128): contiguous bf16 on
// the current device, 16-byte aligned. scale_log2 = scale * log2(e).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int play_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                  int Lq, int Lk, float scale_log2, void* stream) {
  return launch<false>(q, k, v, o, nullptr, B, Lq, Lk, scale_log2, stream);
}

// As play_attention_fwd, and writes lse (B, Lq) f32: each row's base-2
// log-sum-exp of scale * log2(e) * q.k.
extern "C" int play_attention_fwd_res(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int Lq, int Lk, float scale_log2,
                                      void* stream) {
  return launch<true>(q, k, v, o, static_cast<float*>(lse), B, Lq, Lk, scale_log2, stream);
}
