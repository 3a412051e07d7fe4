// Play attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V.
// Three kernels come from one template whose mode (a compile-time argument)
// changes only the prologue and the epilogue:
//   * kernel 1 (`play_attention_fwd`, inference): o = O / l in bf16;
//   * kernel 2 (`play_attention_fwd_res`, training's forward): the same o,
//     bit for bit, and each row's base-2 log-sum-exp;
//   * kernel 5 (`play_attention_carry`, one hop of the ring play attention):
//     starts from an incoming unnormalised state and writes the merged state
//     back in place.
//
// Kernels 1 and 2 replace the Pallas TPU kernel `_flash_kernel` of
// ppmstereo_tpu/kernels/play_attention.py, reached through
// `_play_attention_pallas` (dispatched by `play_attention`, called from
// `PPMUpdateLoop._play`) and, with `save_residuals=True`, through
// `_flash_fwd_res` (the forward of the custom VJP). They compute what that
// kernel computes: single head, non-causal, head dim 128, bf16 q/k/v, an
// online base-2 softmax in f32, an f32 accumulator, bf16 output, keys past Lk
// masked. With `lse` it writes lse = m + log2(l) per row, one f32 per row
// (B, Lq), where the Pallas kernel writes m and l as (B, Lq, 128) lane tiles;
// the backward kernels (play_attention_bwd.cu) consume it.
//
// Kernel 5 replaces `_flash_carry_kernel` of the same file (reached through
// `flash_attend_carry`, called per hop by
// ppmstereo_tpu/parallel/ring_attention.py::_ring_local). The state is
// o (B, Lq, 128) f32 unnormalised, m (B, Lq) f32 the base-2 row max and
// l (B, Lq) f32 the row sum, one value per row (not the TPU's 128-lane
// tiles). The prologue loads the incoming state into the accumulators
// before the key loop (o into the O accumulator, m into the row maxima, l
// into the partial sum of each row's first lane), so the loop merges every
// key tile into it as the online softmax merges tiles:
//   m' = max(m, rowmax s), alpha = exp2(m - m'),
//   l' = alpha l + rowsum exp2(s - m'), o' = alpha o + exp2(s - m') V,
// and the epilogue writes o (f32, unnormalised), m and l back in place; the
// caller divides o by l after the last hop. (Merging an empty-state result
// with the incoming state in the epilogue would be the same function with
// its f32 roundings in another order; loading it first needs no second copy
// of o, which the consumers' registers could not hold.) A hop at the 1/4
// stage of the 2-way ring (10 x 5,120 x 25,600) reads and writes 2 x 26 MB of
// f32 state beside 144 MB of bf16 inputs, outside the pipelined loop, as
// float2 per lane; it is still bound by the tensor cores (6.7e11 FLOP,
// 0.68 ms at 989 TFLOP/s).
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
//     f32 lse per row; kernel 5 writes its f32 state back instead (see above).
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
// The kernel allocates nothing; the caller passes the output (or state)
// buffers. The
// host side encodes the tensor maps at each launch with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 128;                    // head dim
constexpr int BM = 128;                   // query rows per block
constexpr int BN = 128;                   // keys per tile
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int NTHREADS = 384;             // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int TILE_BYTES = 128 * D * 2;   // a 128-row bf16 tile of Q, K or V
constexpr int BOX_BYTES = TILE_BYTES / 2; // one 64-column box of it
constexpr int Q_OFF = 0;
constexpr int K_OFF = TILE_BYTES;
constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
constexpr int ABORT_OFF = BAR_OFF + 8 * (1 + 4 * STAGES);  // the block's abort flag
constexpr int SMEM_BYTES = ABORT_OFF + 8 + 1024;            // + alignment slack
constexpr uint64_t STAGE_STEP = TILE_BYTES >> 4;  // a stage, in descriptor address units

// A 128 x 128 tile: rows [row, row + 128) of row b, as two 64-column boxes.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int b) {
  mbar_expect_tx(bar, TILE_BYTES);
  tma_tile_boxes<128>(dst, map, bar, row, b);
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

// The template's modes (mangled as ILi0E, ILi1E, ILi2E).
enum : int {
  NORMALISED = 0,  // kernel 1: o / l in bf16
  WITH_LSE = 1,    // kernel 2: kernel 1's o, and lse per row
  CARRY = 2,       // kernel 5: the state (o, m, l) read and written back, f32
};

// o_out: bf16 (B, Lq, 128) for NORMALISED and WITH_LSE, the f32 state o for
// CARRY; lse (WITH_LSE), cm and cl (CARRY): (B, Lq) f32, else unused.
template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
    play_attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              void* __restrict__ o_out, float* __restrict__ lse,
                              float* __restrict__ cm, float* __restrict__ cl, int Lq, int Lk,
                              float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t s_base = smem_addr(aligned_smem(smem_raw));
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
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
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
    if constexpr (MODE == CARRY) {
      // the incoming state: this thread's columns of o in the accumulator's
      // layout (o[4n + 2r + e] is row r0 + 8r, column 8n + 2t + e), the row
      // maxima, and each row sum in the partial sum of the row's first lane;
      // rows at or past Lq start empty and are not read
      const float* co = static_cast<const float*>(o_out) + static_cast<size_t>(b) * Lq * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Lq) {
          const float* orow = co + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const float2 x = *reinterpret_cast<const float2*>(orow + 8 * n);
            o[4 * n + 2 * r] = x.x;
            o[4 * n + 2 * r + 1] = x.y;
          }
          m[r] = cm[static_cast<size_t>(b) * Lq + row];
          if (t == 0) l[r] = cl[static_cast<size_t>(b) * Lq + row];
        }
      }
    }

    // tile 0: S_0 and its softmax, nothing to overlap with yet
    mbar_wait(bar_q, 0, abort_flag);
    mbar_wait(bar_k_full, 0, abort_flag);
    pin(s);
    wgmma_fence();
    mma_rows_dot_rows(s, desc_q, BOX_BYTES, desc_k, BOX_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    mbar_arrive(bar_k_empty);
    softmax_tile(s, m, l, alpha, 0, Lk, t, scale_log2);
    if constexpr (MODE == CARRY) {
      // the incoming o into tile 0's units (elsewhere o is still zero)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    pack_acc<64>(p, s);

    for (int j = 1; j < ntiles; ++j) {
      const int st = j % STAGES, prev = (j - 1) % STAGES;
      mbar_wait(bar_k_full + 8 * st, (j / STAGES) & 1, abort_flag);
      pin(s);
      pin(o);
      pin(p);
      wgmma_fence();
      mma_rows_dot_rows(s, desc_q, BOX_BYTES, desc_k + st * STAGE_STEP, BOX_BYTES);  // S_j
      wgmma_commit();
      mbar_wait(bar_v_full + 8 * prev, ((j - 1) / STAGES) & 1, abort_flag);
      mma_regs_times_rows(o, p, desc_v + prev * STAGE_STEP);  // O += P_{j-1} V_{j-1}
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
      pack_acc<64>(p, s);
    }

    const int last = (ntiles - 1) % STAGES;
    mbar_wait(bar_v_full + 8 * last, ((ntiles - 1) / STAGES) & 1, abort_flag);
    pin(o);
    pin(p);
    wgmma_fence();
    mma_regs_times_rows(o, p, desc_v + last * STAGE_STEP);
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);

    // epilogue: full row sums across the 4 lanes of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if constexpr (MODE == CARRY) {
      // the merged state, unnormalised, in place; a wait timed out: NaN
      // into o and l, so no check can pass
      const float keep = block_aborted(abort_flag) ? NAN : 1.f;
      float* co = static_cast<float*>(o_out) + static_cast<size_t>(b) * Lq * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Lq) {
          float* orow = co + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<float2*>(orow + 8 * n) =
                make_float2(o[4 * n + 2 * r] * keep, o[4 * n + 2 * r + 1] * keep);
          }
          if (t == 0) {
            cm[static_cast<size_t>(b) * Lq + row] = m[r];
            cl[static_cast<size_t>(b) * Lq + row] = l[r] * keep;
          }
        }
      }
    } else {
      // normalise and store
      float inv[2] = {1.f / l[0], 1.f / l[1]};
      // a wait timed out: write NaN, so no check can pass
      if (block_aborted(abort_flag)) inv[0] = inv[1] = NAN;
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o_out) + static_cast<size_t>(b) * Lq * D;
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
          if (MODE == WITH_LSE && t == 0) {
            lse[static_cast<size_t>(b) * Lq + row] = m[r] + log2f(l[r]);
          }
        }
      }
    }
  }
}

template <int MODE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, float* cm,
           float* cl, int B, int Lq, int Lk, float scale_log2, void* stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, Lq, B, BM) || !make_map(&k_map, k, Lk, B, BN) ||
      !make_map(&v_map, v, Lk, B, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(play_attention_fwd_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BM - 1) / BM, B);
  play_attention_fwd_kernel<MODE><<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, o, lse, cm, cl, Lq, Lk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq, 128), k and v (B, Lk, 128), o (B, Lq, 128): contiguous bf16 on
// the current device, 16-byte aligned. scale_log2 = scale * log2(e).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int play_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                  int Lq, int Lk, float scale_log2, void* stream) {
  return launch<NORMALISED>(q, k, v, o, nullptr, nullptr, nullptr, B, Lq, Lk, scale_log2, stream);
}

// As play_attention_fwd, and writes lse (B, Lq) f32: each row's base-2
// log-sum-exp of scale * log2(e) * q.k.
extern "C" int play_attention_fwd_res(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int Lq, int Lk, float scale_log2,
                                      void* stream) {
  return launch<WITH_LSE>(q, k, v, o, static_cast<float*>(lse), nullptr, nullptr, B, Lq, Lk,
                          scale_log2, stream);
}

// One ring hop (kernel 5): q (B, Lq, 128), k and v (B, Lk, 128) bf16; the
// state o (B, Lq, 128), m and l (B, Lq) f32, read and overwritten with the
// merged state (unnormalised; m base 2). All contiguous on the current
// device, 16-byte aligned. Returns as play_attention_fwd.
extern "C" int play_attention_carry(const void* q, const void* k, const void* v, void* o,
                                    void* m, void* l, int B, int Lq, int Lk, float scale_log2,
                                    void* stream) {
  return launch<CARRY>(q, k, v, o, nullptr, static_cast<float*>(m), static_cast<float*>(l), B,
                       Lq, Lk, scale_log2, stream);
}
