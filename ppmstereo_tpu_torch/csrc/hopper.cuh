// Hopper (sm_90a) building blocks shared by the play-attention kernels of
// play_attention_fwd.cu (kernels 1, 2 and 5) and play_attention_bwd.cu
// (kernels 3 and 4): mbarriers with a timed wait that aborts instead of
// hanging, TMA tile loads, 128-byte-swizzle wgmma descriptors, the wgmma
// products the kernels use, register pins, and the host-side encoding of
// the tensor maps.
//
// Conventions every kernel here keeps:
//   * a bf16 tensor (B, L, 128) is read through a 3-D tensor map (D, L, B)
//     in boxes of 64 columns (128 bytes, the widest the 128-byte swizzle
//     takes) x `rows` rows x 1, so a tile past L is zero-filled inside its
//     own row b and never read from the next row;
//   * a tile of `rows` x 128 lands in shared memory as two boxes of
//     rows x 128 bytes, 1024-byte aligned (descriptor base_offset 0);
//   * K-major operands (rows of 128 bytes along the reduction dimension):
//     descriptor leading offset unused (16), stride 1 KB between 8-row
//     groups; a k16 step advances 32 bytes inside the swizzle atom and the
//     ninth step moves to the second box;
//   * an MN-major B (the reduction runs over the tile's rows, D contiguous;
//     the transpose flag): leading offset one box (between the two
//     64-column halves), stride 1 KB between 8-row groups; a k16 step
//     advances 16 rows, 2 KB.
// Pitfalls: a descriptor that does not match the TMA swizzle gives wrong
// numbers, not a crash; a wgmma reads and writes its registers after the
// instruction has issued, so the registers are pinned (`pin`) around every
// fence and wait; a no-return path (`__trap()`) inside a consumer branch
// makes ptxas ignore the registers `setmaxnreg` raised, so a timed-out wait
// sets an abort flag instead and the kernel writes NaN.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int HEAD_DIM = 128;   // every tensor's last dimension
constexpr int BOX_COLS = 64;    // columns of one swizzled box (128 bytes)
constexpr unsigned long long WAIT_LIMIT_NS = 2000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory from its first 1024-byte boundary: the
// swizzled tiles need that alignment (descriptor base_offset 0).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
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

__device__ __forceinline__ bool block_aborted(uint32_t abort_flag) {
  uint32_t aborted;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(aborted) : "r"(abort_flag));
  return aborted != 0;
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

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A ROWS x 128 bf16 tile, rows [row, row + ROWS) of row b, as two 64-column
// boxes; the caller's expect_tx covers its ROWS * 256 bytes.
template <int ROWS>
__device__ __forceinline__ void tma_tile_boxes(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int row, int b) {
  tma_load_3d(dst, map, bar, 0, row, b);
  tma_load_3d(dst + ROWS * 128, map, bar, BOX_COLS, row, b);
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
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(p[i])::"memory");
}

#define WGMMA_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define WGMMA_D64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define WGMMA_ACC32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

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

// d (64 x 64, f32) = [d +] A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_ACC32(d)
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

// d (64 x N) [+]= A B^T over the head dim (128 = eight k16 steps, four in
// each 64-column box): A and B K-major tiles whose boxes are a_box and
// b_box bytes apart. N is 128 (float[64]) or 64 (float[32]).
template <int NACC>
__device__ __forceinline__ void mma_rows_dot_rows(float (&d)[NACC], uint64_t desc_a,
                                                  uint32_t a_box, uint64_t desc_b,
                                                  uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
    const uint64_t in_box = (kk % 4) * (32 >> 4);
    wgmma_ss(d, desc_a + (kk / 4) * (a_box >> 4) + in_box,
             desc_b + (kk / 4) * (b_box >> 4) + in_box, kk > 0);
  }
}

// d (64 x 128) += A M over KEYS rows of M: A (64 x KEYS) packed bf16 pairs
// in registers (a wgmma accumulator's layout, 4 registers a k16 step), M an
// MN-major tile (KEYS x 128, two 64-column boxes) at desc_m; a k16 step
// advances 16 rows (2 KB).
template <int NA>
__device__ __forceinline__ void mma_regs_times_rows(float (&d)[64], const uint32_t (&a)[NA],
                                                    uint64_t desc_m) {
#pragma unroll
  for (int kk = 0; kk < NA / 4; ++kk) {
    wgmma_rs_tb(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                desc_m + kk * ((16 * BOX_COLS * 2) >> 4));
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

// An accumulator (s[4i + e]: row g + 8 (e >> 1), column 8i + 2t + (e & 1))
// as the A operand of the next product: bf16 pairs, 4 registers a k16 step.
template <int N>
__device__ __forceinline__ void pack_acc(uint32_t (&p)[N / 2], const float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// ---------------------------------------------------------------- host
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
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
// 64 columns x box_rows rows x 1, 128-byte swizzled; reads past L are zeros.
inline bool make_map(CUtensorMap* map, const void* base, int L, int B, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HEAD_DIM), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HEAD_DIM) * 2,
                                 static_cast<cuuint64_t>(L) * HEAD_DIM * 2};
  const cuuint32_t box[3] = {BOX_COLS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 1-D map of a contiguous f32 vector of n elements, in boxes of `box`
// elements, unswizzled; reads past n are zeros.
inline bool make_map_1d(CUtensorMap* map, const void* base, long long n, int box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t no_strides[1] = {0};  // a rank-1 map has none
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem_strides[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
                no_strides, boxes, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
