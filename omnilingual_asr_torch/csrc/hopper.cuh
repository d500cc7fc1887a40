// Hopper's own machinery for the port's kernels (sm_90a): tensor maps and
// the Tensor Memory Accelerator (TMA) for global -> shared copies of whole
// tiles, mbarriers that count the copies' bytes and the consumers'
// arrivals, and the warpgroup matrix products (wgmma.mma_async) over f16
// operands with f32 accumulation. Used by the f16 K2 (attention_f16.cu).
//
// Layout that ties them together: a TMA box of 64 16-bit columns (128
// bytes) and R rows, copied with CU_TENSOR_MAP_SWIZZLE_128B into shared
// memory at a multiple of 1024 bytes, holds row r's 16-byte chunk c at
// r * 128 + ((c ^ (r % 8)) * 16). That is wgmma's 128-byte-swizzled
// canonical layout: atoms of 8 rows x 128 bytes, 1024 bytes apart. A box
// so copied is a wgmma operand read through a shared-memory descriptor
// (sw128_desc), either K-major (the product's contraction runs along the
// 128-byte rows: Q and K in S = Q K^T; a k-step of 16 columns starts 32
// bytes further along the row) or MN-major (the contraction runs down the
// rows: V in O = P V, with the transpose bit; a k-step of 16 rows starts
// 2048 bytes further; two boxes side by side, the leading byte offset
// apart, are one operand 128 columns wide).
//
// Register fragments of wgmma.m64nNk16 (warp w of the warpgroup, lane =
// 4 g + t): the f32 accumulator D holds rows 16 w + g and 16 w + g + 8,
// in N / 8 groups of 4 registers: d[n][0..1] (row 16 w + g, columns
// 8 n + 2 t, + 1) and d[n][2..3] (row 16 w + g + 8, the same columns),
// which is mma.sync.m16n8k16's C layout (mma.cuh) repeated along N; an
// A operand in registers holds the same warp's 16 rows as mma.sync's A
// fragment (mma.cuh's header). So two adjacent 8-column groups of an
// accumulator, packed to 16-bit pairs, are the A fragment of the 16
// columns they cover, for a next product from registers.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "mma.cuh"

namespace omni {

// ---- Host: tensor maps ----------------------------------------------------

// cuTensorMapEncodeTiled, found through the runtime's driver entry point
// so that the library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// One head's rows of a contiguous f16 [B, T, H, D] tensor as a 4-D tensor
// map {D, H, T, B} (byte strides 2 D, 2 H D, 2 T H D) whose box is 64
// columns x 1 head x `rows` rows x 1 batch, 128-byte swizzled; rows at or
// past T (and columns past D) are zero-filled by the hardware. Returns 0
// or an OMNI_ERR_* code (common.cuh): TMA wants a 16-byte aligned base.
inline int encode_bthd_f16(CUtensorMap* map, const void* base, int B, int T,
                           int H, int D, int rows) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return OMNI_ERR_MISALIGNED;
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return OMNI_ERR_NO_TENSOR_MAPS;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * T * H * D};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : OMNI_ERR_TENSOR_MAP;
}

// ---- Device: mbarriers and TMA --------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the asynchronous proxy (TMA);
// a __syncthreads() after it makes them visible to the block.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more of transactions (a TMA copy's
// size, out-of-bounds fill included) before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed (phases
// count from 0 after init: a use j of a barrier waits on parity j & 1). A
// wait that outlasts 2^26 tries (seconds) traps: a copy that never lands
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- Device: warpgroup matrix products ------------------------------------

// The shared-memory descriptor of a 128-byte-swizzled operand starting at
// p (see the head of this file): start address >> 4 in bits 0-13, the
// leading and stride byte offsets >> 4 in bits 16-29 and 32-45, the
// 128-byte swizzle (1) in bits 62-63, base offset 0 (the atoms start at
// multiples of 1024 bytes; p itself may be 32 bytes further along a row,
// a K-major k-step). The stride offset is 1024 bytes, the step between
// 8-row atoms, for both majors; the leading offset `lead` is the step
// between 64-column atoms of an MN-major operand wider than 64 columns
// (unused by a K-major one and by one of 64 columns).
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lead = 1024) {
  constexpr uint64_t atom = 1024 >> 4;
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (atom << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Orders the warpgroup's register and shared-memory accesses before it
// against the wgmma that follow (needed before the first wgmma and after
// any other access to an accumulator or A register).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of wgmma are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving an access to an accumulator across the
// wgmma_wait that completes it (the asm statements that issue a wgmma
// write their accumulators, as far as the compiler knows, at issue).
template <int N>
__device__ __forceinline__ void fence_accumulator(float (*d)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

#define OMNI_WGMMA_D64N64(d)                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),             \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),         \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),         \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),         \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),         \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),         \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),         \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

#define OMNI_WGMMA_D32_LIST                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d (+)= A B over a 64 x 16 A and a 16 x 64 B, both f16 in shared memory
// through descriptors, both K-major (S = Q K^T: A the query rows, B^T the
// key rows); d is overwritten when `accumulate` is false. Exact products,
// f32 sums.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (*d)[4],
                                                   uint64_t a, uint64_t b,
                                                   bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " OMNI_WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : OMNI_WGMMA_D64N64(d)
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// d += A B over a 64 x 16 f16 A held in registers (a[4]: this warp's 16
// rows, mma.sync's A fragment) and a 16 x 64 f16 B in shared memory,
// MN-major (O += P V: B the rows of 16 keys, each 64 columns wide).
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (*d)[4],
                                                      const uint32_t a[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " OMNI_WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : OMNI_WGMMA_D64N64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// As wgmma_m64n64k16_rs_mn over a 16 x 128 B: two 64-column atoms of the
// MN-major operand, `lead` bytes apart in its descriptor.
__device__ __forceinline__ void wgmma_m64n128k16_rs_mn(float (*d)[4],
                                                       const uint32_t a[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
      "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
      "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
      "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
      "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
      "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
      "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
      "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
      "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef OMNI_WGMMA_D32_LIST
#undef OMNI_WGMMA_D64N64

}  // namespace omni
