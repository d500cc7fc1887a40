// Warp-level tensor-core building blocks for Hopper (sm_90a): asynchronous
// global -> shared copies (cp.async), shared -> register fragment loads
// (ldmatrix) and the m16n8k16 matrix products with f32 accumulation
// (mma.sync), bf16, f16 and int8, the f32 -> bf16 or scaled f16 hi + lo
// splits, and the tf32 m16n8k8 product with its 3xTF32 split. Used by the
// flash-attention kernels (K2, attention.cu; K6 and K7, attention_bwd.cu;
// bf16 and f16) through flash.cuh, by the f16 K2 (attention_f16.cu, its
// P split), by the f32 K6 and K7 (attention_f32.cu), by the conv
// module (K3, conv_module.cu) and by the W8A16 and W8A8 matmuls (K4, K5,
// quant.cu).
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 g + t):
//   A 16x16 bf16, 4 x b32: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same),
//                          a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same)
//   B 16x8  bf16, 2 x b32: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9)
//   C 16x8  f32,  4 x f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so the C fragments of two adjacent 8-column tiles, packed to bf16 pairs,
// are the A fragment of the 16 columns they cover (a product's output
// feeds the next product without leaving registers).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace omni {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred (src must
// still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// A [ROWS, ROW_BYTES] tile of a row-major global matrix (src at the
// tile's first row, row stride src_ld bytes) into shared memory (row stride
// dst_ld bytes), 16 bytes a cp.async, spread over THREADS threads. Rows at
// or past `valid` (>= 1) are zero-filled and read nothing (their source is
// clamped to row valid - 1, which exists). Every address must be 16-byte
// aligned.
template <int ROWS, int ROW_BYTES, int THREADS>
__device__ __forceinline__ void load_rows_async(void* dst, int dst_ld,
                                                const void* src,
                                                size_t src_ld, int tid,
                                                int valid = ROWS) {
  constexpr int CHUNKS = ROW_BYTES / 16;
  static_assert(ROW_BYTES % 16 == 0, "rows are copied 16 bytes at a time");
#pragma unroll
  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 16;
    cp_async_16(static_cast<char*>(dst) + r * dst_ld + c,
                static_cast<const char*>(src) + min(r, valid - 1) * src_ld +
                    c,
                r < valid);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, which lands in r[i] (row lane / 4, columns 2 (lane % 4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// As ldmatrix_x4, each matrix transposed: r[i] holds (rows 2 (lane % 4),
// +1; column lane / 4) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Where lane must point for ldmatrix_x4 to load, from a row-major tile of
// 16-bit elements E (bf16 or f16) with row stride ld (elements):
//   a_frag_at: the A fragment of rows r0 .. r0 + 16, columns c0 .. c0 + 16;
//   b_frag_at: as non-transposed B (k = column), the B fragments of the
//     8-row n-tiles r0 and r0 + 8 over columns c0 .. c0 + 16, in r[0..1]
//     and r[2..3] (the tile holds B^T, e.g. keys x dims for S = Q K^T);
//   b_frag_trans_at: with ldmatrix_x4_trans (k = row), the B fragments of
//     the 8-column n-tiles c0 and c0 + 8 over rows r0 .. r0 + 16, in
//     r[0..1] and r[2..3] (the tile holds B, e.g. keys x dims for P V).
template <typename E>
__device__ __forceinline__ const E* a_frag_at(
    const E* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

template <typename E>
__device__ __forceinline__ const E* b_frag_at(
    const E* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

template <typename E>
__device__ __forceinline__ const E* b_frag_trans_at(
    const E* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
         (lane >> 4) * 8;
}

// c += a b for a 16x16 bf16 A, a 16x8 bf16 B, f32 C (exact products,
// f32 sums).
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for a 16x16 f16 A, a 16x8 f16 B, f32 C (exact products, f32
// sums); the fragments are laid out as bf16's.
__device__ __forceinline__ void mma_f16_16816(float c[4], const uint32_t a[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The m16n8k16 product of the element type E's operands.
template <typename E>
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  mma_bf16_16816(c, a, b0, b1);
}
template <>
__device__ __forceinline__ void mma_16816<__half>(
    float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  mma_f16_16816(c, a, b0, b1);
}

// c += a b for a 16x32 int8 A, a 32x8 int8 B, int32 C (exact). The
// fragments are those of the bf16 m16n8k16 product over the same bytes
// read as b16 pairs, so a_frag_at / b_frag_at with ldmatrix_x4 load them
// from a byte tile viewed as b16 (columns and row stride halved).
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to a bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo to ~16 significant bits: hi = bf16(x), lo = bf16(x - hi),
// both as packed pairs.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<uint32_t*>(&h);
  *lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The C fragments c[0], c[1] of two adjacent 8-column tiles as the A
// fragment of the 16 columns they cover, split as hi + lo.
__device__ __forceinline__ void split_a_frag(float (*c)[4], uint32_t hi[4],
                                             uint32_t lo[4]) {
  split_bf16(c[0][0], c[0][1], &hi[0], &lo[0]);
  split_bf16(c[0][2], c[0][3], &hi[1], &lo[1]);
  split_bf16(c[1][0], c[1][1], &hi[2], &lo[2]);
  split_bf16(c[1][2], c[1][3], &hi[3], &lo[3]);
}

// Two f32 values rounded to an f16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x s = hi + lo to ~22 significant bits in f16, both as packed pairs:
// hi = f16(x s), lo = f16(x s - hi), where x s - hi is exact in f32. s is
// a power of two chosen by the caller so that |x s| < 2^15 (hi cannot
// overflow f16's 65504) and the values that matter stay clear of f16's
// subnormals (lo's rounding is then ~2^-22 of |x s|, and at worst 2^-25
// absolute).
__device__ __forceinline__ void split_f16(float x0, float x1, float s,
                                          uint32_t* hi, uint32_t* lo) {
  const float y0 = x0 * s, y1 = x1 * s;
  __half2 h = __floats2half2_rn(y0, y1);
  const float2 hf = __half22float2(h);
  *hi = *reinterpret_cast<uint32_t*>(&h);
  *lo = pack_f16(y0 - hf.x, y1 - hf.y);
}

// As split_a_frag, in f16 and times s[0] on row g (c[.][0], c[.][1]) and
// s[1] on row g + 8 (c[.][2], c[.][3]).
__device__ __forceinline__ void split_a_frag_f16(float (*c)[4],
                                                 const float s[2],
                                                 uint32_t hi[4],
                                                 uint32_t lo[4]) {
  split_f16(c[0][0], c[0][1], s[0], &hi[0], &lo[0]);
  split_f16(c[0][2], c[0][3], s[1], &hi[1], &lo[1]);
  split_f16(c[1][0], c[1][1], s[0], &hi[2], &lo[2]);
  split_f16(c[1][2], c[1][3], s[1], &hi[3], &lo[3]);
}

// f32 -> tf32, rounded to nearest with ties away from zero, as an f32 bit
// pattern with its 13 low mantissa bits cleared: cvt.rna.tf32.f32's
// rounding, by two integer operations (cvt.rna compiles to four: it also
// guards Inf and NaN, which no operand here holds).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~22 significant bits (3xTF32): hi = tf32(x) and
// lo = tf32(x - hi), where x - hi is exact in f32. a b is then taken as
// a_hi b_lo + a_lo b_hi + a_hi b_hi: every tf32 product is exact in f32,
// and the dropped a_lo b_lo and the roundings of lo are ~2^-22 of |a b|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// c += a b for a 16x8 tf32 A, an 8x8 tf32 B, f32 C. Fragments of
// mma.sync.m16n8k8.row.col with tf32 operands (lane = 4 g + t):
//   A 4 x b32: a0 (row g, col t), a1 (row g+8, col t), a2 (row g,
//              col t+4), a3 (row g+8, col t+4)
//   B 2 x b32: b0 (row t, col g), b1 (row t+4, col g)
//   C 4 x f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same)
// Unlike bf16's, C's columns are not A's, so a C fragment feeds a next
// product as A only with its contraction index permuted (attention_f32.cu).
// The f32 sum of the 8 products and c is not rounded to nearest: the
// tensor cores truncate, so a long chain of products into one c drifts
// by an ulp of c a product (attention_f32.cu sums each short chain into
// a zeroed c and adds that to its accumulator in f32).
__device__ __forceinline__ void mma_tf32_1688(float c[4], const uint32_t a[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (c = 0) for the same fragments.
__device__ __forceinline__ void mma_tf32_1688_zero(float d[4],
                                                   const uint32_t a[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

}  // namespace omni
