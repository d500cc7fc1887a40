// Shared layout of the flash-attention kernels: the bf16 forward (K2,
// attention.cu) and the backward's dQ (K6) and dK/dV (K7,
// attention_bwd.cu), all on the warp-level tensor-core tiles of mma.cuh,
// the backward for bf16 operands and (the f16 encoder) for f16 ones. The
// f16 forward (attention_f16.cu, on wgmma and TMA) takes only the
// constants below.
//
// q, k, v, o and dO are bf16 or f16 [B, T, H, D] (D in {64, 128}), read in
// place; the key mask is int32 [B, T]; lse and delta are f32 [B, H, T]. A
// block of 4 warps owns 64 rows of one (b, h) (queries, or keys for K7),
// 16 a warp, and streams the other side's rows through shared memory in
// 64-row tiles of 16-bit elements, double-buffered with cp.async, each row
// padded by 16 bytes so that ldmatrix reads 8 rows without bank conflicts.
// Rows at or past T are zero-filled and never stored, so T may be any
// length.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace omni {

// The operands' element type of a flash kernel: f16 or bf16.
template <bool F16>
using flash_elem = std::conditional_t<F16, __half, __nv_bfloat16>;

constexpr float NEG_INF = -1e30f;
// A fully-masked query row's logsumexp: exp(s - FULLY_MASKED_LSE) is 0.
constexpr float FULLY_MASKED_LSE = 1e30f;

constexpr int FLASH_ROWS = 64;    // rows a block owns; rows a tile streams
constexpr int FLASH_WARPS = 4;
constexpr int FLASH_THREADS = FLASH_WARPS * 32;

template <int D>
struct FlashTile {
  static constexpr int LD = D + 8;                // 16-bit row, padded 16 B
  static constexpr int ELEMS = FLASH_ROWS * LD;   // 16-bit elements a tile
  // Dynamic shared memory of two double-buffered operand tiles and
  // `words` double-buffered rows of 4-byte values (mask, lse, delta).
  static constexpr size_t bytes(int words) {
    return 4 * ELEMS * sizeof(__nv_bfloat16) + 2 * words * FLASH_ROWS * 4;
  }
};

// Rows t0 .. t0 + 64 (t0 < T) of one head of a [B, T, H, D] operand (src
// at the head's row 0, frame stride ts) into a padded shared tile, by
// cp.async; rows at or past T are zero-filled. Every thread takes part.
template <int D, typename E>
__device__ __forceinline__ void load_tile(E* tile, const E* src, size_t ts,
                                          int t0, int T, int tid) {
  load_rows_async<FLASH_ROWS, D * 2, FLASH_THREADS>(
      tile, FlashTile<D>::LD * 2, src + static_cast<size_t>(t0) * ts, ts * 2,
      tid, T - t0);
}

// Values t0 .. t0 + 64 of a length-T row of 4-byte words (a key mask, lse
// or delta) into shared memory, by cp.async; those at or past T are set to
// `fill` (the caller's __syncthreads publishes both).
template <typename W>
__device__ __forceinline__ void load_words(W* dst, const W* src, int t0,
                                           int T, int tid, W fill) {
  if (tid < FLASH_ROWS) {
    const int t = t0 + tid;
    if (t < T)
      cp_async_4(dst + tid, src + t);
    else
      dst[tid] = fill;
  }
}

// The A fragments of a warp's 16 rows (from r0) of a padded tile, all D
// columns: f[kk] covers columns 16 kk .. 16 kk + 16.
template <int D, typename E>
__device__ __forceinline__ void load_a_frags(uint32_t (*f)[4], const E* tile,
                                             int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(f[kk], a_frag_at(tile, FlashTile<D>::LD, r0, 16 * kk, lane));
}

// acc[n] (n < NT) += A B over D: A the 16 x D fragments a[D / 16] held in
// registers, B^T the tile's rows n0 .. n0 + 8 NT (S = Q K^T: one row a key),
// both of the element type E (exact products of bf16 or f16 values).
template <int D, int NT, typename E>
__device__ __forceinline__ void mma_a_rows(float (*acc)[4],
                                           uint32_t (*a)[4], const E* tile,
                                           int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_frag_at(tile, FlashTile<D>::LD, n0 + 16 * n2,
                               16 * kk, lane));
      mma_16816<E>(acc[2 * n2], a[kk], b[0], b[1]);
      mma_16816<E>(acc[2 * n2 + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[n] (n < D / 8) += (hi + lo) B: hi + lo one 16 x 16 A fragment split
// in two halves of the element type E, B the tile's rows k0 .. k0 + 16, all
// D columns (O = P V: one row a key), as two products of E. The bf16
// kernels' P V, dS K, P^T dO and dS^T Q (mma_split_cols); the f16 K6's and
// K7's, with P and dS scaled into f16's range (attention_bwd.cu).
template <int D, typename E>
__device__ __forceinline__ void mma_pair_cols(float (*acc)[4],
                                              const uint32_t hi[4],
                                              const uint32_t lo[4],
                                              const E* tile, int k0,
                                              int lane) {
#pragma unroll
  for (int d2 = 0; d2 < D / 16; ++d2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, b_frag_trans_at(tile, FlashTile<D>::LD, k0,
                                         16 * d2, lane));
    mma_16816<E>(acc[2 * d2], hi, b[0], b[1]);
    mma_16816<E>(acc[2 * d2], lo, b[0], b[1]);
    mma_16816<E>(acc[2 * d2 + 1], hi, b[2], b[3]);
    mma_16816<E>(acc[2 * d2 + 1], lo, b[2], b[3]);
  }
}

// mma_pair_cols over a bf16 tile, hi + lo in bf16.
template <int D>
__device__ __forceinline__ void mma_split_cols(float (*acc)[4],
                                               const uint32_t hi[4],
                                               const uint32_t lo[4],
                                               const __nv_bfloat16* tile,
                                               int k0, int lane) {
  mma_pair_cols<D>(acc, hi, lo, tile, k0, lane);
}

// Two f32 values rounded to the element type E's packed pair (lo in the
// low half).
template <typename E>
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack_pair<__nv_bfloat16>(float lo,
                                                             float hi) {
  return pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack_pair<__half>(float lo, float hi) {
  return pack_f16(lo, hi);
}

}  // namespace omni
