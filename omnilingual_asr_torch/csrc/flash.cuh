// Shared layout of the flash-attention kernels: the forward (K2,
// attention.cu) and the backward (K6 and K7, attention_bwd.cu).
//
// q, k, v, o and dO are bf16 [B, T, H, D], read in place; lse and delta are
// f32 [B, H, T]. A block owns 64 rows (queries, or keys for K7) of one
// (b, h); four threads share a row and each holds D/4 of its dimensions,
// dims part*4 + 16*i + j for i < D/16 and j < 4, so that a row's dot
// product is finished with two warp shuffles. The streamed operand goes
// through shared memory in f32 tiles of 4096 / D rows, which keeps two such
// tiles at 32 KB of static shared memory for D = 64 and D = 128 alike.
#pragma once

#include "common.cuh"

namespace omni {

constexpr int BQ = 64;            // rows a block owns
constexpr int TPQ = 4;            // threads per row
constexpr int THREADS = BQ * TPQ;
constexpr float NEG_INF = -1e30f;
// A fully-masked query row's logsumexp: exp(s - FULLY_MASKED_LSE) is 0.
constexpr float FULLY_MASKED_LSE = 1e30f;

// Rows of a streamed shared-memory tile at head dim D.
__host__ __device__ constexpr int tile_keys(int D) { return 4096 / D; }

__device__ __forceinline__ void bf16x8_to_f32(const uint4 raw, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// This thread's D/4 dims of one row (src points at row + part*4), times mul.
template <int D>
__device__ __forceinline__ void load_row(const __nv_bfloat16* src, float* dst,
                                         float mul) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src + 16 * i);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(p2[0]);
    const float2 f1 = __bfloat1622float2(p2[1]);
    dst[4 * i + 0] = f0.x * mul;
    dst[4 * i + 1] = f0.y * mul;
    dst[4 * i + 2] = f1.x * mul;
    dst[4 * i + 3] = f1.y * mul;
  }
}

// Round this thread's D/4 dims (times mul) to bf16 and store them at
// dst = row + part*4.
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float* v,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[4 * i + 0] * mul,
                                              v[4 * i + 1] * mul);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[4 * i + 2] * mul,
                                              v[4 * i + 3] * mul);
    uint2 raw;
    raw.x = *reinterpret_cast<unsigned int*>(&lo);
    raw.y = *reinterpret_cast<unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(dst + 16 * i) = raw;
  }
}

// Rows t0 .. t0 + ROWS of two [.., T, H, D] operands (frame stride ts, head
// offset base) into two f32 shared-memory tiles; rows past T are zero.
// Every thread of the block takes part; the caller synchronises.
template <int D, int ROWS>
__device__ __forceinline__ void load_tiles(const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ b,
                                           float (*As)[D], float (*Bs)[D],
                                           size_t base, size_t ts, int t0,
                                           int T, int tid) {
#pragma unroll
  for (int idx = tid; idx < ROWS * D / 8; idx += THREADS) {
    const int row = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    const int t = t0 + row;
    float af[8], bf[8];
    if (t < T) {
      const size_t g = base + static_cast<size_t>(t) * ts + c;
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(a + g), af);
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(b + g), bf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) af[i] = bf[i] = 0.f;
    }
    *reinterpret_cast<float4*>(&As[row][c]) = make_float4(af[0], af[1], af[2], af[3]);
    *reinterpret_cast<float4*>(&As[row][c + 4]) = make_float4(af[4], af[5], af[6], af[7]);
    *reinterpret_cast<float4*>(&Bs[row][c]) = make_float4(bf[0], bf[1], bf[2], bf[3]);
    *reinterpret_cast<float4*>(&Bs[row][c + 4]) = make_float4(bf[4], bf[5], bf[6], bf[7]);
  }
}

// This thread's share of a row's dot product with shared-memory row r,
// finished across the row's four threads.
template <int D>
__device__ __forceinline__ float row_dot(const float* mine, const float* r,
                                         int part) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(r + part * 4 + 16 * i);
    acc = fmaf(mine[4 * i + 0], x.x, acc);
    acc = fmaf(mine[4 * i + 1], x.y, acc);
    acc = fmaf(mine[4 * i + 2], x.z, acc);
    acc = fmaf(mine[4 * i + 3], x.w, acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// mine += w * (shared-memory row r), on this thread's dims.
template <int D>
__device__ __forceinline__ void row_axpy(float* mine, float w, const float* r,
                                         int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(r + part * 4 + 16 * i);
    mine[4 * i + 0] = fmaf(w, x.x, mine[4 * i + 0]);
    mine[4 * i + 1] = fmaf(w, x.y, mine[4 * i + 1]);
    mine[4 * i + 2] = fmaf(w, x.z, mine[4 * i + 2]);
    mine[4 * i + 3] = fmaf(w, x.w, mine[4 * i + 3]);
  }
}

}  // namespace omni
