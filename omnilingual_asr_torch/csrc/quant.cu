// K4 and K5: the int8-weight matmuls of quantized serving.
//
// K4 replaces omnilingual_asr_tpu/ops/quant.py::_q_matmul_kernel (launched
// by quantized_matmul), the W8A16 product
//
//     out[m, n] = (sum_k bf16(x[m, k]) * w_q[k, n]) * scale[n]  (+ bias[n])
//
// with bf16 inputs and f32 accumulation. K5 replaces
// omnilingual_asr_tpu/ops/quant.py::_q8a8_matmul_kernel (launched by
// quantized_matmul_a8), the W8A8 product with each row of x quantized on
// the fly:
//
//     sx[m]    = max(max_k |x[m, k]|, 1e-8) * (1/127)      (f32 multiply)
//     xq[m, k] = clip(rint(x[m, k] / sx[m]), -127, 127)    (IEEE division,
//                                                           half to even)
//     out[m, n] = f32(sum_k xq[m, k] * w_q[k, n]) * sx[m] * scale[n]
//                 (+ bias[n])                              (int32 sums)
//
// Both take x [M, K] f32 row-major, the weight as w_t = w_q^T [N, K] int8
// (K contiguous, the "col" operand of mma), scale [N] f32 and an optional
// bias [N] f32, and write out [M, N] f32. The reference adds the bias
// outside its kernels; here it is folded into the epilogue, in the same
// order ((...) * scale, then + bias), with every multiply and add rounded on
// its own (__fmul_rn / __fadd_rn: no fused multiply-add), so that K5's
// result equals its plain version bit for bit.
//
// What bounds them on an H100: at the main path's shapes (M = 3072 = 4
// windows x 768 frames, K = 256, N = 1024) each reads 3.1 MB of x and
// 0.26 MB of weights and writes 12.6 MB of f32 output, ~16.0 MB or ~4.8 us
// at 3.35 TB/s, against 1.61 GOP: 1.6 us at the bf16 peak of 989 TFLOP/s
// (K4), 0.8 us at the int8 peak of 1979 TOP/s (K5). Both are bound by
// bytes, and the f32 output dominates them.
//
// Design: the Pallas kernels held K whole in VMEM with 256 x 512 blocks.
// Here one block of 8 warps owns a 64 x 128 output tile and walks K in
// chunks of 128 through shared memory; each warp computes 32 x 32 with
// warp-level tensor-core products from inline PTX (K4:
// mma.m16n8k16 bf16 -> f32; K5: mma.m16n8k32 s8 -> s32). K4 rounds x to
// bf16 as it stores the chunk and widens the int8 weights to bf16 (exact
// for |v| <= 127) as it builds the B fragments. K5 first reduces the
// absmax of its 64 rows over the whole K, then quantizes each x chunk to
// int8 in shared memory. The M edge is masked (rows past M load as zero
// and are not stored); K and N must be multiples of 128.
//
// What limits this simple design: no asynchronous copies or double
// buffering (each chunk's global loads stall the tensor cores), x is read
// again by every one of the N / 128 column tiles (from L2), K5 reads its
// x rows twice (absmax, then quantization) and re-quantizes them (one IEEE
// division per element) in every column tile, and mma.sync reaches a
// fraction of wgmma's rate. On an H100 SXM (700 W) at N = 1024 this runs
// K4 in ~17 us and K5 in ~27 us, 3.6x and 5.7x the byte bound
// (chip_smoke.py). Quantizing a row stripe once per block, wgmma and TMA
// are left to a later change.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 64;            // output rows per block
constexpr int BN = 128;           // output columns per block
constexpr int BK = 128;           // depth of one shared-memory chunk
constexpr int THREADS = 256;      // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int LD8 = BK + 16;      // int8 tile row stride in bytes (144)
constexpr int LD16 = BK + 8;      // bf16 tile row stride in elements (272 B)
constexpr int X_ITERS = BM * (BK / 4) / THREADS;   // x float4s a thread
constexpr int W_ITERS = BN * (BK / 16) / THREADS;  // w_t int4s a thread
static_assert(BM * (BK / 4) % THREADS == 0 && BN * (BK / 16) % THREADS == 0,
              "chunk loads must divide evenly among the threads");

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// D = A (16 x 16, row) * B (16 x 8, col) + D, bf16 in, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A (16 x 32, row) * B (32 x 8, col) + D, int8 in, int32 accumulation.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive int8 weights (k, k + 1 of one column) as a bf16 pair,
// the lower k in the low half.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(const int8_t* p) {
  return bits(__floats2bfloat162_rn(static_cast<float>(p[0]),
                                    static_cast<float>(p[1])));
}

// One int8 activation: clip(rint(v / s), -127, 127).
__device__ __forceinline__ signed char quantize_s8(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(q));
}

// Four consecutive values of row m of x from column k; zeros past the M
// edge.
__device__ __forceinline__ float4 load_x4(const float* __restrict__ x, int m,
                                          int M, int K, int k) {
  if (m >= M) return make_float4(0.f, 0.f, 0.f, 0.f);
  return *reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + k);
}

// The [BN, BK] int8 chunk of w_t (rows n0.., columns k0..) into shared
// memory, 16 bytes a thread per step.
__device__ __forceinline__ void load_w_chunk(int8_t (*Bs)[LD8],
                                             const int8_t* __restrict__ wt,
                                             int n0, int k0, int K) {
  constexpr int VEC = BK / 16;
#pragma unroll
  for (int it = 0; it < W_ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int n = i / VEC, c = (i % VEC) * 16;
    *reinterpret_cast<int4*>(&Bs[n][c]) = *reinterpret_cast<const int4*>(
        wt + static_cast<size_t>(n0 + n) * K + k0 + c);
  }
}

// Store two neighbouring outputs of one row: (v * scale) + bias, each
// operation rounded on its own.
__device__ __forceinline__ void store2(float* __restrict__ out, int r, int c,
                                       int N, float v0, float v1,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias) {
  float2 y = make_float2(__fmul_rn(v0, scale[c]), __fmul_rn(v1, scale[c + 1]));
  if (bias != nullptr) {
    y.x = __fadd_rn(y.x, bias[c]);
    y.y = __fadd_rn(y.y, bias[c + 1]);
  }
  *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N + c) = y;
}

__global__ void __launch_bounds__(THREADS)
q_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ wt,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LD16];
  __shared__ __align__(16) int8_t Bs[BN][LD8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    constexpr int AV = BK / 4;
#pragma unroll
    for (int it = 0; it < X_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / AV, c = (i % AV) * 4;
      const float4 v = load_x4(x, m0 + r, M, K, k0 + c);
      uint2 packed;
      packed.x = bits(__floats2bfloat162_rn(v.x, v.y));
      packed.y = bits(__floats2bfloat162_rn(v.z, v.w));
      *reinterpret_cast<uint2*>(&As[r][c]) = packed;
    }
    load_w_chunk(Bs, wt, n0, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = ld32(&As[r][kk + tig * 2]);
        a[mi][1] = ld32(&As[r + 8][kk + tig * 2]);
        a[mi][2] = ld32(&As[r][kk + 8 + tig * 2]);
        a[mi][3] = ld32(&As[r + 8][kk + 8 + tig * 2]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* col = &Bs[wn + ni * 8 + g][kk + tig * 2];
        const uint32_t b0 = s8x2_to_bf16x2(col);
        const uint32_t b1 = s8x2_to_bf16x2(col + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + h * 8;
        if (r < M)
          store2(out, r, c, N, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1],
                 scale, bias);
      }
    }
}

__global__ void __launch_bounds__(THREADS)
q8a8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ wt,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM][LD8];
  __shared__ __align__(16) int8_t Bs[BN][LD8];
  __shared__ float sx[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // Phase 1: each row's scale from its absmax over the whole K. In each
  // chunk a warp covers one row's 128 columns a step (rows warp + 8 * it),
  // and every load of the chunk is issued before any is reduced.
  constexpr int AV = BK / 4;
  float amax[X_ITERS];
#pragma unroll
  for (int it = 0; it < X_ITERS; ++it) amax[it] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    float4 v[X_ITERS];
#pragma unroll
    for (int it = 0; it < X_ITERS; ++it) {
      const int i = tid + it * THREADS;
      v[it] = load_x4(x, m0 + i / AV, M, K, k0 + (i % AV) * 4);
    }
#pragma unroll
    for (int it = 0; it < X_ITERS; ++it)
      amax[it] = fmaxf(fmaxf(amax[it], fmaxf(fabsf(v[it].x), fabsf(v[it].y))),
                       fmaxf(fabsf(v[it].z), fabsf(v[it].w)));
  }
#pragma unroll
  for (int it = 0; it < X_ITERS; ++it) {
    const float a = warp_max(amax[it]);
    if (lane == 0)
      sx[(tid + it * THREADS) / AV] =
          __fmul_rn(fmaxf(a, 1e-8f), 1.0f / 127.0f);
  }
  __syncthreads();

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  // Phase 2: quantize each x chunk into shared memory, int8 products.
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < X_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / AV, c = (i % AV) * 4;
      const float4 v = load_x4(x, m0 + r, M, K, k0 + c);
      const float s = sx[r];
      char4 q;
      q.x = quantize_s8(v.x, s);
      q.y = quantize_s8(v.y, s);
      q.z = quantize_s8(v.z, s);
      q.w = quantize_s8(v.w, s);
      *reinterpret_cast<char4*>(&As[r][c]) = q;
    }
    load_w_chunk(Bs, wt, n0, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = ld32(&As[r][kk + tig * 4]);
        a[mi][1] = ld32(&As[r + 8][kk + tig * 4]);
        a[mi][2] = ld32(&As[r][kk + 16 + tig * 4]);
        a[mi][3] = ld32(&As[r + 8][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* col = &Bs[wn + ni * 8 + g][kk + tig * 4];
        const uint32_t b0 = ld32(col);
        const uint32_t b1 = ld32(col + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm + mi * 16 + g + h * 8;
        const int r = m0 + rl;
        if (r < M) {
          const float s = sx[rl];
          store2(out, r, c, N,
                 __fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), s),
                 __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), s),
                 scale, bias);
        }
      }
    }
}

bool shapes_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % BN == 0 && K % BK == 0 &&
         N / BN <= 65535;
}

}  // namespace

OMNI_API int omni_q_matmul(const float* x, const void* wt, const float* scale,
                           const float* bias, float* out, int M, int N, int K,
                           void* stream) {
  if (!shapes_ok(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, N / BN);
  q_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const int8_t*>(wt), scale, bias, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

OMNI_API int omni_q8a8_matmul(const float* x, const void* wt,
                              const float* scale, const float* bias,
                              float* out, int M, int N, int K, void* stream) {
  if (!shapes_ok(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, N / BN);
  q8a8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const int8_t*>(wt), scale, bias, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
