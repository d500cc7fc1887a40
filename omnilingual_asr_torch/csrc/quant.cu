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
// K4's design: the Pallas kernels held K whole in VMEM with 256 x 512
// blocks. Here one block of 8 warps owns a 64 x 128 output tile and walks
// K in chunks of 128 through shared memory; each warp computes 32 x 32
// with mma.m16n8k16 bf16 -> f32, rounding x to bf16 as it stores the chunk
// and widening the int8 weights to bf16 (exact for |v| <= 127) as it
// builds the B fragments. No asynchronous copies (each chunk's global
// loads stall the tensor cores) and x is read again by every one of the
// N / 128 column tiles: ~17 us at N = 1024 on an H100 SXM (700 W), 3.6x
// the byte bound (chip_smoke.py). Left to a later change.
//
// K5's design: each row of x quantized once, then an int8 GEMM, in two
// launches (the wrapper counts one K5 launch a call).
// 1. quantize_rows_kernel: one warp a row (3072 rows, 384 blocks at the
//    main path's M), the absmax over the whole row and the int8 values
//    (one IEEE division each) from the same registers (a row of
//    K <= 512 is read once), into xq [M, K] int8 and sx [M] f32 in the
//    wrapper's scratch (0.8 MB at the main path's shapes, in L2).
// 2. q8a8_matmul_kernel: one block of 8 warps a 64 x 128 output tile
//    (384 blocks at N 1024, one wave at 3 blocks an SM); the int8 rows of
//    xq and of w_t stream in 128-byte chunks through an A8_STAGES-deep
//    cp.async ring, each warp computing 32 x 32 with mma.m16n8k32 s8 ->
//    s32 from ldmatrix fragments; the f32 epilogue is staged through
//    shared memory and written as 16-byte stores, whole 512-byte row
//    segments per warp (the f32 output is 12.6 of the 16 MB that bound
//    K5). It is launched as a programmatic dependent of the pre-pass, so
//    it starts, and loads its first weight chunks, while the pre-pass
//    finishes. Rows past M load as zeros and are not stored.
// On an H100 SXM (700 W) K5 runs in ~12 us at N = 1024 (chip_smoke.py),
// 2.4x the byte bound (its 16 MB move at ~1.4 TB/s). The tiling
// and launch bounds were chosen by ops/conv_quant_sweep.py on the card;
// times in PERF.md.
#include <cstdint>

#include "mma.cuh"

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

// K5's two launches overlap by programmatic dependent launch: the product
// is launched with cudaLaunchAttributeProgrammaticStreamSerialization, may
// start once every pre-pass block has called launch_dependents, loads its
// first weight chunks, and waits in wait_prerequisites (until the pre-pass
// has completed and its writes are visible) before it reads xq.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// K5 tiling (ops/conv_quant_sweep.py times the alternatives).
constexpr int A8_BM = 64;         // output rows a block owns
constexpr int A8_BN = 128;        // output columns a block owns
constexpr int A8_BK = 128;        // depth of one operand chunk (bytes)
constexpr int A8_STAGES = 2;      // chunks in the cp.async ring
constexpr int A8_MIN_BLOCKS = 3;  // __launch_bounds__' blocks an SM
constexpr int A8_WARPS = A8_BM / 32 * (A8_BN / 32);   // 32 x 32 a warp
constexpr int A8_THREADS = A8_WARPS * 32;
constexpr int A8_LDK = A8_BK + 16;         // int8 chunk row (bytes)
constexpr int A8_LDO = A8_BN + 8;          // staged output row (floats)
constexpr int A8_STAGE = (A8_BM + A8_BN) * A8_LDK;   // bytes a ring slot
constexpr int A8_RING = A8_STAGES * A8_STAGE;
constexpr int A8_SMEM = A8_RING > A8_BM * A8_LDO * 4 ? A8_RING
                                                     : A8_BM * A8_LDO * 4;
static_assert(A8_BM % 32 == 0 && A8_BN % 32 == 0 && A8_STAGE % 16 == 0,
              "K5 tiling");
// The quantizing pre-pass: one warp a row, Q_ROWS rows a block; a lane
// keeps Q_XREG 128-column segments of its row in registers.
constexpr int Q_ROWS = 8;
constexpr int Q_XREG = 4;

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ void store_q4(int8_t* q, float4 v, float s) {
  char4 c;
  c.x = quantize_s8(v.x, s);
  c.y = quantize_s8(v.y, s);
  c.z = quantize_s8(v.z, s);
  c.w = quantize_s8(v.w, s);
  *reinterpret_cast<char4*>(q) = c;
}

// K5's first launch: each row of x quantized once, xq [M, K] int8 and
// sx [M] f32. A row's first Q_XREG segments are read once, kept in
// registers for both its absmax and its quantization; a longer row's rest
// is read again (from L1) to quantize it.
__global__ void __launch_bounds__(Q_ROWS * 32)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int K) {
  launch_dependents();     // the product may start its weight loads
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * Q_ROWS + (threadIdx.x >> 5);
  if (m >= M) return;
  const float* xr = x + static_cast<size_t>(m) * K;
  int8_t* q = xq + static_cast<size_t>(m) * K;
  float4 v[Q_XREG];
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < Q_XREG; ++i) {
    const int k = i * 128 + lane * 4;
    v[i] = k < K ? *reinterpret_cast<const float4*>(xr + k)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    a = fmaxf(a, absmax4(v[i]));
  }
  for (int k = Q_XREG * 128 + lane * 4; k < K; k += 128)
    a = fmaxf(a, absmax4(*reinterpret_cast<const float4*>(xr + k)));
  const float s = __fmul_rn(fmaxf(warp_max(a), 1e-8f), 1.0f / 127.0f);
  if (lane == 0) sx[m] = s;
#pragma unroll
  for (int i = 0; i < Q_XREG; ++i) {
    const int k = i * 128 + lane * 4;
    if (k < K) store_q4(q + k, v[i], s);
  }
  for (int k = Q_XREG * 128 + lane * 4; k < K; k += 128)
    store_q4(q + k, *reinterpret_cast<const float4*>(xr + k), s);
}

// K5's second launch: out = ((f32(xq @ w_q) * sx) * scale) + bias for one
// A8_BM x A8_BN tile a block. The int8 rows of xq and of w_t stream in
// A8_BK-byte chunks through an A8_STAGES-deep cp.async ring, the loads of
// the next chunks in flight under each chunk's mma.m16n8k32 products; the
// f32 epilogue is staged through shared memory (over the ring) and written
// as 16-byte stores, whole 512-byte row segments a warp.
__global__ void __launch_bounds__(A8_THREADS, A8_MIN_BLOCKS)
q8a8_matmul_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ sx,
                   const int8_t* __restrict__ wt,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char a8_smem[];
  auto* staged = reinterpret_cast<float*>(a8_smem);  // [BM][LDO], after
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / (A8_BN / 32) * 32, wn = warp % (A8_BN / 32) * 32;
  const int m0 = blockIdx.x * A8_BM, n0 = blockIdx.y * A8_BN;
  const int kc = K / A8_BK;

  // Chunk s into ring slot s % A8_STAGES: xq rows m0 .. (zero past M),
  // then w_t rows n0 ..; one commit group a chunk (empty past the last).
  auto slot = [&](int s) {
    return reinterpret_cast<int8_t*>(a8_smem) + (s % A8_STAGES) * A8_STAGE;
  };
  auto issue_a = [&](int s) {
    omni::load_rows_async<A8_BM, A8_BK, A8_THREADS>(
        slot(s), A8_LDK, xq + static_cast<size_t>(m0) * K + s * A8_BK, K,
        tid, M - m0);
  };
  auto issue_b = [&](int s) {
    omni::load_rows_async<A8_BN, A8_BK, A8_THREADS>(
        slot(s) + A8_BM * A8_LDK, A8_LDK,
        wt + static_cast<size_t>(n0) * K + s * A8_BK, K, tid);
  };
  auto issue = [&](int s) {
    if (s < kc) {
      issue_a(s);
      issue_b(s);
    }
    omni::cp_async_commit();
  };
  // The first chunks' weights load while the pre-pass finishes; xq only
  // after it (the first commit group holds them all).
#pragma unroll
  for (int s = 0; s < A8_STAGES - 1; ++s)
    if (s < kc) issue_b(s);
  wait_prerequisites();
#pragma unroll
  for (int s = 0; s < A8_STAGES - 1; ++s) {
    if (s < kc) issue_a(s);
    omni::cp_async_commit();
  }

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  for (int s = 0; s < kc; ++s) {
    omni::cp_async_wait<A8_STAGES - 2>();
    __syncthreads();              // chunk s landed; slot (s - 1) is free
    issue(s + A8_STAGES - 1);
    // Byte tiles read as b16: columns and row strides halve.
    const auto* at = reinterpret_cast<const __nv_bfloat16*>(
        a8_smem + (s % A8_STAGES) * A8_STAGE);
    const auto* bt = at + A8_BM * A8_LDK / 2;
#pragma unroll
    for (int kk = 0; kk < A8_BK / 2; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        omni::ldmatrix_x4(a[mi], omni::a_frag_at(at, A8_LDK / 2,
                                                 wm + mi * 16, kk, lane));
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t b[4];
        omni::ldmatrix_x4(b, omni::b_frag_at(bt, A8_LDK / 2, wn + nb * 16,
                                             kk, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          omni::mma_s8_16832(acc[mi][2 * nb], a[mi], b[0], b[1]);
          omni::mma_s8_16832(acc[mi][2 * nb + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  omni::cp_async_wait<0>();
  __syncthreads();                // the staged tile overwrites the ring

  // ((f32(acc) * sx) * scale) + bias, each operation rounded on its own.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm + mi * 16 + g + h * 8;
      const float sr = m0 + rl < M ? sx[m0 + rl] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cl = wn + ni * 8 + tig * 2;
        float2 y = make_float2(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), sr),
                      scale[n0 + cl]),
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), sr),
                      scale[n0 + cl + 1]));
        if (bias != nullptr) {
          y.x = __fadd_rn(y.x, bias[n0 + cl]);
          y.y = __fadd_rn(y.y, bias[n0 + cl + 1]);
        }
        *reinterpret_cast<float2*>(&staged[rl * A8_LDO + cl]) = y;
      }
    }
  __syncthreads();
  constexpr int V = A8_BN / 4;
#pragma unroll 4
  for (int i = tid; i < A8_BM * V; i += A8_THREADS) {
    const int r = i / V, c4 = (i % V) * 4;
    if (m0 + r < M)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + r) * N + n0 +
                                 c4) =
          *reinterpret_cast<const float4*>(&staged[r * A8_LDO + c4]);
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

// scratch: M K + 4 M bytes, xq [M, K] int8 then sx [M] f32, between K5's
// two launches.
OMNI_API int omni_q8a8_matmul(const float* x, const void* wt,
                              const float* scale, const float* bias,
                              float* out, void* scratch, int M, int N, int K,
                              void* stream) {
  if (!shapes_ok(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* xq = static_cast<int8_t*>(scratch);
  auto* sx = reinterpret_cast<float*>(xq + static_cast<size_t>(M) * K);
  quantize_rows_kernel<<<(M + Q_ROWS - 1) / Q_ROWS, Q_ROWS * 32, 0, st>>>(
      x, xq, sx, M, K);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = omni::allow_smem(q8a8_matmul_kernel, A8_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + A8_BM - 1) / A8_BM, N / A8_BN);
  cfg.blockDim = dim3(A8_THREADS);
  cfg.dynamicSmemBytes = A8_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, q8a8_matmul_kernel,
                           static_cast<const int8_t*>(xq),
                           static_cast<const float*>(sx),
                           static_cast<const int8_t*>(wt), scale, bias, out,
                           M, N, K);
  return static_cast<int>(err);
}
