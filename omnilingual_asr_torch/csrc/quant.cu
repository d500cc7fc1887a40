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
// K4's design: bf16(x) made once, then a pipelined bf16 tensor-core GEMM,
// in two launches (the wrapper counts one K4 launch a call).
// 1. bf16_rows_kernel: x rounded to bf16 (round to nearest even, as
//    astype(jnp.bfloat16)) once, 8 columns a thread, into xb [M, K] in the
//    wrapper's scratch (1.6 MB at the main path's shapes, in L2). Within
//    each 16-column group the columns are stored in the order the GEMM's
//    fragments want: physical columns 4t .. 4t + 3 go to storage columns
//    2t, 2t + 1, 2t + 8, 2t + 9.
// 2. q_matmul_kernel: one block of 4 warps a 64 x 128 output tile (384
//    blocks at N 1024, one wave at 3 blocks an SM); the bf16 rows of xb and
//    the int8 rows of w_t stream in 64-deep chunks through a K4_STAGES-deep
//    cp.async ring. A warp owns 64 x 32 outputs, so each weight is widened
//    once a chunk: A fragments by ldmatrix from the bf16 tile, B fragments
//    by ldmatrix from the int8 tile (four consecutive k of one column a
//    register), each widened in registers to two bf16 pairs by byte
//    permutes and a magic-number subtraction (exact for |v| <= 127);
//    mma.m16n8k16 bf16 -> f32. The widened pairs hold k (4t, 4t + 1) and
//    (4t + 2, 4t + 3) where the fragment layout has (2t, 2t + 1) and
//    (2t + 8, 2t + 9): the pre-pass's column order gives A the same
//    permutation, so the sums run over the same products. Scale and bias
//    are read into registers before the first chunk; the f32 epilogue is
//    staged through shared memory (over the ring) and written as 16-byte
//    stores, whole 512-byte row segments. It is launched as a programmatic
//    dependent of the pre-pass and loads its first weight chunks while the
//    pre-pass finishes.
// On an H100 SXM (700 W) K4 runs in ~12.6 us at N = 1024 (chip_smoke.py;
// 17.3 us before), 2.6x the byte bound. Its chunk loop holds it (ops/
// k4_phases.py): the operands of 384 blocks streaming from L2 (25 MB in
// all, each x row read by N / 128 column tiles and each weight by M / 64
// row tiles) and the mma.sync and widening issue of 12 warps an SM. A
// persistent grid with cp.async.bulk stores of the staged tile, tried
// against it, was no faster. Tiling and launch bounds were chosen by
// ops/conv_quant_sweep.py on the card; times in PERF.md.
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One int8 activation: clip(rint(v / s), -127, 127).
__device__ __forceinline__ signed char quantize_s8(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(q));
}

// K4's and K5's two launches overlap by programmatic dependent launch: the
// product is launched with cudaLaunchAttributeProgrammaticStreamSerialization,
// may start once every pre-pass block has called launch_dependents, loads
// its first weight chunks, and waits in wait_prerequisites (until the
// pre-pass has completed and its writes are visible) before it reads the
// pre-pass's output.
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

// K4 tiling (ops/conv_quant_sweep.py --k4 times the alternatives).
constexpr int K4_BM = 64;         // output rows a block owns
constexpr int K4_BN = 128;        // output columns a block owns
constexpr int K4_BK = 64;         // depth of one operand chunk (k values)
constexpr int K4_WM = 64;         // rows a warp owns
constexpr int K4_WN = 32;         // columns a warp owns
constexpr int K4_STAGES = 2;      // chunks in the cp.async ring
constexpr int K4_MIN_BLOCKS = 3;  // __launch_bounds__' blocks an SM
constexpr int K4_WARPS = K4_BM / K4_WM * (K4_BN / K4_WN);
constexpr int K4_THREADS = K4_WARPS * 32;
constexpr int K4_MI = K4_WM / 16;          // 16-row fragments a warp
constexpr int K4_NB = K4_WN / 16;          // 16-column fragment pairs
constexpr int K4_LDA = 2 * K4_BK + 16;     // bf16 x chunk row (bytes)
constexpr int K4_LDB = K4_BK + 16;         // int8 w_t chunk row (bytes)
constexpr int K4_LDO = K4_BN + 8;          // staged output row (floats)
constexpr int K4_STAGE = K4_BM * K4_LDA + K4_BN * K4_LDB;  // a ring slot
constexpr int K4_RING = K4_STAGES * K4_STAGE;
constexpr int K4_SMEM = K4_RING > K4_BM * K4_LDO * 4 ? K4_RING
                                                     : K4_BM * K4_LDO * 4;
static_assert(K4_BM % K4_WM == 0 && K4_WM % 16 == 0 &&
                  K4_BN % K4_WN == 0 && K4_WN % 16 == 0 &&
                  K4_BK % 32 == 0 && 128 % K4_BN == 0 &&
                  128 % K4_BK == 0 && K4_STAGES >= 2 &&
                  K4_STAGE % 16 == 0,
              "K4 tiling (the wrapper takes K and N multiples of 128)");
// The pre-pass: one thread an 8-column group.
constexpr int R_THREADS = 256;

// Four int8 weights (consecutive k of one column, the lowest in the low
// byte) as two bf16 pairs, lo = (k0, k1), hi = (k2, k3). Each byte, offset
// by 128, becomes the low mantissa byte of 2^23; subtracting 2^23 + 128
// leaves the weight exactly, and an integer of magnitude <= 128 is a bf16
// (its f32 has no bits in the low half).
__device__ __forceinline__ void widen_s8x4(uint32_t v, uint32_t& lo,
                                           uint32_t& hi) {
  constexpr uint32_t TWO23 = 0x4B000000u;
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, TWO23, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, TWO23, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, TWO23, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, TWO23, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// K4's first launch: xb = bf16(x), 8 columns a thread, each 16-column
// group's columns in the GEMM's order: physical 4t + j (j < 2) to storage
// 2t + j, 4t + 2 + j to 2t + 8 + j (t < 4). Thread i converts half i & 1
// of group i >> 1: physical 0-7 (t 0, 1) or 8-15 (t 2, 3).
__global__ void __launch_bounds__(R_THREADS)
bf16_rows_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                 long long groups) {
  launch_dependents();     // the product may start its weight loads
  const long long i =
      static_cast<long long>(blockIdx.x) * R_THREADS + threadIdx.x;
  if (i >= groups) return;
  const float4* src = reinterpret_cast<const float4*>(x) + i * 2;
  const float4 v0 = src[0], v1 = src[1];
  // As bf16 pairs, the group's word t holds physical (4t, 4t + 1) and
  // word 4 + t holds (4t + 2, 4t + 3).
  auto* dst = reinterpret_cast<uint2*>(xb) + (i >> 1) * 4 + (i & 1);
  dst[0] = make_uint2(omni::pack_bf16(v0.x, v0.y), omni::pack_bf16(v1.x, v1.y));
  dst[2] = make_uint2(omni::pack_bf16(v0.z, v0.w), omni::pack_bf16(v1.z, v1.w));
}

// K4's second launch: out = (xb @ w_q) * scale (+ bias) for one K4_BM x
// K4_BN tile a block. The bf16 rows of xb and the int8 rows of w_t stream
// in K4_BK-deep chunks through a K4_STAGES-deep cp.async ring; the f32
// epilogue is staged through shared memory (over the ring) and written as
// 16-byte stores, whole 512-byte row segments.
__global__ void __launch_bounds__(K4_THREADS, K4_MIN_BLOCKS)
q_matmul_kernel(const __nv_bfloat16* __restrict__ xb,
                const int8_t* __restrict__ wt,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  auto* staged = reinterpret_cast<float*>(k4_smem);  // [BM][LDO], after
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / (K4_BN / K4_WN) * K4_WM;
  const int wn = warp % (K4_BN / K4_WN) * K4_WN;
  const int m0 = blockIdx.x * K4_BM, n0 = blockIdx.y * K4_BN;
  const int kc = K / K4_BK;

  // Chunk s into ring slot s % K4_STAGES: xb rows m0 .. (zero past M),
  // then w_t rows n0 ..; one commit group a chunk (empty past the last).
  auto slot = [&](int s) { return k4_smem + s % K4_STAGES * K4_STAGE; };
  auto issue_a = [&](int s) {
    omni::load_rows_async<K4_BM, 2 * K4_BK, K4_THREADS>(
        slot(s), K4_LDA, xb + static_cast<size_t>(m0) * K + s * K4_BK,
        2 * static_cast<size_t>(K), tid, M - m0);
  };
  auto issue_b = [&](int s) {
    omni::load_rows_async<K4_BN, K4_BK, K4_THREADS>(
        slot(s) + K4_BM * K4_LDA, K4_LDB,
        wt + static_cast<size_t>(n0) * K + s * K4_BK, K, tid);
  };
  // The scale and bias at this thread's output columns, and the first
  // chunks' weights, load while the pre-pass finishes; xb only after it
  // (the first commit group holds them all).
  float2 sc[2 * K4_NB], bi[2 * K4_NB];
#pragma unroll
  for (int ni = 0; ni < 2 * K4_NB; ++ni) {
    const int c = n0 + wn + ni * 8 + tig * 2;
    sc[ni] = *reinterpret_cast<const float2*>(scale + c);
    bi[ni] = bias != nullptr ? *reinterpret_cast<const float2*>(bias + c)
                             : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int s = 0; s < K4_STAGES - 1; ++s)
    if (s < kc) issue_b(s);
  wait_prerequisites();
#pragma unroll
  for (int s = 0; s < K4_STAGES - 1; ++s) {
    if (s < kc) issue_a(s);
    omni::cp_async_commit();
  }

  float acc[K4_MI][2 * K4_NB][4];
#pragma unroll
  for (int mi = 0; mi < K4_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2 * K4_NB; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int s = 0; s < kc; ++s) {
    omni::cp_async_wait<K4_STAGES - 2>();
    __syncthreads();              // chunk s landed; slot (s - 1) is free
    if (s + K4_STAGES - 1 < kc) {
      issue_a(s + K4_STAGES - 1);
      issue_b(s + K4_STAGES - 1);
    }
    omni::cp_async_commit();
    const auto* at = reinterpret_cast<const __nv_bfloat16*>(slot(s));
    // The int8 tile read as b16: columns and row stride halve.
    const auto* bt =
        reinterpret_cast<const __nv_bfloat16*>(slot(s) + K4_BM * K4_LDA);
#pragma unroll
    for (int kw = 0; kw < K4_BK; kw += 32) {
      uint32_t a[K4_MI][2][4];
#pragma unroll
      for (int mi = 0; mi < K4_MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          omni::ldmatrix_x4(a[mi][h],
                            omni::a_frag_at(at, K4_LDA / 2, wm + mi * 16,
                                            kw + 16 * h, lane));
#pragma unroll
      for (int nb = 0; nb < K4_NB; ++nb) {
        // b[0], b[1]: k kw + 4t .. + 3 and kw + 16 + 4t .. + 3 of column
        // wn + 16 nb + g; b[2], b[3]: the same of column + 8.
        uint32_t b[4], w[4][2];
        omni::ldmatrix_x4(b, omni::b_frag_at(bt, K4_LDB / 2, wn + nb * 16,
                                             kw / 2, lane));
#pragma unroll
        for (int j = 0; j < 4; ++j) widen_s8x4(b[j], w[j][0], w[j][1]);
#pragma unroll
        for (int mi = 0; mi < K4_MI; ++mi) {
          omni::mma_bf16_16816(acc[mi][2 * nb], a[mi][0], w[0][0], w[0][1]);
          omni::mma_bf16_16816(acc[mi][2 * nb], a[mi][1], w[1][0], w[1][1]);
          omni::mma_bf16_16816(acc[mi][2 * nb + 1], a[mi][0], w[2][0],
                               w[2][1]);
          omni::mma_bf16_16816(acc[mi][2 * nb + 1], a[mi][1], w[3][0],
                               w[3][1]);
        }
      }
    }
  }
  omni::cp_async_wait<0>();
  __syncthreads();                // the staged tile overwrites the ring

  // (acc * scale) + bias, each operation rounded on its own.
#pragma unroll
  for (int mi = 0; mi < K4_MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm + mi * 16 + g + h * 8;
#pragma unroll
      for (int ni = 0; ni < 2 * K4_NB; ++ni) {
        float2 y = make_float2(__fmul_rn(acc[mi][ni][2 * h], sc[ni].x),
                               __fmul_rn(acc[mi][ni][2 * h + 1], sc[ni].y));
        if (bias != nullptr) {
          y.x = __fadd_rn(y.x, bi[ni].x);
          y.y = __fadd_rn(y.y, bi[ni].y);
        }
        *reinterpret_cast<float2*>(
            &staged[rl * K4_LDO + wn + ni * 8 + tig * 2]) = y;
      }
    }
  __syncthreads();
  constexpr int V = K4_BN / 4;
#pragma unroll 4
  for (int i = tid; i < K4_BM * V; i += K4_THREADS) {
    const int r = i / V, c4 = (i % V) * 4;
    if (m0 + r < M)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + r) * N + n0 +
                                 c4) =
          *reinterpret_cast<const float4*>(&staged[r * K4_LDO + c4]);
  }
}

// The wrappers' limits: K and N multiples of 128, any M >= 1.
bool shapes_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % 128 == 0 && K % 128 == 0 &&
         N / A8_BN <= 65535 && N / K4_BN <= 65535;
}

// Launch `kernel` as a programmatic dependent of the work before it on
// `st`.
template <typename Kernel, typename... Args>
cudaError_t launch_dependent(Kernel kernel, dim3 grid, int threads,
                             int smem, cudaStream_t st, Args... args) {
  cudaError_t err = omni::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// scratch: 2 M K bytes, xb [M, K] bf16, between K4's two launches.
OMNI_API int omni_q_matmul(const float* x, const void* wt, const float* scale,
                           const float* bias, float* out, void* scratch,
                           int M, int N, int K, void* stream) {
  if (!shapes_ok(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* xb = static_cast<__nv_bfloat16*>(scratch);
  const long long groups = static_cast<long long>(M) * K / 8;
  bf16_rows_kernel<<<static_cast<unsigned>((groups + R_THREADS - 1) /
                                           R_THREADS),
                     R_THREADS, 0, st>>>(x, xb, groups);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_dependent(q_matmul_kernel,
                           dim3((M + K4_BM - 1) / K4_BM, N / K4_BN),
                           K4_THREADS, K4_SMEM, st,
                           static_cast<const __nv_bfloat16*>(xb),
                           static_cast<const int8_t*>(wt), scale, bias, out,
                           M, N, K);
  return static_cast<int>(err);
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
  if (err == cudaSuccess)
    err = launch_dependent(q8a8_matmul_kernel,
                           dim3((M + A8_BM - 1) / A8_BM, N / A8_BN),
                           A8_THREADS, A8_SMEM, st,
                           static_cast<const int8_t*>(xq),
                           static_cast<const float*>(sx),
                           static_cast<const int8_t*>(wt), scale, bias, out,
                           M, N, K);
  return static_cast<int>(err);
}
