// K2: flash-attention forward with a key mask and the row logsumexp.
//
// Replaces omnilingual_asr_tpu/ops/attention.py::_flash_fwd_lse_kernel
// (launched by _fwd_lse). Non-causal attention over q, k, v [B, T, H, 64]
// bf16 with an int32 key-validity mask [B, T]:
//
//     s = (q * 1/sqrt(D)) k^T   masked keys -> -1e30, f32 online softmax
//     o = softmax(s) v           bf16 out, [B, T, H, D]
//     lse = m + log(l)           f32, [B, H, T]; +1e30 for a fully-masked row
//
// A fully-masked row (a padded batch slot, n_valid = 0) gets o = 0 and
// lse = +1e30, exactly as the reference; a key tile that is masked whole
// contributes p = 0 even while the running max is still -1e30.
//
// What bounds it on an H100: at the main path's shapes (B*H = 16, T = 768,
// D = 64) the work is 2.4 GFLOP against 6.3 MB of q/k/v/o, so operations;
// this version runs the dot products in f32 on the CUDA cores (the
// reference's dots are f32 over bf16-valued inputs, so f32 FMA reproduces
// them up to summation order). Tensor cores (mma / wgmma on bf16 tiles) are
// the next step and are left to a later change.
//
// Design: one block per (b*h, 64-query tile): 16 x 12 = 192 blocks on the
// main path. Four threads share one query row, each holding 16 of its 64
// dimensions of q (pre-scaled) and of the output accumulator; dot products
// are finished with two warp shuffles. K and V stream through shared memory
// in 64-key tiles converted to f32; each tile updates the running max m,
// denominator l and accumulator once (online softmax in f32). The [T, T]
// score matrix never exists. q/k/v are read in place from the [B, T, H, D]
// layout the projections produce, so no transpose runs before or after.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int BQ = 64;            // queries per block
constexpr int BKV = 64;           // keys per shared-memory tile
constexpr int TPQ = 4;            // threads per query row
constexpr int THREADS = BQ * TPQ;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void bf16x8_to_f32(const uint4 raw, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, float scale) {
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];
  __shared__ int Ms[BKV];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * BQ + tid / TPQ;
  const int part = tid % TPQ;       // dims part*4 + 16*i + j
  const size_t ts = static_cast<size_t>(H) * D;   // stride between frames
  const size_t base = static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;

  float qr[16];
  if (qi < T) {
    const __nv_bfloat16* src = q + base + qi * ts + part * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src + 16 * i);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(p2[0]);
      const float2 f1 = __bfloat1622float2(p2[1]);
      qr[4 * i + 0] = f0.x * scale;
      qr[4 * i + 1] = f0.y * scale;
      qr[4 * i + 2] = f1.x * scale;
      qr[4 * i + 3] = f1.y * scale;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) qr[i] = 0.f;
  }

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  for (int j0 = 0; j0 < T; j0 += BKV) {
#pragma unroll
    for (int r = 0; r < (BKV * D / 8) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int key = idx >> 3;
      const int c = (idx & 7) * 8;
      const int t = j0 + key;
      float kf[8], vf[8];
      if (t < T) {
        const size_t g = base + t * ts + c;
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(k + g), kf);
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(v + g), vf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
      }
      *reinterpret_cast<float4*>(&Ks[key][c]) = make_float4(kf[0], kf[1], kf[2], kf[3]);
      *reinterpret_cast<float4*>(&Ks[key][c + 4]) = make_float4(kf[4], kf[5], kf[6], kf[7]);
      *reinterpret_cast<float4*>(&Vs[key][c]) = make_float4(vf[0], vf[1], vf[2], vf[3]);
      *reinterpret_cast<float4*>(&Vs[key][c + 4]) = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    if (tid < BKV) {
      const int t = j0 + tid;
      Ms[tid] = (t < T) ? mask[static_cast<size_t>(b) * T + t] : 0;
    }
    __syncthreads();

    float s[BKV];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float part_dot = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[j][part * 4 + 16 * i]);
        part_dot = fmaf(qr[4 * i + 0], kv.x, part_dot);
        part_dot = fmaf(qr[4 * i + 1], kv.y, part_dot);
        part_dot = fmaf(qr[4 * i + 2], kv.z, part_dot);
        part_dot = fmaf(qr[4 * i + 3], kv.w, part_dot);
      }
      part_dot += __shfl_xor_sync(0xffffffffu, part_dot, 1);
      part_dot += __shfl_xor_sync(0xffffffffu, part_dot, 2);
      s[j] = Ms[j] > 0 ? part_dot : NEG_INF;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = Ms[j] > 0 ? expf(s[j] - m_new) : 0.f;
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][part * 4 + 16 * i]);
        acc[4 * i + 0] = fmaf(s[j], vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (qi < T) {
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = o + base + qi * ts + part * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * i + 0] / denom,
                                                acc[4 * i + 1] / denom);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * i + 2] / denom,
                                                acc[4 * i + 3] / denom);
      uint2 raw;
      raw.x = *reinterpret_cast<unsigned int*>(&lo);
      raw.y = *reinterpret_cast<unsigned int*>(&hi);
      *reinterpret_cast<uint2*>(dst + 16 * i) = raw;
    }
    if (part == 0)
      lse[static_cast<size_t>(bh) * T + qi] =
          l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : 1e30f;
  }
}

}  // namespace

OMNI_API int omni_flash_fwd(const void* q, const void* k, const void* v,
                            const int* mask, void* o, float* lse, int B,
                            int T, int H, int head_dim, float scale,
                            void* stream) {
  if (head_dim != D || B <= 0 || T <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(o), lse, T, H, scale);
  return static_cast<int>(cudaGetLastError());
}
