// K2: flash-attention forward with a key mask and the row logsumexp.
//
// Replaces omnilingual_asr_tpu/ops/attention.py::_flash_fwd_lse_kernel
// (launched by _fwd_lse). Non-causal attention over q, k, v [B, T, H, D]
// bf16, D in {64, 128}, with an int32 key-validity mask [B, T]:
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
// main path. Four threads share one query row, each holding D/4 of its D
// dimensions of q (pre-scaled) and of the output accumulator (dims
// part*4 + 16*i + j); dot products are finished with two warp shuffles. K
// and V stream through shared memory in f32 tiles of 4096 / D keys (64 at
// D = 64, 32 at D = 128, so the two tiles stay at 32 KB of static shared
// memory and the per-thread score array at 4096 / D registers); each tile
// updates the running max m, denominator l and accumulator once (online
// softmax in f32). The [T, T] score matrix never exists. q/k/v are read in
// place from the [B, T, H, D] layout the projections produce, so no
// transpose runs before or after. The template is instantiated for
// D = 64 and D = 128.
#include "flash.cuh"

namespace {

using omni::BQ;
using omni::NEG_INF;
using omni::THREADS;
using omni::TPQ;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, float scale) {
  constexpr int BKV = omni::tile_keys(D);  // keys per shared-memory tile
  constexpr int NG = D / 16;              // 16-dim groups; 4 dims each
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];
  __shared__ int Ms[BKV];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * BQ + tid / TPQ;
  const int part = tid % TPQ;       // dims part*4 + 16*i + j, i < NG
  const size_t ts = static_cast<size_t>(H) * D;   // stride between frames
  const size_t base = static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;

  float qr[4 * NG];
  if (qi < T) {
    omni::load_row<D>(q + base + qi * ts + part * 4, qr, scale);
  } else {
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i) qr[i] = 0.f;
  }

  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  for (int j0 = 0; j0 < T; j0 += BKV) {
    omni::load_tiles<D, BKV>(k, v, Ks, Vs, base, ts, j0, T, tid);
    if (tid < BKV) {
      const int t = j0 + tid;
      Ms[tid] = (t < T) ? mask[static_cast<size_t>(b) * T + t] : 0;
    }
    __syncthreads();

    float s[BKV];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float dot = omni::row_dot<D>(qr, Ks[j], part);
      s[j] = Ms[j] > 0 ? dot : NEG_INF;
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
    for (int i = 0; i < 4 * NG; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) omni::row_axpy<D>(acc, s[j], Vs[j], part);
    m = m_new;
    __syncthreads();
  }

  if (qi < T) {
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = o + base + qi * ts + part * 4;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
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
          l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : omni::FULLY_MASKED_LSE;
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* mask, void* o, float* lse, int B, int T,
                       int H, float scale, cudaStream_t stream) {
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(o), lse, T, H, scale);
  return cudaGetLastError();
}

}  // namespace

OMNI_API int omni_flash_fwd(const void* q, const void* k, const void* v,
                            const int* mask, void* o, float* lse, int B,
                            int T, int H, int head_dim, float scale,
                            void* stream) {
  if (B <= 0 || T <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_fwd<64>(q, k, v, mask, o, lse, B, T, H,
                                             scale, s));
    case 128:
      return static_cast<int>(launch_fwd<128>(q, k, v, mask, o, lse, B, T,
                                              H, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
