// K6 and K7: the flash-attention backward, dQ and dK/dV.
//
// Replace omnilingual_asr_tpu/ops/attention.py::_flash_bwd_dq_kernel (K6)
// and ::_flash_bwd_dkv_kernel (K7), both launched by _flash_bh_bwd. Over
// q, k, v, dO bf16 [B, T, H, D] (D in {64, 128}), the key mask int32
// [B, T], and the forward's row logsumexp lse and delta = sum_d dO * O, both
// f32 [B, H, T], with scale = 1/sqrt(D):
//
//     p  = exp(q k^T * scale - lse) * keymask   (recomputed, never stored)
//     ds = p * (dO v^T - delta)
//     dQ = ds k * scale                          K6, bf16 [B, T, H, D]
//     dV = p^T dO,  dK = ds^T q * scale          K7, bf16 [B, T, H, D]
//
// A masked key has p = 0, so its dK and dV are exactly 0; a fully-masked
// query row has lse = +1e30, so its p is 0 and it adds nothing anywhere
// (and gets dQ = 0), as the reference's test of a padded batch slot needs.
//
// What bounds them on an H100: at the training path's shapes (B*H = 128,
// T = 256, D = 64) K6 does 6 and K7 8 * B*H * T * T_valid * D operations
// (3.2 and 4.3 GFLOP when every key is valid, 3-4 us at the bf16
// tensor-core rate) and moves 17-21 MB (5-6 us), so bytes bound them. This
// version runs every dot product in f32 on the CUDA cores, like K2: the
// reference's dots are f32 over bf16-valued inputs, so f32 FMA reproduces
// them up to summation order. Tensor cores are left to a later change.
//
// Design (flash.cuh): K6 is one block per (b*h, 64-query tile); the
// block's q and dO rows, lse and delta sit in registers, four threads to a
// row, and K and V stream through shared memory in 4096 / D-key f32 tiles.
// For each key a thread finishes two partial dot products (s and dp) with
// warp shuffles and adds ds * k to its dims of dQ. K7 is the transpose: one
// block per (b*h, 64-key tile), the block's k and v rows and their dK and
// dV accumulators in registers, and Q, dO, lse and delta streaming through
// shared memory. Both accumulate in f32 and round to bf16 once at the end;
// nothing is transposed before or after, and no atomics are used.
#include "flash.cuh"

namespace {

using omni::BQ;
using omni::THREADS;
using omni::TPQ;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int T, int H,
                    float scale) {
  constexpr int BKV = omni::tile_keys(D);
  constexpr int NG = D / 16;
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];
  __shared__ int Ms[BKV];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * BQ + tid / TPQ;
  const int part = tid % TPQ;
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;

  float qr[4 * NG], dor[4 * NG], acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) qr[i] = dor[i] = acc[i] = 0.f;
  float row_lse = omni::FULLY_MASKED_LSE;
  float row_delta = 0.f;
  if (qi < T) {
    omni::load_row<D>(q + base + qi * ts + part * 4, qr, 1.f);
    omni::load_row<D>(dout + base + qi * ts + part * 4, dor, 1.f);
    row_lse = lse[static_cast<size_t>(bh) * T + qi];
    row_delta = delta[static_cast<size_t>(bh) * T + qi];
  }

  for (int j0 = 0; j0 < T; j0 += BKV) {
    omni::load_tiles<D, BKV>(k, v, Ks, Vs, base, ts, j0, T, tid);
    if (tid < BKV) {
      const int t = j0 + tid;
      Ms[tid] = (t < T) ? mask[static_cast<size_t>(b) * T + t] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float s = omni::row_dot<D>(qr, Ks[j], part) * scale;
      const float dp = omni::row_dot<D>(dor, Vs[j], part);
      const float p = Ms[j] > 0 ? expf(s - row_lse) : 0.f;
      omni::row_axpy<D>(acc, p * (dp - row_delta), Ks[j], part);
    }
    __syncthreads();
  }
  if (qi < T) omni::store_row<D>(dq + base + qi * ts + part * 4, acc, scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int T, int H,
                     float scale) {
  constexpr int BQT = omni::tile_keys(D);   // query rows per tile
  constexpr int NG = D / 16;
  __shared__ __align__(16) float Qs[BQT][D];
  __shared__ __align__(16) float Os[BQT][D];  // dO
  __shared__ float Ls[BQT];
  __shared__ float Ds[BQT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int ki = blockIdx.x * BQ + tid / TPQ;
  const int part = tid % TPQ;
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;

  float kr[4 * NG], vr[4 * NG], dka[4 * NG], dva[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) kr[i] = vr[i] = dka[i] = dva[i] = 0.f;
  bool key_valid = false;
  if (ki < T) {
    omni::load_row<D>(k + base + ki * ts + part * 4, kr, 1.f);
    omni::load_row<D>(v + base + ki * ts + part * 4, vr, 1.f);
    key_valid = mask[static_cast<size_t>(b) * T + ki] > 0;
  }

  for (int i0 = 0; i0 < T; i0 += BQT) {
    omni::load_tiles<D, BQT>(q, dout, Qs, Os, base, ts, i0, T, tid);
    if (tid < BQT) {
      const int t = i0 + tid;
      const size_t g = static_cast<size_t>(bh) * T + t;
      Ls[tid] = (t < T) ? lse[g] : omni::FULLY_MASKED_LSE;
      Ds[tid] = (t < T) ? delta[g] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BQT; ++i) {
      const float s = omni::row_dot<D>(kr, Qs[i], part) * scale;
      const float dp = omni::row_dot<D>(vr, Os[i], part);
      const float p = key_valid ? expf(s - Ls[i]) : 0.f;
      omni::row_axpy<D>(dva, p, Os[i], part);
      omni::row_axpy<D>(dka, p * (dp - Ds[i]), Qs[i], part);
    }
    __syncthreads();
  }
  if (ki < T) {
    omni::store_row<D>(dk + base + ki * ts + part * 4, dka, scale);
    omni::store_row<D>(dv + base + ki * ts + part * 4, dva, 1.f);
  }
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const int* mask, const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int B, int T, int H, float scale,
                       cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  if (dq != nullptr) {
    flash_bwd_dq_kernel<D><<<grid, THREADS, 0, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), mask, static_cast<const bf*>(dout), lse,
        delta, static_cast<bf*>(dq), T, H, scale);
  } else {
    flash_bwd_dkv_kernel<D><<<grid, THREADS, 0, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), mask, static_cast<const bf*>(dout), lse,
        delta, static_cast<bf*>(dk), static_cast<bf*>(dv), T, H, scale);
  }
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const int* mask,
             const void* dout, const float* lse, const float* delta,
             void* dq, void* dk, void* dv, int B, int T, int H, int head_dim,
             float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_bwd<64>(q, k, v, mask, dout, lse, delta,
                                             dq, dk, dv, B, T, H, scale, s));
    case 128:
      return static_cast<int>(launch_bwd<128>(q, k, v, mask, dout, lse,
                                              delta, dq, dk, dv, B, T, H,
                                              scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

OMNI_API int omni_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const int* mask, const void* dout,
                               const float* lse, const float* delta, void* dq,
                               int B, int T, int H, int head_dim, float scale,
                               void* stream) {
  if (dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, mask, dout, lse, delta, dq, nullptr, nullptr, B,
                  T, H, head_dim, scale, stream);
}

OMNI_API int omni_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const int* mask, const void* dout,
                                const float* lse, const float* delta,
                                void* dk, void* dv, int B, int T, int H,
                                int head_dim, float scale, void* stream) {
  if (dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B, T, H,
                  head_dim, scale, stream);
}
