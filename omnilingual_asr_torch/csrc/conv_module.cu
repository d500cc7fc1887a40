// K3: the whole conformer convolution module, fused.
//
// Replaces omnilingual_asr_tpu/ops/conv_module.py::_conv_kernel (launched by
// _fused_conv_fwd_kernel_call). For x [B, T, D] f32 and a frame mask it
// computes, per frame,
//
//     h   = LN(x)                                  (eps 1e-5)
//     g   = bf16(h) @ bf16(pw1)                    [2D], f32 accumulation
//     u   = g[:D] * sigmoid(g[D:]) * mask          GLU, padded frames -> 0
//     c   = depthwise conv of u over time, K taps, SAME (left (K-1)/2)
//     y   = SiLU(LN(c))
//     out = x + bf16(y) @ bf16(pw2)                f32 accumulation
//
// What bounds it on an H100: at the main path's shapes (B 4, T 768, D 256,
// K 32) it reads and writes ~6.3 MB of activations and ~0.8 MB of weights
// (~2 us at 3.35 TB/s) and does ~1.3 GFLOP, mostly in the two pointwise
// products; this version runs those in f32 FMA on the CUDA cores over
// bf16-rounded inputs (what the reference's bf16 matmul with f32
// accumulation computes), so operations, launch latency and occupancy bound
// it. Tensor-core products are left to a later change.
//
// Design: the TPU kernel held one whole [T, D] row per grid step in VMEM;
// that would give 4 blocks for 132 SMs. Here one block owns 32 output
// frames of one row (96 blocks on the main path) and recomputes LN -> pw1 ->
// GLU -> mask over those frames plus the K-1 frame halo the depthwise taps
// need (63 rows), all in shared memory. The depthwise taps, the second LN,
// SiLU and pw2 then run on the block's own 32 frames, and only the final
// residual sum is written to device memory. Shared memory holds the halo's
// LN output in bf16 (it is rounded to bf16 anyway) and its GLU output in
// f32, 6 (D + 4) bytes a row: D up to 576 fits the 227 KB a block may use
// (the training path's D = 512 included).
#include "common.cuh"

namespace {

constexpr int TT = 32;            // output frames per block
constexpr int RP = 64;            // halo rows held: TT + K - 1 <= RP
constexpr int THREADS = 256;
constexpr int KC = 16;            // depth of one weight tile
constexpr int NC = 64;            // output channels per GEMM chunk
constexpr float LN_EPS = 1e-5f;
// The bf16 halo buffer [RP][ld] is reused as the f32 conv output [TT][ld].
static_assert(TT * sizeof(float) <= RP * sizeof(__nv_bfloat16),
              "conv output must fit in the bf16 halo buffer");

__device__ __forceinline__ void bf16x8_to_f32(const uint4 raw, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// Mean and 1/sqrt(var + eps) of one row of n values, by one warp.
__device__ __forceinline__ void row_stats(const float* row, int n, float* mean,
                                          float* inv) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += row[c];
  const float mu = omni::warp_sum(s) / n;
  float q = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = row[c] - mu;
    q += d * d;
  }
  const float var = omni::warp_sum(q) / n;
  *mean = mu;
  *inv = 1.f / sqrtf(var + LN_EPS);
}

__global__ void __launch_bounds__(THREADS, 1)
conv_module_kernel(const float* __restrict__ x, const int* __restrict__ mask,
                   const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                   const __nv_bfloat16* __restrict__ pw1,
                   const float* __restrict__ dw,
                   const float* __restrict__ dwln_s,
                   const float* __restrict__ dwln_b,
                   const __nv_bfloat16* __restrict__ pw2,
                   float* __restrict__ out, int T, int D, int K) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem);  // [RP][ld]
  //                                   bf16(LN(x)); later the f32 dw output
  float* Gs = smem + RP * ld / 2;   // [RP][ld]  masked GLU (ld is even)
  float* Wa = Gs + RP * ld;         // [KC][NC]  weight tile
  float* Wb = Wa + KC * NC;         // [KC][NC]  weight tile (GLU gate half)
  float* rowm = Wb + KC * NC;       // [RP]      1 if the halo row is a valid frame

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int pad_l = (K - 1) / 2;
  const int R = TT + K - 1;
  const float* xb = x + static_cast<size_t>(b) * T * D;

  // 1. LayerNorm of the halo rows, rounded to bf16 (the pw1 input).
  for (int r = warp; r < RP; r += THREADS / 32) {
    const int t = t0 - pad_l + r;
    const bool in = r < R && t >= 0 && t < T;
    if (lane == 0)
      rowm[r] = (in && mask[static_cast<size_t>(b) * T + t] != 0) ? 1.f : 0.f;
    if (!in) {
      for (int c = lane; c < D; c += 32) Hs[r * ld + c] = __float2bfloat16_rn(0.f);
      continue;
    }
    const float* xr = xb + static_cast<size_t>(t) * D;
    float mu, inv;
    row_stats(xr, D, &mu, &inv);
    for (int c = lane; c < D; c += 32)
      Hs[r * ld + c] = __float2bfloat16_rn((xr[c] - mu) * inv * ln_s[c] + ln_b[c]);
  }
  __syncthreads();

  // 2. pw1 -> GLU -> frame mask, NC output channels at a time.
  const int tx = tid & 15;          // channels tx*4 .. tx*4+3 of the chunk
  const int ty = tid >> 4;          // rows ty*4 .. ty*4+3 (0..63)
  for (int j0 = 0; j0 < D; j0 += NC) {
    float acc_a[4][4], acc_b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += KC) {
      {
        const int k = tid >> 4;
        const int part = tid & 15;
        const int col = (part & 7) * 8;
        const __nv_bfloat16* src = pw1 + static_cast<size_t>(c0 + k) * (2 * D) +
                                   (part < 8 ? 0 : D) + j0 + col;
        float w[8];
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(src), w);
        float* dst = (part < 8 ? Wa : Wb) + k * NC + col;
        *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hv[i] = __bfloat162float(Hs[(ty * 4 + i) * ld + c0 + k]);
        const float4 wa = *reinterpret_cast<const float4*>(Wa + k * NC + tx * 4);
        const float4 wb = *reinterpret_cast<const float4*>(Wb + k * NC + tx * 4);
        const float a4[4] = {wa.x, wa.y, wa.z, wa.w};
        const float b4[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_a[i][j] = fmaf(hv[i], a4[j], acc_a[i][j]);
            acc_b[i][j] = fmaf(hv[i], b4[j], acc_b[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float mk = rowm[r];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Gs[r * ld + j0 + tx * 4 + j] = acc_a[i][j] * sigmoidf(acc_b[i][j]) * mk;
    }
  }
  __syncthreads();

  // 3. Depthwise conv over the block's TT frames, taps in ascending order.
  float* Ds = smem;                 // Hs is free again: [TT][ld] f32
  for (int c = tid; c < D; c += THREADS) {
    float acc[TT];
#pragma unroll
    for (int o = 0; o < TT; ++o) acc[o] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = dw[static_cast<size_t>(k) * D + c];
#pragma unroll
      for (int o = 0; o < TT; ++o) acc[o] = fmaf(Gs[(o + k) * ld + c], w, acc[o]);
    }
#pragma unroll
    for (int o = 0; o < TT; ++o) Ds[o * ld + c] = acc[o];
  }
  __syncthreads();

  // 4. LayerNorm -> SiLU, rounded to bf16 (the pw2 input).
  for (int o = warp; o < TT; o += THREADS / 32) {
    float* row = Ds + o * ld;
    float mu, inv;
    row_stats(row, D, &mu, &inv);
    for (int c = lane; c < D; c += 32) {
      const float y = (row[c] - mu) * inv * dwln_s[c] + dwln_b[c];
      row[c] = omni::bf16_round(y * sigmoidf(y));
    }
  }
  __syncthreads();

  // 5. pw2 + residual, NC output channels at a time (2 rows x 4 per thread).
  for (int n0 = 0; n0 < D; n0 += NC) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += KC) {
      if (tid < KC * NC / 8) {
        const int k = tid >> 3;
        const int col = (tid & 7) * 8;
        float w[8];
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(
                          pw2 + static_cast<size_t>(c0 + k) * D + n0 + col), w);
        float* dst = Wa + k * NC + col;
        *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float d0 = Ds[(ty * 2) * ld + c0 + k];
        const float d1 = Ds[(ty * 2 + 1) * ld + c0 + k];
        const float4 w = *reinterpret_cast<const float4*>(Wa + k * NC + tx * 4);
        acc[0][0] = fmaf(d0, w.x, acc[0][0]);
        acc[0][1] = fmaf(d0, w.y, acc[0][1]);
        acc[0][2] = fmaf(d0, w.z, acc[0][2]);
        acc[0][3] = fmaf(d0, w.w, acc[0][3]);
        acc[1][0] = fmaf(d1, w.x, acc[1][0]);
        acc[1][1] = fmaf(d1, w.y, acc[1][1]);
        acc[1][2] = fmaf(d1, w.z, acc[1][2]);
        acc[1][3] = fmaf(d1, w.w, acc[1][3]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + ty * 2 + i;
      if (t >= T) continue;
      const size_t off = static_cast<size_t>(t) * D + n0 + tx * 4;
      const float4 xr = *reinterpret_cast<const float4*>(xb + off);
      *reinterpret_cast<float4*>(out + static_cast<size_t>(b) * T * D + off) =
          make_float4(xr.x + acc[i][0], xr.y + acc[i][1], xr.z + acc[i][2],
                      xr.w + acc[i][3]);
    }
  }
}

}  // namespace

OMNI_API int omni_conv_module(const float* x, const int* mask,
                              const float* ln_s, const float* ln_b,
                              const void* pw1, const float* dw,
                              const float* dwln_s, const float* dwln_b,
                              const void* pw2, float* out, int B, int T,
                              int D, int K, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || D % NC != 0 || K < 1 || TT + K - 1 > RP)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = RP * (D + 4) * (sizeof(__nv_bfloat16) + sizeof(float)) +
                      (2 * KC * NC + RP) * sizeof(float);
  cudaError_t err = omni::allow_smem(conv_module_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TT - 1) / TT, B);
  conv_module_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, mask, ln_s, ln_b, static_cast<const __nv_bfloat16*>(pw1), dw, dwln_s,
      dwln_b, static_cast<const __nv_bfloat16*>(pw2), out, T, D, K);
  return static_cast<int>(cudaGetLastError());
}
