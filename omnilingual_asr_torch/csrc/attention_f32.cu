// K2, K6 and K7 at f32: the flash-attention forward with the row
// logsumexp, and the backward's dQ and dK/dV, for an f32 encoder
// (EncoderConfig.dtype == "float32").
//
// Replace omnilingual_asr_tpu/ops/attention.py::_flash_fwd_lse_kernel,
// ::_flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel where they are called
// with f32 operands: the Pallas kernels are generic in their input type,
// cast to f32 inside and return in the input's type, so at f32 every
// product is an exact f32 product. Over q, k, v, o, dO f32 [B, T, H, D]
// (D in {64, 128}), the key mask int32 [B, T] and f32 lse, delta
// [B, H, T], with scale = 1/sqrt(D):
//
//     forward   s = (q scale) k^T, masked keys -> -1e30, f32 online softmax
//               o = softmax(s) v; lse = m + log(l), +1e30 for a row whose
//               every key is masked (its o is 0)
//     dQ        p = exp(q k^T scale - lse) * keymask, ds = p (dO v^T - delta)
//               dQ = (ds k) scale
//     dK, dV    dV = p^T dO, dK = (ds^T q) scale
//
// A masked key contributes p = 0 even while the running max is still
// -1e30 (exp(NEG_INF - NEG_INF) would be 1), so a whole masked key tile
// adds nothing; a fully-masked query row's lse of +1e30 makes its p 0 in
// the backward, so its dQ is 0 and it adds nothing to dK, dV. Query and
// key rows at or past T are zero-filled, count as masked and are not
// stored, so T may be any length. dQ and dK are scaled once, at the end.
//
// What bounds them on an H100: f32 has no tensor-core path that keeps
// f32's precision in one product (TF32 keeps 10 mantissa bits), so every
// product is an FMA on the CUDA cores, at 67 TFLOP/s. At the training
// shape [16, 256, 8, 64] the forward does 4 B H T T_valid D operations
// (2.1 GFLOP, 32 us) against 8.4 MB of q/k/v/o (2.5 us): operations bound
// all three kernels by far.
//
// Design (simple and right first; a 3xTF32 mma.sync design is later
// work): one block of 256 threads per (64-row tile, b*h). The block's own
// rows (queries; keys for dK/dV) and each streamed 64-row tile of the
// other side sit in shared memory as f32 rows padded by one word, so that
// 16 threads reading 16 rows at one column hit 16 banks. Thread (ty, tx)
// = (tid / 16, tid % 16) computes a 4 x 4 block of the 64 x 64 score tile,
// rows 4 ty .. 4 ty + 3 and columns tx + 16 c, as FMAs over D from shared
// memory; the 16 threads of a row are 16 lanes of one warp, so the row
// max and sum take four shuffles. The second product (P V, dS K, P^T dO,
// dS^T Q) reads the 64 x 64 tile of p or ds back from shared memory, each
// thread accumulating its 4 rows x D / 16 columns (tx + 16 c) in
// registers. Each block owns its output rows: no atomics, the same result
// on every run. Shared memory: 66.8 KB (forward), 83.5 KB (dQ) and
// 99.8 KB (dK/dV) at D 64; 116 KB, 149 KB and 166 KB at D 128, above
// 48 KB by cudaFuncSetAttribute.
#include "common.cuh"

namespace {

constexpr int R = 64;            // rows a block owns; rows a tile streams
constexpr int THREADS = 256;     // 16 x 16 threads, each 4 x 4 of a tile
constexpr int PLD = R + 1;       // row stride of a p / ds tile in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float FULLY_MASKED_LSE = 1e30f;

template <int D>
struct Rows {
  static constexpr int LD = D + 1;           // f32 row, padded one word
  static constexpr int ELEMS = R * LD;
  static constexpr int DC = D / 16;          // output columns a thread owns
};

// Rows t0 .. t0 + 64 of one head of a [B, T, H, D] f32 operand (src at the
// head's row 0, frame stride ts) into a padded shared tile, times mul; rows
// at or past T are zero. Every thread takes part (16-byte loads).
template <int D>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          size_t ts, int t0, int T, int tid,
                                          float mul) {
  constexpr int V = D / 4;
  for (int i = tid; i < R * V; i += THREADS) {
    const int r = i / V;
    const int c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(t0 + r) * ts + c);
    float* d = tile + r * Rows<D>::LD + c;
    d[0] = x.x * mul;
    d[1] = x.y * mul;
    d[2] = x.z * mul;
    d[3] = x.w * mul;
  }
}

// Values t0 .. t0 + 64 of a length-T row (a key mask, lse or delta) into
// shared memory; those at or past T are `fill`.
template <typename W>
__device__ __forceinline__ void load_words(W* dst, const W* src, int t0,
                                           int T, int tid, W fill) {
  if (tid < R) dst[tid] = t0 + tid < T ? src[t0 + tid] : fill;
}

// acc[i][c] += sum_d A[4 ty + i][d] * B[tx + 16 c][d] over two padded
// tiles: the thread's 4 x 4 block of A B^T.
template <int D>
__device__ __forceinline__ void rows_by_rows(float (*acc)[4], const float* A,
                                             const float* Bt, int ty,
                                             int tx) {
  constexpr int LD = Rows<D>::LD;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bt[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// acc[i][c] += sum_j P[4 ty + i][j] * V[j][tx + 16 c] over a 64 x 64 tile P
// (row stride PLD) and a padded 64-row tile V: the thread's 4 rows x D / 16
// columns of P V.
template <int D>
__device__ __forceinline__ void tile_by_rows(float (*acc)[Rows<D>::DC],
                                             const float* P, const float* V,
                                             int ty, int tx) {
  constexpr int LD = Rows<D>::LD;
#pragma unroll 2
  for (int j = 0; j < R; ++j) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(4 * ty + i) * PLD + j];
#pragma unroll
    for (int c = 0; c < Rows<D>::DC; ++c) {
      const float v = V[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], v, acc[i][c]);
    }
  }
}

// Reduce over the 16 lanes that share a row (lanes differing in bits 0-3).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Store a thread's 4 rows x D / 16 columns (times mul) of the block's rows
// r0 .. r0 + 64 that lie below T; dst at the head's row 0.
template <int D>
__device__ __forceinline__ void store_rows(float* dst,
                                           float (*acc)[Rows<D>::DC],
                                           float mul, size_t ts, int r0,
                                           int T, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + 4 * ty + i;
    if (t >= T) continue;
    float* row = dst + static_cast<size_t>(t) * ts;
#pragma unroll
    for (int c = 0; c < Rows<D>::DC; ++c) row[tx + 16 * c] = acc[i][c] * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ lse, int T, int H, float scale) {
  constexpr int E = Rows<D>::ELEMS;
  constexpr int DC = Rows<D>::DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + E;
  float* Vs = Ks + E;
  float* Ps = Vs + E;                               // [R][PLD]
  int* Ms = reinterpret_cast<int*>(Ps + R * PLD);   // [R]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * R;
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const int* mrow = mask + static_cast<size_t>(b) * T;

  load_rows<D>(Qs, q + base, ts, q0, T, tid, scale);   // q * scale, as JAX
  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < T; j0 += R) {
    __syncthreads();                 // the previous tile's readers are done
    load_rows<D>(Ks, k + base, ts, j0, T, tid, 1.f);
    load_rows<D>(Vs, v + base, ts, j0, T, tid, 1.f);
    load_words(Ms, mrow, j0, T, tid, 0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    rows_by_rows<D>(s, Qs, Ks, ty, tx);
    bool valid[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) valid[c] = Ms[tx + 16 * c] > 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = valid[c] ? s[i][c] : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid[c] ? expf(s[i][c] - m_new) : 0.f;
        l[i] += p;                   // this thread's share of the row sum
        Ps[(4 * ty + i) * PLD + tx + 16 * c] = p;
      }
    }
    __syncthreads();
    tile_by_rows<D>(acc, Ps, Vs, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = row_sum(l[i]);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] *= inv[i];
  }
  store_rows<D>(o + base, acc, 1.f, ts, q0, T, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      if (t < T)
        lse[static_cast<size_t>(bh) * T + t] =
            l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : FULLY_MASKED_LSE;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ mask,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int T, int H, float scale) {
  constexpr int E = Rows<D>::ELEMS;
  constexpr int DC = Rows<D>::DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + E;                               // dO
  float* Ks = Gs + E;
  float* Vs = Ks + E;
  float* Ss = Vs + E;                               // ds [R][PLD]
  int* Ms = reinterpret_cast<int*>(Ss + R * PLD);   // [R]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * R;
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const int* mrow = mask + static_cast<size_t>(b) * T;

  load_rows<D>(Qs, q + base, ts, q0, T, tid, 1.f);
  load_rows<D>(Gs, dout + base, ts, q0, T, tid, 1.f);
  float row_lse[4], row_delta[4];
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    const size_t at = static_cast<size_t>(bh) * T + t;
    row_lse[i] = t < T ? lse[at] : FULLY_MASKED_LSE;
    row_delta[i] = t < T ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < T; j0 += R) {
    __syncthreads();
    load_rows<D>(Ks, k + base, ts, j0, T, tid, 1.f);
    load_rows<D>(Vs, v + base, ts, j0, T, tid, 1.f);
    load_words(Ms, mrow, j0, T, tid, 0);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    rows_by_rows<D>(s, Qs, Ks, ty, tx);
    rows_by_rows<D>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = Ms[tx + 16 * c] > 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(s[i][c] * scale - row_lse[i]) : 0.f;
        Ss[(4 * ty + i) * PLD + tx + 16 * c] = p * (dp[i][c] - row_delta[i]);
      }
    }
    __syncthreads();
    tile_by_rows<D>(acc, Ss, Ks, ty, tx);
  }
  store_rows<D>(dq + base, acc, scale, ts, q0, T, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ mask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int T, int H, float scale) {
  constexpr int E = Rows<D>::ELEMS;
  constexpr int DC = Rows<D>::DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + E;
  float* Qs = Vs + E;
  float* Gs = Qs + E;                               // dO
  float* Ps = Gs + E;                               // p^T [R keys][PLD]
  float* Ss = Ps + R * PLD;                         // ds^T [R keys][PLD]
  float* Ls = Ss + R * PLD;                         // [R] lse
  float* Ds = Ls + R;                               // [R] delta

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * R;
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const int* mrow = mask + static_cast<size_t>(b) * T;
  const float* lrow = lse + static_cast<size_t>(bh) * T;
  const float* drow = delta + static_cast<size_t>(bh) * T;

  load_rows<D>(Ks, k + base, ts, k0, T, tid, 1.f);
  load_rows<D>(Vs, v + base, ts, k0, T, tid, 1.f);
  bool key_valid[4];
  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + 4 * ty + i;
    key_valid[i] = t < T && mrow[t] > 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < T; j0 += R) {
    __syncthreads();
    load_rows<D>(Qs, q + base, ts, j0, T, tid, 1.f);
    load_rows<D>(Gs, dout + base, ts, j0, T, tid, 1.f);
    load_words(Ls, lrow, j0, T, tid, FULLY_MASKED_LSE);
    load_words(Ds, drow, j0, T, tid, 0.f);
    __syncthreads();

    // s^T and dp^T: rows are this block's keys, columns the tile's queries.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    rows_by_rows<D>(s, Ks, Qs, ty, tx);
    rows_by_rows<D>(dp, Vs, Gs, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float lj = Ls[j];
      const float dj = Ds[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key_valid[i] ? expf(s[i][c] * scale - lj) : 0.f;
        Ps[(4 * ty + i) * PLD + j] = p;
        Ss[(4 * ty + i) * PLD + j] = p * (dp[i][c] - dj);
      }
    }
    __syncthreads();
    tile_by_rows<D>(acc_v, Ps, Gs, ty, tx);
    tile_by_rows<D>(acc_k, Ss, Qs, ty, tx);
  }
  store_rows<D>(dk + base, acc_k, scale, ts, k0, T, ty, tx);
  store_rows<D>(dv + base, acc_v, 1.f, ts, k0, T, ty, tx);
}

template <int D>
constexpr size_t fwd_smem() {
  return (3 * Rows<D>::ELEMS + R * PLD + R) * 4;
}

template <int D>
constexpr size_t dq_smem() {
  return (4 * Rows<D>::ELEMS + R * PLD + R) * 4;
}

template <int D>
constexpr size_t dkv_smem() {
  return (4 * Rows<D>::ELEMS + 2 * R * PLD + 2 * R) * 4;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* mask, void* o, float* lse, int B, int T,
                       int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = omni::allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B * H);
  flash_fwd_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), lse, T, H,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const int* mask, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int T, int H,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = omni::allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B * H);
  flash_bwd_dq_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq), T, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const int* mask, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int T,
                       int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = omni::allow_smem(flash_bwd_dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B * H);
  flash_bwd_dkv_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), T, H,
      scale);
  return cudaGetLastError();
}

bool bad_dims(int B, int T, int H) { return B <= 0 || T <= 0 || H <= 0; }

}  // namespace

OMNI_API int omni_flash_fwd_f32(const void* q, const void* k, const void* v,
                                const int* mask, void* o, float* lse, int B,
                                int T, int H, int head_dim, float scale,
                                void* stream) {
  if (bad_dims(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(
          launch_fwd<64>(q, k, v, mask, o, lse, B, T, H, scale, s));
    case 128:
      return static_cast<int>(
          launch_fwd<128>(q, k, v, mask, o, lse, B, T, H, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

OMNI_API int omni_flash_bwd_dq_f32(const void* q, const void* k,
                                   const void* v, const int* mask,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, int B,
                                   int T, int H, int head_dim, float scale,
                                   void* stream) {
  if (bad_dims(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dq<64>(q, k, v, mask, dout, lse, delta,
                                            dq, B, T, H, scale, s));
    case 128:
      return static_cast<int>(launch_dq<128>(q, k, v, mask, dout, lse, delta,
                                             dq, B, T, H, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

OMNI_API int omni_flash_bwd_dkv_f32(const void* q, const void* k,
                                    const void* v, const int* mask,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dk, void* dv,
                                    int B, int T, int H, int head_dim,
                                    float scale, void* stream) {
  if (bad_dims(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dkv<64>(q, k, v, mask, dout, lse, delta,
                                             dk, dv, B, T, H, scale, s));
    case 128:
      return static_cast<int>(launch_dkv<128>(q, k, v, mask, dout, lse,
                                              delta, dk, dv, B, T, H, scale,
                                              s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
