// K2: flash-attention forward with a key mask and the row logsumexp, on
// bf16 tensor cores. (K2 at f16 is attention_f16.cu, on wgmma and TMA.)
//
// Replaces omnilingual_asr_tpu/ops/attention.py::_flash_fwd_lse_kernel
// (launched by _fwd_lse). Non-causal attention over q, k, v [B, T, H, D]
// bf16, D in {64, 128}, with an int32 key-validity mask [B, T]:
//
//     s = (q k^T) / sqrt(D)      masked keys -> -1e30, f32 online softmax
//     o = softmax(s) v           bf16 out, [B, T, H, D]
//     lse = m + log(l)           f32, [B, H, T]; +1e30 for a fully-masked row
//
// A fully-masked row (a padded batch slot, n_valid = 0) gets o = 0 and
// lse = +1e30, exactly as the reference; a masked key contributes p = 0
// even while the running max is still -1e30. T may be any length: query
// rows and keys past T are zero-filled, masked and not stored.
//
// What bounds it on an H100: at the serving shape (B*H = 16, T = 768,
// D = 64) the work is 2.4 GFLOP of bf16 products against 6.3 MB of
// q/k/v/o: 2.4 us of tensor-core time, 1.9 us of memory time. At that size
// neither bounds it; the latency of each key tile's chain (load, QK^T,
// softmax, PV) and the number of blocks in flight do. The design keeps the
// chain short and overlaps the next tile's copy with it.
//
// Design (FlashAttention-2's shape, on warp-level mma.sync): one block of 4
// warps per (64-query tile, b*h): 192 blocks at the serving shape. Each
// warp owns 16 query rows, whose bf16 Q fragments it loads once
// (ldmatrix) and keeps in registers. K and V stream as bf16 tiles of 64
// keys into dynamic shared memory, double-buffered with cp.async (16 bytes
// a thread, zero-filled past T), rows padded by 16 bytes so that ldmatrix
// reads them without bank conflicts; the key mask comes along in 4-byte
// copies. Per tile a warp computes S = Q K^T with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (q.k an f32 sum of exact bf16
// products, as in the reference), scales S in f32 (scaling q first would
// leave bf16 at D = 128), masks it and updates the running max and sum in
// registers (row max and sum across the 4 lanes of a row by shuffles).
// P comes straight from the S accumulators as bf16 A fragments, V through
// ldmatrix.trans. P is split as hi + lo (hi = bf16(p), lo = bf16(p - hi))
// and O += P_hi V + P_lo V: the reference takes P V in f32, and bf16 P
// alone misses the output tolerance (tests/test_torch_attention.py
// emulates both on the CPU), while hi + lo carries p to ~16 bits. The
// [T, T] score matrix never exists; q/k/v are read in place from
// [B, T, H, D]. mma.sync and cp.async, not wgmma and TMA: at these shapes
// the tensor cores' rate is not the limit.
//
// Shared memory: two K and two V tiles of 64 x (D + 8) bf16 and two mask
// tiles (Q is staged in the second K tile before the loop): 36.5 KB at
// D 64, 68.5 KB at D 128. Registers (nvcc -Xptxas -v, sm_90a, as
// chip_smoke.py prints them): 128 at D 64 with no spills, 168 at D 128
// with 56 bytes of spill stores, both capped by the launch bounds below.
#include "flash.cuh"

namespace {

using omni::FlashTile;
using omni::NEG_INF;

constexpr int BQ = omni::FLASH_ROWS;      // query rows a block owns (16 a warp)
constexpr int BK = omni::FLASH_ROWS;      // keys a shared-memory tile holds
constexpr int THREADS = omni::FLASH_THREADS;

// Blocks an SM the register budget must allow: at D 128 three (<= 170
// registers) keep the 384 blocks of [4, 768, 8, 128] in one wave; at D 64
// four (<= 128) keep the training shape's 512 blocks in one (at 160
// registers it took 1.3x as long on an H100, chip_smoke.py's timing).
template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 3 : 4)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, float scale) {
  using E = __nv_bfloat16;
  constexpr int TILE = FlashTile<D>::ELEMS;
  constexpr int KD = D / 16;        // k-steps of QK^T; dim-tile pairs of PV
  constexpr int NT = BK / 8;        // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Ks = reinterpret_cast<E*>(smem_raw);                           // [2][TILE]
  E* Vs = Ks + 2 * TILE;                                            // [2][TILE]
  int* Ms = reinterpret_cast<int*>(Vs + 2 * TILE);                  // [2][BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int tq = lane & 3;          // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const size_t ts = static_cast<size_t>(H) * D;   // stride between frames
  const size_t base = static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const int* mrow = mask + static_cast<size_t>(b) * T;
  const int n_tiles = (T + BK - 1) / BK;

  // Q (staged in K buffer 1), key tile 0 and its mask.
  omni::load_tile<D>(Ks + TILE, q + base, ts, q0, T, tid);
  omni::load_tile<D>(Ks, k + base, ts, 0, T, tid);
  omni::load_tile<D>(Vs, v + base, ts, 0, T, tid);
  omni::load_words(Ms, mrow, 0, T, tid, 0);
  omni::cp_async_commit();
  omni::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
  omni::load_a_frags<D>(qf, Ks + TILE, warp * 16, lane);
  __syncthreads();                  // K buffer 1 is free for tile 1

  float acc[2 * KD][4];             // O: 8-dim tiles, rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the running sum

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int nb = buf ^ 1;
      omni::load_tile<D>(Ks + nb * TILE, k + base, ts, (j + 1) * BK, T, tid);
      omni::load_tile<D>(Vs + nb * TILE, v + base, ts, (j + 1) * BK, T, tid);
      omni::load_words(Ms + nb * BK, mrow, (j + 1) * BK, T, tid, 0);
    }
    omni::cp_async_commit();
    omni::cp_async_wait<1>();       // tile j has landed
    __syncthreads();
    const E* kt = Ks + buf * TILE;
    const E* vt = Vs + buf * TILE;
    const int* mt = Ms + buf * BK;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    omni::mma_a_rows<D, NT>(s, qf, kt, 0, lane);

    // Scale, mask, online softmax (rows g: s[.][0..1]; g + 8: s[.][2..3]).
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int2 mk = *reinterpret_cast<const int2*>(mt + n * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = (e & 1 ? mk.y : mk.x) > 0;
        s[n][e] = valid ? s[n][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int2 mk = *reinterpret_cast<const int2*>(mt + n * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = (e & 1 ? mk.y : mk.x) > 0;
        s[n][e] = valid ? expf(s[n][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V, P = hi + lo in bf16, 16 keys per k-step.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      omni::split_a_frag(s + 2 * kk, ph, pl);
      omni::mma_split_cols<D>(acc, ph, pl, vt, 16 * kk, lane);
    }
    __syncthreads();                // buffer `buf` is refilled next round
  }

  // Epilogue: finish each row's sum across its 4 lanes, normalise, store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= T) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    E* dst = o + base + static_cast<size_t>(qi) * ts + 2 * tq;
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) = omni::pack_pair<E>(
          acc[i][2 * r] / denom, acc[i][2 * r + 1] / denom);
    if (tq == 0)
      lse[static_cast<size_t>(bh) * T + qi] =
          l[r] > 0.f ? m[r] + logf(fmaxf(l[r], 1e-30f))
                     : omni::FULLY_MASKED_LSE;
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* mask, void* o, float* lse, int B, int T,
                       int H, float scale, cudaStream_t stream) {
  using E = __nv_bfloat16;
  const size_t smem = FlashTile<D>::bytes(1);
  cudaError_t err = omni::allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), mask, static_cast<E*>(o), lse, T, H, scale);
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
      return static_cast<int>(
          launch_fwd<64>(q, k, v, mask, o, lse, B, T, H, scale, s));
    case 128:
      return static_cast<int>(
          launch_fwd<128>(q, k, v, mask, o, lse, B, T, H, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
