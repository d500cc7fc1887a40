// K6 and K7: the flash-attention backward, dQ and dK/dV, on bf16 tensor
// cores; and K6 and K7 at f16 (the f16 encoder), the same kernels over f16
// operands (F16 = true; see the end of this comment).
//
// Replace omnilingual_asr_tpu/ops/attention.py::_flash_bwd_dq_kernel (K6)
// and ::_flash_bwd_dkv_kernel (K7), both launched by _flash_bh_bwd. Over
// q, k, v, dO bf16 [B, T, H, D] (D in {64, 128}), the key mask int32
// [B, T], and the forward's row logsumexp lse and delta = sum_d dO * O, both
// f32 [B, H, T], with scale = 1/sqrt(D):
//
//     p  = exp(q k^T * scale - lse) * keymask   (f32; recomputed, never stored)
//     ds = p * (dO v^T - delta)
//     dQ = ds k * scale                          K6, bf16 [B, T, H, D]
//     dV = p^T dO,  dK = ds^T q * scale          K7, bf16 [B, T, H, D]
//
// A masked key has p = 0 exactly, so its dK and dV are exactly 0; a
// fully-masked query row has lse = +1e30, so its p is 0, it adds nothing
// anywhere and its dQ is exactly 0. Query rows past T count as fully
// masked (K7 sets their lse to +1e30, not cp.async's zero fill); key rows
// past T as masked keys.
//
// What bounds them on an H100: at the training path's shape (B*H = 128,
// T = 256, D = 64) K6 reads q, k, v, dO, lse and delta and writes dQ,
// 21 MB (6.3 us at 3.35 TB/s); K7 writes dK and dV, 25 MB (7.6 us). Their
// products, 6 and 8 * B*H * T * T_valid * D operations (3-4 us at the bf16
// tensor-core rate), are below that, so bytes bound both; at large_config's
// head dim 128 ([4, 768, 8, 128]) the same holds (9.5 and 11.3 us). What
// holds a kernel above its bound at these sizes is the latency of each
// tile's product chain and how many blocks an SM keeps in flight.
//
// Design (FlashAttention-2's backward on warp-level mma.sync, the tiles of
// K2; flash.cuh): K6 is one block of 4 warps per (64-query tile, b*h); each
// warp owns 16 query rows, whose Q and dO A fragments it loads once
// (ldmatrix) and keeps in registers with the rows' lse and delta. K and V
// stream as bf16 64-key tiles through dynamic shared memory, double-
// buffered with cp.async. For each step of keys (32 at D 64, 16 at D 128,
// to bound the registers) a warp computes S = Q K^T and dP = dO V^T as
// mma.sync chains over D (f32 sums of exact bf16 products, as in the
// reference), scales S in f32, forms P and dS = P (dP - delta) in registers
// (S and dP share the C-fragment layout; lse and delta are per row), and
// adds dS K to dQ: dS enters as A fragments straight from the accumulators,
// K as ldmatrix.trans B fragments of the same shared tile. K7 is the
// transpose: one block per (64-key tile, b*h), each warp holding its 16
// keys' K and V A fragments; Q, dO and that tile's lse and delta stream;
// per 16-query step S^T = K Q^T and dP^T = V dO^T, P^T and dS^T with lse
// and delta per column (from shared memory), and dV += P^T dO,
// dK += dS^T Q with dO and Q as ldmatrix.trans B fragments. Both keep f32
// accumulators in registers and round to bf16 once at the end (dQ and dK
// times scale there). Each block owns its output rows: no atomics, and the
// results are the same on every run.
//
// Numerics: the only roundings beyond the reference's are of P and dS to
// bf16 operands. Both are split as hi + lo (hi = bf16(x), lo = bf16(x -
// hi), two products): with hi alone dV misses the tolerance at every shape
// tried and dQ/dK on ragged rows (ops/attention.py::
// flash_attention_bwd_emulated, tests/test_torch_attention_grad.py).
//
// Shared memory: two tiles each of the streamed operands, 64 x (D + 8)
// bf16, and their 4-byte rows (mask; lse and delta): 36.5 / 37 KB at D 64,
// 68.5 / 69 KB at D 128. Registers (nvcc -Xptxas -v, sm_90a, as
// chip_smoke.py prints them): K6 128 at D 64 (8 bytes of spill stores) and
// 168 at D 128 (32); K7 128 at D 64 (108) and 255 at D 128 (72), each
// capped by its launch bounds. The bounds are the fastest of those that
// python -m omnilingual_asr_torch.ops.flash_bwd_sweep timed on an H100:
// at the training shape fewer blocks an SM (more registers, no spills)
// took 1.3x as long for K6 and 1.1-1.2x for K7; at D 128 K6 at 2 blocks
// 1.2x as long as at 3, K7 at 3 blocks 1.7x as long as at 2.
//
// At f16 (omni_flash_bwd_dq_f16, omni_flash_bwd_dkv_f16) every product
// runs on f16 mma.sync: S = Q K^T and dP = dO V^T over the f16 operands
// (exact products), and the second products take the f16 B fragments (K
// for dQ, dO for dV, Q for dK) straight from ldmatrix.trans, against P and
// dS split as f16 hi + lo (hi = f16(x 2^e), lo = f16(x 2^e - hi), ~22
// significant bits; two products, as at bf16). f16 lacks f32's exponent
// range (normal from 2^-14, nothing below 2^-24, nothing above 65504), so
// each is first brought into it by an exact power of two, taken out again
// from the f32 accumulator at the store:
// - P <= 1 (exp(s - lse), lse the row's logsumexp), times 2^P_EXP = 2^14:
//   P 2^14 <= 2^14 cannot overflow, P_hi is normal down to p = 2^-28, and
//   what lo loses below that is 2^-39 absolute; dV is times 2^-14.
// - dS = P (dP - delta) scales with dO: a mean loss gives dO ~ 1e-6, where
//   dS alone would flush, and a large dO overflows 65504. Each row of the
//   f32 accumulator (a query of dQ in K6, a key of dK in K7: the rows of
//   dS, or of dS^T, that a product contracts along) carries a running
//   exponent e. At each step, the quad of lanes that holds the row reduces
//   its largest |dS| of the step, m; if m 2^e would reach 2^EXP_LIMIT =
//   2^15, e drops to EXP_RESET - floor(log2 m), so that m 2^e lies in
//   [2^10, 2^11), and the row's accumulator is scaled by the exact power of
//   two 2^(new e - old e) (skipped when no row of the warp drops). So
//   |dS 2^e| < 2^15 always: no overflow; and every dS of the row, at
//   whichever step, was split under an exponent no smaller than the
//   final one, under which the row's largest |dS| is at least 2^10: what
//   the split loses of any dS is ~2^-22 of it and at most 2^-35 of that
//   largest |dS|, at any dO. e starts at EXP_START = 64 and stays there in
//   a row whose |dS| stays below 2^-49 (2^-89 lost at most), as in one
//   whose dS is 0 (masked keys, a fully masked row: its accumulator stays
//   exactly 0). The store takes dQ and dK times scale 2^-e, one f32
//   rounding as before.
// dQ, dK and dV are rounded to f16 once, at the end, as the reference
// rounds them. Registers at f16 (nvcc -Xptxas -v, sm_90a, as
// chip_smoke.py prints them; the bf16 kernels of the same build in
// brackets): K6 128 at D 64, no spill stores (8 bytes), and 168 at D 128,
// 44 (32); K7 128 at D 64, 120 (108), and 255 at D 128, 112 (72).
#include "flash.cuh"

namespace {

using omni::FlashTile;

constexpr int BR = omni::FLASH_ROWS;      // rows a block owns; tile rows
constexpr int THREADS = omni::FLASH_THREADS;

// Round a warp's accumulators acc[D / 8] (its rows g and g + 8, times
// mul[0] and mul[1]) to the element type E and store those below T; dst is
// the warp's first row, row0 its index.
template <int D, typename E>
__device__ __forceinline__ void store_rows(E* dst, float (*acc)[4],
                                           const float mul[2], size_t ts,
                                           int row0, int T, int lane) {
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + g + 8 * r >= T) continue;
    E* p = dst + static_cast<size_t>(g + 8 * r) * ts + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(p + i * 8) = omni::pack_pair<E>(
          acc[i][2 * r] * mul[r], acc[i][2 * r + 1] * mul[r]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// The f16 kernels' scales (see the head of this file).
constexpr int P_EXP = 14;        // P 2^14 for dV = P^T dO
constexpr int EXP_START = 64;    // a row's dS exponent before any dS > 0
constexpr int EXP_LIMIT = 15;    // |dS| 2^e < 2^15
constexpr int EXP_RESET = 10;    // on a drop, 2^10 <= m 2^e < 2^11

// 2^e as an f32, e in [-126, 127].
__device__ __forceinline__ float exp2i(int e) {
  return __uint_as_float(static_cast<uint32_t>(127 + e) << 23);
}

// The dS exponents ex of a warp's accumulator rows g and g + 8 brought up
// to date with a step's dS, the NS 8-column C tiles x (the lanes 4 g ..
// 4 g + 3 hold a row's columns; every lane of the quad reaches the same
// exponent); where one drops, the row's NA accumulator tiles acc are
// scaled by the exact power of two. Returns the rows' scales 2^ex in sc.
template <int NS, int NA>
__device__ __forceinline__ void track_exponents(float (*x)[4], int ex[2],
                                                float (*acc)[4],
                                                float sc[2]) {
  float m[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    m[0] = fmaxf(m[0], fmaxf(fabsf(x[n][0]), fabsf(x[n][1])));
    m[1] = fmaxf(m[1], fmaxf(fabsf(x[n][2]), fabsf(x[n][3])));
  }
  float f[2];
  bool drop = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    // floor(log2 m) from m's exponent bits; -127 at 0, which never drops.
    const int lg = static_cast<int>(__float_as_uint(m[r]) >> 23) - 127;
    const int e = lg + ex[r] >= EXP_LIMIT ? EXP_RESET - lg : ex[r];
    f[r] = exp2i(max(e - ex[r], -126));
    drop |= e != ex[r];
    ex[r] = e;
    sc[r] = exp2i(e);
  }
  if (__any_sync(0xffffffffu, drop)) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      acc[i][0] *= f[0];
      acc[i][1] *= f[0];
      acc[i][2] *= f[1];
      acc[i][3] *= f[1];
    }
  }
}

// Blocks an SM that each kernel's register budget must allow, by head
// dim (python -m omnilingual_asr_torch.ops.flash_bwd_sweep times others).
// K6: four at D 64 keep the training shape's 512 blocks in one wave,
// three at D 128 the 384 of [4, 768, 8, 128]. K7: four at D 64; two at
// D 128, where K and V fragments and the dK and dV accumulators alone
// take 192 registers. The f16 kernels share them: timed on their own on
// an H100 (--f16), they were the fastest there too (at the training
// shape K6 at three blocks took 1.27x as long, K7 at three 1.14x; at
// D 128 K6 at two 1.33x, K7 at one 1.02x).
constexpr int DQ_MIN_BLOCKS_64 = 4;
constexpr int DQ_MIN_BLOCKS_128 = 3;
constexpr int DKV_MIN_BLOCKS_64 = 4;
constexpr int DKV_MIN_BLOCKS_128 = 2;
// K6.
template <int D, bool F16>
__global__ void __launch_bounds__(
    THREADS, D == 128 ? DQ_MIN_BLOCKS_128 : DQ_MIN_BLOCKS_64)
flash_bwd_dq_kernel(const omni::flash_elem<F16>* __restrict__ q,
                    const omni::flash_elem<F16>* __restrict__ k,
                    const omni::flash_elem<F16>* __restrict__ v,
                    const int* __restrict__ mask,
                    const omni::flash_elem<F16>* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    omni::flash_elem<F16>* __restrict__ dq, int T, int H,
                    float scale) {
  using E = omni::flash_elem<F16>;
  constexpr int TILE = FlashTile<D>::ELEMS;
  constexpr int KD = D / 16;
  constexpr int KS = D == 128 ? 16 : 32;   // keys a step takes
  constexpr int NS = KS / 8;               // 8-key column tiles a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Ks = reinterpret_cast<E*>(smem_raw);         // [2][TILE]
  E* Vs = Ks + 2 * TILE;                             // [2][TILE]
  int* Ms = reinterpret_cast<int*>(Vs + 2 * TILE);      // [2][BR]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.x * BR + warp * 16;   // the warp's first query
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const int* mrow = mask + static_cast<size_t>(b) * T;
  const int n_tiles = (T + BR - 1) / BR;

  // Q and dO (staged in the second K and V buffers), key tile 0, its mask.
  omni::load_tile<D>(Ks + TILE, q + base, ts, blockIdx.x * BR, T, tid);
  omni::load_tile<D>(Vs + TILE, dout + base, ts, blockIdx.x * BR, T, tid);
  omni::load_tile<D>(Ks, k + base, ts, 0, T, tid);
  omni::load_tile<D>(Vs, v + base, ts, 0, T, tid);
  omni::load_words(Ms, mrow, 0, T, tid, 0);
  omni::cp_async_commit();
  omni::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4], dof[KD][4];
  omni::load_a_frags<D>(qf, Ks + TILE, warp * 16, lane);
  omni::load_a_frags<D>(dof, Vs + TILE, warp * 16, lane);
  __syncthreads();                  // the second buffers are free for tile 1

  float rl[2], rd[2];               // lse and delta of rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + 8 * r;
    const size_t at = static_cast<size_t>(bh) * T + qi;
    rl[r] = qi < T ? lse[at] : omni::FULLY_MASKED_LSE;
    rd[r] = qi < T ? delta[at] : 0.f;
  }
  float acc[2 * KD][4];             // dQ: 8-dim tiles, rows g and g + 8
  zero<2 * KD>(acc);
  int ex[2] = {EXP_START, EXP_START};   // f16: dS exponents of the rows

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int nb = buf ^ 1;
      omni::load_tile<D>(Ks + nb * TILE, k + base, ts, (j + 1) * BR, T, tid);
      omni::load_tile<D>(Vs + nb * TILE, v + base, ts, (j + 1) * BR, T, tid);
      omni::load_words(Ms + nb * BR, mrow, (j + 1) * BR, T, tid, 0);
    }
    omni::cp_async_commit();
    omni::cp_async_wait<1>();       // tile j has landed
    __syncthreads();
    const E* kt = Ks + buf * TILE;
    const E* vt = Vs + buf * TILE;
    const int* mt = Ms + buf * BR;

#pragma unroll
    for (int k0 = 0; k0 < BR; k0 += KS) {
      // S = Q K^T and dP = dO V^T for the warp's 16 rows x KS keys.
      float s[NS][4], dp[NS][4];
      zero<NS>(s);
      zero<NS>(dp);
      omni::mma_a_rows<D, NS>(s, qf, kt, k0, lane);
      omni::mma_a_rows<D, NS>(dp, dof, vt, k0, lane);
      // dS = P (dP - delta), P = exp(S scale - lse) on valid keys; in S.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int2 mk =
            *reinterpret_cast<const int2*>(mt + k0 + n * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = (e & 1 ? mk.y : mk.x) > 0;
          const float p = valid ? expf(s[n][e] * scale - rl[e >> 1]) : 0.f;
          s[n][e] = p * (dp[n][e] - rd[e >> 1]);
        }
      }
      // dQ += dS K, 16 keys a k-step: dS = hi + lo in bf16, or at f16 in
      // f16 under the rows' exponents.
      float sc[2];
      if constexpr (F16) track_exponents<NS, 2 * KD>(s, ex, acc, sc);
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t hi[4], lo[4];
        if constexpr (F16) {
          omni::split_a_frag_f16(s + 2 * kk, sc, hi, lo);
          omni::mma_pair_cols<D>(acc, hi, lo, kt, k0 + 16 * kk, lane);
        } else {
          omni::split_a_frag(s + 2 * kk, hi, lo);
          omni::mma_split_cols<D>(acc, hi, lo, kt, k0 + 16 * kk, lane);
        }
      }
    }
    __syncthreads();                // buffer `buf` is refilled next round
  }
  float mul[2] = {scale, scale};
  if constexpr (F16) {
    mul[0] *= exp2i(-ex[0]);
    mul[1] *= exp2i(-ex[1]);
  }
  store_rows<D>(dq + base + static_cast<size_t>(row0) * ts, acc, mul, ts,
                row0, T, lane);
}

// K7.
template <int D, bool F16>
__global__ void __launch_bounds__(
    THREADS, D == 128 ? DKV_MIN_BLOCKS_128 : DKV_MIN_BLOCKS_64)
flash_bwd_dkv_kernel(const omni::flash_elem<F16>* __restrict__ q,
                     const omni::flash_elem<F16>* __restrict__ k,
                     const omni::flash_elem<F16>* __restrict__ v,
                     const int* __restrict__ mask,
                     const omni::flash_elem<F16>* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     omni::flash_elem<F16>* __restrict__ dk,
                     omni::flash_elem<F16>* __restrict__ dv, int T, int H,
                     float scale) {
  using E = omni::flash_elem<F16>;
  constexpr int TILE = FlashTile<D>::ELEMS;
  constexpr int KD = D / 16;
  constexpr int QS = 16;                   // queries a step takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);         // [2][TILE]
  E* Os = Qs + 2 * TILE;                             // dO, [2][TILE]
  float* Ls = reinterpret_cast<float*>(Os + 2 * TILE);  // lse, [2][BR]
  float* Ds = Ls + 2 * BR;                              // delta, [2][BR]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.x * BR + warp * 16;   // the warp's first key
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const float* lrow = lse + static_cast<size_t>(bh) * T;
  const float* drow = delta + static_cast<size_t>(bh) * T;
  const int n_tiles = (T + BR - 1) / BR;

  // K and V (staged in the second Q and dO buffers), query tile 0 with its
  // lse and delta; queries past T get lse +1e30, so p = 0 there.
  omni::load_tile<D>(Qs + TILE, k + base, ts, blockIdx.x * BR, T, tid);
  omni::load_tile<D>(Os + TILE, v + base, ts, blockIdx.x * BR, T, tid);
  omni::load_tile<D>(Qs, q + base, ts, 0, T, tid);
  omni::load_tile<D>(Os, dout + base, ts, 0, T, tid);
  omni::load_words(Ls, lrow, 0, T, tid, omni::FULLY_MASKED_LSE);
  omni::load_words(Ds, drow, 0, T, tid, 0.f);
  omni::cp_async_commit();
  omni::cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[KD][4], vf[KD][4];
  omni::load_a_frags<D>(kf, Qs + TILE, warp * 16, lane);
  omni::load_a_frags<D>(vf, Os + TILE, warp * 16, lane);
  __syncthreads();                  // the second buffers are free for tile 1

  bool kvalid[2];                   // keys g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = row0 + g + 8 * r;
    kvalid[r] = ki < T && mask[static_cast<size_t>(b) * T + ki] > 0;
  }
  float dka[2 * KD][4], dva[2 * KD][4];   // 8-dim tiles, keys g and g + 8
  zero<2 * KD>(dka);
  zero<2 * KD>(dva);
  int ex[2] = {EXP_START, EXP_START};   // f16: dS exponents of the keys

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int nb = buf ^ 1;
      const int t0 = (j + 1) * BR;
      omni::load_tile<D>(Qs + nb * TILE, q + base, ts, t0, T, tid);
      omni::load_tile<D>(Os + nb * TILE, dout + base, ts, t0, T, tid);
      omni::load_words(Ls + nb * BR, lrow, t0, T, tid,
                       omni::FULLY_MASKED_LSE);
      omni::load_words(Ds + nb * BR, drow, t0, T, tid, 0.f);
    }
    omni::cp_async_commit();
    omni::cp_async_wait<1>();       // tile j has landed
    __syncthreads();
    const E* qt = Qs + buf * TILE;
    const E* ot = Os + buf * TILE;
    const float* lt = Ls + buf * BR;
    const float* dt = Ds + buf * BR;

#pragma unroll
    for (int i0 = 0; i0 < BR; i0 += QS) {
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 16 queries.
      float st[2][4], dpt[2][4];
      zero<2>(st);
      zero<2>(dpt);
      omni::mma_a_rows<D, 2>(st, kf, qt, i0, lane);
      omni::mma_a_rows<D, 2>(dpt, vf, ot, i0, lane);
      // P^T in st, dS^T in dpt; lse and delta per column (query).
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = i0 + n * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = e & 1 ? l2.y : l2.x;
          const float dl = e & 1 ? d2.y : d2.x;
          const float p = kvalid[e >> 1] ? expf(st[n][e] * scale - lq) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl);
        }
      }
      // dV += P^T dO, dK += dS^T Q; P and dS = hi + lo in bf16, or at f16
      // in f16, P times 2^P_EXP and dS under the key rows' exponents.
      uint32_t hi[4], lo[4];
      if constexpr (F16) {
        const float ps[2] = {exp2i(P_EXP), exp2i(P_EXP)};
        omni::split_a_frag_f16(st, ps, hi, lo);
        omni::mma_pair_cols<D>(dva, hi, lo, ot, i0, lane);
        float sc[2];
        track_exponents<2, 2 * KD>(dpt, ex, dka, sc);
        omni::split_a_frag_f16(dpt, sc, hi, lo);
        omni::mma_pair_cols<D>(dka, hi, lo, qt, i0, lane);
      } else {
        omni::split_a_frag(st, hi, lo);
        omni::mma_split_cols<D>(dva, hi, lo, ot, i0, lane);
        omni::split_a_frag(dpt, hi, lo);
        omni::mma_split_cols<D>(dka, hi, lo, qt, i0, lane);
      }
    }
    __syncthreads();                // buffer `buf` is refilled next round
  }
  const size_t at = base + static_cast<size_t>(row0) * ts;
  float kmul[2] = {scale, scale}, vmul[2] = {1.f, 1.f};
  if constexpr (F16) {
    kmul[0] *= exp2i(-ex[0]);
    kmul[1] *= exp2i(-ex[1]);
    vmul[0] = vmul[1] = exp2i(-P_EXP);
  }
  store_rows<D>(dk + at, dka, kmul, ts, row0, T, lane);
  store_rows<D>(dv + at, dva, vmul, ts, row0, T, lane);
}

template <int D, bool F16>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const int* mask, const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int B, int T, int H, float scale,
                       cudaStream_t stream) {
  using E = omni::flash_elem<F16>;
  const dim3 grid((T + BR - 1) / BR, B * H);
  const E* qb = static_cast<const E*>(q);
  const E* kb = static_cast<const E*>(k);
  const E* vb = static_cast<const E*>(v);
  const E* ob = static_cast<const E*>(dout);
  cudaError_t err;
  if (dq != nullptr) {
    const size_t smem = FlashTile<D>::bytes(1);
    err = omni::allow_smem(flash_bwd_dq_kernel<D, F16>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D, F16><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, mask, ob, lse, delta, static_cast<E*>(dq), T, H, scale);
  } else {
    const size_t smem = FlashTile<D>::bytes(2);
    err = omni::allow_smem(flash_bwd_dkv_kernel<D, F16>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D, F16><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, mask, ob, lse, delta, static_cast<E*>(dk),
        static_cast<E*>(dv), T, H, scale);
  }
  return cudaGetLastError();
}

template <bool F16>
int dispatch(const void* q, const void* k, const void* v, const int* mask,
             const void* dout, const float* lse, const float* delta,
             void* dq, void* dk, void* dv, int B, int T, int H, int head_dim,
             float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_bwd<64, F16>(
          q, k, v, mask, dout, lse, delta, dq, dk, dv, B, T, H, scale, s));
    case 128:
      return static_cast<int>(launch_bwd<128, F16>(
          q, k, v, mask, dout, lse, delta, dq, dk, dv, B, T, H, scale, s));
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
  return dispatch<false>(q, k, v, mask, dout, lse, delta, dq, nullptr,
                         nullptr, B, T, H, head_dim, scale, stream);
}

OMNI_API int omni_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const int* mask, const void* dout,
                                const float* lse, const float* delta,
                                void* dk, void* dv, int B, int T, int H,
                                int head_dim, float scale, void* stream) {
  if (dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B,
                         T, H, head_dim, scale, stream);
}

// K6 and K7 at f16: the same arguments over f16 q, k, v, dO and outputs.
OMNI_API int omni_flash_bwd_dq_f16(const void* q, const void* k,
                                   const void* v, const int* mask,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, int B, int T,
                                   int H, int head_dim, float scale,
                                   void* stream) {
  if (dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, mask, dout, lse, delta, dq, nullptr,
                        nullptr, B, T, H, head_dim, scale, stream);
}

OMNI_API int omni_flash_bwd_dkv_f16(const void* q, const void* k,
                                    const void* v, const int* mask,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dk, void* dv,
                                    int B, int T, int H, int head_dim,
                                    float scale, void* stream) {
  if (dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B,
                        T, H, head_dim, scale, stream);
}
