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
// The forward (K2 at f32). What bounds it on an H100: it computes every
// product as an FMA on the CUDA cores, at 67 TFLOP/s. At the training
// shape [16, 256, 8, 64] it does 4 B H T T_valid D operations (2.1 GFLOP,
// 32 us) against 8.4 MB of q/k/v/o (2.5 us): operations bound it by far.
// Design (simple and right first; a tensor-core design is later work): one
// block of 256 threads per (64-row tile, b*h). The block's query rows and
// each streamed 64-key tile sit in shared memory as f32 rows padded by one
// word, so that 16 threads reading 16 rows at one column hit 16 banks.
// Thread (ty, tx) = (tid / 16, tid % 16) computes a 4 x 4 block of the
// 64 x 64 score tile, rows 4 ty .. 4 ty + 3 and columns tx + 16 c, as FMAs
// over D from shared memory; the 16 threads of a row are 16 lanes of one
// warp, so the row max and sum take four shuffles. P V reads the 64 x 64
// tile of p back from shared memory, each thread accumulating its 4 rows x
// D / 16 columns (tx + 16 c) in registers. Shared memory 66.8 KB at D 64,
// 116 KB at D 128.
//
// The backward (K6 and K7 at f32), on TF32 tensor cores. What bounds it:
// one TF32 product keeps 10 mantissa bits, so each f32 product is taken as
// three (3xTF32: a = a_hi + a_lo, b likewise, a b ~ a_hi b_lo + a_lo b_hi +
// a_hi b_hi, mma.cuh::split_tf32), ~2^-21 of |a b| where f32 gives 2^-24,
// at three times the tensor-core work: 3 x 6 (dQ) and 3 x 8 (dK, dV)
// B H T T_valid D operations at 495 TFLOP/s, 16 and 21 us at the training
// shape, against 42 and 50 MB of f32 operands (12.5 and 15 us at 3.35
// TB/s): operations bound both, barely.
//
// Design (FlashAttention-2's backward, as the bf16 K6 and K7 of
// attention_bwd.cu, on mma.sync.m16n8k8 tf32): K6 is one block of 4 warps
// per (64-query tile, b*h); each warp owns 16 query rows with their lse
// and delta. The block's Q and dO rows sit in shared memory as raw f32;
// K and V stream through it in tiles of DQ_TILE keys. A tile lands by
// cp.async in a raw staging area while the block computes on the one
// before; then the block splits it once (split_tile) into (hi, lo) pairs,
// so that no warp splits a streamed value itself. For each step of
// DQ_STEP keys a warp computes S = Q K^T and dP = dO V^T (splitting its
// Q and dO fragments as it loads them), P and dS = P (dP - delta) in
// registers, and adds dS K to its dQ accumulators. K7 is the mirror: the
// block owns 64 keys (K and V raw in shared memory), and Q, dO, lse and
// delta stream; per step S^T = K Q^T, dP^T = V dO^T, P^T and dS^T with
// lse and delta by column, then dV += P^T dO and dK += dS^T Q. Each block
// owns its output rows: no atomics, the same result on every run. dQ and
// dK times scale once, at the end. Where the design meets the card:
//   1. tf32's C fragment (row g, cols 2t, 2t+1) is not its A fragment (row
//      g, cols t, t+4), so P and dS could not feed the next product from
//      the accumulators as at bf16. The contraction order is free, so
//      every product takes its 8-wide k-step in the order kappa t <- 2t,
//      kappa t + 4 <- 2t + 1 (in A and B alike): a C fragment is then an A
//      fragment as it stands (a_from_c), and a lane's two values of a row
//      are adjacent (one 8- or 16-byte load).
//   2. ldmatrix has no 32-bit transpose, so fragments are plain shared
//      loads, along rows (S, dP: A and B) and down columns (the B of dS K,
//      P^T dO, dS^T Q). One XOR swizzle of 16-byte chunks (sw) makes both
//      conflict-free on raw and on split tiles without padding, and keeps
//      cp.async's chunks whole.
//   3. At D 128 the dK and dV accumulators take 128 registers a thread,
//      so K7 takes 8 queries a step there (DKV_STEP_128) and 16-row
//      streamed tiles keep two blocks an SM within shared memory. At D 64
//      a grid that cannot give every SM two blocks (a serving batch, a
//      model shard's heads) runs the FEW choices: 64-row tiles, one block
//      an SM, half the barriers and splits a key.
//      ops/flash_bwd_sweep.py timed the alternatives (PERF.md), among them
//      D's output columns split over blocks that each recompute S and dP,
//      and a block's warps splitting each tile: both slower.
//   4. Masks stay exact: a masked key has p = 0 and a fully-masked query
//      row (lse +1e30) p = 2^-huge = 0, and hi = lo = 0 for 0, so their
//      dK, dV and dQ are exactly 0; rows past T are zero-filled, count as
//      masked (queries past T read lse +1e30) and are not stored. Work
//      that adds exactly nothing is skipped: K6 neither splits nor
//      computes a key tile with no valid key, and a K7 block none of
//      whose keys is valid stores zeros without a tile (a padded batch
//      row and keys past a short row's length: two fifths of the
//      serving batch's key tiles).
//   5. No atomics: each block writes only its own rows.
//   6. The tensor cores truncate the f32 sum inside a product, so a chain
//      of at most two 8-wide steps of a contraction sums into a fragment
//      started at 0, added to its accumulator in f32 (add_parts). Chains
//      over a whole contraction read 1.5e-5 of the largest dK at the
//      training shape, over the 1e-5 gate: on its row of one valid key
//      dP - delta cancels, and dP's truncation stands out.
//   7. Issue slots: an address computed through the swizzle at every load,
//      and cvt.rna with its Inf and NaN guard, would cost several
//      instructions a product each. Every fragment load is a lane offset
//      (Lane) plus a constant, the split two integer operations a value
//      (mma.cuh::tf32_round), p = 2^(s scale log2 e - lse log2 e).
// Shared memory: 80.1 KB (dQ) and 80.3 KB (dK/dV) at D 64 (32-row
// tiles; 128.3 and 128.5 KB for the FEW 64-row tiles), 112.1 KB each at
// D 128 (16-row tiles), above 48 KB by cudaFuncSetAttribute.
#include "mma.cuh"

namespace {

constexpr int R = 64;            // rows a block owns; rows a tile streams
constexpr int THREADS = 256;     // 16 x 16 threads, each 4 x 4 of a tile
constexpr int PLD = R + 1;       // row stride of a p / ds tile in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float FULLY_MASKED_LSE = 1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// K6 and K7 at f32 on TF32 tensor cores (3xTF32 mma.sync)
// ---------------------------------------------------------------------------

// The backward's tile and launch-bound choices, by head dim: rows of a
// streamed tile (keys for dQ, queries for dK/dV), rows a step of the
// score products takes, and the minimum blocks an SM in __launch_bounds__.
// At D 64 a grid too small to give every SM MIN_BLOCKS blocks (a serving
// batch: 192 blocks on 132 SMs) takes the FEW choices instead: 64-row
// tiles and one block an SM, so that each block's own chain of tiles is
// shorter and holds more registers. python -m
// omnilingual_asr_torch.ops.flash_bwd_sweep times others.
constexpr int DQ_TILE_64 = 32;
constexpr int DQ_STEP_64 = 32;
constexpr int DQ_MIN_BLOCKS_64 = 2;
constexpr int DQ_FEW_TILE_64 = 64;
constexpr int DQ_FEW_STEP_64 = 32;
constexpr int DQ_FEW_MIN_BLOCKS_64 = 1;
constexpr int DQ_TILE_128 = 16;
constexpr int DQ_STEP_128 = 16;
constexpr int DQ_MIN_BLOCKS_128 = 2;
constexpr int DKV_TILE_64 = 32;
constexpr int DKV_STEP_64 = 16;
constexpr int DKV_MIN_BLOCKS_64 = 2;
constexpr int DKV_FEW_TILE_64 = 64;
constexpr int DKV_FEW_STEP_64 = 16;
constexpr int DKV_FEW_MIN_BLOCKS_64 = 1;
constexpr int DKV_TILE_128 = 16;
constexpr int DKV_STEP_128 = 8;
constexpr int DKV_MIN_BLOCKS_128 = 2;

constexpr int TF_THREADS = 128;   // 4 warps, 16 of the block's rows each

template <int D, bool FEW>
struct Bwd {
  static_assert(D == 64 || !FEW, "the FEW choices are D 64's");
  static constexpr int DQ_TILE =
      D == 128 ? DQ_TILE_128 : FEW ? DQ_FEW_TILE_64 : DQ_TILE_64;
  static constexpr int DQ_STEP =
      D == 128 ? DQ_STEP_128 : FEW ? DQ_FEW_STEP_64 : DQ_STEP_64;
  static constexpr int DQ_BLOCKS =
      D == 128 ? DQ_MIN_BLOCKS_128
               : FEW ? DQ_FEW_MIN_BLOCKS_64 : DQ_MIN_BLOCKS_64;
  static constexpr int DKV_TILE =
      D == 128 ? DKV_TILE_128 : FEW ? DKV_FEW_TILE_64 : DKV_TILE_64;
  static constexpr int DKV_STEP =
      D == 128 ? DKV_STEP_128 : FEW ? DKV_FEW_STEP_64 : DKV_STEP_64;
  static constexpr int DKV_BLOCKS =
      D == 128 ? DKV_MIN_BLOCKS_128
               : FEW ? DKV_FEW_MIN_BLOCKS_64 : DKV_MIN_BLOCKS_64;
  // Dynamic shared memory: the block's two operands (64 raw rows), the
  // two streamed operands' raw staging and split tiles (`tile` rows each;
  // a split row is 2 D words) and `words` rows of 4-byte values (mask;
  // lse and delta).
  static constexpr size_t bytes(int tile, int words) {
    return (2 * R * D + 6 * tile * D + words * tile) * 4;
  }
};

// Word (r, c) of a tile of rows of W words in shared memory. Bits 3 and 4
// of each row's word index are XORed with bits of r (r1; r0 ^ r2), so
// that the fragment loads hit distinct banks: 8-byte loads along raw f32
// rows (W = D; a lane of group g and index t reads words c0 + 2t, +1 of
// row r0 + g: each half warp 16 distinct bank pairs), and on split rows
// (W = 2 D, an (hi, lo) pair a value) 16-byte loads along rows (a quarter
// warp 8 distinct 16-byte bank groups) and 8-byte loads down columns (the
// pair of column c0 + g of rows r0 + 2t + e: each half warp 16 distinct
// bank pairs). 16-byte chunks stay whole, so cp.async fills a raw tile in
// place.
__device__ __forceinline__ int swz(int r) {
  return ((r & 2) << 2) ^ (((r ^ (r >> 2)) & 1) << 4);
}

template <int W>
__device__ __forceinline__ int sw(int r, int c) {
  return r * W + (c ^ swz(r));
}

// Rows t0 .. t0 + ROWS (t0 < T) of one head of an f32 [B, T, H, D] operand
// (src at the head's row 0, frame stride ts) into shared memory by
// cp.async, rows at or past T zero-filled: a swizzled raw tile (SW), or a
// dense staging tile (16-byte chunk i at 4 i). Thread tid copies chunks
// tid, tid + TF_THREADS, ..., the ones that split_tile reads back, so a
// thread's own cp.async.wait_group publishes them to it: no barrier
// between the copy and the split.
template <int ROWS, int D, bool SW>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t ts, int t0, int T, int tid) {
  constexpr int CH = D / 4;               // 16-byte chunks a row
  const int valid = T - t0;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += TF_THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    omni::cp_async_16(dst + (SW ? sw<D>(r, c) : 4 * i),
                      src + static_cast<size_t>(t0 + min(r, valid - 1)) * ts +
                          c,
                      r < valid);
  }
}

// A staged tile split once for every warp: each value x as the pair
// (tf32(x), tf32(x - tf32(x))) at words 2 c, 2 c + 1 of a swizzled row of
// 2 D words.
template <int ROWS, int D>
__device__ __forceinline__ void split_tile(uint32_t* split,
                                           const float* stage, int tid) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += TF_THREADS) {
    const float4 x = *reinterpret_cast<const float4*>(stage + 4 * i);
    uint4 a, b;
    omni::split_tf32(x.x, a.x, a.y);
    omni::split_tf32(x.y, a.z, a.w);
    omni::split_tf32(x.z, b.x, b.y);
    omni::split_tf32(x.w, b.z, b.w);
    uint32_t* row = split + sw<2 * D>(i / CH, 2 * (i % CH) * 4);
    *reinterpret_cast<uint4*>(row) = a;
    *reinterpret_cast<uint4*>(row + 4) = b;
  }
}

// The products' contraction index runs over 8 columns (or rows) c0 ..
// c0 + 8 in the order kappa t <- c0 + 2t, kappa t + 4 <- c0 + 2t + 1, in A
// and B alike, so that a lane's two values of a row are adjacent and a C
// fragment (columns 2t, 2t + 1) is an A fragment as it stands.

// Where a lane (lane = 4 g + t) loads its fragments from, as word offsets.
// The swizzle term of a load depends on the lane and on the low bits of
// its step only, so every load is one of these offsets plus a constant
// (and a step's or tile's base): the compiler folds them into the loads.
//   a[v]       raw tile, (row g, column 8 v + 2 t), v = (c0 / 8) % 4; the
//              step c0 adds 32 (c0 / 32), row g + 8 adds 8 D
//   brow[p]    split tile, (row g, column 8 p + 2 t) (its words 2 c, 2 c
//              + 1), p = (c0 / 8) % 2; the step adds 32 (c0 / 16)
//   bcol[e][p] split tile, (row 2 t + e, column 8 p + g); the step adds
//              32 (c0 / 16)
template <int D>
struct Lane {
  int a[4];
  int brow[2];
  int bcol[2][2];

  __device__ __forceinline__ Lane(int g, int t) {
    const int hg = swz(g);
#pragma unroll
    for (int v = 0; v < 4; ++v) a[v] = g * D + ((8 * v) ^ hg) + 2 * t;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      brow[p] = g * 2 * D + 16 * (p ^ (hg >> 4)) + ((4 * t) ^ (hg & 8));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int he = swz(2 * t + e);
        bcol[e][p] = (2 * t + e) * 2 * D + 16 * (p ^ (he >> 4)) +
                     ((2 * g) ^ (he & 8));
      }
    }
  }
};

// The A fragment of 16 rows over the 8 columns of step v of a raw tile
// (own at the rows' first and the step's 32-column block), split into
// tf32 hi and lo.
template <int D>
__device__ __forceinline__ void a_rows(uint32_t hi[4], uint32_t lo[4],
                                       const float* own, const Lane<D>& L,
                                       int v) {
  const float2 x = *reinterpret_cast<const float2*>(own + L.a[v]);
  const float2 y = *reinterpret_cast<const float2*>(own + L.a[v] + 8 * D);
  omni::split_tf32(x.x, hi[0], lo[0]);
  omni::split_tf32(y.x, hi[1], lo[1]);
  omni::split_tf32(x.y, hi[2], lo[2]);
  omni::split_tf32(y.y, hi[3], lo[3]);
}

// The B fragment whose 8 columns are 8 rows of a split tile (split at the
// first, a row a key for S = Q K^T) and whose contraction runs over 8 of
// its columns (step parity p; split at the step's 16-column block): one
// 16-byte load.
template <int D>
__device__ __forceinline__ void b_rows(uint32_t hi[2], uint32_t lo[2],
                                       const uint32_t* split,
                                       const Lane<D>& L, int p) {
  const uint4 x = *reinterpret_cast<const uint4*>(split + L.brow[p]);
  hi[0] = x.x;
  lo[0] = x.y;
  hi[1] = x.z;
  lo[1] = x.w;
}

// The B fragment whose contraction runs over 8 rows of a split tile (split
// at the first, a row a key for dQ = dS K) and whose 8 columns are 8 of
// its columns (parity p; split at their 16-column block): two 8-byte loads.
template <int D>
__device__ __forceinline__ void b_cols(uint32_t hi[2], uint32_t lo[2],
                                       const uint32_t* split,
                                       const Lane<D>& L, int p) {
  const uint2 x = *reinterpret_cast<const uint2*>(split + L.bcol[0][p]);
  const uint2 y = *reinterpret_cast<const uint2*>(split + L.bcol[1][p]);
  hi[0] = x.x;
  lo[0] = x.y;
  hi[1] = y.x;
  lo[1] = y.y;
}

// A C fragment (16 rows x 8 columns) as the A fragment over those columns,
// split: a0 = c0 (row g, kappa t), a1 = c2, a2 = c1 (kappa t + 4), a3 = c3.
__device__ __forceinline__ void a_from_c(const float c[4], uint32_t hi[4],
                                         uint32_t lo[4]) {
  omni::split_tf32(c[0], hi[0], lo[0]);
  omni::split_tf32(c[2], hi[1], lo[1]);
  omni::split_tf32(c[1], hi[2], lo[2]);
  omni::split_tf32(c[3], hi[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// part[n] (+)= A B[n] for n < N, each as three tf32 products, A = ah + al
// and B[n] = bh[n] + bl[n]: ah bl, then al bh, then ah bh (the small
// terms first); `first` starts part at 0. Each pass runs over every n, so
// that its N products are independent and their latencies overlap.
template <int N>
__device__ __forceinline__ void mma3(float (*part)[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     uint32_t (*bh)[2], uint32_t (*bl)[2],
                                     bool first) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (first)
      omni::mma_tf32_1688_zero(part[n], ah, bl[n][0], bl[n][1]);
    else
      omni::mma_tf32_1688(part[n], ah, bl[n][0], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    omni::mma_tf32_1688(part[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    omni::mma_tf32_1688(part[n], ah, bh[n][0], bh[n][1]);
}

// acc[n] += part[n] for n < N, in f32: the tensor cores truncate the f32
// sum inside a product, so a long chain of products into acc itself
// would gather that truncation, an ulp of acc a product (note 6).
template <int N>
__device__ __forceinline__ void add_parts(float (*acc)[4],
                                          float (*part)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// x[n] += A B over D and y[n] += A' B' (n < NS) for 16 rows of two raw
// tiles (A, A': own_x, own_y at the rows' first) and 8 NS rows of two
// split tiles (B^T, B'^T: split_x, split_y at the first): S = Q K^T with
// dP = dO V^T, and their transposes. The two products' steps interleave,
// two 8-wide steps of D a chain.
template <int D, int NS>
__device__ __forceinline__ void rows_by_rows_tf32(
    float (*x)[4], float (*y)[4], const float* own_x, const float* own_y,
    const uint32_t* split_x, const uint32_t* split_y, const Lane<D>& L) {
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += 32) {
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      float px[NS][4], py[NS][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int v = 2 * pair + u;             // the step's (c0 / 8) % 4
        const int bo = 2 * c0 + 32 * pair;      // its 16-column block
        uint32_t ah[4], al[4], bh[NS][2], bl[NS][2];
        a_rows<D>(ah, al, own_x + c0, L, v);
#pragma unroll
        for (int n = 0; n < NS; ++n)
          b_rows<D>(bh[n], bl[n], split_x + 16 * D * n + bo, L, u);
        mma3<NS>(px, ah, al, bh, bl, u == 0);
        a_rows<D>(ah, al, own_y + c0, L, v);
#pragma unroll
        for (int n = 0; n < NS; ++n)
          b_rows<D>(bh[n], bl[n], split_y + 16 * D * n + bo, L, u);
        mma3<NS>(py, ah, al, bh, bl, u == 0);
      }
      add_parts<NS>(x, px);
      add_parts<NS>(y, py);
    }
  }
}

// acc[j] (j < D / 8) += C B, C one 16 x 8 C fragment (8 rows of the
// contraction: 8 rows of a split tile, split at the first), B all D
// columns of those rows: dQ += dS K, dV += P^T dO, dK += dS^T Q.
template <int D>
__device__ __forceinline__ void c_by_rows_tf32(float (*acc)[4],
                                               const float c[4],
                                               const uint32_t* split,
                                               const Lane<D>& L) {
  uint32_t ah[4], al[4];
  a_from_c(c, ah, al);
#pragma unroll
  for (int j0 = 0; j0 < D / 8; j0 += 4) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b_cols<D>(bh[i], bl[i], split + 16 * (j0 + i - (i & 1)), L, i & 1);
    float part[4][4];
    mma3<4>(part, ah, al, bh, bl, true);
    add_parts<4>(acc + j0, part);
  }
}

// Store a warp's accumulators acc[D / 8] (its rows g and g + 8, times
// mul) that lie below T; dst at the head's row 0, row0 the warp's first.
template <int D>
__device__ __forceinline__ void store_acc(float* dst, float (*acc)[4],
                                          float mul, size_t ts, int row0,
                                          int T, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    float* p = dst + static_cast<size_t>(row) * ts + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) =
          make_float2(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

// K6 at f32: one block of 4 warps per (64-query tile, b*h).
template <int D, bool FEW>
__global__ void __launch_bounds__(TF_THREADS, Bwd<D, FEW>::DQ_BLOCKS)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ mask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int T, int H, float scale) {
  constexpr int BN = Bwd<D, FEW>::DQ_TILE;
  constexpr int KS = Bwd<D, FEW>::DQ_STEP;
  constexpr int NS = KS / 8;
  static_assert(BN % KS == 0 && KS % 8 == 0 && BN <= TF_THREADS,
                "a tile holds whole steps of 8-key columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);         // [R][D]
  float* Gs = Qs + R * D;                                  // dO, [R][D]
  float* Kst = Gs + R * D;                                 // staging [BN][D]
  float* Vst = Kst + BN * D;
  uint32_t* Ksp = reinterpret_cast<uint32_t*>(Vst + BN * D);  // [BN][2D]
  uint32_t* Vsp = Ksp + 2 * BN * D;
  int* Ms = reinterpret_cast<int*>(Vsp + 2 * BN * D);      // [BN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;    // the warp's first row in the block
  const int g = lane >> 2;
  const int tq = lane & 3;
  const Lane<D> L(g, tq);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * R;
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const int* mrow = mask + static_cast<size_t>(b) * T;
  const int n_tiles = (T + BN - 1) / BN;

  load_tile<R, D, true>(Qs, q + base, ts, q0, T, tid);
  load_tile<R, D, true>(Gs, dout + base, ts, q0, T, tid);
  load_tile<BN, D, false>(Kst, k + base, ts, 0, T, tid);
  load_tile<BN, D, false>(Vst, v + base, ts, 0, T, tid);
  omni::cp_async_commit();

  // lse (times log2 e: p = 2^(s scale log2 e - lse log2 e)) and delta of
  // rows g and g + 8.
  const float sl2 = scale * LOG2E;
  float rl[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    const size_t at = static_cast<size_t>(bh) * T + qi;
    rl[r] = (qi < T ? lse[at] : FULLY_MASKED_LSE) * LOG2E;
    rd[r] = qi < T ? delta[at] : 0.f;
  }
  float acc[D / 8][4];              // dQ: 8-column tiles, rows g and g + 8
  zero<D / 8>(acc);

  for (int j = 0; j < n_tiles; ++j) {
    omni::cp_async_wait<0>();       // this thread's chunks of tile j
    int mk = 0;
    if (tid < BN && j * BN + tid < T) mk = mrow[j * BN + tid];
    // Every warp is done with tile j - 1; a tile with no valid key adds
    // exactly nothing (p = 0), so it is neither split nor computed.
    const bool live = __syncthreads_or(mk > 0);
    if (live) {
      split_tile<BN, D>(Ksp, Kst, tid);
      split_tile<BN, D>(Vsp, Vst, tid);
      if (tid < BN) Ms[tid] = mk;
    }
    if (j + 1 < n_tiles) {          // tile j + 1 lands while j computes
      load_tile<BN, D, false>(Kst, k + base, ts, (j + 1) * BN, T, tid);
      load_tile<BN, D, false>(Vst, v + base, ts, (j + 1) * BN, T, tid);
    }
    omni::cp_async_commit();
    if (!live) continue;
    __syncthreads();                // split tile j is whole

#pragma unroll 1
    for (int k0 = 0; k0 < BN; k0 += KS) {
      // S = Q K^T and dP = dO V^T for the warp's 16 rows x KS keys.
      float s[NS][4], dp[NS][4];
      zero<NS>(s);
      zero<NS>(dp);
      rows_by_rows_tf32<D, NS>(s, dp, Qs + wr * D, Gs + wr * D,
                               Ksp + 2 * D * k0, Vsp + 2 * D * k0, L);
      // dS = P (dP - delta), P = exp(S scale - lse) on valid keys; in s.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int2 mk =
            *reinterpret_cast<const int2*>(Ms + k0 + 8 * n + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = (e & 1 ? mk.y : mk.x) > 0;
          const float p =
              valid ? exp2f(fmaf(s[n][e], sl2, -rl[e >> 1])) : 0.f;
          s[n][e] = p * (dp[n][e] - rd[e >> 1]);
        }
      }
      // dQ += dS K, 8 keys a product.
#pragma unroll
      for (int n = 0; n < NS; ++n)
        c_by_rows_tf32<D>(acc, s[n], Ksp + 2 * D * (k0 + 8 * n), L);
    }
  }
  store_acc<D>(dq + base, acc, scale, ts, q0 + wr, T, g, tq);
}

// K7 at f32: one block of 4 warps per (64-key tile, b*h).
template <int D, bool FEW>
__global__ void __launch_bounds__(TF_THREADS, Bwd<D, FEW>::DKV_BLOCKS)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int T, int H, float scale) {
  constexpr int BN = Bwd<D, FEW>::DKV_TILE;
  constexpr int QS = Bwd<D, FEW>::DKV_STEP;
  constexpr int NS = QS / 8;
  static_assert(BN % QS == 0 && QS % 8 == 0 && BN <= TF_THREADS,
                "a tile holds whole steps of 8-query columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);         // [R][D]
  float* Vs = Ks + R * D;                                  // [R][D]
  float* Qst = Vs + R * D;                                 // staging [BN][D]
  float* Ost = Qst + BN * D;                               // dO
  uint32_t* Qsp = reinterpret_cast<uint32_t*>(Ost + BN * D);  // [BN][2D]
  uint32_t* Osp = Qsp + 2 * BN * D;
  float* Ls = reinterpret_cast<float*>(Osp + 2 * BN * D);  // lse [BN]
  float* Ds = Ls + BN;                                     // delta [BN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;    // the warp's first key in the block
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0b = blockIdx.x * R;
  const Lane<D> L(g, tq);
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const float* lrow = lse + static_cast<size_t>(bh) * T;
  const float* drow = delta + static_cast<size_t>(bh) * T;
  const int n_tiles = (T + BN - 1) / BN;
  const float sl2 = scale * LOG2E;    // p = 2^(s scale log2 e - lse log2 e)
  const int* mrow = mask + static_cast<size_t>(b) * T;

  // A block none of whose keys is valid has p = 0 everywhere: its dK and
  // dV are exactly 0, stored without a tile.
  const bool live = __syncthreads_or(tid < R && k0b + tid < T &&
                                     mrow[k0b + tid] > 0);
  if (!live) {
    float zeros[D / 8][4];
    zero<D / 8>(zeros);
    store_acc<D>(dk + base, zeros, 1.f, ts, k0b + wr, T, g, tq);
    store_acc<D>(dv + base, zeros, 1.f, ts, k0b + wr, T, g, tq);
    return;
  }

  load_tile<R, D, true>(Ks, k + base, ts, k0b, T, tid);
  load_tile<R, D, true>(Vs, v + base, ts, k0b, T, tid);
  load_tile<BN, D, false>(Qst, q + base, ts, 0, T, tid);
  load_tile<BN, D, false>(Ost, dout + base, ts, 0, T, tid);
  omni::cp_async_commit();

  bool kvalid[2];                   // keys g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0b + wr + g + 8 * r;
    kvalid[r] = ki < T && mrow[ki] > 0;
  }
  float dka[D / 8][4], dva[D / 8][4];   // 8-column tiles, keys g, g + 8
  zero<D / 8>(dka);
  zero<D / 8>(dva);

  for (int j = 0; j < n_tiles; ++j) {
    omni::cp_async_wait<0>();       // this thread's chunks of tile j
    __syncthreads();                // every warp is done with tile j - 1
    split_tile<BN, D>(Qsp, Qst, tid);
    split_tile<BN, D>(Osp, Ost, tid);
    if (tid < BN) {                 // queries past T: lse +1e30, so p = 0
      const int t = j * BN + tid;
      Ls[tid] = t < T ? lrow[t] : FULLY_MASKED_LSE;
      Ds[tid] = t < T ? drow[t] : 0.f;
    }
    if (j + 1 < n_tiles) {          // tile j + 1 lands while j computes
      load_tile<BN, D, false>(Qst, q + base, ts, (j + 1) * BN, T, tid);
      load_tile<BN, D, false>(Ost, dout + base, ts, (j + 1) * BN, T, tid);
    }
    omni::cp_async_commit();
    __syncthreads();                // split tile j is whole

#pragma unroll 1
    for (int i0 = 0; i0 < BN; i0 += QS) {
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x QS queries.
      float st[NS][4], dpt[NS][4];
      zero<NS>(st);
      zero<NS>(dpt);
      rows_by_rows_tf32<D, NS>(st, dpt, Ks + wr * D, Vs + wr * D,
                               Qsp + 2 * D * i0, Osp + 2 * D * i0, L);
      // P^T in st, dS^T in dpt; lse and delta per column (query).
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int col = i0 + 8 * n + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(Ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(Ds + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = e & 1 ? l2.y : l2.x;
          const float dl = e & 1 ? d2.y : d2.x;
          const float p = kvalid[e >> 1]
                              ? exp2f(fmaf(st[n][e], sl2, -lq * LOG2E))
                              : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl);
        }
      }
      // dV += P^T dO, dK += dS^T Q, 8 queries a product.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int at = 2 * D * (i0 + 8 * n);
        c_by_rows_tf32<D>(dva, st[n], Osp + at, L);
        c_by_rows_tf32<D>(dka, dpt[n], Qsp + at, L);
      }
    }
  }
  store_acc<D>(dk + base, dka, scale, ts, k0b + wr, T, g, tq);
  store_acc<D>(dv + base, dva, 1.f, ts, k0b + wr, T, g, tq);
}

template <int D>
constexpr size_t fwd_smem() {
  return (3 * Rows<D>::ELEMS + R * PLD + R) * 4;
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

template <int D, bool FEW>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const int* mask, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int T, int H,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = Bwd<D, FEW>::bytes(Bwd<D, FEW>::DQ_TILE, 1);
  cudaError_t err =
      omni::allow_smem(flash_bwd_dq_tf32_kernel<D, FEW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B * H);
  flash_bwd_dq_tf32_kernel<D, FEW><<<grid, TF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq), T, H, scale);
  return cudaGetLastError();
}

template <int D, bool FEW>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const int* mask, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int T,
                       int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = Bwd<D, FEW>::bytes(Bwd<D, FEW>::DKV_TILE, 2);
  cudaError_t err =
      omni::allow_smem(flash_bwd_dkv_tf32_kernel<D, FEW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B * H);
  flash_bwd_dkv_tf32_kernel<D, FEW><<<grid, TF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), T, H,
      scale);
  return cudaGetLastError();
}

// Whether a backward grid at D 64 gives some SM fewer than `min_blocks`
// blocks of 64 rows: then the FEW tiles run.
bool few_blocks(int B, int T, int H, int min_blocks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  return static_cast<long>((T + R - 1) / R) * B * H <
         static_cast<long>(min_blocks) * sms;
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
      return static_cast<int>(
          few_blocks(B, T, H, DQ_MIN_BLOCKS_64)
              ? launch_dq<64, true>(q, k, v, mask, dout, lse, delta, dq, B,
                                    T, H, scale, s)
              : launch_dq<64, false>(q, k, v, mask, dout, lse, delta, dq, B,
                                     T, H, scale, s));
    case 128:
      return static_cast<int>(launch_dq<128, false>(
          q, k, v, mask, dout, lse, delta, dq, B, T, H, scale, s));
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
      return static_cast<int>(
          few_blocks(B, T, H, DKV_MIN_BLOCKS_64)
              ? launch_dkv<64, true>(q, k, v, mask, dout, lse, delta, dk, dv,
                                     B, T, H, scale, s)
              : launch_dkv<64, false>(q, k, v, mask, dout, lse, delta, dk,
                                      dv, B, T, H, scale, s));
    case 128:
      return static_cast<int>(launch_dkv<128, false>(
          q, k, v, mask, dout, lse, delta, dk, dv, B, T, H, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
