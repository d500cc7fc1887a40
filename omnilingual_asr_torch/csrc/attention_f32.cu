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
// stored, so T may be any length. q times scale is rounded to f32 before
// its product, as JAX does; dQ and dK are scaled once, at the end.
//
// All three run on TF32 tensor cores (mma.sync.m16n8k8). One TF32 product
// keeps 10 mantissa bits, so each f32 product is taken as three (3xTF32:
// a = a_hi + a_lo, b likewise, a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi,
// mma.cuh::split_tf32), ~2^-21 of |a b| where f32 gives 2^-24, at three
// times the tensor-core work. What bounds them on an H100, at the training
// shape [16, 256, 8, 64] (H T D times the valid keys = 0.44 G):
//   forward   3 x 4 H T D T_valid operations at 495 TFLOP/s, 10.6 us,
//             against 33.7 MB of q, k, v, o and lse (10.1 us at 3.35 TB/s);
//   dQ, dK/dV 3 x 6 and 3 x 8 H T D T_valid operations, 16 and 21 us,
//             against 42 and 50 MB of f32 operands (12.5 and 15 us):
// operations bound all three, the forward barely. Beside every three MMAs
// a warp loads and splits operands and sums chains; what that costs the
// forward is below.
//
// The forward (K2; FlashAttention-2's forward on the backward's pieces):
// one block per (query tile, b*h), of 4 warps (8 for the FEW choices,
// below). The block's Q rows, times
// scale, sit raw in shared memory, and a warp splits its Q fragments as
// it loads them. K and V stream in tiles of FWD_TILE keys by cp.async into
// raw staging while the block computes on the tile before, and are split
// once a tile (split_tile). Per step of FWD_STEP keys a warp computes
// S = Q K^T, then the online softmax in f32 on the C fragments (a lane
// holds rows g and g + 8: the row max and sum over its quad take two
// shuffles; p = 2^(s log2 e - m log2 e) on valid keys, 0 on masked ones;
// O and l times alpha = 2^((m_old - m_new) log2 e), skipped while no row
// of the tile has a new max), and adds P V with P's C fragments as the A
// fragments of the product (a_from_c, note 1): no P tile goes through
// shared memory. A key tile with no valid key is neither loaded, split
// nor computed, tested on the mask itself (a padded batch row runs no
// tile and stores o = 0, lse = +1e30). What the card meets first is
// shared-memory traffic and latency more than the tensor cores. Counted
// from the code, a warp step of 32 keys over 16 rows moves ~52 KB through
// shared memory (K's and V's split fragments, Q, the split pass) for 192
// MMAs. So at D 64, where the grid fills the card, each warp owns two
// tiles of 16 rows (FWD_MTILES_64; 128-row blocks) and every K and V
// fragment it loads serves both. A grid too small to give every SM
// FWD_MIN_BLOCKS_64 blocks of 64 rows (a serving batch, a model shard's
// heads, a short T) is bound by one block's chain of steps: it runs the
// FEW choices, 64-row blocks of 8 warps, the two groups of 4 taking
// alternate steps of each 128-key tile, merged once at the end through
// shared memory. At D 128 O takes 64 registers a row tile, so a warp owns
// 16 rows. ops/k2_f32_parts.py times the kernel with each part taken out
// (PERF.md): without two of each three products the training shape runs
// about a third faster, the serving batch less than a tenth.
//
// The backward (K6 and K7; FlashAttention-2's backward, as the bf16 K6 and
// K7 of attention_bwd.cu): K6 is one block of 4 warps per (64-query tile,
// b*h); each warp owns 16 query rows with their lse and delta. The block's
// Q and dO rows sit in shared memory as raw f32; K and V stream through it
// as the forward's do, in tiles of DQ_TILE keys. For each step of DQ_STEP
// keys a warp computes S = Q K^T and dP = dO V^T (splitting its Q and dO
// fragments as it loads them), P and dS = P (dP - delta) in registers, and
// adds dS K to its dQ accumulators. K7 is the mirror: the block owns 64
// keys (K and V raw in shared memory), and Q, dO, lse and delta stream;
// per step S^T = K Q^T, dP^T = V dO^T, P^T and dS^T with lse and delta by
// column, then dV += P^T dO and dK += dS^T Q. Each block owns its output
// rows: no atomics, the same result on every run. Where the designs meet
// the card:
//   1. tf32's C fragment (row g, cols 2t, 2t+1) is not its A fragment (row
//      g, cols t, t+4), so P and dS could not feed the next product from
//      the accumulators as at bf16. The contraction order is free, so
//      every product takes its 8-wide k-step in the order kappa t <- 2t,
//      kappa t + 4 <- 2t + 1 (in A and B alike): a C fragment is then an A
//      fragment as it stands (a_from_c), and a lane's two values of a row
//      are adjacent (one 8- or 16-byte load).
//   2. ldmatrix has no 32-bit transpose, so fragments are plain shared
//      loads, along rows (S, dP: A and B) and down columns (the B of P V,
//      dS K, P^T dO, dS^T Q). One XOR swizzle of 16-byte chunks (sw) makes
//      both conflict-free on raw and on split tiles without padding, and
//      keeps cp.async's chunks whole.
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
//      o, dK, dV and dQ are exactly 0; rows past T are zero-filled, count
//      as masked (queries past T read lse +1e30) and are not stored. Work
//      that adds exactly nothing is skipped: the forward and K6 neither
//      split nor compute a key tile with no valid key, and a K7 block none
//      of whose keys is valid stores zeros without a tile (a padded batch
//      row and keys past a short row's length: two fifths of the serving
//      batch's key tiles).
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
// Shared memory: the forward 80.1 KB at D 64 (128 rows, 32-key tiles;
// 208.5 KB for the FEW 64 rows and 128-key tiles), 80.1 KB at D 128
// (16-key tiles); dQ 80.1 KB and dK/dV 80.3 KB at D 64 (32-row tiles;
// 128.3 and 128.5 KB for the FEW 64-row tiles), 112.1 KB each at D 128
// (16-row tiles); above 48 KB by cudaFuncSetAttribute.
#include "mma.cuh"

namespace {

constexpr int R = 64;            // rows a backward block owns
constexpr float NEG_INF = -1e30f;
constexpr float FULLY_MASKED_LSE = 1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by one MUFU.EX2 (~2 ulp, as exp2f; results below 2^-126 flush to
// 0, which no sum here can see). exp2f adds a scaling for such results.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward's tile and launch-bound choices, by head dim: keys of a
// streamed tile, keys a step of a warp takes, the minimum blocks an SM in
// __launch_bounds__, the groups of 4 warps that split each tile's steps
// over the same rows (1 or 2), the tiles of 16 query rows a warp owns
// (FWD_MTILES_*: 1 or 2, so a block owns 64 or 128 rows; each K and V
// fragment a warp loads serves all its row tiles). A grid too small to
// give every SM MIN_BLOCKS blocks of 64 rows takes the FEW choices.
constexpr int FWD_TILE_64 = 32;
constexpr int FWD_STEP_64 = 16;
constexpr int FWD_MIN_BLOCKS_64 = 2;
constexpr int FWD_SPLIT_64 = 1;
constexpr int FWD_MTILES_64 = 2;
constexpr int FWD_FEW_TILE_64 = 128;
constexpr int FWD_FEW_STEP_64 = 16;
constexpr int FWD_FEW_MIN_BLOCKS_64 = 1;
constexpr int FWD_FEW_SPLIT_64 = 2;
constexpr int FWD_FEW_MTILES_64 = 1;
constexpr int FWD_TILE_128 = 16;
constexpr int FWD_STEP_128 = 16;
constexpr int FWD_MIN_BLOCKS_128 = 2;
constexpr int FWD_SPLIT_128 = 1;
constexpr int FWD_MTILES_128 = 1;

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

template <int D, bool FEW>
struct Fwd {
  static_assert(D == 64 || !FEW, "the FEW choices are D 64's");
  static constexpr int TILE =
      D == 128 ? FWD_TILE_128 : FEW ? FWD_FEW_TILE_64 : FWD_TILE_64;
  static constexpr int STEP =
      D == 128 ? FWD_STEP_128 : FEW ? FWD_FEW_STEP_64 : FWD_STEP_64;
  static constexpr int BLOCKS =
      D == 128 ? FWD_MIN_BLOCKS_128
               : FEW ? FWD_FEW_MIN_BLOCKS_64 : FWD_MIN_BLOCKS_64;
  static constexpr int SPLIT =
      D == 128 ? FWD_SPLIT_128 : FEW ? FWD_FEW_SPLIT_64 : FWD_SPLIT_64;
  static constexpr int MTILES =
      D == 128 ? FWD_MTILES_128 : FEW ? FWD_FEW_MTILES_64 : FWD_MTILES_64;
  static constexpr int ROWS = 64 * MTILES;         // rows a block owns
  static constexpr int THREADS = TF_THREADS * SPLIT;
  // What group 1 hands to group 0 at the end, in words: each warp's O
  // (D / 8 fragments of 4 values a lane a row tile), then m and l of its
  // rows.
  static constexpr int MERGE =
      4 * MTILES * ((D / 8) * 4 * 32 + 2 * 2 * 32);
  static_assert(SPLIT == 1 || SPLIT == 2, "one or two groups of 4 warps");
  static_assert(MTILES == 1 || MTILES == 2, "16 or 32 rows a warp");
  static_assert(TILE % (SPLIT * STEP) == 0 && STEP % 16 == 0 &&
                    TILE <= THREADS,
                "a tile holds whole steps of 16 keys for every group");
  static_assert(SPLIT == 1 || MERGE <= 6 * TILE * D,
                "the merge fits the streamed tiles' area");
  // Dynamic shared memory: Q (ROWS raw rows), K's and V's raw staging
  // and split tiles, the tile's key mask.
  static constexpr size_t bytes() {
    return (ROWS * D + 6 * TILE * D + TILE) * 4;
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
// dense staging tile (16-byte chunk i at 4 i). Thread tid of NT copies
// chunks tid, tid + NT, ..., the ones that split_tile (and scale_tile)
// read back, so a thread's own cp.async.wait_group publishes them to it:
// no barrier between the copy and the split.
template <int ROWS, int D, bool SW, int NT = TF_THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t ts, int t0, int T, int tid) {
  constexpr int CH = D / 4;               // 16-byte chunks a row
  const int valid = T - t0;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NT) {
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
// 2 D words. Thread tid of NT splits the chunks it copied.
template <int ROWS, int D, int NT = TF_THREADS>
__device__ __forceinline__ void split_tile(uint32_t* split,
                                           const float* stage, int tid) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NT) {
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

// A raw swizzled tile of ROWS rows times mul, in place; thread tid of NT
// scales the chunks it copied (load_tile), after its own wait.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void scale_tile(float* tile, float mul, int tid) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NT) {
    float4* p = reinterpret_cast<float4*>(tile + sw<D>(i / CH, (i % CH) * 4));
    float4 x = *p;
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *p = x;
  }
}

// The A fragments of 16 query rows (own at the first, raw in shared
// memory) over the 8-wide step kk of D, split as they are loaded.
template <int D>
struct QFrags {
  const float* own;
  uint32_t hi[4], lo[4];

  __device__ __forceinline__ void load(int kk, const Lane<D>& L) {
    a_rows<D>(hi, lo, own + 32 * (kk / 4), L, kk % 4);
  }
};

// s[mt][n] = Q K^T (n < NS) for a warp's MT tiles of 16 rows (q[mt]) and
// 8 NS keys of a split K tile (split at the step's first key), over D in
// chains of two 8-wide steps. Each B fragment serves all MT tiles.
template <int D, int NS, int MT>
__device__ __forceinline__ void scores_tf32(float (*s)[NS][4], QFrags<D>* q,
                                            const uint32_t* split,
                                            const Lane<D>& L) {
#pragma unroll
  for (int kk = 0; kk < D / 8; kk += 2) {
    float part[MT][NS][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t bh[NS][2], bl[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        b_rows<D>(bh[n], bl[n], split + 16 * D * n + 16 * kk, L, u);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        q[mt].load(kk + u, L);
        // The first chain is s itself.
        mma3<NS>(kk == 0 ? s[mt] : part[mt], q[mt].hi, q[mt].lo, bh, bl,
                 u == 0);
      }
    }
    if (kk > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) add_parts<NS>(s[mt], part[mt]);
    }
  }
}

// acc[mt][j] (j < D / 8) += P V for a warp's MT tiles of 16 rows: P the C
// fragments p[mt][n] over 8 NS keys, V their rows of a split tile (split
// at the step's first key), in chains of two 8-key steps. Each B fragment
// serves all MT tiles.
template <int D, int NS, int MT>
__device__ __forceinline__ void pv_tf32(float (*acc)[D / 8][4],
                                        float (*p)[NS][4],
                                        const uint32_t* split,
                                        const Lane<D>& L) {
  static_assert(NS % 2 == 0, "chains of two 8-key steps");
#pragma unroll
  for (int n = 0; n < NS; n += 2) {
    uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a_from_c(p[mt][n], ah[mt][0], al[mt][0]);
      a_from_c(p[mt][n + 1], ah[mt][1], al[mt][1]);
    }
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += 4) {
      float part[MT][4][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          b_cols<D>(bh[i], bl[i],
                    split + 16 * D * (n + u) + 16 * (j0 + i - (i & 1)), L,
                    i & 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3<4>(part[mt], ah[mt][u], al[mt][u], bh, bl, u == 0);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) add_parts<4>(acc[mt] + j0, part[mt]);
    }
  }
}

// One step of 8 NS keys for a warp's MT tiles of 16 rows (rows g and
// g + 8 of each, in a lane): S = Q K^T, the online softmax in f32 on S's C
// fragments (m the rows' running max, l this lane's share of their sums;
// ms the keys' mask), then O += P V.
template <int D, int NS, int MT>
__device__ __forceinline__ void fwd_step(float (*acc)[D / 8][4],
                                         float (*m)[2], float (*l)[2],
                                         QFrags<D>* q,
                                         const uint32_t* ksplit,
                                         const uint32_t* vsplit,
                                         const int* ms, const Lane<D>& L,
                                         int tq) {
  float s[MT][NS][4];
  scores_tf32<D, NS, MT>(s, q, ksplit, L);
  bool valid[NS][2];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int2 mk = *reinterpret_cast<const int2*>(ms + 8 * n + 2 * tq);
    valid[n][0] = mk.x > 0;
    valid[n][1] = mk.y > 0;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (valid[n][e & 1]) mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
    float ml[2], alpha[2];           // the new max times log2 e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[mt][r], mx[r]);
      alpha[r] = exp2_fast((m[mt][r] - m_new) * LOG2E);
      m[mt][r] = m_new;
      ml[r] = m_new * LOG2E;
      l[mt][r] *= alpha[r];
    }
    // O times alpha, unless no row of the tile has a new max (alpha 1).
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            valid[n][e & 1]
                ? exp2_fast(fmaf(s[mt][n][e], LOG2E, -ml[e >> 1]))
                : 0.f;
        l[mt][e >> 1] += p;
        s[mt][n][e] = p;
      }
  }
  pv_tf32<D, NS, MT>(acc, s, vsplit, L);
}

// K2 at f32: one block of 4 SPLIT warps per (64 MTILES-query tile, b*h).
template <int D, bool FEW>
__global__ void __launch_bounds__(Fwd<D, FEW>::THREADS, Fwd<D, FEW>::BLOCKS)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ mask, float* __restrict__ o,
                      float* __restrict__ lse, int T, int H, float scale) {
  using C = Fwd<D, FEW>;
  constexpr int BN = C::TILE;
  constexpr int KS = C::STEP;
  constexpr int NT = C::THREADS;
  constexpr int MT = C::MTILES;
  constexpr int RB = C::ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);         // [RB][D]
  float* Kst = Qs + RB * D;                                // staging [BN][D]
  float* Vst = Kst + BN * D;
  uint32_t* Ksp = reinterpret_cast<uint32_t*>(Vst + BN * D);  // [BN][2D]
  uint32_t* Vsp = Ksp + 2 * BN * D;
  int* Ms = reinterpret_cast<int*>(Vsp + 2 * BN * D);      // [BN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w4 = (tid >> 5) & 3;     // the warp's rows in the block
  const int wr = w4 * 16 * MT;
  const int grp = tid >> 7;          // its group: steps grp, grp + SPLIT, ..
  const int g = lane >> 2;
  const int tq = lane & 3;
  const Lane<D> L(g, tq);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * RB;
  const size_t ts = static_cast<size_t>(H) * D;
  const size_t base =
      static_cast<size_t>(b) * T * ts + static_cast<size_t>(h) * D;
  const int* mrow = mask + static_cast<size_t>(b) * T;
  const int n_tiles = (T + BN - 1) / BN;
  // This thread's key of tile j (threads below BN): its mask, 0 past T.
  const auto key_mask = [&](int j) {
    const int t = j * BN + tid;
    return tid < BN && t < T ? mrow[t] : 0;
  };

  load_tile<RB, D, true, NT>(Qs, q + base, ts, q0, T, tid);
  omni::cp_async_commit();
  int mk = key_mask(0), mk_next = key_mask(1);
  // A key tile with no valid key adds exactly nothing (p = 0, alpha = 1),
  // so it is neither loaded, split nor computed.
  bool live = __syncthreads_or(mk > 0);
  if (live) {
    load_tile<BN, D, false, NT>(Kst, k + base, ts, 0, T, tid);
    load_tile<BN, D, false, NT>(Vst, v + base, ts, 0, T, tid);
  }
  omni::cp_async_commit();
  omni::cp_async_wait<1>();          // this thread's chunks of Q
  scale_tile<RB, D, NT>(Qs, scale, tid);   // q * scale in f32, as JAX
  __syncthreads();                   // Q whole
  QFrags<D> qf[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) qf[mt].own = Qs + (wr + 16 * mt) * D;

  float acc[MT][D / 8][4];           // O: 8-column tiles, rows g and g + 8
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero<D / 8>(acc[mt]);
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int mk_far = key_mask(j + 2);   // lands while tile j computes
    if (live) omni::cp_async_wait<0>();   // this thread's chunks of tile j
    // Every warp is done with tile j - 1.
    const bool live_next = __syncthreads_or(mk_next > 0);
    if (live) {
      split_tile<BN, D, NT>(Ksp, Kst, tid);
      split_tile<BN, D, NT>(Vsp, Vst, tid);
      if (tid < BN) Ms[tid] = mk;
    }
    if (live_next) {                 // tile j + 1 lands while j computes
      load_tile<BN, D, false, NT>(Kst, k + base, ts, (j + 1) * BN, T, tid);
      load_tile<BN, D, false, NT>(Vst, v + base, ts, (j + 1) * BN, T, tid);
    }
    omni::cp_async_commit();
    if (live) {
      __syncthreads();               // split tile j is whole
#pragma unroll 1
      for (int st = 0; st < BN / (C::SPLIT * KS); ++st) {
        const int k0 = (st * C::SPLIT + grp) * KS;   // the group's steps
        fwd_step<D, KS / 8, MT>(acc, m, l, qf, Ksp + 2 * D * k0,
                                Vsp + 2 * D * k0, Ms + k0, L, tq);
      }
    }
    live = live_next;
    mk = mk_next;
    mk_next = mk_far;
  }

  if constexpr (C::SPLIT > 1) {
    // Group 1 hands its rows' O, m and l to group 0 through the streamed
    // tiles' area, once every warp is done with it (every copy into it
    // was waited for).
    float* xo = Kst;                 // [warp][mt][j][e][lane]
    float* xm = xo + 4 * MT * (D / 8) * 4 * 32;  // [warp][mt][row][lane]
    float* xl = xm + 4 * MT * 2 * 32;
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int wt = w4 * MT + mt;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xo[((wt * (D / 8) + j) * 4 + e) * 32 + lane] = acc[mt][j][e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xm[(wt * 2 + r) * 32 + lane] = m[mt][r];
          xl[(wt * 2 + r) * 32 + lane] = l[mt][r];
        }
      }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int wt = w4 * MT + mt;
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xm[(wt * 2 + r) * 32 + lane];
        const float m_new = fmaxf(m[mt][r], m1);
        a0[r] = exp2_fast((m[mt][r] - m_new) * LOG2E);
        a1[r] = exp2_fast((m1 - m_new) * LOG2E);
        m[mt][r] = m_new;
        l[mt][r] = l[mt][r] * a0[r] + xl[(wt * 2 + r) * 32 + lane] * a1[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][j][e] =
              acc[mt][j][e] * a0[e >> 1] +
              xo[((wt * (D / 8) + j) * 4 + e) * 32 + lane] * a1[e >> 1];
    }
  }

  // o = O / max(l, 1e-30), lse = m + log l (+1e30 without a valid key).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      inv[r] = 1.f / fmaxf(l[mt][r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] *= inv[e >> 1];
    const int row0 = q0 + wr + 16 * mt;
    store_acc<D>(o + base, acc[mt], 1.f, ts, row0, T, g, tq);
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row < T)
          lse[static_cast<size_t>(bh) * T + row] =
              l[mt][r] > 0.f ? m[mt][r] + logf(fmaxf(l[mt][r], 1e-30f))
                             : FULLY_MASKED_LSE;
      }
    }
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

template <int D, bool FEW>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* mask, void* o, float* lse, int B, int T,
                       int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = Fwd<D, FEW>::bytes();
  cudaError_t err = omni::allow_smem(flash_fwd_tf32_kernel<D, FEW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + Fwd<D, FEW>::ROWS - 1) / Fwd<D, FEW>::ROWS, B * H);
  flash_fwd_tf32_kernel<D, FEW>
      <<<grid, Fwd<D, FEW>::THREADS, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), mask, static_cast<float*>(o), lse, T,
          H, scale);
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

// Whether a grid at D 64 gives some SM fewer than `min_blocks` blocks of
// 64 rows: then the FEW choices run.
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
          few_blocks(B, T, H, FWD_MIN_BLOCKS_64)
              ? launch_fwd<64, true>(q, k, v, mask, o, lse, B, T, H, scale, s)
              : launch_fwd<64, false>(q, k, v, mask, o, lse, B, T, H, scale,
                                      s));
    case 128:
      return static_cast<int>(
          launch_fwd<128, false>(q, k, v, mask, o, lse, B, T, H, scale, s));
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
