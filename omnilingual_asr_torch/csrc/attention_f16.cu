// K2 at f16 (the f16 encoder's attention forward): flash attention with a
// key mask and the row logsumexp over f16 q, k and v, on Hopper's warpgroup
// products (wgmma) fed by the Tensor Memory Accelerator (TMA).
//
// Replaces omnilingual_asr_tpu/ops/attention.py::_flash_fwd_lse_kernel
// (launched by _fwd_lse) at f16 operands. The Pallas kernel is generic in
// its input type and casts to f32 inside, so at f16 every product is an
// f32 product of f16 values. Non-causal attention over q, k, v
// [B, T, H, D] f16, D in {64, 128}, with an int32 key-validity mask
// [B, T]:
//
//     s = (q k^T) / sqrt(D)      masked keys -> -1e30, f32 online softmax
//     o = softmax(s) v           f16 out, [B, T, H, D], rounded once
//     lse = m + log(l)           f32, [B, H, T]; +1e30 for a fully-masked row
//
// A fully-masked row (a padded batch slot) gets o = 0 and lse = +1e30; a
// masked key contributes p = 0 exactly. T may be any length: rows at or
// past T are zero-filled by TMA, their keys masked, their queries not
// stored.
//
// What bounds it on an H100: at the serving shape (B*H = 16, T = 768,
// D = 64) 2.4 GFLOP of f16 products (P V twice, as hi and lo) against
// 6.3 MB of q/k/v/o: ~2.4 us of tensor-core time, 1.9 us of memory time.
// Neither bounds it there: each block walks its key tiles in sequence and
// the grid of 192 blocks fills 132 SMs about once, so a tile's chain of
// waits, products and softmax does, and of that chain the softmax and the
// split of P (exp2 and f32 -> f16 conversions, quarter-rate units) more
// than the products. The design shortens the chain: the copies leave the
// threads (TMA, one thread issues them), S = Q K^T is D / 16 wgmma a
// warpgroup instead of 16 D mma.sync a warp, P V takes P from registers
// against V in shared memory (2 wgmma a 16-key step), the softmax takes
// one FFMA and one exp2 an element, the split two conversions a pair, and
// on a small grid two warpgroups of a block split its key tiles.
//
// Design: one block per (64-query tile, b*h), as the bf16 K2
// (attention.cu), of one warpgroup (4 warps, 16 query rows each) or, when
// the grid has at most FWD16_SPLIT_BLOCKS_* blocks (at D 64: the serving
// batch, a model shard's heads, a ragged batch), of two: warpgroup w takes key
// tiles w, w + 2, ..., each with its own O, running max and sum, and the
// second hands them to the first through shared memory at the end
// (O = O_0 2^(m_0 - m) + O_1 2^(m_1 - m), as the online softmax merges two
// tiles). Q, K and V come in by TMA through 4-D tensor maps over
// [B, T, H, D] (hopper.cuh::encode_bthd_f16: boxes of 64 rows x 64
// columns, 128-byte swizzled, two boxes a tile at D 128), encoded on the
// host at each call and passed as __grid_constant__ parameters. A
// warpgroup's thread 0 issues them: Q once, K and V through the
// warpgroup's ring of STAGES stages, each with a "full" mbarrier for K,
// one for V (their bytes) and an "empty" one (one arrival a warp once its
// products have read the stage), so the stage is refilled with the
// warpgroup's tile i + STAGES as soon as tile i is done. The key mask
// comes as two words a lane a tile (keys t0 + lane, t0 + 32 + lane,
// fetched a tile ahead), turned into the tile's 64 validity bits by two
// ballots; a tile whose keys are all valid skips the masking. Per tile:
// - S = Q K^T as D / 16 wgmma.m64n64k16 with both operands read from
//   shared memory through K-major 128B-swizzle descriptors (exact f16
//   products, f32 sums). Its accumulator is mma.sync's C layout a warp,
//   so the row max and sum take the bf16 K2's shuffles across a row's 4
//   lanes.
// - An f32 online softmax in log2 units: the row max of the raw scores
//   times 1/sqrt(D) log2(e), and p 2^P_EXP = exp2(s 1/sqrt(D) log2(e) -
//   m + P_EXP), one FFMA and one ex2.approx an element, the scale 2^14
//   folded into exp2's argument; a lane's 16 values of a row are reduced
//   (max, then sum) as trees of 4 steps, not chains of 16. p <= 1, so p 2^14 <= 2^14 splits as f16 hi + lo
//   (split_f16_trunc: hi = p 2^14 with its 13 low mantissa bits cleared,
//   lo = f16(p 2^14 - hi), ~22 significant bits, in f16's normal range
//   down to p = 2^-28, what lo loses below that 2^-39 absolute), as the
//   f16 K7 splits its P (attention_bwd.cu). The running sum l sums the
//   same scaled p, so the 2^14 cancels in o = O / l, and lse =
//   (m + log2 l - 14) ln 2. A masked key's p is 0, not computed.
// - O += P V as two wgmma a 16-key step (hi, then lo): m64n64k16, or at
//   D 128 m64n128k16 over V's two boxes as one operand; A from registers
//   (the S accumulator's 8-column pairs are wgmma's A fragment), B the V
//   tile in shared memory, MN-major (the transpose bit): native f16
//   products, no split of V.
// o is rounded to f16 once, from the accumulators. The [T, T] score matrix
// never exists. Issuing tile j + 1's S before tile j's softmax (two S
// accumulators live) was slower on an H100 at every shape, and is not
// kept (PERF.md §6, the f16 K2's findings).
//
// Shared memory: Q, then each warpgroup's STAGES K and STAGES V tiles of
// 8 KB a box (64 rows x 128 bytes), at a multiple of 1024 bytes (the
// swizzle's atom), and the barriers. Registers (nvcc -Xptxas -v, sm_90a,
// as chip_smoke.py prints them): 127 at D 64 with one warpgroup or two,
// 155 at D 128, no spills.
#include "flash.cuh"
#include "hopper.cuh"

namespace {

using omni::NEG_INF;

constexpr int BQ = omni::FLASH_ROWS;          // query rows a block owns
constexpr int BK = omni::FLASH_ROWS;          // keys a tile holds
constexpr int BOX_BYTES = 64 * 64 * 2;        // 64 rows x 64 f16 columns
constexpr int ROW_BYTES = 128;                // a box row, the swizzle's
constexpr int P_EXP = 14;                     // p 2^14 splits in f16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Stages of a warpgroup's K/V ring and blocks an SM that the register
// budget must allow, by head dim, and the largest grid whose blocks split
// their key tiles over two warpgroups (0: never). python -m
// omnilingual_asr_torch.ops.flash_bwd_sweep --f16fwd times others; on an
// H100 (PERF.md §6): at D 64 two warpgroups took 0.83-0.93x one's time
// on grids of up to 192 blocks and 1.19x on the training shape's 512, and
// 3 stages 1.3x at training (fewer blocks an SM); at D 128 ([4, 768, 8,
// 128], 384 blocks) 1 stage at 3 blocks an SM took 0.72x the time of 2
// stages at 2, and two warpgroups (one block an SM) 0.89x.
constexpr int FWD16_STAGES_64 = 2;
constexpr int FWD16_STAGES_128 = 1;
constexpr int FWD16_MIN_BLOCKS_64 = 3;
constexpr int FWD16_MIN_BLOCKS_128 = 3;
constexpr int FWD16_SPLIT_BLOCKS_64 = 264;
constexpr int FWD16_SPLIT_BLOCKS_128 = 0;

// D columns of 64 a TMA box; SPLIT warpgroups, each with its own K/V ring
// of STAGES stages, take key tiles j = w, w + SPLIT, ... of the block.
template <int D, int SPLIT>
struct Fwd16 {
  static constexpr int BOXES = D / 64;
  static constexpr int TILE = BOXES * BOX_BYTES;
  static constexpr int STAGES = D == 64 ? FWD16_STAGES_64 : FWD16_STAGES_128;
  static constexpr int THREADS = SPLIT * omni::FLASH_THREADS;
  static constexpr int MIN_BLOCKS =
      SPLIT > 1 ? 1 : D == 64 ? FWD16_MIN_BLOCKS_64 : FWD16_MIN_BLOCKS_128;
  static constexpr int RING = SPLIT * STAGES;          // stages a block
  static constexpr int K_OFF = TILE;                   // after Q
  static constexpr int V_OFF = K_OFF + RING * TILE;
  static constexpr int BAR_OFF = V_OFF + RING * TILE;
  static constexpr int BARS = 1 + 3 * RING;            // Q; K, V, empty
  // 1024 bytes of slack to align the tiles.
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * BARS;
  // The second warpgroup's O, running max and sum, handed to the first
  // through the K/V ring once both are done.
  static constexpr int MERGE = 8 * BOXES * 4 + 4;      // floats a thread
  static_assert(STAGES >= 1 && STAGES <= 4, "1 to 4 stages");
  static_assert(SPLIT == 1 || SPLIT == 2, "one or two warpgroups");
  static_assert(SPLIT == 1 || MERGE * 128 * 4 <= 2 * RING * TILE,
                "the merge fits the ring");
};

// 2^x by the MUFU alone (ex2.approx.ftz: results under 2^-126 flush to 0,
// far below what a p 2^14 can lose).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x0, x1 (each p 2^14, at most 2^14) as f16 hi + lo pairs: hi = x with its
// 13 low mantissa bits cleared (an f16 value, exact, for x in f16's normal
// range), lo = f16(x - hi) (x - hi exact in f32): ~22 significant bits,
// two conversions a pair where rounding hi takes four.
__device__ __forceinline__ void split_f16_trunc(float x0, float x1,
                                                uint32_t* hi, uint32_t* lo) {
  const float h0 = __uint_as_float(__float_as_uint(x0) & 0xffffe000u);
  const float h1 = __uint_as_float(__float_as_uint(x1) & 0xffffe000u);
  *hi = omni::pack_f16(h0, h1);
  *lo = omni::pack_f16(x0 - h0, x1 - h1);
}

template <int D, int SPLIT>
__global__ void __launch_bounds__((Fwd16<D, SPLIT>::THREADS),
                                  (Fwd16<D, SPLIT>::MIN_BLOCKS))
flash_fwd_f16_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const int* __restrict__ mask, __half* __restrict__ o,
                     float* __restrict__ lse, int T, int H,
                     float scale_log2) {
  using L = Fwd16<D, SPLIT>;
  constexpr int S = L::STAGES;
  constexpr int NB = L::BOXES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + ((1024 - (omni::smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int wg = tid / 128;         // this thread's warpgroup
  const int wt = tid % 128;         // its index in the warpgroup
  const int lane = tid & 31;
  const int warp = wt >> 5;         // 16 query rows a warp
  const int g = lane >> 2;          // accumulator row (and row + 8)
  const int tq = lane & 3;          // accumulator column pair
  // This warpgroup's ring: its S stages of K and V, and their barriers.
  unsigned char* ks = qs + L::K_OFF + wg * S * L::TILE;
  unsigned char* vs = qs + L::V_OFF + wg * S * L::TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(qs + L::BAR_OFF);
  uint64_t* k_full = q_full + 1 + wg * S;
  uint64_t* v_full = k_full + L::RING;
  uint64_t* empty = v_full + L::RING;
  const CUtensorMap* kp = &kmap;
  const CUtensorMap* vp = &vmap;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (T + BK - 1) / BK;
  const int n_mine = (n_tiles - wg + SPLIT - 1) / SPLIT;  // tiles i: w + i SPLIT
  const int* mrow = mask + static_cast<size_t>(b) * T;

  // K and V of this warpgroup's tile i (key tile wg + i SPLIT) into its
  // stage i % S (the warpgroup's thread 0 only).
  auto load_kv = [&](int i) {
    const int st = i % S;
    const int t0 = (wg + i * SPLIT) * BK;
    omni::mbar_arrive_expect_tx(k_full + st, L::TILE);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      omni::tma_load_4d(ks + st * L::TILE + x * BOX_BYTES, kp, k_full + st,
                        64 * x, h, t0, b);
    omni::mbar_arrive_expect_tx(v_full + st, L::TILE);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      omni::tma_load_4d(vs + st * L::TILE + x * BOX_BYTES, vp, v_full + st,
                        64 * x, h, t0, b);
  };

  if (tid == 0) {
    omni::mbar_init(q_full, 1);
    for (int r = 0; r < L::RING; ++r) {
      omni::mbar_init(q_full + 1 + r, 1);                // K full
      omni::mbar_init(q_full + 1 + L::RING + r, 1);      // V full
      omni::mbar_init(q_full + 1 + 2 * L::RING + r, 4);  // empty: 4 warps
    }
    omni::mbar_fence_init();
  }
  __syncthreads();
  if (wt == 0) {
    if (wg == 0) {
      omni::mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int x = 0; x < NB; ++x)
        omni::tma_load_4d(qs + x * BOX_BYTES, &qmap, q_full, 64 * x, h, q0,
                          b);
    }
    for (int i = 0; i < S && i < n_mine; ++i) load_kv(i);
  }
  __syncwarp();

  // This lane's mask words of this warpgroup's tile i: keys t0 + lane and
  // t0 + lane + 32.
  auto fetch_mask = [&](int i, int& lo, int& hi) {
    const int t = (wg + i * SPLIT) * BK + lane;
    lo = t < T ? __ldg(mrow + t) : 0;
    hi = t + 32 < T ? __ldg(mrow + t + 32) : 0;
  };

  float acc[D / 8][4];              // O: rows g and g + 8, 8-column groups
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max (log2 units), g, g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the running sum
  int mlo = 0, mhi = 0;             // mask words of the current tile
  if (n_mine > 0) fetch_mask(0, mlo, mhi);
  omni::mbar_wait(q_full, 0);

  for (int i = 0; i < n_mine; ++i) {
    const int st = i % S;
    const uint32_t parity = (i / S) & 1;
    int nlo = 0, nhi = 0;
    if (i + 1 < n_mine) fetch_mask(i + 1, nlo, nhi);

    // S = Q K^T: D / 16 k-steps of 16 columns (32 bytes along the
    // swizzled rows; the second box at D 128).
    float s[8][4];
    omni::mbar_wait(k_full + st, parity);
    omni::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      omni::wgmma_m64n64k16_ss(s, omni::sw128_desc(qs + at),
                               omni::sw128_desc(ks + st * L::TILE + at),
                               kk > 0);
    }
    omni::wgmma_commit();
    omni::wgmma_wait<0>();
    omni::fence_accumulator<8>(s);

    // Online softmax in log2 units (rows g: s[.][0..1]; g + 8:
    // s[.][2..3]); bit 8 n + e of `mine` is column 8 n + 2 tq + e's. A
    // tile whose 64 keys are all valid skips the masking.
    const uint64_t bits =
        (static_cast<uint64_t>(__ballot_sync(0xffffffffu, mhi != 0)) << 32) |
        __ballot_sync(0xffffffffu, mlo != 0);
    const uint64_t mine = bits >> (2 * tq);
    const bool full = bits == ~0ull;
    if (!full) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((mine >> (8 * n + (e & 1))) & 1)) s[n][e] = NEG_INF;
    }
    // A row's 16 values of this lane, reduced as a tree (4 dependent
    // steps, not 16).
    auto row_tree = [&](int r, auto op) {
      float v[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] = op(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] = op(v[i], v[i + w]);
      return v[0];
    };
    auto fmax2 = [](float a, float b) { return fmaxf(a, b); };
    auto add2 = [](float a, float b) { return a + b; };
    float mx[2] = {row_tree(0, fmax2), row_tree(1, fmax2)};
    // p 2^P_EXP = exp2(s scale log2(e) - m + P_EXP): one FFMA and one
    // exp2 an element; a masked one is 0 (not computed: while a row's max
    // is still -1e30 its exponent is no number).
    float alpha[2], off[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
      off[r] = P_EXP - m_new;
    }
    // P 2^14 as f16 hi + lo: the A fragments of the four 16-key steps.
    uint32_t hi[4][4], lo[4][4];
    auto exp_split = [&](auto masked) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* v = s[2 * kk + c] + 2 * r;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = ex2(fmaf(v[e], scale_log2, off[r]));
              v[e] = !decltype(masked)::value ||
                             ((mine >> (8 * (2 * kk + c) + e)) & 1)
                         ? p
                         : 0.f;
            }
            split_f16_trunc(v[0], v[1], &hi[kk][2 * c + r],
                            &lo[kk][2 * c + r]);
          }
    };
    if (full)
      exp_split(std::false_type{});
    else
      exp_split(std::true_type{});
    l[0] += row_tree(0, add2);
    l[1] += row_tree(1, add2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: 16 keys a step, V's rows 16 kk .. 16 kk + 16 (2048 bytes
    // a step); at D 128 V's two boxes are one operand, 8 KB apart.
    omni::mbar_wait(v_full + st, parity);
    omni::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = omni::sw128_desc(
          vs + st * L::TILE + 16 * kk * ROW_BYTES, BOX_BYTES);
      if constexpr (D == 64) {
        omni::wgmma_m64n64k16_rs_mn(acc, hi[kk], vd);
        omni::wgmma_m64n64k16_rs_mn(acc, lo[kk], vd);
      } else {
        omni::wgmma_m64n128k16_rs_mn(acc, hi[kk], vd);
        omni::wgmma_m64n128k16_rs_mn(acc, lo[kk], vd);
      }
    }
    omni::wgmma_commit();
    omni::wgmma_wait<0>();
    omni::fence_accumulator<D / 8>(acc);

    // The stage is free once every warp's products have read it; the
    // warpgroup's thread 0 then refills it with tile i + S.
    if (lane == 0) omni::mbar_arrive(empty + st);
    if (wt == 0 && i + S < n_mine) {
      omni::mbar_wait(empty + st, parity);
      load_kv(i + S);
    }
    __syncwarp();
    mlo = nlo;
    mhi = nhi;
  }

  if (SPLIT > 1) {
    // The second warpgroup hands its O, max and sum to the first through
    // the ring (every copy into it has been consumed): value v of thread
    // wt at [v][wt].
    float* merge = reinterpret_cast<float*>(qs + L::K_OFF);
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) merge[(n * 4 + e) * 128 + wt] = acc[n][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        merge[(L::MERGE - 4 + r) * 128 + wt] = m[r];
        merge[(L::MERGE - 2 + r) * 128 + wt] = l[r];
      }
    }
    __syncthreads();
    if (wg == 1) return;
    float f0[2], f1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = merge[(L::MERGE - 4 + r) * 128 + wt];
      const float l1 = merge[(L::MERGE - 2 + r) * 128 + wt];
      const float m_new = fmaxf(m[r], m1);
      f0[r] = ex2(m[r] - m_new);
      f1[r] = ex2(m1 - m_new);
      m[r] = m_new;
      l[r] = l[r] * f0[r] + l1 * f1[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * f0[e >> 1] +
                    merge[(n * 4 + e) * 128 + wt] * f1[e >> 1];
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
    __half* dst = o + (static_cast<size_t>(b) * T + qi) * H * D +
                  static_cast<size_t>(h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = omni::pack_f16(
          acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    if (tq == 0)
      lse[static_cast<size_t>(bh) * T + qi] =
          l[r] > 0.f ? (m[r] + log2f(l[r]) - P_EXP) * LN2
                     : omni::FULLY_MASKED_LSE;
  }
}

template <int D, int SPLIT>
int launch_split(const CUtensorMap* maps, const int* mask, void* o,
                   float* lse, int B, int T, int H, float scale,
                   cudaStream_t stream) {
  using L = Fwd16<D, SPLIT>;
  const cudaError_t err =
      omni::allow_smem(flash_fwd_f16_kernel<D, SPLIT>, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_f16_kernel<D, SPLIT><<<grid, L::THREADS, L::SMEM, stream>>>(
      maps[0], maps[1], maps[2], mask, static_cast<__half*>(o), lse, T, H,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// Two warpgroups a block when the grid is at most SPLIT_BLOCKS blocks and
// a block has two key tiles or more.
template <int D, int SPLIT_BLOCKS>
int launch_fwd_f16(const void* q, const void* k, const void* v,
                   const int* mask, void* o, float* lse, int B, int T, int H,
                   float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = omni::encode_bthd_f16(&maps[i], src[i], B, T, H, D, BK);
    if (err != 0) return err;
  }
  if constexpr (SPLIT_BLOCKS > 0) {
    const long blocks = static_cast<long>((T + BQ - 1) / BQ) * B * H;
    if (T > BK && blocks <= SPLIT_BLOCKS)
      return launch_split<D, 2>(maps, mask, o, lse, B, T, H, scale, stream);
  }
  return launch_split<D, 1>(maps, mask, o, lse, B, T, H, scale, stream);
}

}  // namespace

// K2 at f16: the bf16 K2's arguments (attention.cu::omni_flash_fwd) over
// f16 q, k, v and o, each 16-byte aligned (TMA's rule).
OMNI_API int omni_flash_fwd_f16(const void* q, const void* k, const void* v,
                                const int* mask, void* o, float* lse, int B,
                                int T, int H, int head_dim, float scale,
                                void* stream) {
  if (B <= 0 || T <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd_f16<64, FWD16_SPLIT_BLOCKS_64>(q, k, v, mask, o, lse,
                                                       B, T, H, scale, s);
    case 128:
      return launch_fwd_f16<128, FWD16_SPLIT_BLOCKS_128>(
          q, k, v, mask, o, lse, B, T, H, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
