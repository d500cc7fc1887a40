// K3: the whole conformer convolution module, in two launches.
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
// What bounds it on an H100: at the serving shape (B 4, T 768, D 256,
// K 32) it must read and write ~6.3 MB of activations and ~0.4 MB of
// weights (~2 us at 3.35 TB/s) and does ~1.3 GFLOP, nearly all in the two
// pointwise products, which run on the bf16 tensor cores (1.2 us at
// 989 TFLOP/s): bytes bound. At [16, 256, 512] and [4, 256, 1024] the
// products (6.4 GFLOP each, 6.5 us at the bf16 peak) bound it.
//
// Design. The TPU kernel held one whole [T, D] row per grid step in VMEM;
// one block a row (or a few frames of one row, over all channels) would
// leave most of the 132 SMs idle at [4, 256, 1024]. So the channel work is
// split across blocks: pw1 -> GLU -> mask -> taps is independent per
// channel, while the second LN and pw2 need a whole frame. Two launches
// carry the split, and a thread block cluster joins the blocks of one
// frame tile inside the first:
//
// 1. conv_stage1_kernel<TT>: a block owns TT output frames of one row and
//    NC = 64 GLU channels; the D / NC blocks of a frame tile form one
//    cluster (grid ceil(T / TT) x D / NC x B, cluster 1 x D / NC x 1, so
//    D <= 1024). TT is 96 (RP = TT + 32 = 128 rows computed for 96
//    frames, 1.33 a frame) unless that leaves SMs without a block, then
//    64 (96 rows, 1.5 a frame): 192 blocks at serving [4, 768, 256] (TT
//    64), 384 at [16, 256, 512] and 192 at [4, 256, 1024] (TT 96).
//    (a) The cluster's warps share the tile's RP halo rows: each row is
//        read once, held in registers, normalised (two passes) and
//        written as bf16(LN(x)) to a scratch tile in global memory (L2);
//        a cluster barrier publishes the tile to the cluster.
//    (b) pw1's 2 NC columns (value | gate) over the RP rows with
//        mma.m16n8k16 bf16 -> f32: the A (tile rows) and B (pw1 rows,
//        [D, 2D] as stored, read with ldmatrix.trans) operands stream by
//        cp.async through (PIPE + 1)-deep rings, PIPE chunks of KC
//        channels in flight. Each warp holds the value and gate columns
//        of the same 16 channels, so GLU and mask are applied in
//        registers.
//    (c) The masked GLU tile goes to shared memory and the K taps run
//        over it in f32, ascending k, each thread's rows sliding through
//        registers.
//    (d) The second LN: each block takes every frame's (mean, sum of
//        squared deviations) over its NC channels of c and writes it into
//        every block of the cluster (distributed shared memory); after a
//        cluster barrier each block merges the D / NC parts of a frame
//        (Chan et al.'s update, exact in algebra) and writes
//        a = bf16(SiLU(LN(c))), the pw2 input, as bf16 to scratch.
// 2. conv_stage2_kernel: a plain bf16 GEMM of BM2 x BN2 tiles over the
//    flattened B x T frames: a and pw2 stream by cp.async as in (b), and
//    the epilogue adds x.
//
// Each output element is computed by the same operations as the plain
// version, up to the order of f32 sums (LN statistics, products, taps) and
// a fast sigmoid, which TOL_K3 in chip_smoke.py covers. The tiling and
// launch bounds were chosen by ops/conv_quant_sweep.py on the card; the
// sweep's table, times and registers are in PERF.md. Every tile load is
// mma.cuh's load_rows_async (flash.cuh's load_tile is the same copy at the
// attention heads' fixed shape).
// On an H100 SXM (700 W) it runs in 0.038 / 0.105 / 0.078 ms at [4, 768,
// 256] / [16, 256, 512] / [4, 256, 1024] (chip_smoke.py), 19x / 12x / 10x
// the bound. What limits it (PERF.md): the per-block phases around the
// product ((a), (c), (d) and the cluster barriers) take as long as the
// product itself, and each block re-reads its tile's A rows and its pw1
// columns from L2.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace {

constexpr float LN_EPS = 1e-5f;
constexpr int KC = 32;            // depth of one operand tile (both stages)
constexpr int LDA = KC + 8;       // bf16 A tile row (80 B: ldmatrix without
                                  // bank conflicts)

// Both stages stream their operands through shared memory in chunks of KC
// channels, chunks s + 1 .. s + PIPE in flight while chunk s is
// multiplied, the bf16 A and B tiles each in a (PIPE + 1)-deep cp.async
// ring.
constexpr int PIPE = 2;

// Stage 1 (ops/conv_quant_sweep.py times the alternatives).
constexpr int TT_SMALL = 64;      // output frames a block owns: TT_LARGE
constexpr int TT_LARGE = 96;      // where that still gives every SM a block
constexpr int HALO = 32;          // rows beyond them: K - 1 <= HALO
constexpr int NC = 64;            // GLU channels a block owns
constexpr int S1_WM = 2;          // warps along the rows (x 4 along NC)
constexpr int S1_THREADS = S1_WM * 4 * 32;
constexpr int S1_MIN_BLOCKS = 2;  // __launch_bounds__' blocks an SM
constexpr int TAP_THREADS = 256;  // threads that run the taps
// A frame tile's D / NC channel-chunk blocks form one cluster (at most 16,
// so D <= 16 NC = 1024): they make the tile's LN rows once and merge the
// second LN's statistics from their parts.
constexpr int MAX_CLUSTER = 16;
constexpr int ROW_VEC = MAX_CLUSTER * NC / 128;   // float4s a lane, a row
constexpr int LDB1 = 2 * NC + 8;  // bf16 pw1 tile row (value | gate)
constexpr int GLD = NC + 8;       // f32 GLU tile row

template <int TT>
struct Stage1 {
  static constexpr int RP = TT + HALO;            // rows pw1 runs over
  static constexpr int MT = RP / (16 * S1_WM);    // 16-row tiles a warp
  static constexpr int A = RP * LDA;              // bf16 elements an A tile
  static constexpr int B = KC * LDB1;             // bf16 elements a B tile
  static constexpr int TILES = (PIPE + 1) * (A + B) * 2;
  static constexpr int UNION = TILES > RP * GLD * 4 ? TILES : RP * GLD * 4;
  // ... then the block's depthwise taps, [HALO + 1][NC] f32, the second
  // LN's scale and bias over its channels, [2][NC], and the second LN's
  // parts, [D / NC][TT] float2 (FIXED + 8 TT D / NC bytes in all).
  static constexpr int FIXED = UNION + (HALO + 1) * NC * 4 + 2 * NC * 4;
  static_assert(RP % (16 * S1_WM) == 0 && NC == 4 * 16 &&
                    RP % (S1_THREADS / 32) == 0 &&
                    S1_THREADS >= TAP_THREADS &&
                    (TT * NC) % TAP_THREADS == 0,
                "stage-1 tiling");
};

// Stage 2.
constexpr int BM2 = 64;           // frames a block owns
constexpr int BN2 = 64;           // output channels a block owns
constexpr int S2_MIN_BLOCKS = 2;
constexpr int WM2 = 32;           // rows of a warp's tile (x 32 columns)
constexpr int MT2 = WM2 / 16;
constexpr int S2_WARPS_N = BN2 / 32;
constexpr int S2_THREADS = BM2 / WM2 * S2_WARPS_N * 32;
constexpr int LDB2 = BN2 + 8;
static_assert(BM2 % WM2 == 0 && WM2 % 16 == 0 && BN2 % 32 == 0 &&
                  64 % BN2 == 0,
              "stage-2 tiling");
struct Tiles2 {
  static constexpr int A = BM2 * LDA;
  static constexpr int B = KC * LDB2;
  static constexpr int BYTES = (PIPE + 1) * (A + B) * 2;
};

// sigmoid(v) = 1 / (1 + e^-v) from the fast exponential and a rounded
// reciprocal (relative error ~1e-7, far below the bf16 rounding that
// follows it on both paths).
__device__ __forceinline__ float sigmoidf(float v) {
  return __frcp_rn(1.f + __expf(-v));
}

// (mean, sum of squared deviations, count) of one group of values, and the
// same of two disjoint groups merged (Chan et al.'s pairwise update, as
// accurate as two passes over the values).
struct Moments {
  float mean, m2, n;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean, wb = __fdividef(b.n, n);
  return {a.mean + d * wb, a.m2 + b.m2 + d * d * a.n * wb, n};
}

__device__ __forceinline__ Moments warp_merge(Moments a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments b = {__shfl_xor_sync(0xffffffffu, a.mean, o),
                       __shfl_xor_sync(0xffffffffu, a.m2, o),
                       __shfl_xor_sync(0xffffffffu, a.n, o)};
    a = merge(a, b);
  }
  return a;
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float a,
                                             float b, float c, float d) {
  uint2 p;
  p.x = omni::pack_bf16(a, b);
  p.y = omni::pack_bf16(c, d);
  *reinterpret_cast<uint2*>(dst) = p;
}

template <int TT>
__global__ void __launch_bounds__(S1_THREADS, S1_MIN_BLOCKS)
conv_stage1_kernel(const float* __restrict__ x, const int* __restrict__ mask,
                   const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b,
                   const __nv_bfloat16* __restrict__ pw1,
                   const float* __restrict__ dw,
                   const float* __restrict__ dwln_s,
                   const float* __restrict__ dwln_b,
                   __nv_bfloat16* __restrict__ h_tiles,
                   __nv_bfloat16* __restrict__ a_out, int T, int D, int K) {
  using S = Stage1<TT>;
  constexpr int RP = S::RP, MT = S::MT;
  __shared__ float rowm[RP];         // 1 where the halo row is a valid frame
  __shared__ float2 ln2[TT];         // each frame's (mean, 1/std) over all
  extern __shared__ __align__(16) unsigned char s1_smem[];
  auto* As = reinterpret_cast<__nv_bfloat16*>(s1_smem);   // [PIPE + 1][A]
  __nv_bfloat16* Bs = As + (PIPE + 1) * S::A;              // [PIPE + 1][B]
  auto* Gc = reinterpret_cast<float*>(s1_smem);  // [RP][GLD], after the GEMM
  auto* taps = reinterpret_cast<float*>(s1_smem + S::UNION);   // [K][NC]
  float* dwp = taps + (HALO + 1) * NC;                      // [2][NC]
  // [D / NC][TT]: (mean, m2) of each frame's c over each block's channels,
  // written by the cluster's blocks.
  auto* parts = reinterpret_cast<float2*>(dwp + 2 * NC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int t0 = blockIdx.x * TT, j0 = blockIdx.y * NC, b = blockIdx.z;
  const int pad_l = (K - 1) / 2;
  const int R = TT + K - 1;
  const float* xb = x + static_cast<size_t>(b) * T * D;
  // This frame tile's A operand, bf16(LN(x)) of its RP halo rows.
  __nv_bfloat16* ht =
      h_tiles + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * RP * D;
  const int n_k = D / KC;

  // 1. The A operand of the frame tile, bf16(LN(x)) of rows t0 - pad_l ..
  //    (zero outside [0, T)), made once for the cluster: its warp gw takes
  //    rows gw, gw + (cluster warps), ..., one at a time, and writes them
  //    to ht (global memory, L2); a cluster barrier then makes them
  //    visible to every block of the cluster.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  {
    constexpr int W = S1_THREADS / 32;
    const int cw = static_cast<int>(cluster.num_blocks()) * W;
    for (int r = static_cast<int>(cluster.block_rank()) * W + warp; r < RP;
         r += cw) {
      const int t = t0 - pad_l + r;
      __nv_bfloat16* hr = ht + static_cast<size_t>(r) * D;
      if (r >= R || t < 0 || t >= T) {
        for (int c = lane * 4; c < D; c += 128)
          store_bf16x4(hr + c, 0.f, 0.f, 0.f, 0.f);
        continue;
      }
      // The row in registers (D <= 1024: at most 8 float4 a lane), its
      // mean and variance by two passes over them, then bf16(LN(row)).
      const float* xr = xb + static_cast<size_t>(t) * D;
      float4 v[ROW_VEC];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < ROW_VEC; ++j) {
        const int c = j * 128 + lane * 4;
        v[j] = c < D ? *reinterpret_cast<const float4*>(xr + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        sum += (v[j].x + v[j].y) + (v[j].z + v[j].w);
      }
      const float mu = omni::warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < ROW_VEC; ++j)
        if (j * 128 + lane * 4 < D) {
          const float d0 = v[j].x - mu, d1 = v[j].y - mu;
          const float d2 = v[j].z - mu, d3 = v[j].w - mu;
          sq += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
        }
      const float inv = 1.f / sqrtf(omni::warp_sum(sq) / D + LN_EPS);
#pragma unroll
      for (int j = 0; j < ROW_VEC; ++j) {
        const int c = j * 128 + lane * 4;
        if (c >= D) continue;
        const float4 s4 = *reinterpret_cast<const float4*>(ln_s + c);
        const float4 b4 = *reinterpret_cast<const float4*>(ln_b + c);
        store_bf16x4(hr + c, (v[j].x - mu) * inv * s4.x + b4.x,
                     (v[j].y - mu) * inv * s4.y + b4.y,
                     (v[j].z - mu) * inv * s4.z + b4.z,
                     (v[j].w - mu) * inv * s4.w + b4.w);
      }
    }
    for (int r = tid; r < RP; r += S1_THREADS) {
      const int t = t0 - pad_l + r;
      rowm[r] = r < R && t >= 0 && t < T &&
                        mask[static_cast<size_t>(b) * T + t] != 0
                    ? 1.f : 0.f;
    }
    cluster.sync();
  }

  // 2. pw1 over the tile. Chunk s: rows of ht, columns s * KC .., and pw1
  //    rows s * KC ..: the value columns j0 .. j0 + NC, then the gate
  //    columns D + j0 .., side by side. One commit group a chunk (empty
  //    past the last); the taps and the second LN's parameters join the
  //    first.
  auto issue = [&](int s) {
    if (s < n_k) {
      const int k0 = s * KC;
      omni::load_rows_async<RP, KC * 2, S1_THREADS>(
          As + (s % (PIPE + 1)) * S::A, LDA * 2, ht + k0, 2 * D, tid);
      const __nv_bfloat16* src = pw1 + static_cast<size_t>(k0) * 2 * D + j0;
      __nv_bfloat16* B = Bs + (s % (PIPE + 1)) * S::B;
      omni::load_rows_async<KC, NC * 2, S1_THREADS>(B, LDB1 * 2, src, 4 * D,
                                                    tid);
      omni::load_rows_async<KC, NC * 2, S1_THREADS>(B + NC, LDB1 * 2,
                                                    src + D, 4 * D, tid);
    }
    omni::cp_async_commit();
  };
  for (int i = tid; i < K * (NC / 4); i += S1_THREADS)
    omni::cp_async_16(taps + i * 4,
                      dw + static_cast<size_t>(i / (NC / 4)) * D + j0 +
                          (i % (NC / 4)) * 4,
                      true);
  if (tid < NC / 2)
    omni::cp_async_16(dwp + tid * 4, tid < NC / 4 ? dwln_s + j0 + tid * 4
                                                  : dwln_b + j0 + tid * 4 -
                                                        NC,
                      true);
  for (int s = 0; s < PIPE; ++s) issue(s);

  float acc_v[MT][2][4], acc_g[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[mi][j][e] = acc_g[mi][j][e] = 0.f;

  const int row0 = wr * (RP / S1_WM);
  for (int s = 0; s < n_k; ++s) {
    omni::cp_async_wait<PIPE - 1>();
    __syncthreads();      // chunk s landed; slot (s - 1) is free
    issue(s + PIPE);
    const __nv_bfloat16* A = As + (s % (PIPE + 1)) * S::A;
    const __nv_bfloat16* B = Bs + (s % (PIPE + 1)) * S::B;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t bv[4], bg[4];
      omni::ldmatrix_x4_trans(bv, omni::b_frag_trans_at(B, LDB1, kk, wc * 16,
                                                        lane));
      omni::ldmatrix_x4_trans(bg, omni::b_frag_trans_at(B, LDB1, kk,
                                                        NC + wc * 16, lane));
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        omni::ldmatrix_x4(a, omni::a_frag_at(A, LDA, row0 + mi * 16, kk,
                                             lane));
        omni::mma_bf16_16816(acc_v[mi][0], a, bv[0], bv[1]);
        omni::mma_bf16_16816(acc_v[mi][1], a, bv[2], bv[3]);
        omni::mma_bf16_16816(acc_g[mi][0], a, bg[0], bg[1]);
        omni::mma_bf16_16816(acc_g[mi][1], a, bg[2], bg[3]);
      }
    }
  }
  omni::cp_async_wait<0>();
  __syncthreads();                // the GLU tile overwrites the tiles

  // GLU and frame mask in registers, into the GLU tile.
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 16 + g + h * 8;
        const int col = wc * 16 + j * 8 + tig * 2;
        const float mk = rowm[r];
        *reinterpret_cast<float2*>(&Gc[r * GLD + col]) = make_float2(
            acc_v[mi][j][2 * h] * sigmoidf(acc_g[mi][j][2 * h]) * mk,
            acc_v[mi][j][2 * h + 1] * sigmoidf(acc_g[mi][j][2 * h + 1]) * mk);
      }
  __syncthreads();

  // Depthwise taps in ascending order, by the first TAP_THREADS threads:
  // channel tid % NC, NO consecutive frames from (tid / NC) * NO. The GLU
  // rows the NO outputs read at tap k sit in registers and shift by one
  // row a tap.
  constexpr int NO = TT * NC / TAP_THREADS;
  const bool tapper = tid < TAP_THREADS;
  const int cc = tid % NC;
  const int o0 = (tid / NC) * NO;
  float acc[NO], win[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    acc[o] = 0.f;
    win[o] = tapper ? Gc[(o0 + o) * GLD + cc] : 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < (tapper ? K : 0); ++k) {
    const float w = taps[k * NC + cc];
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[o] = fmaf(win[o], w, acc[o]);
#pragma unroll
    for (int o = 0; o + 1 < NO; ++o) win[o] = win[o + 1];
    if (k + 1 < K) win[NO - 1] = Gc[(o0 + NO + k) * GLD + cc];
  }

  // The second LayerNorm needs a frame's statistics over all D channels.
  // Each block takes the (mean, sum of squared deviations) of its frames'
  // c over its NC channels; after a cluster barrier every block merges the
  // D / NC parts of each frame from the cluster's blocks (exact: Chan et
  // al.'s pairwise update) and writes a = bf16(SiLU(LN(c))), the pw2
  // input, for its channels. The c tile goes through shared memory (over
  // the GLU tile) so that a warp holds a frame.
  float* Ct = Gc;
  __syncthreads();                // every tap has read the GLU tile
  if (tapper) {
#pragma unroll
    for (int o = 0; o < NO; ++o) Ct[(o0 + o) * GLD + cc] = acc[o];
  }
  __syncthreads();
  const int n_ch = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int f = warp; f < TT; f += S1_THREADS / 32) {
    const float v0 = Ct[f * GLD + lane], v1 = Ct[f * GLD + lane + 32];
    const float mu = omni::warp_sum(v0 + v1) * (1.f / NC);
    const float d0 = v0 - mu, d1 = v1 - mu;
    const float m2 = omni::warp_sum(d0 * d0 + d1 * d1);
    const float2 pt = make_float2(__shfl_sync(0xffffffffu, mu, 0),
                                  __shfl_sync(0xffffffffu, m2, 0));
    for (int q = lane; q < n_ch; q += 32)
      *cluster.map_shared_rank(parts + rank * TT + f, q) = pt;
  }
  cluster.sync();
  for (int f = warp; f < TT; f += S1_THREADS / 32) {
    Moments mo = {0.f, 0.f, 0.f};
    for (int j = lane; j < n_ch; j += 32) {
      const float2 pt = parts[j * TT + f];
      mo = merge(mo, Moments{pt.x, pt.y, static_cast<float>(NC)});
    }
    mo = warp_merge(mo);
    if (lane == 0)
      ln2[f] = make_float2(mo.mean, 1.f / sqrtf(mo.m2 / D + LN_EPS));
  }
  __syncthreads();
  // 8 channels a thread: frame i / (NC / 8), one 16-byte store each.
  for (int i = tid; i < TT * (NC / 8); i += S1_THREADS) {
    const int f = i / (NC / 8), c8 = (i % (NC / 8)) * 8;
    if (t0 + f >= T) continue;
    const float2 st = ln2[f];
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float y[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = c8 + e + h;
        const float v =
            (Ct[f * GLD + ch] - st.x) * st.y * dwp[ch] + dwp[NC + ch];
        y[h] = v * sigmoidf(v);
      }
      packed[e / 2] = omni::pack_bf16(y[0], y[1]);
    }
    *reinterpret_cast<uint4*>(a_out + (static_cast<size_t>(b) * T + t0 + f) *
                                          D + j0 + c8) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

__global__ void __launch_bounds__(S2_THREADS, S2_MIN_BLOCKS)
conv_stage2_kernel(const __nv_bfloat16* __restrict__ a_in,
                   const float* __restrict__ x,
                   const __nv_bfloat16* __restrict__ pw2,
                   float* __restrict__ out, int M, int D) {
  extern __shared__ __align__(16) unsigned char s2_smem[];
  auto* As = reinterpret_cast<__nv_bfloat16*>(s2_smem);   // [PIPE + 1][A]
  __nv_bfloat16* Bs = As + (PIPE + 1) * Tiles2::A;         // [PIPE + 1][B]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp / S2_WARPS_N, wc = warp % S2_WARPS_N;
  const int m0 = blockIdx.x * BM2, n0 = blockIdx.y * BN2;
  const int n_k = D / KC;

  // Chunk s: a rows m0 .. (zero past M), columns s * KC .., and pw2 rows
  // s * KC .., columns n0 .. n0 + BN2; one commit group a chunk.
  auto issue = [&](int s) {
    if (s < n_k) {
      omni::load_rows_async<BM2, KC * 2, S2_THREADS>(
          As + (s % (PIPE + 1)) * Tiles2::A, LDA * 2,
          a_in + static_cast<size_t>(m0) * D + s * KC, 2 * D, tid, M - m0);
      omni::load_rows_async<KC, BN2 * 2, S2_THREADS>(
          Bs + (s % (PIPE + 1)) * Tiles2::B, LDB2 * 2,
          pw2 + static_cast<size_t>(s) * KC * D + n0, 2 * D, tid);
    }
    omni::cp_async_commit();
  };
  for (int s = 0; s < PIPE; ++s) issue(s);

  float acc[MT2][4][4];
#pragma unroll
  for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int s = 0; s < n_k; ++s) {
    omni::cp_async_wait<PIPE - 1>();
    __syncthreads();      // chunk s landed; slot (s - 1) is free
    issue(s + PIPE);
    const __nv_bfloat16* A = As + (s % (PIPE + 1)) * Tiles2::A;
    const __nv_bfloat16* B = Bs + (s % (PIPE + 1)) * Tiles2::B;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[MT2][4];
#pragma unroll
      for (int mi = 0; mi < MT2; ++mi)
        omni::ldmatrix_x4(a[mi], omni::a_frag_at(A, LDA, wr * WM2 + mi * 16,
                                                 kk, lane));
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t bf[4];
        omni::ldmatrix_x4_trans(bf, omni::b_frag_trans_at(
                                        B, LDB2, kk, wc * 32 + nb * 16,
                                        lane));
#pragma unroll
        for (int mi = 0; mi < MT2; ++mi) {
          omni::mma_bf16_16816(acc[mi][2 * nb], a[mi], bf[0], bf[1]);
          omni::mma_bf16_16816(acc[mi][2 * nb + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
  }
  omni::cp_async_wait<0>();

  // + x (the unmasked input), two neighbouring channels a store.
#pragma unroll
  for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wr * WM2 + mi * 16 + g + h * 8;
        if (m >= M) continue;
        const size_t off = static_cast<size_t>(m) * D + n0 + wc * 32 +
                           ni * 8 + tig * 2;
        const float2 xr = *reinterpret_cast<const float2*>(x + off);
        *reinterpret_cast<float2*>(out + off) = make_float2(
            xr.x + acc[mi][ni][2 * h], xr.y + acc[mi][ni][2 * h + 1]);
      }
}

// D % 64 == 0 covers both stages' channel tiles (NC and BN2 divide 64);
// stage 1's cluster holds all D / NC channel chunks of a frame tile.
bool shapes_ok(int B, int T, int D, int K) {
  return B > 0 && B <= 65535 && T > 0 && D > 0 && D % 64 == 0 &&
         D / NC <= MAX_CLUSTER && K >= 1 && K - 1 <= HALO;
}

// Stage 1's frames a block at (B, T, D): TT_LARGE (fewer blocks re-read
// the weights and fewer rows are computed a frame) unless that would leave
// SMs without a block.
int frames_a_block(int B, int T, int D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const long large = static_cast<long>((T + TT_LARGE - 1) / TT_LARGE) *
                     (D / NC) * B;
  return large >= sms ? TT_LARGE : TT_SMALL;
}

template <int TT>
cudaError_t launch_stage1(const float* x, const int* mask, const float* ln_s,
                          const float* ln_b, const void* pw1, const float* dw,
                          const float* dwln_s, const float* dwln_b,
                          __nv_bfloat16* h, __nv_bfloat16* a, int B, int T,
                          int D, int K, cudaStream_t st) {
  const int cs = D / NC;   // the cluster: one frame tile's channel chunks
  const size_t smem = Stage1<TT>::FIXED + 8 * TT * cs;
  cudaError_t err = omni::allow_smem(conv_stage1_kernel<TT>, smem);
  if (err == cudaSuccess && cs > 8)   // 8 is the portable cluster size
    err = cudaFuncSetAttribute(conv_stage1_kernel<TT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + TT - 1) / TT, cs, B);
  cfg.blockDim = dim3(S1_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = static_cast<unsigned>(cs);
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv_stage1_kernel<TT>, x, mask, ln_s,
                            ln_b, static_cast<const __nv_bfloat16*>(pw1), dw,
                            dwln_s, dwln_b, h, a, T, D, K);
}

}  // namespace

// scratch: the pw2 input a = bf16(SiLU(LN(c))), [B, T, D] bf16, between
// the two launches, then stage 1's A operands, bf16(LN(x)) of each frame
// tile's halo rows, [B, ceil(T / TT), RP, D] bf16 (RP and TT are
// omni_conv_module_plan's plan[1] and plan[2] at the same B, T, D).
OMNI_API int omni_conv_module(const float* x, const int* mask,
                              const float* ln_s, const float* ln_b,
                              const void* pw1, const float* dw,
                              const float* dwln_s, const float* dwln_b,
                              const void* pw2, void* scratch, float* out,
                              int B, int T, int D, int K, void* stream) {
  if (!shapes_ok(B, T, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* h = a + static_cast<size_t>(B) * T * D;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      frames_a_block(B, T, D) == TT_LARGE
          ? launch_stage1<TT_LARGE>(x, mask, ln_s, ln_b, pw1, dw, dwln_s,
                                    dwln_b, h, a, B, T, D, K, st)
          : launch_stage1<TT_SMALL>(x, mask, ln_s, ln_b, pw1, dw, dwln_s,
                                    dwln_b, h, a, B, T, D, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * T;
  err = omni::allow_smem(conv_stage2_kernel, Tiles2::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_stage2_kernel<<<dim3((M + BM2 - 1) / BM2, D / BN2), S2_THREADS,
                       Tiles2::BYTES, st>>>(
      a, x, static_cast<const __nv_bfloat16*>(pw2), out, M, D);
  return static_cast<int>(cudaGetLastError());
}

// K3's plan at (B, T, D), for reports: plan[0] stage-1 blocks, [1] rows
// pw1 runs over a stage-1 block, [2] output frames a stage-1 block owns,
// [3] stage-2 blocks, [4] stage-1 threads, [5] stage-2 threads.
OMNI_API int omni_conv_module_plan(int B, int T, int D, int* plan) {
  if (!shapes_ok(B, T, D, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int tt = frames_a_block(B, T, D);
  plan[0] = (T + tt - 1) / tt * (D / NC) * B;
  plan[1] = tt + HALO;
  plan[2] = tt;
  plan[3] = (B * T + BM2 - 1) / BM2 * (D / BN2);
  plan[4] = S1_THREADS;
  plan[5] = S2_THREADS;
  return 0;
}
