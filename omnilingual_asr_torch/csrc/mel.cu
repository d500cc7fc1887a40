// K1: fused log-mel frontend, as a real FFT in shared memory.
//
// Replaces omnilingual_asr_tpu/ops/mel_pallas.py::_mel_kernel (launched by
// log_mel_frames_pallas). For raw frames F [N, 1024] it computes
//
//     out = log(max(|rfft(F * w)|^2 FB, floor))                [N, 128]
//
// which is the reference's log(max(((F Cw)^2 + (F Sw)^2) FB, floor)) with
// the Hann window w folded out of the dense DFT matrices Cw, Sw. The
// reference needs true f32 (Precision.HIGHEST), so tensor cores (TF32,
// bf16) are closed; the way to the card's speed is fewer operations. The
// TPU kernel ran the dense DFT, 2 x 1024 x 513 x 2 FLOP a frame (27.4
// GFLOP at the serving shape, 12 288 frames); an FFT needs ~2.5 n log2 n
// = 25.6 kFLOP a frame, and the filterbank's triangles ~2 x 1 013 more.
//
// What bounds it on an H100: bytes. It reads the 400 windowed samples of
// each frame (the window is exactly zero past win_length), 1.6 KB, and
// writes 128 f32: ~26 MB at the serving shape against ~0.33 GFLOP.
//
// Design: one block of 256 threads takes 4 frames at a time, 64 threads a
// frame, and walks over groups of 4 frames (grid of 4 blocks an SM, or one
// a group if fewer). Each thread loads its packed complex samples
// z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1] at m = i + 64 r straight into
// registers (coalesced 8-byte loads, none past the window) and the
// 512-point complex FFT runs as three radix-8 Stockham stages (stride
// p = 1, 8, 64; butterfly i reads i + 64 r, multiplies by the twiddle
// exp(-2 pi i r (i mod p) / 8p), and writes (i - i mod p) 8 + i mod p + q p),
// through two 4 KB buffers a frame in shared memory (float2, one pad slot
// every 8 against bank conflicts). Bins 0..512 follow from Z[k] and
// conj(Z[512 - k]); the power spectrum stays in shared memory, and each
// thread sums two mel filters (i and 127 - i, which balances the narrow
// low filters against the wide high ones) over their nonzero bands in
// ascending bin order, then takes the log. Twiddles are a table computed
// in float64 on the host and held as f32 (ops/mel.py::twiddle_table); the
// bands and the packed filter weights are read into shared memory once a
// block. Nothing but the log-mel reaches device memory.
//
// Shared memory: twiddles 8 KB, window <= 4 KB, 4 x 2 FFT buffers 36 KB,
// bands 1.5 KB, weights <= 16 KB (52 KB with the release filterbank's
// 1 013 weights), so four blocks an SM. Registers (nvcc -Xptxas -v,
// sm_90a, as chip_smoke.py prints them): 64, with 8 bytes of spill.
#include "common.cuh"

namespace {

constexpr int N_FFT = 1024;
constexpr int HALF = N_FFT / 2;   // complex FFT length
constexpr int FPB = 4;            // frames in flight a block
constexpr int TPF = HALF / 8;     // threads a frame: one radix-8 butterfly
constexpr int THREADS = FPB * TPF;
constexpr int NMELS = 128;
constexpr int MAX_WEIGHTS = 4096;
constexpr int PAD_LEN = HALF + HALF / 8;   // padded buffer, float2

__device__ __forceinline__ int pad(int j) { return j + (j >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// y[q] = sum_r x_r exp(-2 pi i r q / 4).
__device__ __forceinline__ void dft4(float2 x0, float2 x1, float2 x2,
                                     float2 x3, float2 y[4]) {
  const float2 a = cadd(x0, x2), b = csub(x0, x2), c = cadd(x1, x3);
  const float2 d = make_float2(x1.y - x3.y, x3.x - x1.x);   // -i (x1 - x3)
  y[0] = cadd(a, c);
  y[1] = cadd(b, d);
  y[2] = csub(a, c);
  y[3] = csub(b, d);
}

// u[q] <- sum_r u[r] exp(-2 pi i r q / 8): two radix-4 halves (even and
// odd inputs), then the odd half times exp(-2 pi i q / 8).
__device__ __forceinline__ void dft8(float2 u[8]) {
  const float r2 = 0.70710678118654752f;
  float2 e[4], o[4];
  dft4(u[0], u[2], u[4], u[6], e);
  dft4(u[1], u[3], u[5], u[7], o);
  const float2 w[4] = {o[0],
                       make_float2(r2 * (o[1].x + o[1].y), r2 * (o[1].y - o[1].x)),
                       make_float2(o[2].y, -o[2].x),
                       make_float2(r2 * (o[3].y - o[3].x), -r2 * (o[3].x + o[3].y))};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    u[q] = cadd(e[q], w[q]);
    u[q + 4] = csub(e[q], w[q]);
  }
}

// One Stockham stage of stride P from src to dst (padded buffers).
template <int P>
__device__ __forceinline__ void stage(const float2* src, float2* dst,
                                      const float2* tw, int i) {
  const int k = i % P;
  float2 u[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) u[r] = src[pad(i + TPF * r)];
#pragma unroll
  for (int r = 1; r < 8; ++r) u[r] = cmul(u[r], tw[r * k * (N_FFT / (8 * P))]);
  dft8(u);
  const int j = (i - k) * 8 + k;
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[pad(j + q * P)] = u[q];
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ frames, const float* __restrict__ win,
               int n_win, const float2* __restrict__ twiddles,
               const float* __restrict__ fb, const int* __restrict__ bands,
               int n_weights, float* __restrict__ out, int n_frames,
               float log_floor) {
  extern __shared__ __align__(16) float smem[];
  float2* tw = reinterpret_cast<float2*>(smem);          // [N_FFT]
  float2* bufA = tw + N_FFT;                              // [FPB][PAD_LEN]
  float2* bufB = bufA + FPB * PAD_LEN;                    // [FPB][PAD_LEN]
  int* bs = reinterpret_cast<int*>(bufB + FPB * PAD_LEN); // [NMELS][3]
  float* ws = reinterpret_cast<float*>(bs + 3 * NMELS);   // [n_weights]
  float* wn = ws + n_weights;                             // [n_win]

  const int tid = threadIdx.x;
  const int slot = tid / TPF;
  const int i = tid % TPF;
  for (int t = tid; t < N_FFT; t += THREADS) tw[t] = twiddles[t];
  for (int t = tid; t < 3 * NMELS; t += THREADS) bs[t] = bands[t];
  for (int t = tid; t < n_win; t += THREADS) wn[t] = win[t];
  __syncthreads();
  for (int m = tid; m < NMELS; m += THREADS) {
    const int lo = bs[3 * m], cnt = bs[3 * m + 1], off = bs[3 * m + 2];
    for (int c = 0; c < cnt; ++c) ws[off + c] = fb[(lo + c) * NMELS + m];
  }
  __syncthreads();

  float2* A = bufA + slot * PAD_LEN;
  float2* Bf = bufB + slot * PAD_LEN;
  const int n_groups = (n_frames + FPB - 1) / FPB;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int f = grp * FPB + slot;
    const bool live = f < n_frames;
    const float* x = frames + static_cast<size_t>(live ? f : 0) * N_FFT;

    // Windowed, packed samples; the first stage (stride 1) from registers.
    float2 u[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n0 = 2 * (i + TPF * r);
      float2 z = make_float2(0.f, 0.f);
      if (live && n0 < n_win) {
        const float2 s = *reinterpret_cast<const float2*>(x + n0);
        z.x = s.x * wn[n0];
        z.y = n0 + 1 < n_win ? s.y * wn[n0 + 1] : 0.f;
      }
      u[r] = z;
    }
    dft8(u);
#pragma unroll
    for (int q = 0; q < 8; ++q) A[pad(i * 8 + q)] = u[q];
    __syncthreads();
    stage<8>(A, Bf, tw, i);
    __syncthreads();
    stage<64>(Bf, A, tw, i);
    __syncthreads();

    // Bins 0..HALF of the real FFT, their power into Bf.
    float* P = reinterpret_cast<float*>(Bf);
    for (int k = i; k <= HALF; k += TPF) {
      const float2 zk = A[pad(k & (HALF - 1))];
      const float2 zm = A[pad((HALF - k) & (HALF - 1))];
      const float2 e = make_float2((zk.x + zm.x) * 0.5f, (zk.y - zm.y) * 0.5f);
      const float2 o = make_float2((zk.y + zm.y) * 0.5f, (zm.x - zk.x) * 0.5f);
      const float2 w = tw[k];
      const float xr = e.x + (w.x * o.x - w.y * o.y);
      const float xi = e.y + (w.x * o.y + w.y * o.x);
      P[k] = xr * xr + xi * xi;
    }
    __syncthreads();

    // Mel filters i and NMELS - 1 - i over their bands, then the log.
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = h ? NMELS - 1 - i : i;
        const int lo = bs[3 * m], cnt = bs[3 * m + 1], off = bs[3 * m + 2];
        float acc = 0.f;
        for (int c = 0; c < cnt; ++c) acc = fmaf(P[lo + c], ws[off + c], acc);
        out[static_cast<size_t>(f) * NMELS + m] = logf(fmaxf(acc, log_floor));
      }
    }
    __syncthreads();                // A and Bf are rewritten next group
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace

OMNI_API int omni_log_mel(const float* frames, const float* win, int n_win,
                          const float* twiddles, const float* fb,
                          const int* bands, int n_weights, float* out,
                          int n_frames, int n_fft, int n_mels,
                          float log_floor, void* stream) {
  if (n_frames <= 0 || n_fft != N_FFT || n_mels != NMELS || n_win <= 0 ||
      n_win > N_FFT || n_weights < 0 || n_weights > MAX_WEIGHTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * N_FFT + 2 * 2 * FPB * PAD_LEN + 3 * NMELS +
                       n_weights + n_win) * sizeof(float);
  cudaError_t err = omni::allow_smem(log_mel_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (n_frames + FPB - 1) / FPB;
  const dim3 grid(n_groups < 4 * sm_count() ? n_groups : 4 * sm_count());
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, win, n_win, reinterpret_cast<const float2*>(twiddles), fb,
      bands, n_weights, out, n_frames, log_floor);
  return static_cast<int>(cudaGetLastError());
}
