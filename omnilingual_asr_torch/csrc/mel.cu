// K1: fused log-mel frontend.
//
// Replaces omnilingual_asr_tpu/ops/mel_pallas.py::_mel_kernel (launched by
// log_mel_frames_pallas). For frames F [N, n_fft] (raw, unwindowed), the
// Hann-windowed DFT matrices Cw, Sw [n_fft, n_bins] and the mel filterbank
// FB [n_bins, 128] it computes
//
//     out = log(max(((F Cw)^2 + (F Sw)^2) FB, floor))          [N, 128]
//
// entirely in f32 FMA on the CUDA cores: the reference runs these products
// at Precision.HIGHEST (true f32), so neither TF32 nor bf16 tensor-core
// paths are allowed (they would lift the -100 dB feature noise floor).
//
// What bounds it on an H100: operations. At the main path's shapes
// (N = 4 windows x 3072 frames, n_fft 1024, 513 bins, 128 mels) the function
// needs 27.4 GFLOP of f32 FMA against 50 MB of frames, i.e. ~550 FLOP per
// byte, far above the card's f32 ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B).
// The bins arrive zero-padded to 576 (a multiple of BN), so the kernel does
// 30.8 GFLOP.
//
// Design: one block of 256 threads owns 128 frames. It walks the 576 bins in
// chunks of 64; for each chunk it runs a register-tiled GEMM (8 frames x 4
// bins x {re, im} per thread, 16-deep shared-memory stages) for Re and Im
// together, squares them into a transposed power tile in shared memory, and
// immediately folds that tile into the 128 x 128 mel accumulator it keeps in
// registers (8 x 8 per thread). Re, Im and the power spectrum never reach
// device memory; each frame is read once from DRAM (later chunks hit L2).
// The TPU kernel ran 256-frame blocks in order on one core; here 96 blocks
// of 128 frames run in parallel across the SMs.
#include "common.cuh"

namespace {

constexpr int BM = 128;           // frames per block
constexpr int BN = 64;            // DFT bins per chunk
constexpr int BK = 16;            // n_fft depth per shared-memory stage
constexpr int NMELS = 128;
constexpr int THREADS = 256;
constexpr int AS_LD = BM + 4;     // transposed frame tile row (padded)
constexpr int PS_LD = BM + 4;     // transposed power tile row (padded)
constexpr int SMEM_FLOATS =
    BK * AS_LD + 2 * BK * BN + BN * PS_LD + BN * NMELS;

__global__ void __launch_bounds__(THREADS, 1)
log_mel_kernel(const float* __restrict__ frames, const float* __restrict__ cw,
               const float* __restrict__ sw, const float* __restrict__ fb,
               float* __restrict__ out, int n_frames, int n_fft, int n_bins,
               float log_floor) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                    // [BK][AS_LD]  frames, transposed
  float* Cs = As + BK * AS_LD;         // [BK][BN]     windowed cos tile
  float* Ss = Cs + BK * BN;            // [BK][BN]     windowed sin tile
  float* PsT = Ss + BK * BN;           // [BN][PS_LD]  power, transposed
  float* Fs = PsT + BN * PS_LD;        // [BN][NMELS]  filterbank chunk

  const int tid = threadIdx.x;
  const int tx = tid & 15;             // bins tx*4.. / mels tx*8..
  const int ty = tid >> 4;             // frames ty*8..
  const int m0 = blockIdx.x * BM;

  float mel[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mel[i][j] = 0.f;

  for (int n0 = 0; n0 < n_bins; n0 += BN) {
    float re[8][4], im[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += BK) {
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const int idx = tid + l * THREADS;           // 0..511
        const int row = idx >> 2;
        const int kq = (idx & 3) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + row < n_frames)
          v = *reinterpret_cast<const float4*>(
              frames + static_cast<size_t>(m0 + row) * n_fft + k0 + kq);
        As[(kq + 0) * AS_LD + row] = v.x;
        As[(kq + 1) * AS_LD + row] = v.y;
        As[(kq + 2) * AS_LD + row] = v.z;
        As[(kq + 3) * AS_LD + row] = v.w;
      }
      {
        const int k = tid >> 4;
        const int nq = (tid & 15) * 4;
        const size_t g = static_cast<size_t>(k0 + k) * n_bins + n0 + nq;
        *reinterpret_cast<float4*>(Cs + k * BN + nq) =
            *reinterpret_cast<const float4*>(cw + g);
        *reinterpret_cast<float4*>(Ss + k * BN + nq) =
            *reinterpret_cast<const float4*>(sw + g);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(As + k * AS_LD + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(As + k * AS_LD + ty * 8 + 4);
        const float4 c = *reinterpret_cast<const float4*>(Cs + k * BN + tx * 4);
        const float4 s = *reinterpret_cast<const float4*>(Ss + k * BN + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float cc[4] = {c.x, c.y, c.z, c.w};
        const float ss[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], cc[j], re[i][j]);
            im[i][j] = fmaf(a[i], ss[j], im[i][j]);
          }
      }
      __syncthreads();
    }

    // Power spectrum of this bin chunk, transposed: PsT[bin][frame].
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        PsT[(tx * 4 + j) * PS_LD + ty * 8 + i] =
            re[i][j] * re[i][j] + im[i][j] * im[i][j];
#pragma unroll
    for (int l = 0; l < (BN * NMELS / 4) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int b = idx / (NMELS / 4);
      const int mq = (idx % (NMELS / 4)) * 4;
      *reinterpret_cast<float4*>(Fs + b * NMELS + mq) =
          *reinterpret_cast<const float4*>(
              fb + static_cast<size_t>(n0 + b) * NMELS + mq);
    }
    __syncthreads();
#pragma unroll 4
    for (int b = 0; b < BN; ++b) {
      const float4 p0 = *reinterpret_cast<const float4*>(PsT + b * PS_LD + ty * 8);
      const float4 p1 = *reinterpret_cast<const float4*>(PsT + b * PS_LD + ty * 8 + 4);
      const float4 f0 = *reinterpret_cast<const float4*>(Fs + b * NMELS + tx * 8);
      const float4 f1 = *reinterpret_cast<const float4*>(Fs + b * NMELS + tx * 8 + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mel[i][j] = fmaf(p[i], f[j], mel[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= n_frames) continue;
    float* dst = out + static_cast<size_t>(row) * NMELS + tx * 8;
    float4 o0, o1;
    o0.x = logf(fmaxf(mel[i][0], log_floor));
    o0.y = logf(fmaxf(mel[i][1], log_floor));
    o0.z = logf(fmaxf(mel[i][2], log_floor));
    o0.w = logf(fmaxf(mel[i][3], log_floor));
    o1.x = logf(fmaxf(mel[i][4], log_floor));
    o1.y = logf(fmaxf(mel[i][5], log_floor));
    o1.z = logf(fmaxf(mel[i][6], log_floor));
    o1.w = logf(fmaxf(mel[i][7], log_floor));
    *reinterpret_cast<float4*>(dst) = o0;
    *reinterpret_cast<float4*>(dst + 4) = o1;
  }
}

}  // namespace

OMNI_API int omni_log_mel(const float* frames, const float* cw,
                          const float* sw, const float* fb, float* out,
                          int n_frames, int n_fft, int n_bins, int n_mels,
                          float log_floor, void* stream) {
  if (n_frames <= 0 || n_mels != NMELS || n_fft % BK != 0 ||
      n_bins % BN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = omni::allow_smem(log_mel_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + BM - 1) / BM);
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, cw, sw, fb, out, n_frames, n_fft, n_bins, log_floor);
  return static_cast<int>(cudaGetLastError());
}
