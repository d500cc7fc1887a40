// Shared definitions for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C entry point that launches on
// the caller's stream, allocates nothing and returns cudaGetLastError() as
// an int; the Python wrapper (ops/*.py) raises when it is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define OMNI_API extern "C" __attribute__((visibility("default")))

namespace omni {

// Errors of an entry point's own checks, beside cudaError_t's values
// (omni_error_string names them).
constexpr int OMNI_ERR_MISALIGNED = 10001;     // a TMA operand's base
constexpr int OMNI_ERR_NO_TENSOR_MAPS = 10002; // no cuTensorMapEncodeTiled
constexpr int OMNI_ERR_TENSOR_MAP = 10003;     // the driver refused a map

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace omni
