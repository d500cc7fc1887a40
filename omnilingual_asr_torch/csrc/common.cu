// C helpers shared by every kernel entry point.
#include "common.cuh"

OMNI_API const char* omni_error_string(int err) {
  switch (err) {
    case omni::OMNI_ERR_MISALIGNED:
      return "operand not 16-byte aligned (a TMA tensor map needs it)";
    case omni::OMNI_ERR_NO_TENSOR_MAPS:
      return "the driver has no cuTensorMapEncodeTiled";
    case omni::OMNI_ERR_TENSOR_MAP:
      return "cuTensorMapEncodeTiled refused the tensor map";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
