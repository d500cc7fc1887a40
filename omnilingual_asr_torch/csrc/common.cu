// C helpers shared by every kernel entry point.
#include "common.cuh"

OMNI_API const char* omni_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
