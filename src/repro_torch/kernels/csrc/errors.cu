// Error text for the codes the kernel entry points return.
#include "common.cuh"

REPRO_API const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
