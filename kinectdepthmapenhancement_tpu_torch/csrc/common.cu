// Error text for the status codes the kernels' C entry points return.

#include <cuda_runtime.h>

extern "C" const char* kde_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
