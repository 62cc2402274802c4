// Shared C entry of the kernel library: CUDA error text for the Python wrappers.
#include <cuda_runtime.h>

extern "C" const char* ofri_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
