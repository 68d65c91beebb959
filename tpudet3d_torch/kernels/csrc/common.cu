// C entry shared by all kernels: the message for a CUDA error code.
#include <cuda_runtime.h>

extern "C" const char* tpd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
