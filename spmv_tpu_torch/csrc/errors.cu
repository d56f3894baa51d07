// Error text for the launch entries' return codes (cudaError_t values).
#include <cuda_runtime.h>

extern "C" const char* spmv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
