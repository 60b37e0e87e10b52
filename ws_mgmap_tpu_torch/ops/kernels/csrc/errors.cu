// Error text for the cudaError_t codes the kernels' C functions return.
#include <cuda_runtime.h>

extern "C" const char* ws_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
