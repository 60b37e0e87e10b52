// Error text for the codes the kernels' C functions return: cudaError_t
// values and the codes of status.cuh.
#include <cuda_runtime.h>

#include "status.cuh"

extern "C" const char* ws_cuda_error_string(int status) {
  if (status == kWsUnsupportedShape)
    return "shape or tile the kernel was not compiled for";
  if (status == kWsNoDriverEntry)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (status >= kWsTensorMapError)
    return "cuTensorMapEncodeTiled refused the tensor map (CUresult = "
           "status - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
