// Status codes the kernels' C functions return besides 0 and cudaError_t
// values (which stay below 1000).
#pragma once

constexpr int kWsUnsupportedShape = 9000;  // a shape or tile not compiled
constexpr int kWsNoDriverEntry = 9001;     // no cuTensorMapEncodeTiled
constexpr int kWsTensorMapError = 10000;   // + the CUresult of the encode
