// Ground-plane scatter-max splat for Hopper (sm_90a).
//
// Replaces: ws_mgmap_tpu/ops/pallas/splat.py::splat_pallas (and its
// packed-row variant splat_pallas_packed, which existed only to fit TPU
// VMEM): per ego-grid cell, the max over the pixels whose cell id lands
// there, fp32 accumulation, 0 for cells with no valid pixel and for any
// max <= -1e16. Pixels with id < 0 are invalid and skipped.
//
// What bounds it: bytes. The features (B*P*C, bf16 or fp32), the ids
// (B*P int32) and the fp32 output (B*cells*C) each pass once through
// device memory; the arithmetic is one compare per feature.
//
// Design: the TPU kernel kept n_acc copies of the 2.56 MB fp32 per-frame
// accumulator in VMEM; a Hopper SM has 227 KB of shared memory, so the
// accumulator lives in the output buffer in device memory (hot in the
// 50 MB L2) and blocks merge into it with atomics. Max is order
// independent, so the result is exact and deterministic.
//   pass 1 fills the output with -inf;
//   pass 2 runs one thread per (pixel, channel): an invalid pixel's
//          thread returns after reading its id; a valid one reads its
//          feature (bf16 converted in registers, no fp32 copy of the map)
//          and merges it with a float atomic max, skipped when a plain
//          read already shows a value at least as large (values only grow,
//          so a stale read only costs a redundant atomic);
//   pass 3 writes 0 where the max is <= -1e16 (untouched cells are -inf).
// About 75% of pixels are invalid (height filter, off-grid) and the valid
// ones crowd near the agent, so atomics contend on those cells; the
// read-before-atomic test removes most of that traffic for post-ReLU
// features, where most values lose to the current max.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsInvalid = -1e16f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Float max through integer atomics. For a value with the sign bit clear,
// the IEEE bit pattern orders like a signed int; with it set (negative
// values and -0.0) a larger float has a smaller unsigned pattern. Mixed
// signs order correctly in both cases, and -inf is the identity.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!(__float_as_uint(v) >> 31)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void fill_neg_inf(float* __restrict__ out, int64_t n) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i < n) out[i] = -INFINITY;
}

template <typename T>
__global__ void scatter_max(const T* __restrict__ feats,
                            const int* __restrict__ ids,
                            float* __restrict__ out, int64_t n_pix, int P,
                            int C, int cells) {
  int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n_pix * C) return;
  int64_t pix = t / C;  // b * P + p
  int c = static_cast<int>(t - pix * C);
  int id = __ldg(ids + pix);
  if (id < 0) return;
  float v = to_float(feats[t]);
  int64_t b = pix / P;
  float* dst = out + (b * cells + id) * static_cast<int64_t>(C) + c;
  if (v > *reinterpret_cast<volatile float*>(dst)) atomic_max_float(dst, v);
}

__global__ void zero_eps(float* __restrict__ out, int64_t n) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i < n && out[i] <= kEpsInvalid) out[i] = 0.0f;
}

template <typename T>
int launch(const void* feats, const int* ids, float* out, int B, int P, int C,
           int cells, cudaStream_t stream) {
  constexpr int kThreads = 256;
  int64_t n_out = static_cast<int64_t>(B) * cells * C;
  int64_t n_in = static_cast<int64_t>(B) * P * C;
  unsigned g_out = static_cast<unsigned>((n_out + kThreads - 1) / kThreads);
  unsigned g_in = static_cast<unsigned>((n_in + kThreads - 1) / kThreads);
  fill_neg_inf<<<g_out, kThreads, 0, stream>>>(out, n_out);
  scatter_max<T><<<g_in, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), ids, out, static_cast<int64_t>(B) * P, P,
      C, cells);
  zero_eps<<<g_out, kThreads, 0, stream>>>(out, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats [B, P, C] (fp32 or bf16), ids [B, P] int32 in [-1, cells),
// out [B, cells, C] fp32. All contiguous. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int ws_splat_max_f32(const void* feats, const void* ids, void* out,
                                int B, int P, int C, int cells, void* stream) {
  return launch<float>(feats, static_cast<const int*>(ids),
                       static_cast<float*>(out), B, P, C, cells,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ws_splat_max_bf16(const void* feats, const void* ids, void* out,
                                 int B, int P, int C, int cells,
                                 void* stream) {
  return launch<__nv_bfloat16>(feats, static_cast<const int*>(ids),
                               static_cast<float*>(out), B, P, C, cells,
                               static_cast<cudaStream_t>(stream));
}
