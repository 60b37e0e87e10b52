// Fused 3x3 stride-1 SAME conv + folded BN (+ residual) (+ ReLU), NHWC,
// for Hopper (sm_90a).
//
// Replaces: ws_mgmap_tpu/ops/pallas/conv.py::conv3x3_bn_relu. Computes
//   y = [relu](conv3x3(concat([x, x2], C)) * scale + bias [+ residual])
// with fp32 accumulation and the output in the input dtype. x2 (the UNet
// decoder's skip input) is read as its own operand, so the channel concat
// is never materialized; residual and x2 are never combined.
//
// What bounds it: operations. At the UNet's shapes each input element
// feeds 9*Co multiply-adds, far above the card's ~300 FLOP/byte balance
// point, so the floor is the tensor-core rate (989 TFLOP/s dense bf16).
//
// Design of this first version (simple and right first): a direct conv on
// CUDA cores in fp32 FMA, far from that floor; wgmma/TMA pipelining is
// later work. A block owns an 8x16 tile of output pixels x 64 output
// channels. It walks the input channels in chunks of 8: for each chunk it
// stages the (8+2)x(16+2) halo of the input (from x or x2 by channel,
// zero outside the image and past the last channel) and the 3x3x8x64
// weight slice in shared memory as fp32, then each of the 256 threads
// accumulates 4 pixels x 8 channels in registers. The epilogue applies
// scale/bias, the residual and the ReLU and stores in the input dtype.
// Ragged channel counts and image edges are masked, so Ci and Co need not
// be multiples of anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;    // output rows per block
constexpr int kTW = 16;   // output columns per block
constexpr int kTCO = 64;  // output channels per block
constexpr int kKC = 8;    // input channels per staged chunk
constexpr int kThreads = 256;
constexpr int kHaloH = kTH + 2;
constexpr int kHaloW = kTW + 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ x2,
               const T* __restrict__ w, const float* __restrict__ scale,
               const float* __restrict__ bias, const T* __restrict__ residual,
               T* __restrict__ out, int H, int W, int C1, int C2, int Co,
               int relu) {
  __shared__ float in_s[kKC][kHaloH][kHaloW];
  __shared__ __align__(16) float w_s[9][kKC][kTCO];

  const int Ci = C1 + C2;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kTCO;
  const int64_t b = blockIdx.z;

  const int tid = threadIdx.x;
  const int co_g = tid & 7;        // channels co_g*4+[0,4) and 32+co_g*4+[0,4)
  const int pg = tid >> 3;         // 32 pixel groups of 4 columns
  const int row = pg >> 2;         // 0..7
  const int col0 = (pg & 3) * 4;   // 0, 4, 8, 12

  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.0f;

  for (int cb = 0; cb < Ci; cb += kKC) {
    // stage the input halo for channels [cb, cb + kKC)
    for (int e = tid; e < kKC * kHaloH * kHaloW; e += kThreads) {
      const int k = e % kKC;
      const int pos = e / kKC;
      const int hr = pos / kHaloW;
      const int hc = pos % kHaloW;
      const int gy = y0 + hr - 1;
      const int gx = x0 + hc - 1;
      const int ch = cb + k;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Ci) {
        const int64_t pix = (b * H + gy) * W + gx;
        v = ch < C1 ? to_float(x[pix * C1 + ch])
                    : to_float(x2[pix * C2 + (ch - C1)]);
      }
      in_s[k][hr][hc] = v;
    }
    // stage the weight slice w[tap, cb:cb+kKC, co0:co0+kTCO]
    for (int e = tid; e < 9 * kKC * kTCO; e += kThreads) {
      const int co = e % kTCO;
      const int k = (e / kTCO) % kKC;
      const int tap = e / (kTCO * kKC);
      const int ch = cb + k;
      float v = 0.0f;
      if (ch < Ci && co0 + co < Co)
        v = to_float(w[(static_cast<int64_t>(tap) * Ci + ch) * Co + co0 + co]);
      w_s[tap][k][co] = v;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kKC; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float iv[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) iv[i] = in_s[k][row + dy][col0 + i];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wa =
              *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx][k][co_g * 4]);
          const float4 wb = *reinterpret_cast<const float4*>(
              &w_s[dy * 3 + dx][k][32 + co_g * 4]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float a = iv[p + dx];
            acc[p][0] = fmaf(a, wa.x, acc[p][0]);
            acc[p][1] = fmaf(a, wa.y, acc[p][1]);
            acc[p][2] = fmaf(a, wa.z, acc[p][2]);
            acc[p][3] = fmaf(a, wa.w, acc[p][3]);
            acc[p][4] = fmaf(a, wb.x, acc[p][4]);
            acc[p][5] = fmaf(a, wb.y, acc[p][5]);
            acc[p][6] = fmaf(a, wb.z, acc[p][6]);
            acc[p][7] = fmaf(a, wb.w, acc[p][7]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gy = y0 + row;
  if (gy >= H) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gx = x0 + col0 + p;
    if (gx >= W) continue;
    const int64_t base = ((b * H + gy) * W + gx) * Co;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + (j < 4 ? co_g * 4 + j : 32 + co_g * 4 + (j - 4));
      if (co >= Co) continue;
      float v = acc[p][j] * scale[co] + bias[co];
      if (residual != nullptr) v += to_float(residual[base + co]);
      if (relu) v = fmaxf(v, 0.0f);
      out[base + co] = from_float<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* x2, const void* w, const void* scale,
           const void* bias, const void* residual, void* out, int B, int H,
           int W, int C1, int C2, int Co, int relu, cudaStream_t stream) {
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const dim3 grid(tiles, (Co + kTCO - 1) / kTCO, B);
  conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(x2),
      static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(residual),
      static_cast<T*>(out), H, W, C1, C2, Co, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B,H,W,C1], x2 [B,H,W,C2] or null (C2 = 0), w [3,3,C1+C2,Co] (HWIO),
// scale/bias [Co] fp32, residual [B,H,W,Co] or null, out [B,H,W,Co]; all
// contiguous, x/x2/w/residual/out in one dtype. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ws_conv3x3_bn_act_f32(const void* x, const void* x2,
                                     const void* w, const void* scale,
                                     const void* bias, const void* residual,
                                     void* out, int B, int H, int W, int C1,
                                     int C2, int Co, int relu, void* stream) {
  return launch<float>(x, x2, w, scale, bias, residual, out, B, H, W, C1, C2,
                       Co, relu, static_cast<cudaStream_t>(stream));
}

extern "C" int ws_conv3x3_bn_act_bf16(const void* x, const void* x2,
                                      const void* w, const void* scale,
                                      const void* bias, const void* residual,
                                      void* out, int B, int H, int W, int C1,
                                      int C2, int Co, int relu,
                                      void* stream) {
  return launch<__nv_bfloat16>(x, x2, w, scale, bias, residual, out, B, H, W,
                               C1, C2, Co, relu,
                               static_cast<cudaStream_t>(stream));
}
