// Fused 3x3 stride-1 SAME conv + folded BN (+ residual) (+ ReLU), NHWC,
// in fp32 FMA on the CUDA cores, for Hopper (sm_90a).
//
// Replaces: ws_mgmap_tpu/ops/pallas/conv.py:113 (conv3x3_bn_relu) where
// the tensor cores may not run it: fp32, which they would round to TF32,
// and channel counts the wgmma kernel (conv3x3_wgmma.cu) does not take.
// Computes
//   y = [relu](conv3x3(concat([x, x2], C)) * scale + bias [+ residual])
// with fp32 accumulation and the output in the input dtype (fp32, or bf16
// with ragged channels). x2 (the UNet decoder's skip input) is read as its
// own operand, so the channel concat is never materialized; residual and
// x2 are never combined.
//
// What bounds it: operations, at the card's fp32 FMA rate (67 TFLOP/s on
// an H100 SXM). Each input element feeds 9*Co multiply-adds and each
// weight element B*H*W, far above the ~20 FLOP/byte at which fp32 FMA
// and HBM balance, so every fused site is bound by operations.
//
// The design: an implicit GEMM on the CUDA cores, tiled in the classic
// SGEMM way. M = a TH x TW tile of output pixels of one image, N = a BN
// slice of Co, K = 9 taps x (C1 + C2), walked in chunks of KC input
// channels, each chunk taken from x or from x2 (never both; a chunk past
// the last channel of its operand is zero-filled, as is its weight).
//   - Each thread holds 8 neighbouring pixels of one row x 8 channels: 64
//     fp32 accumulators. A chunk is 3 * KC / 4 work units, one per
//     (channel quad, dy): the thread reads its row's 8 + 2 halo values
//     once from shared memory, as float4 along the channels, reuses them
//     over the three dx taps, and reads its 8 weights of each (tap,
//     channel) as two float4 along Co: 768 FMAs per 34 shared loads.
//   - The unit loop is not unrolled: one unit's body is the whole hot
//     loop. Unrolled over a chunk's units, the code outgrew the
//     instruction cache and KC = 16 ran at half speed.
//   - `split` thread groups share each chunk's units and, at the end, sum
//     their partial tiles through shared memory. Where the grid is short
//     of the card (the 12^2-56^2 sites at B=6), this cuts each block's
//     critical path by the split.
//   - A warp is 4 rows x 8 channel groups: the 8 channel groups of a row
//     read 128 contiguous bytes of weights, the 4 rows broadcast each
//     weight, and a halo pixel's channels sit KC + 4 floats apart, so the
//     4 rows' float4 reads land in 4 distinct bank quads (the row stride,
//     (TW + 2) * (KC + 4), is 8 or 24 mod 32 words): no bank conflicts.
//   - A ring of stages in dynamic shared memory (3 at KC = 8; 2 at KC =
//     16, so that two blocks fit an SM), filled by cp.async: the (TH+2) x
//     (TW+2) x KC input halo and the 9 x KC x BN weight slice of one
//     chunk. The copies of chunk j + stages - 1 are issued before chunk j
//     is computed, behind one __syncthreads a chunk. cp.async's zero fill
//     (source size 0) writes the SAME padding outside the image, the
//     channels past the operand's last one and the output channels past
//     Co, so the copies have no branches. The copies are 16 bytes where
//     C1, C2 and Co are multiples of 4 and every pointer is 16-byte
//     aligned (every fp32 site of the UNet and the map decoder), 4 bytes
//     otherwise; bf16 (ragged channels only) is loaded, widened to fp32
//     and stored by the threads.
//   - Index math is hoisted: a thread's halo copies decode their pixel
//     once a block; per chunk only the operand, its channel stride and the
//     channel base change. Every tile dimension is a compile-time constant,
//     so the remaining divisions are multiplies and shifts.
//   - A launch plan per shape: conv.py::direct_tile picks one of the
//     tiles of WS_DIRECT_TILES by a cost model fitted to their measured
//     times (conv.py::direct_cost): the widest unsplit tile on a full
//     card, split tiles and short chunks where the grid is short of it.
//     Shared memory above 48 KB is granted with cudaFuncSetAttribute;
//     ws_conv3x3_direct_smem_bytes and ws_conv3x3_direct_blocks_per_sm
//     report the plan's inputs, so the Python plan can be held against the
//     kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "status.cuh"

namespace {

constexpr int kPX = 8;  // output pixels a thread holds, along a row

// copy modes: 16-byte cp.async, 4-byte cp.async, bf16 loaded and widened
enum Mode { kVec4 = 0, kScalar = 1, kWiden = 2 };

// TH x TW pixels x BN channels; chunks of kKC input channels, whose
// (channel quad, dy) work units kSplit thread groups share (and sum their
// partial tiles at the end); a ring of kStages chunks
template <int TH_, int TW_, int BN_, int kKC_, int kSplit_, int kStages_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_, BN = BN_, kKC = kKC_;
  static constexpr int kSplit = kSplit_, kStages = kStages_;
  static constexpr int kKP = kKC + 4;  // floats between two halo pixels
  static constexpr int kUnits = (kKC / 4) * 3;
  static constexpr int kGroupThreads = TH * TW * BN / (kPX * 8);
  static constexpr int kThreads = kSplit * kGroupThreads;
  static constexpr int kHaloH = TH + 2, kHaloW = TW + 2;
  static constexpr int kInFloats = kHaloH * kHaloW * kKP;
  static constexpr int kWFloats = 9 * kKC * BN;
  static constexpr int kStageFloats = kInFloats + kWFloats;
  static constexpr int kRingFloats = kStages * kStageFloats;
  static constexpr int kSumFloats = (kSplit - 1) * kGroupThreads * 64;
  static constexpr int kSmemBytes =
      4 * (kRingFloats > kSumFloats ? kRingFloats : kSumFloats);
  static_assert(TH % 4 == 0 && TW % kPX == 0 && BN % 64 == 0,
                "a warp is 4 rows x 8 channel groups of 8 channels");
  static_assert(kInFloats % 4 == 0, "stages stay 16-byte aligned");
  static_assert(kUnits % kSplit == 0 && kStages >= 2, "split and ring");
  static_assert(kKC % 4 == 0, "chunks of channel quads");
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// copy `bytes` (16 or 4) from global to shared; zero-fill when !valid
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const void* src,
                                         bool valid) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One chunk: channels [ch0, ch0 + nvalid) of `src` (channel stride cs),
// which are channels [wch0, wch0 + nvalid) of the weight.
template <typename T>
struct Chunk {
  const T* src;
  int cs, ch0, nvalid, wch0;
};

template <int kKC, typename T>
__device__ __forceinline__ Chunk<T> chunk_of(int j, int n1, const T* x,
                                             const T* x2, int C1, int C2) {
  Chunk<T> c;
  if (j < n1) {
    c.src = x;
    c.cs = C1;
    c.ch0 = j * kKC;
    c.nvalid = min(kKC, C1 - c.ch0);
    c.wch0 = c.ch0;
  } else {
    c.src = x2;
    c.cs = C2;
    c.ch0 = (j - n1) * kKC;
    c.nvalid = min(kKC, C2 - c.ch0);
    c.wch0 = C1 + c.ch0;
  }
  return c;
}

template <class Tl, typename T, int kMode>
__global__ void __launch_bounds__(Tl::kThreads)
conv3x3_direct_kernel(const T* __restrict__ x, const T* __restrict__ x2,
                      const T* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const T* __restrict__ residual, T* __restrict__ out,
                      int H, int W, int C1, int C2, int Co, int relu) {
  constexpr int TH = Tl::TH, TW = Tl::TW, BN = Tl::BN;
  constexpr int kKC = Tl::kKC, kKP = Tl::kKP;
  constexpr int kThreads = Tl::kThreads;
  constexpr int kHaloW = Tl::kHaloW;
  constexpr int kHaloPix = Tl::kHaloH * kHaloW;
  extern __shared__ __align__(16) float smem[];

  const int Ci = C1 + C2;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;

  const int tid = threadIdx.x;
  const int group = tid / Tl::kGroupThreads;  // warp-uniform
  const int gt = tid % Tl::kGroupThreads;
  const int lane = gt & 31, warp = gt >> 5;
  constexpr int kWarpsCo = BN / 64, kWarpsW = TW / kPX;
  const int cg = (warp % kWarpsCo) * 8 + (lane & 7);
  const int col0 = ((warp / kWarpsCo) % kWarpsW) * kPX;
  const int row = (warp / (kWarpsCo * kWarpsW)) * 4 + (lane >> 3);
  const int ca = cg * 4, cb = BN / 2 + cg * 4;  // the thread's 2 channel quads

  // the halo copies of this thread (16-byte mode): pixel index in the
  // batch (-1 outside the image) and shared-memory offset, decoded once
  constexpr int kIn4 = kHaloPix * (kKC / 4);
  constexpr int kInSlots = (kIn4 + kThreads - 1) / kThreads;
  int in_pix[kInSlots], in_dst[kInSlots];
  if constexpr (kMode == kVec4) {
#pragma unroll
    for (int i = 0; i < kInSlots; ++i) {
      const int e = tid + i * kThreads;
      const int p = e / (kKC / 4), q = e % (kKC / 4);
      const int gy = y0 + p / kHaloW - 1, gx = x0 + p % kHaloW - 1;
      const bool in = e < kIn4 && gy >= 0 && gy < H && gx >= 0 && gx < W;
      in_pix[i] = in ? (b * H + gy) * W + gx : -1;
      in_dst[i] = e < kIn4 ? p * kKP + q * 4 : -1;
    }
  }

  auto load = [&](int stage, const Chunk<T>& c) {
    float* in_s = smem + stage * Tl::kStageFloats;
    float* w_s = in_s + Tl::kInFloats;
    if constexpr (kMode == kVec4) {
#pragma unroll
      for (int i = 0; i < kInSlots; ++i) {
        if (in_dst[i] < 0) continue;
        const int q = (in_dst[i] % kKP) / 4;
        const bool valid = in_pix[i] >= 0 && q * 4 < c.nvalid;
        const T* src = valid ? c.src + static_cast<int64_t>(in_pix[i]) * c.cs
                                   + c.ch0 + q * 4
                             : c.src;
        cp_async<16>(in_s + in_dst[i], src, valid);
      }
      // w_s[tap][k][BN] in the order of the copies: element e * 4. Not
      // unrolled: unrolled, the compiler keeps every copy's address live
      // across the chunk loop and runs out of registers
#pragma unroll 1
      for (int e = tid; e < 9 * kKC * BN / 4; e += kThreads) {
        const int tap = e / (kKC * BN / 4);
        const int k = (e / (BN / 4)) % kKC;
        const int co = co0 + (e % (BN / 4)) * 4;
        const bool valid = k < c.nvalid && co < Co;
        const T* src =
            valid ? w + (static_cast<int64_t>(tap) * Ci + c.wch0 + k) * Co + co
                  : w;
        cp_async<16>(w_s + e * 4, src, valid);
      }
    } else {
      for (int e = tid; e < kHaloPix * kKC; e += kThreads) {
        const int p = e / kKC, k = e % kKC;
        const int gy = y0 + p / kHaloW - 1, gx = x0 + p % kHaloW - 1;
        const bool valid = k < c.nvalid && gy >= 0 && gy < H && gx >= 0 &&
                           gx < W;
        const T* src =
            valid ? c.src + static_cast<int64_t>((b * H + gy) * W + gx) * c.cs
                        + c.ch0 + k
                  : c.src;
        if constexpr (kMode == kScalar)
          cp_async<4>(in_s + p * kKP + k, src, valid);
        else
          in_s[p * kKP + k] = valid ? to_float(*src) : 0.0f;
      }
      for (int e = tid; e < 9 * kKC * BN; e += kThreads) {
        const int tap = e / (kKC * BN);
        const int k = (e / BN) % kKC;
        const int co = co0 + e % BN;
        const bool valid = k < c.nvalid && co < Co;
        const T* src =
            valid ? w + (static_cast<int64_t>(tap) * Ci + c.wch0 + k) * Co + co
                  : w;
        if constexpr (kMode == kScalar)
          cp_async<4>(w_s + e, src, valid);
        else
          w_s[e] = valid ? to_float(*src) : 0.0f;
      }
    }
  };

  float acc[kPX][8];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.0f;

  constexpr int kStages = Tl::kStages;
  const int n1 = (C1 + kKC - 1) / kKC;
  const int nchunks = n1 + (C2 + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load(s, chunk_of<kKC>(s, n1, x, x2, C1, C2));
    cp_async_commit();
  }

  for (int j = 0; j < nchunks; ++j) {
    // chunk j has landed (this thread's copies), and after the barrier
    // everyone's; everyone is also done with chunk j-1's stage, which
    // chunk j + kStages - 1 refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int jn = j + kStages - 1;
    if (jn < nchunks)
      load(jn % kStages, chunk_of<kKC>(jn, n1, x, x2, C1, C2));
    cp_async_commit();

    const float* in_s = smem + (j % kStages) * Tl::kStageFloats;
    const float* w_s = in_s + Tl::kInFloats;
    // this group's units; one unit's body (10 + 24 shared loads, 768
    // FMAs) is the hot loop: unrolled over the units, the code outgrows
    // the instruction cache
#pragma unroll 1
    for (int i = 0; i < Tl::kUnits / Tl::kSplit; ++i) {
      const int u = group + i * Tl::kSplit;
      const int q = u / 3, dy = u % 3;
      {
        const float* src = in_s + ((row + dy) * kHaloW + col0) * kKP + q * 4;
        float4 iv[kPX + 2];
#pragma unroll
        for (int i = 0; i < kPX + 2; ++i)
          iv[i] = *reinterpret_cast<const float4*>(src + i * kKP);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wr =
                w_s + ((dy * 3 + dx) * kKC + q * 4 + kk) * BN;
            const float4 wa = *reinterpret_cast<const float4*>(wr + ca);
            const float4 wb = *reinterpret_cast<const float4*>(wr + cb);
#pragma unroll
            for (int p = 0; p < kPX; ++p) {
              const float a = lane4(iv[p + dx], kk);
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
    }
  }
  cp_async_wait<0>();  // the ring's trailing (empty) groups
  if constexpr (Tl::kSplit > 1) {
    // groups 1.. leave their partial tiles in the ring's place; group 0
    // sums them and writes the output
    float* part = smem;
    __syncthreads();
    if (group > 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        part[((group - 1) * 64 + i) * Tl::kGroupThreads + gt] =
            acc[i / 8][i % 8];
    }
    __syncthreads();
    if (group > 0) return;
    for (int g = 1; g < Tl::kSplit; ++g) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i / 8][i % 8] += part[((g - 1) * 64 + i) * Tl::kGroupThreads + gt];
    }
  }

  // epilogue: * scale + bias [+ residual] [relu], the input dtype
  const int gy = y0 + row;
  if (gy >= H) return;
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + (j < 4 ? ca + j : cb + j - 4);
    sc[j] = co < Co ? scale[co] : 0.0f;
    bi[j] = co < Co ? bias[co] : 0.0f;
  }
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int gx = x0 + col0 + p;
    if (gx >= W) break;
    const int64_t base = (static_cast<int64_t>(b * H + gy) * W + gx) * Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + (h ? cb : ca);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = acc[p][h * 4 + j] * sc[h * 4 + j] + bi[h * 4 + j];
      if constexpr (kMode == kVec4) {
        if (co >= Co) continue;  // Co % 4 == 0: the quad is whole or out
        if (residual != nullptr) {
          const float4 r =
              *reinterpret_cast<const float4*>(residual + base + co);
          v[0] += r.x, v[1] += r.y, v[2] += r.z, v[3] += r.w;
        }
        if (relu) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], 0.0f);
        }
        *reinterpret_cast<float4*>(out + base + co) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (co + j >= Co) continue;
          float u = v[j];
          if (residual != nullptr) u += to_float(residual[base + co + j]);
          if (relu) u = fmaxf(u, 0.0f);
          out[base + co + j] = from_float<T>(u);
        }
      }
    }
  }
}

template <class Tl, typename T, int kMode>
int launch_mode(const void* x, const void* x2, const void* w,
                const void* scale, const void* bias, const void* residual,
                void* out, int B, int H, int W, int C1, int C2, int Co,
                int relu, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_direct_kernel<Tl, T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((H + Tl::TH - 1) / Tl::TH) * ((W + Tl::TW - 1) / Tl::TW),
                  (Co + Tl::BN - 1) / Tl::BN, B);
  conv3x3_direct_kernel<Tl, T, kMode>
      <<<grid, Tl::kThreads, Tl::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(x2),
      static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(residual),
      static_cast<T*>(out), H, W, C1, C2, Co, relu);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class Tl, typename T>
int launch_tile(const void* x, const void* x2, const void* w,
                const void* scale, const void* bias, const void* residual,
                void* out, int B, int H, int W, int C1, int C2, int Co,
                int relu, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_mode<Tl, T, kWiden>(x, x2, w, scale, bias, residual, out,
                                      B, H, W, C1, C2, Co, relu, stream);
  } else {
    const bool vec = C1 % 4 == 0 && C2 % 4 == 0 && Co % 4 == 0 &&
                     aligned16(x) && aligned16(x2) && aligned16(w) &&
                     aligned16(residual) && aligned16(out);
    if (vec)
      return launch_mode<Tl, T, kVec4>(x, x2, w, scale, bias, residual, out,
                                       B, H, W, C1, C2, Co, relu, stream);
    return launch_mode<Tl, T, kScalar>(x, x2, w, scale, bias, residual, out,
                                       B, H, W, C1, C2, Co, relu, stream);
  }
}

// the compiled tiles (TH, TW, BN, split, stages), as conv.py's DIRECT_TILES
#define WS_DIRECT_TILES(X) \
  X(8, 16, 64, 16, 1, 2)   \
  X(8, 16, 64, 16, 3, 2)   \
  X(8, 8, 64, 16, 2, 2)    \
  X(8, 8, 64, 8, 2, 3)

template <typename T>
int launch(const void* x, const void* x2, const void* w, const void* scale,
           const void* bias, const void* residual, void* out, int B, int H,
           int W, int C1, int C2, int Co, int relu, const int* cfg,
           cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C1 <= 0 || C2 < 0 || Co <= 0)
    return kWsUnsupportedShape;
#define WS_DIRECT_LAUNCH(th, tw, bn, kc, split, stages)                      \
  if (cfg[0] == th && cfg[1] == tw && cfg[2] == bn && cfg[3] == kc &&        \
      cfg[4] == split && cfg[5] == stages)                                   \
    return launch_tile<Tile<th, tw, bn, kc, split, stages>, T>(              \
        x, x2, w, scale, bias, residual, out, B, H, W, C1, C2, Co, relu,     \
        stream);
  WS_DIRECT_TILES(WS_DIRECT_LAUNCH)
#undef WS_DIRECT_LAUNCH
  return kWsUnsupportedShape;
}

}  // namespace

// x [B,H,W,C1], x2 [B,H,W,C2] or null (C2 = 0), w [3,3,C1+C2,Co] (HWIO),
// scale/bias [Co] fp32, residual [B,H,W,Co] or null, out [B,H,W,Co]; all
// contiguous, x/x2/w/residual/out in one dtype. The tile (TH, TW, BN,
// split, stages) is one of WS_DIRECT_TILES. Returns 0, the cudaError_t of
// the launch, or a status.cuh code.
extern "C" int ws_conv3x3_bn_act_f32(const void* x, const void* x2,
                                     const void* w, const void* scale,
                                     const void* bias, const void* residual,
                                     void* out, int B, int H, int W, int C1,
                                     int C2, int Co, int relu, int TH, int TW,
                                     int BN, int KC, int split, int stages,
                                     void* stream) {
  const int cfg[6] = {TH, TW, BN, KC, split, stages};
  return launch<float>(x, x2, w, scale, bias, residual, out, B, H, W, C1, C2,
                       Co, relu, cfg, static_cast<cudaStream_t>(stream));
}

extern "C" int ws_conv3x3_bn_act_bf16(const void* x, const void* x2,
                                      const void* w, const void* scale,
                                      const void* bias, const void* residual,
                                      void* out, int B, int H, int W, int C1,
                                      int C2, int Co, int relu, int TH,
                                      int TW, int BN, int KC, int split,
                                      int stages, void* stream) {
  const int cfg[6] = {TH, TW, BN, KC, split, stages};
  return launch<__nv_bfloat16>(x, x2, w, scale, bias, residual, out, B, H, W,
                               C1, C2, Co, relu, cfg,
                               static_cast<cudaStream_t>(stream));
}

// How many blocks of a tile's fp32 16-byte kernel one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 if the tile is
// not compiled: the Python plan (conv.py::DIRECT_TILES) must agree.
extern "C" int ws_conv3x3_direct_blocks_per_sm(int TH, int TW, int BN, int KC,
                                               int split, int stages) {
#define WS_DIRECT_OCC(th, tw, bn, kc, sp, st)                              \
  if (TH == th && TW == tw && BN == bn && KC == kc && split == sp &&       \
      stages == st) {                                                      \
    using Tl = Tile<th, tw, bn, kc, sp, st>;                               \
    if (cudaFuncSetAttribute(conv3x3_direct_kernel<Tl, float, kVec4>,      \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                             Tl::kSmemBytes) != cudaSuccess)               \
      return -1;                                                           \
    int n = -1;                                                            \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                         \
        &n, conv3x3_direct_kernel<Tl, float, kVec4>, Tl::kThreads,         \
        Tl::kSmemBytes);                                                   \
    return n;                                                              \
  }
  WS_DIRECT_TILES(WS_DIRECT_OCC)
#undef WS_DIRECT_OCC
  return -1;
}

// The dynamic shared memory of a tile, or -1 if it is not compiled: the
// Python plan (conv.py::direct_smem_bytes) must agree.
extern "C" int ws_conv3x3_direct_smem_bytes(int TH, int TW, int BN, int KC,
                                            int split, int stages) {
#define WS_DIRECT_SMEM(th, tw, bn, kc, sp, st)                          \
  if (TH == th && TW == tw && BN == bn && KC == kc && split == sp &&    \
      stages == st)                                                     \
    return Tile<th, tw, bn, kc, sp, st>::kSmemBytes;
  WS_DIRECT_TILES(WS_DIRECT_SMEM)
#undef WS_DIRECT_SMEM
  return -1;
}
