// Fused 3x3 stride-1 SAME conv + folded BN (+ residual) (+ ReLU), NHWC,
// bf16 in and out, fp32 accumulation: an implicit GEMM on Hopper's
// warpgroup MMA (wgmma), fed by the Tensor Memory Accelerator (TMA).
//
// Replaces: ws_mgmap_tpu/ops/pallas/conv.py::conv3x3_bn_relu (bf16).
// Computes
//   y = [relu](conv3x3(concat([x, x2], C)) * scale + bias [+ residual])
// and rounds to bf16 once (round to nearest even). x2 (the UNet decoder's
// skip input) has its own tensor map, so the channel concat is never
// materialized; residual and x2 are never combined.
//
// What bounds it: on paper, operations (each input element feeds 9*Co
// multiply-adds, above the card's ~300 FLOP/byte balance point at every
// UNet site, so the floor is the 989 TFLOP/s bf16 tensor-core rate). In
// practice, what the blocks pull through L2: each Co tile reads the input
// once per tap, each pixel tile reads the weight slice of its Co tile.
// The design cuts the first by a factor of 2.4 (below) and the tile
// choice in conv.py trades the two.
//
// The GEMM: M = output pixels, N = Co, K = 9*(C1+C2). A block owns a
// TH x TW rectangle of output pixels of one image (TW = 8, TH = 8 or 16:
// BM = 64 or 128 rows, one m64 row group per consumer warpgroup) and a
// BN-wide slice of Co (64 or 128). It walks K as (dx, 64-channel chunk)
// pairs; one stage of the ring holds
//   - A: one TMA box [1, TH+2, TW, 64] of x (or of x2, by channel) at
//     (b, y0-1, x0+dx-1, c0): the output rows plus one halo row above and
//     below, (TH+2)*TW rows of 128 bytes. The three dy taps read rows
//     [dy*TW, dy*TW + BM) of it, so the input comes through L2 3*(TH+2)/TH
//     times per Co tile instead of 9. TMA zero-fills what lies outside the
//     image, which is the SAME padding for free; the box's batch extent is
//     1, so it never reads a neighbouring image;
//   - B: one TMA box [1, 3, BN, 64] of the weight packed as
//     [dx][dy][Co][Ci]: the [BN, 64] tiles of the three dy taps, K-major;
//     rows past Co are zero-filled.
// Both land with the 128-byte swizzle, which is the K-major layout a wgmma
// shared-memory descriptor with 128-byte swizzle reads (8-row atoms of
// 1024 bytes, so SBO = 1024; LBO unused; the k16 slices are +32 bytes on
// the descriptor's start address). One producer warp keeps kStages stages
// in flight (one "full" and one "empty" mbarrier per stage); the consumer
// warpgroups run 3 taps x 4 m64nBNk16 wgmma per stage into fp32 registers
// and release a stage once the wgmma group that read it has retired
// (wgmma.wait_group 1). The epilogue works from the accumulator fragment
// layout: * scale + bias, + residual, ReLU, one bf16 rounding, and masked
// bf16x2 stores at ragged H/W edges and past Co.
//
// Where trouble hides, and what this file does about it:
//   - The mbarrier byte count: TMA always writes the whole box, the zero-
//     filled part included, so expect_tx counts full boxes. A short count
//     would hang the block (mbar_wait traps after seconds instead).
//   - cuTensorMapEncodeTiled is a driver-API call; the library links only
//     cudart, so the entry point comes from cudaGetDriverEntryPoint.
//   - Tensor maps embed base pointers: they are encoded on every call and
//     passed by value as __grid_constant__ kernel parameters.
//   - TMA wants 16-byte-aligned base addresses and strides that are
//     multiples of 16 bytes: the wrapper (conv.py) checks both; channel
//     counts that are multiples of 64 (x, x2) and of 8 (Co) keep the
//     strides so.
//   - Box limits: every box dimension <= 256 and the inner one 64 bf16 =
//     the 128-byte swizzle span.
//   - The swizzle only matches the descriptor when each tile starts on a
//     1024-byte boundary: the dynamic shared memory is aligned by hand, the
//     A and B tiles are multiples of 1024 bytes, and a tap's rows start at
//     dy*TW, a multiple of 8 rows.
//   - Accumulator registers are fenced (an empty asm that "writes" them)
//     after each wait, so the compiler cannot read them before the
//     asynchronous wgmma has written them.
//
// Later work, not here: persistent blocks, clusters with TMA multicast of
// the weight (which would cut the second L2 stream), TMA stores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "status.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kKC = 64;             // channels per K step: one 128-byte span
constexpr int kRowBytes = kKC * 2;  // one swizzled smem row
constexpr int kProducerThreads = 32;
constexpr int kTW = 8;              // tile width in pixels

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// spin until the phase of the given parity has completed; a wait of more
// than ~4e9 clocks (seconds: a pipeline that can never complete, such as a
// short byte count) traps, so a fault surfaces as a launch error rather
// than a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row atoms of
// 1024 bytes (SBO), LBO unused by this layout (1), base offset 0 (tiles are
// 1024-byte aligned)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] * B[16 x N]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  if constexpr (BN == 128) wgmma_n128(d, da, db);
}

template <int kWG, int kBN>
struct Tile {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * kWG + kProducerThreads;
  // A: the TH+2 input rows of one dx shift, TW = kTW pixels each
  static constexpr uint32_t kABytes = (kBM + 2 * kTW) * kRowBytes;
  // B: the [kBN, 64] weight tiles of the three dy taps
  static constexpr uint32_t kBBytes = 3 * kBN * kRowBytes;
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  // the ring, 1024 bytes of alignment slack, then 2*kStages mbarriers
  static constexpr size_t kSmemBytes =
      kStages * (kStageBytes + 2 * sizeof(uint64_t)) + 1024;
};

template <int kWG, int kBN>
__global__ void __launch_bounds__(Tile<kWG, kBN>::kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_x2,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ residual,
                     __nv_bfloat16* __restrict__ out, int H, int W, int C1,
                     int C2, int Co, int relu) {
  using T = Tile<kWG, kBN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * T::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  constexpr int TH = T::kBM / kTW, TW = kTW;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int Ci = C1 + C2;
  const int chunks = Ci / kKC;
  const int iters = 3 * chunks;  // (dx, chunk) pairs; dy within a stage
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);             // the producer's expect_tx arrive
      mbar_init(empty(s), 4 * kWG);      // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWG) {  // the producer warp: one thread issues the TMA
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const int dx = it / chunks;
        const int c0 = (it % chunks) * kKC;
        const uint32_t a_dst = ring + s * T::kStageBytes;
        mbar_expect_tx(full(s), T::kStageBytes);  // full boxes, OOB too
        if (c0 < C1)
          tma_load_4d(a_dst, &map_x, full(s), c0, x0 + dx - 1, y0 - 1, b);
        else
          tma_load_4d(a_dst, &map_x2, full(s), c0 - C1, x0 + dx - 1, y0 - 1,
                      b);
        tma_load_4d(a_dst + T::kABytes, &map_w, full(s), c0, n0, 0, dx);
      }
    }
    return;
  }

  // consumer warpgroup wg owns tile rows [64*wg, 64*wg + 64)
  const int wg = warp / 4;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  for (int it = 0; it < iters; ++it) {
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();
    const uint32_t a = ring + s * T::kStageBytes + wg * 64 * kRowBytes;
    const uint32_t bw = ring + s * T::kStageBytes + T::kABytes;
    wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      // tap dy reads the box from row dy*TW on (a multiple of 8 rows, so
      // still on a 1024-byte swizzle atom) and the weight tile of tap dy
      const uint64_t da = smem_desc(a + dy * TW * kRowBytes);
      const uint64_t db = smem_desc(bw + dy * kBN * kRowBytes);
#pragma unroll
      for (int k = 0; k < kKC / 16; ++k)  // +32 bytes per k16 slice
        wgmma_tile<kBN>(acc, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group has retired
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
    __syncwarp();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: thread holds rows r and r+8 of its warp's 16, and per 8-wide
  // column block nb the pair of columns 2*(lane%4) + {0,1}
  const int wrow = wg * 64 + (warp % 4) * 16 + (lane >> 2);
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wrow + 8 * i;
    const int gy = y0 + m / TW, gx = x0 + m % TW;
    if (gy >= H || gx >= W) continue;
    const int64_t pix = (static_cast<int64_t>(b) * H + gy) * W + gx;
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
      const int co = n0 + nb * 8 + col;
      if (co >= Co) continue;  // Co % 8 == 0: the pair is whole or absent
      const float2 sc = *reinterpret_cast<const float2*>(scale + co);
      const float2 bi = *reinterpret_cast<const float2*>(bias + co);
      float v0 = acc[nb * 4 + 2 * i] * sc.x + bi.x;
      float v1 = acc[nb * 4 + 2 * i + 1] * sc.y + bi.y;
      if (residual != nullptr) {
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(residual + pix * Co + co);
        v0 += __low2float(r);
        v1 += __high2float(r);
      }
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + pix * Co + co) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor of rank n, dims innermost first, dense; boxes with the
// 128-byte swizzle; out-of-bounds elements read as zero
int encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int n,
           const cuuint64_t* dims, const cuuint32_t* box) {
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < n; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n,
                         const_cast<void*>(ptr), dims, strides, box, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kWsTensorMapError + static_cast<int>(r);
}

template <int kWG, int kBN>
int launch(const void* x, const void* x2, const void* w, const void* scale,
           const void* bias, const void* residual, void* out, int B, int H,
           int W, int C1, int C2, int Co, int relu, cudaStream_t stream) {
  using T = Tile<kWG, kBN>;
  constexpr int TH = T::kBM / kTW, TW = kTW;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kWsNoDriverEntry;
  CUtensorMap map_x, map_x2, map_w;
  // the output rows and the two halo rows of the three dy taps
  const cuuint32_t box_a[4] = {kKC, static_cast<cuuint32_t>(TW),
                               static_cast<cuuint32_t>(TH + 2), 1};
  const cuuint64_t dims_x[4] = {static_cast<cuuint64_t>(C1),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
  int st = encode(enc, &map_x, x, 4, dims_x, box_a);
  if (st != 0) return st;
  if (C2 > 0) {
    const cuuint64_t dims_x2[4] = {static_cast<cuuint64_t>(C2), dims_x[1],
                                   dims_x[2], dims_x[3]};
    st = encode(enc, &map_x2, x2, 4, dims_x2, box_a);
    if (st != 0) return st;
  } else {
    map_x2 = map_x;  // never read: every chunk lies in x
  }
  // w [dx][dy][Co][Ci]: one box holds the three dy taps of one dx
  const cuuint64_t dims_w[4] = {static_cast<cuuint64_t>(C1 + C2),
                                static_cast<cuuint64_t>(Co), 3, 3};
  const cuuint32_t box_w[4] = {kKC, kBN, 3, 1};
  st = encode(enc, &map_w, w, 4, dims_w, box_w);
  if (st != 0) return st;

  const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<kWG, kBN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
                  (Co + kBN - 1) / kBN, B);
  conv3x3_wgmma_kernel<kWG, kBN><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      map_x, map_x2, map_w, static_cast<const float*>(scale),
      static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), H, W, C1, C2, Co, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B,H,W,C1], x2 [B,H,W,C2] or null (C2 = 0), w [3 (dx), 3 (dy), Co,
// C1+C2] (packed, K-major), scale/bias [Co] fp32, residual [B,H,W,Co] or
// null, out [B,H,W,Co]; bf16 unless stated, contiguous, 16-byte aligned.
// C1 and C2 multiples of 64, Co of 8. The tile is TH x 8 pixels x BN
// channels with TH in {8, 16} and BN in {64, 128}. Returns 0, a
// cudaError_t, or a status.cuh code.
extern "C" int ws_conv3x3_wgmma_bf16(const void* x, const void* x2,
                                     const void* w, const void* scale,
                                     const void* bias, const void* residual,
                                     void* out, int B, int H, int W, int C1,
                                     int C2, int Co, int relu, int TH, int BN,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C1 <= 0 || C1 % kKC != 0 || C2 < 0 || C2 % kKC != 0 || Co <= 0 ||
      Co % 8 != 0)
    return kWsUnsupportedShape;
  const int bm = TH * kTW;
  if (bm == 128 && BN == 64)
    return launch<2, 64>(x, x2, w, scale, bias, residual, out, B, H, W, C1,
                         C2, Co, relu, s);
  if (bm == 128 && BN == 128)
    return launch<2, 128>(x, x2, w, scale, bias, residual, out, B, H, W, C1,
                          C2, Co, relu, s);
  if (bm == 64 && BN == 64)
    return launch<1, 64>(x, x2, w, scale, bias, residual, out, B, H, W, C1,
                         C2, Co, relu, s);
  if (bm == 64 && BN == 128)
    return launch<1, 128>(x, x2, w, scale, bias, residual, out, B, H, W, C1,
                          C2, Co, relu, s);
  return kWsUnsupportedShape;
}
