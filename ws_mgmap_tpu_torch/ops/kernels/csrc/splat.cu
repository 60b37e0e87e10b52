// Ground-plane scatter-max splat for Hopper (sm_90a): one launch, each
// frame's accumulator in shared memory.
//
// Replaces: ws_mgmap_tpu/ops/pallas/splat.py::splat_pallas (and its
// packed-row variant splat_pallas_packed, which computes the same function
// and existed only to fit TPU VMEM): per ego-grid cell, the max over the
// pixels whose cell id lands there, in fp32; 0 for cells with no valid
// pixel and for any max <= -1e16; NaN propagates as in jnp.maximum. Pixels
// with an id outside [0, cells) are skipped.
//
// What bounds it: bytes. The valid pixels' features, the ids and the fp32
// output each cross device memory once; the arithmetic is one compare per
// feature.
//
// Design: the TPU kernel kept each frame's accumulator (cells x C fp32,
// 2.56 MB at the main path's shape) in VMEM. Here it is split over kRanks
// blocks (8, a portable cluster) and groups of at most 32 channels that fit
// in shared memory: grid (kRanks, channel groups, frames). Rank r owns
// cells r, r + 8, r + 16, ... (interleaved, so that a row of crowded cells
// spreads over every rank), each cell a row of `group` keys. A key is the
// float's bit pattern mapped so that unsigned order is float order, with
// every NaN made the largest key; 0 is below every float and marks an
// empty cell.
//   1. each block zeroes its keys;
//   2. rounds of kChunk pixels: each thread loads kIds ids at once
//      (coalesced), and each warp appends the pixels to merge to a list in
//      shared memory, in pixel order within the warp (ballots, then one
//      shared atomic per warp and round to reserve room). When the list
//      may not take another round, or at the end, the block merges it:
//      each warp copies the feature rows of a tile of kTile entries into
//      its stage in shared memory with cp.async (16 bytes a copy, all in
//      flight at once; the next tile's copies run while this one is
//      walked), marks where runs of equal ids start (one shuffle and a
//      ballot), and walks the entries, lane = channel, merging each run in
//      registers with a NaN-propagating max (consecutive pixels of an
//      image row land in the same cell) and ending it with one atomicMax
//      of its key per lane: the warp's lanes hit one row of consecutive
//      words, free of bank conflicts;
//   3. after a barrier each block decodes its own cells (key -> float,
//      <= -1e16 -> 0) and writes them once, 16 bytes a store.
// The ranks form a thread-block cluster and take the frame's 32-pixel
// segments in turn (segment s to rank s % 8, which spreads a band of valid
// image rows over all of them); each rank lists its valid pixels, and a
// run's atomics go to the owner's shared memory through distributed shared
// memory (cluster.map_shared_rank); cluster.sync() fences step 1 from 2
// and 2 from 3. (Letting every block read all of its frame's ids and keep
// its own cells, with only local atomics, measured slower on the wall
// spin's ids: PERF.md.)
// No global atomics, no fill or zero pass. A max picks one of its inputs
// and integer atomicMax is order independent, so the result is exact
// (only a zero max over both +0.0 and -0.0 may come out with either sign).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "status.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRanks = 8;  // blocks per frame and group: a portable cluster
constexpr int kMaxGroup = 32;  // a warp's lanes are a group's channels
constexpr int kIds = 8;  // id loads in flight per thread
constexpr int kChunk = kIds * kThreads;  // pixels listed per round
constexpr int kListCap = 2 * kChunk;     // list entries (4 bytes each)
constexpr int kTileBytes = 1024;  // per warp and tile: kTile feature rows
constexpr int kStageBytes = 2 * kTileBytes;  // per warp: two tiles
constexpr float kEpsInvalid = -1e16f;
constexpr uint32_t kNanKey = 0xFFFFFFFFu;

// Unsigned order of the keys is the float order; every NaN maps to the
// largest key, so it wins every max as in jnp.maximum.
__device__ __forceinline__ uint32_t to_key(uint32_t u) {
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return kNanKey;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ uint32_t key_of(float v) {
  return to_key(__float_as_uint(v));
}
__device__ __forceinline__ uint32_t key_of(__nv_bfloat16 v) {
  return to_key(static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Merges a run's key into its cell: lane = channel, so the warp's lanes
// touch one row of consecutive words.
__device__ __forceinline__ void flush(uint32_t* keys, int id, int group,
                                      int lane, uint32_t run) {
  uint32_t* dst = cg::this_cluster().map_shared_rank(keys, id % kRanks);
  atomicMax(dst + (id / kRanks) * group + lane, run);
}

// max that propagates NaN, as jnp.maximum does
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ __nv_bfloat16 max_nan(__nv_bfloat16 a,
                                                 __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}

// Starts loading the list entries [e0, e0 + m) into a stage: the features
// of channel `lane` by cp.async (one commit group), and returns entry
// e0 + lane's cell id (-1 past m).
template <typename T>
__device__ __forceinline__ int issue_tile(const int* list, int e0, int m,
                                          const int* fid, const T* fg, int C,
                                          int gw, bool aligned, T* st) {
  constexpr int kPer16 = 16 / sizeof(T);  // channels in 16 bytes
  const int lane = threadIdx.x % 32;
  const int id = lane < m ? __ldg(fid + list[e0 + lane]) : -1;
  if (aligned) {
    const int pieces = gw / kPer16;  // 16-byte pieces per row
    for (int i = lane; i < m * pieces; i += 32) {
      const int k = i / pieces;
      const int c = (i - k * pieces) * kPer16;
      cp_async16(st + k * kMaxGroup + c,
                 fg + static_cast<int64_t>(list[e0 + k]) * C + c);
    }
  } else if (lane < gw) {
    for (int k = 0; k < m; ++k)
      st[k * kMaxGroup + lane] =
          fg[static_cast<int64_t>(list[e0 + k]) * C + lane];
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return id;
}

// Merges the features of the n listed pixels into the keys. `fg` points at
// the frame's first pixel, channel g0; `stage` is this warp's two tiles of
// kTile rows. Each warp takes every kWarps-th tile of kTile entries and
// loads the next one while it walks the current one.
template <typename T>
__device__ __forceinline__ void merge_list(const int* list, int n,
                                           const int* fid, const T* fg,
                                           int C, int gw, bool aligned,
                                           int group, T* stage,
                                           uint32_t* keys) {
  constexpr int kTile = kTileBytes / (kMaxGroup * sizeof(T));
  const int lane = threadIdx.x % 32;
  const bool active = lane < gw;
  int e0 = (threadIdx.x / 32) * kTile;
  if (e0 >= n) return;
  int id_cur = issue_tile(list, e0, min(kTile, n - e0), fid, fg, C, gw,
                          aligned, stage);
  for (int buf = 0; e0 < n; e0 += kWarps * kTile, buf ^= 1) {
    const int m = min(kTile, n - e0);
    const int e1 = e0 + kWarps * kTile;
    int id_next = -1;
    if (e1 < n) {
      id_next = issue_tile(list, e1, min(kTile, n - e1), fid, fg, C, gw,
                           aligned, stage + (buf ^ 1) * kTile * kMaxGroup);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();
    const T* st = stage + buf * kTile * kMaxGroup;
    // runs of equal ids: a bit per entry that starts one, and one per
    // entry that ends one
    const int prev = __shfl_up_sync(0xFFFFFFFFu, id_cur, 1);
    const unsigned head =
        __ballot_sync(0xFFFFFFFFu, lane < m && (lane == 0 || id_cur != prev));
    const unsigned tail = (head >> 1) | (1u << (m - 1));
    // every stage row is readable: lanes past gw and rows past m hold stale
    // values that are never flushed, and reading them keeps this loop free
    // of branches, so the loads are in flight together
    T val[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) val[k] = st[k * kMaxGroup + lane];
    T run = val[0];
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (k > 0) run = (head >> k) & 1u ? val[k] : max_nan(run, val[k]);
      if ((tail >> k) & 1u) {  // the same in every lane
        const int id = __shfl_sync(0xFFFFFFFFu, id_cur, k);
        if (active) flush(keys, id, group, lane, key_of(run));
      }
    }
    __syncwarp();  // this stage is read before the next tile lands in it
    id_cur = id_next;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    splat_max_kernel(const T* __restrict__ feats, const int* __restrict__ ids,
                     float* __restrict__ out, int P, int C, int cells,
                     int cells_per_rank, int group) {
  extern __shared__ uint4 smem[];
  __shared__ int list_n;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  const int n_keys = cells_per_rank * group;
  int* list = reinterpret_cast<int*>(smem + (n_keys + 3) / 4);
  T* stage = reinterpret_cast<T*>(list + kListCap) +
             (threadIdx.x / 32) * (kStageBytes / sizeof(T));
  const int rank = blockIdx.x;  // == the block's rank in its cluster
  const int g0 = blockIdx.y * group;
  const int gw = min(group, C - g0);
  const int64_t b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const T* fg = feats + b * P * C + g0;
  const bool aligned = reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                       (C * sizeof(T)) % 16 == 0 &&
                       (group * sizeof(T)) % 16 == 0;

  // 1. every cell of this block empty, the list too
  for (int i = threadIdx.x; i < (n_keys + 3) / 4; i += kThreads)
    smem[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) list_n = 0;
  cg::this_cluster().sync();  // no rank writes into a block before this

  // 2. list the pixels to merge, kChunk at a time, and merge the list when
  //    it may not take another round, or at the end. Index q counts this
  //    rank's pixels: its 32-pixel segment q / 32 is the frame's segment
  //    (q / 32) * kRanks + rank.
  const int64_t segs = (static_cast<int64_t>(P) + 31) / 32;
  const int64_t n_v = (segs + kRanks - 1) / kRanks * 32;
  const int* fid = ids + b * P;
  for (int64_t base = 0; base < n_v; base += kChunk) {
    int pix[kIds], v[kIds];
#pragma unroll
    for (int i = 0; i < kIds; ++i) {
      const int64_t q = base + i * kThreads + threadIdx.x;
      const int64_t p = ((q / 32) * kRanks + rank) * 32 + lane;
      pix[i] = static_cast<int>(p);
      v[i] = q < n_v && p < P ? __ldg(fid + p) : -1;
    }
    unsigned m[kIds];
    int total = 0;
#pragma unroll
    for (int i = 0; i < kIds; ++i) {
      m[i] = __ballot_sync(0xFFFFFFFFu, v[i] >= 0 && v[i] < cells);
      total += __popc(m[i]);
    }
    int off = 0;  // one reservation per warp and round
    if (lane == 0 && total > 0) off = atomicAdd(&list_n, total);
    off = __shfl_sync(0xFFFFFFFFu, off, 0);
#pragma unroll
    for (int i = 0; i < kIds; ++i) {
      if ((m[i] >> lane) & 1u)  // in pixel order within the warp
        list[off + __popc(m[i] & ((1u << lane) - 1u))] = pix[i];
      off += __popc(m[i]);
    }
    __syncthreads();
    const int n = list_n;
    if (n > kListCap - kChunk || base + kChunk >= n_v) {
      merge_list<T>(list, n, fid, fg, C, gw, aligned, group, stage, keys);
      __syncthreads();
      if (threadIdx.x == 0) list_n = 0;
    }
    __syncthreads();
  }
  // every atomic into this block's keys has landed, and no block touches
  // another's shared memory after this
  cg::this_cluster().sync();

  // 3. decode and write this block's cells once: a thread keeps one
  //    4-channel column (one channel where C or the group is ragged)
  const uint32_t eps_key = to_key(__float_as_uint(kEpsInvalid));
  float* ob = out + b * cells * C + g0;
  const int w = (C % 4 == 0 && group % 4 == 0) ? 4 : 1;
  const int q = gw / w;  // columns per cell
  const int col = threadIdx.x % q;
  const int rows = kThreads / q;
  if (threadIdx.x < rows * q) {
    for (int local = threadIdx.x / q; local < cells_per_rank; local += rows) {
      const int cell = local * kRanks + rank;
      if (cell >= cells) break;
      const uint32_t* k = keys + local * group + col * w;
      float* o = ob + static_cast<int64_t>(cell) * C + col * w;
      if (w == 4) {
        const uint4 k4 = *reinterpret_cast<const uint4*>(k);
        *reinterpret_cast<float4*>(o) = make_float4(
            k4.x <= eps_key ? 0.0f : from_key(k4.x),
            k4.y <= eps_key ? 0.0f : from_key(k4.y),
            k4.z <= eps_key ? 0.0f : from_key(k4.z),
            k4.w <= eps_key ? 0.0f : from_key(k4.w));
      } else {
        *o = *k <= eps_key ? 0.0f : from_key(*k);
      }
    }
  }
}

// A block's dynamic shared memory: its keys (padded to 16 bytes), the
// list and its warps' stages.
size_t smem_bytes(int cells_per_rank, int group) {
  return (static_cast<size_t>(cells_per_rank) * group + 3) / 4 * 16 +
         kListCap * 4 + kWarps * kStageBytes;
}

// Launches the kernel, or with `clusters` non-null only asks how many of
// its clusters fit on the card at once (cudaOccupancyMaxActiveClusters).
template <typename T>
int launch(const void* feats, const int* ids, float* out, int B, int P, int C,
           int cells, int cells_per_rank, int group, cudaStream_t stream,
           int* clusters) {
  auto* kern = splat_max_kernel<T>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks, (C + group - 1) / group, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(cells_per_rank, group);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kRanks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.dynamicSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(feats), ids, out,
                         P, C, cells, cells_per_rank, group);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* feats, const void* ids, void* out, int B, int P,
             int C, int cells, int cells_per_rank, int group, int bf16,
             void* stream, int* clusters) {
  if (B < 1 || P < 0 || C < 1 || cells < 1 ||
      cells_per_rank * kRanks < cells || group < 1 || group > kMaxGroup)
    return kWsUnsupportedShape;
  const int* i = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(feats, i, o, B, P, C, cells, cells_per_rank,
                                 group, s, clusters);
  return launch<float>(feats, i, o, B, P, C, cells, cells_per_rank, group, s,
                       clusters);
}

}  // namespace

// feats [B, P, C] (fp32, or bf16 with bf16 = 1), ids [B, P] int32,
// out [B, cells, C] fp32, all contiguous. The plan (cells_per_rank of the
// kRanks ranks, group) comes from splat.py::splat_plan. Returns 0, a
// cudaError_t or a status.cuh code.
extern "C" int ws_splat_max(const void* feats, const void* ids, void* out,
                            int B, int P, int C, int cells,
                            int cells_per_rank, int group, int bf16,
                            void* stream) {
  return dispatch(feats, ids, out, B, P, C, cells, cells_per_rank, group,
                  bf16, stream, nullptr);
}

// How many of the kernel's clusters with this plan fit on the card at
// once, into *clusters. Returns a status as ws_splat_max does.
extern "C" int ws_splat_max_active_clusters(int B, int C, int cells,
                                            int cells_per_rank, int group,
                                            int bf16, int* clusters) {
  return dispatch(nullptr, nullptr, nullptr, B, 0, C, cells, cells_per_rank,
                  group, bf16, nullptr, clusters);
}

// The dynamic shared memory per block that a launch with this plan asks
// for (splat.py::SplatPlan.smem_bytes computes the same for planning).
extern "C" int ws_splat_smem_bytes(int cells_per_rank, int group) {
  return static_cast<int>(smem_bytes(cells_per_rank, group));
}
