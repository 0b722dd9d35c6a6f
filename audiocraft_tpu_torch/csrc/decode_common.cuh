// Shared machinery of the single-query decode-attention kernels (decode_attention.cu,
// int4_decode_attention.cu), for Hopper (sm_90a).
//
// Both kernels stream one (row, head)'s valid window of a KV cache once, so both are bound by
// HBM bytes, and both split that window across the blocks of one thread-block cluster:
//   * tiles of T slots at absolute multiples of T (32 in K1, 128 in K3); the window's tiles
//     go to the n blocks of a cluster in contiguous shares (tile_share), so a block walks few
//     tiles when the batch is small and the whole window when the batch fills the card;
//   * each block's loads go through a ring of shared-memory stages filled by cp.async (16, 8
//     or 4 bytes, or a synchronous copy where the rows are only 2- or 1-byte aligned), so
//     several tiles are in flight while one is computed;
//   * each block leaves its partial (m, l, acc[D]) of the online softmax in its own shared
//     memory; after cluster.sync() block r reads every peer's partial through distributed
//     shared memory, in rank order 0..n-1 (deterministic, no atomics), and writes its slice of
//     the D outputs (cluster_combine_store); a second cluster.sync() keeps every block's
//     shared memory alive until its peers have read it.
// Scores are kept in base 2: q carries log2(e) / sqrt(D), so exp(x) becomes exp2f, and the max
// floor -1e4 of the TPU kernel becomes kMFloor2 = -1e4 * log2(e).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_common {

namespace cg = cooperative_groups;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMFloor2 = -1e4f * kLog2e;
constexpr int kThreads = 128;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;   // portable cluster size

enum QDType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16, 8, 4, 2 or 1; both addresses aligned to it) from global to shared memory.
// 16, 8 and 4 go asynchronously (cp.async, completed by cp_async_wait); 2 and 1 are a plain
// load and store, the slow path for rows with less alignment.
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, int bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else if (bytes == 2) {
    *static_cast<uint16_t*>(dst) = __ldg(static_cast<const uint16_t*>(src));
  } else {
    *static_cast<uint8_t*>(dst) = __ldg(static_cast<const unsigned char*>(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The largest chunk (16, 8, 4, 2 or 1 bytes) that divides `bytes`.
__host__ __device__ __forceinline__ int chunk_of(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : bytes % 2 == 0 ? 2 : 1;
}

// A bf16 scale at an arbitrary element index travels as the 4-byte-aligned word holding it
// (cp.async copies 4 bytes at least); scale_pick takes the element back out of the word.
__device__ __forceinline__ void copy_scale_word(uint32_t* dst, const __nv_bfloat16* elem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(elem);
  copy_chunk(dst, reinterpret_cast<const void*>(a & ~uintptr_t(3)), 4);
}

__device__ __forceinline__ float scale_pick(uint32_t word, const __nv_bfloat16* elem) {
  const bool high = reinterpret_cast<uintptr_t>(elem) & 2;
  return __uint_as_float(high ? (word & 0xffff0000u) : (word << 16));
}

// Tiles [begin, end) (absolute tile indices, tiles of T slots) of cluster rank `rank` of n over
// the window [lo, hi): the window's tiles in contiguous shares of ceil(tiles / n); a share may
// be empty.
struct Share {
  int begin, end;
};

template <int T> __device__ __forceinline__ Share tile_share(int lo, int hi, int rank, int n) {
  const int first = lo / T;
  const int last = (hi + T - 1) / T;
  const int per = (last - first + n - 1) / n;
  const int begin = first + rank * per;
  return Share{begin, max(begin, min(last, begin + per))};
}

// The combine of the cluster's partials. `part` is this block's [2 + D] floats in shared
// memory: m (base 2, >= kMFloor2), l, acc[D]. Block r writes outputs [r * ceil(D / n), ...).
template <typename TQ>
__device__ __forceinline__ void cluster_combine_store(float* part, int D, TQ* out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial is written
  const int n = static_cast<int>(cluster.num_blocks());
  const int per = (D + n - 1) / n;
  const int d0 = static_cast<int>(cluster.block_rank()) * per;
  const int d1 = min(D, d0 + per);
  for (int d = d0 + static_cast<int>(threadIdx.x); d < d1; d += kThreads) {
    float m = kMFloor2;
    for (int r = 0; r < n; ++r) m = fmaxf(m, cluster.map_shared_rank(part, r)[0]);
    float l = 0.f, a = 0.f;
    for (int r = 0; r < n; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      const float w = exp2f(p[0] - m);
      l += p[1] * w;
      a += p[2 + d] * w;
    }
    out[d] = from_f32<TQ>(a / l);
  }
  cluster.sync();  // no block leaves while a peer may still read its partial
}

// Launch Kernel on grid (n, gy, gz) in clusters of (n, 1, 1) blocks of kThreads threads.
// Returns the launch's error, then cudaGetLastError(): a refused launch is never silent.
template <auto Kernel, typename... Args>
cudaError_t launch_cluster(int n, int gy, int gz, size_t smem, cudaStream_t stream,
                           Args... args) {
  static size_t smem_set = 0;  // one per kernel: Kernel is a template argument
  if (smem > smem_set) {  // dynamic plus static shared memory may pass 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, gy, gz);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  // cudaGetLastError also clears a refused launch's error, so it is reported once
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace decode_common
