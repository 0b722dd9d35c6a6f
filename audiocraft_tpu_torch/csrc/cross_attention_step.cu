// Cross-attention of one decode step over the request's text keys and values, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package attends its precomputed cross K/V with the plain
// attention (audiocraft_tpu/modules/transformer.py, StreamingMultiheadAttention with
// cross_kv), which XLA fuses on the TPU. On the card that plain path is nine small kernels
// per layer and step (an f32 upcast and head-order copies of K and V, an f32 GEMV, the
// softmax, a cast, the P.V product) over keys and values that never change during a request.
// For one query per (row b, head h):
//
//     out[b, h] = softmax_t(q[b, h] . K[b, h, t] / sqrt(D)) . V[b, h, t]
//
// over all Tc keys, with no mask (a null condition is zeros, not masked). K and V are stored
// once per request as [B, H, Tc, D], contiguous, so each (row, head) reads one run of Tc * D
// elements. Scores, the online softmax and the accumulator are f32; the output is written once
// in the inputs' dtype: q, K and V all f32 or all bf16. D is a multiple of 8, at most 128, so a
// row is whole 16-byte chunks.
//
// What bounds it: HBM bytes. One query has no reuse of K/V, so the kernel streams them once:
// B * H * Tc * D * 2 elements, plus q and out. What the design does about it:
//   * a warp per (row, head) (or, when B * H warps cannot fill the card, 2 or 4 warps of one
//     block, taking the key tiles in turn and combining their (m, l, acc) through shared
//     memory: no second pass, no workspace, no atomics);
//   * every load is issued before any of it is used: a tile is kUnroll key rows per group of
//     lanes, and each lane loads its 16-byte chunk of the tile's K rows and V rows into
//     registers at once, so a warp keeps 2 * kUnroll loads in flight;
//   * a key row is spread over G lanes (G the power of two covering its C chunks, at most 32:
//     one chunk a lane), which reduce its score by G / 2 .. 1 shuffles; the 32 / G groups of a
//     warp take different keys, and their partial accumulators are summed once, after the
//     loop;
//   * one max and one rescale per tile, with exp2f: q carries log2(e) / sqrt(D);
//   * nothing allocated or synchronised inside the kernel, so a CUDA graph replays it.
//
// C interface (bound with ctypes): cross_attention_step_launch(...) returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kWarps = 4;    // warps per block
constexpr int kUnroll = 4;   // key rows per lane group in a tile
constexpr int kMaxD = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// A 16-byte chunk of a K or V row, held as four 32-bit words.
template <typename T> struct Chunk {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  uint32_t w[4];

  __device__ __forceinline__ void load(const T* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  // element e as f32 (bf16: the high or low half of a word, shifted into place)
  __device__ __forceinline__ float at(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[e]);
    } else {
      const uint32_t x = w[e >> 1];
      return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
cross_attn_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int n_heads, int Tc, int D,
                       int wph, int C, int G) {
  using Ch = Chunk<T>;
  constexpr int E = Ch::kElems;
  __shared__ float sm_ml[kWarps][2];
  __shared__ float sm_acc[kWarps][kMaxD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int head = blockIdx.x * (kWarps / wph) + warp / wph;  // b * H + h
  const int part = warp % wph;
  const bool live = head < n_heads;  // warp-uniform; every warp reaches the block's barrier
  const int g = lane % G, grp = lane / G, groups = 32 / G;
  const bool owns = g < C;  // the lane's chunk, g, lies inside the row
  const int tile = groups * kUnroll;

  const float scale = kLog2e / sqrtf(static_cast<float>(D));
  float qf[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    qf[e] = (live && owns) ? to_float(q[static_cast<size_t>(head) * D + g * E + e]) * scale : 0.f;

  float m = kNegInf, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const size_t base = static_cast<size_t>(live ? head : 0) * Tc * D;
  const T* kb = k + base + g * E;
  const T* vb = v + base + g * E;
  const int n_tiles = live ? (Tc + tile - 1) / tile : 0;
  for (int t = part; t < n_tiles; t += wph) {
    const int s0 = t * tile + grp;
    Ch kc[kUnroll], vc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * groups;
      if (s < Tc && owns) {
        kc[u].load(kb + static_cast<size_t>(s) * D);
        vc[u].load(vb + static_cast<size_t>(s) * D);
      } else {
        kc[u].zero();
        vc[u].zero();
      }
    }
    float sc[kUnroll];
    float tile_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qf[e], kc[u].at(e), d);
      for (int o = G >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
      sc[u] = (s0 + u * groups < Tc) ? d : kNegInf;
      tile_max = fmaxf(tile_max, sc[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, o));
    const float m_new = fmaxf(m, tile_max);  // the tile's first key is valid: finite
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = exp2f(sc[u] - m_new);  // 0 past the last key
      l += p;  // the group's keys: every lane of a group adds the same p
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vc[u].at(e), acc[e]);
    }
    m = m_new;
  }
  // the groups' partial sums: lanes g, g + G, ... own the same chunk
  for (int o = G; o < 32; o <<= 1) {
    l += __shfl_xor_sync(kFull, l, o);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  }

  if (wph > 1) {  // block-uniform: combine the head's warps, in part order
    if (lane == 0) {
      sm_ml[warp][0] = m;
      sm_ml[warp][1] = l;
    }
    if (grp == 0 && owns) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][g * E + e] = acc[e];
    }
    __syncthreads();
    if (part != 0) return;
    const int first = warp;
    float mm = kNegInf;
    for (int w = 0; w < wph; ++w) mm = fmaxf(mm, sm_ml[first + w][0]);
    l = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int w = 0; w < wph; ++w) {
      const float f = exp2f(sm_ml[first + w][0] - mm);  // 0 for a warp that had no tile
      l = fmaf(sm_ml[first + w][1], f, l);
      if (owns)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(sm_acc[first + w][g * E + e], f, acc[e]);
    }
  }
  if (!live || grp != 0 || !owns) return;
  const float inv = 1.f / l;
  T* o = out + static_cast<size_t>(head) * D + g * E;
#pragma unroll
  for (int e = 0; e < E; ++e) store(o + e, acc[e] * inv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int n_heads, int Tc, int D,
           int wph, cudaStream_t st) {
  const int C = D * static_cast<int>(sizeof(T)) / 16;
  int G = 1;
  while (G < C) G <<= 1;
  const int heads_per_block = kWarps / wph;
  const dim3 grid((n_heads + heads_per_block - 1) / heads_per_block);
  cross_attn_step_kernel<T><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n_heads, Tc, D, wph, C, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cross_attention_step_launch(const void* q, const void* k, const void* v,
                                           void* out, int B, int H, int Tc, int D, int dtype,
                                           int warps_per_head, void* stream) {
  if (B <= 0 || H <= 0 || Tc <= 0 || D <= 0 || D > kMaxD || D % 8 != 0 ||
      (warps_per_head != 1 && warps_per_head != 2 && warps_per_head != 4) ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = B * H;
  if (dtype == kF32) return launch<float>(q, k, v, out, n, Tc, D, warps_per_head, st);
  if (dtype == kBF16) return launch<__nv_bfloat16>(q, k, v, out, n, Tc, D, warps_per_head, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
