// Single-query (decode) attention over a static KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiocraft_tpu/ops/flash_attention.py::decode_attention
// (body _decode_attn_kernel). For one query per (row b, head h):
//
//     out[b, h] = softmax_s(q[b, h] . K[b, s, h] / sqrt(D)) . V[b, s, h]
//
// over the valid slots s in [lo, hi): hi = length, lo = max(0, length - 1 - past_context)
// (lo = 0 without a window, past_context < 0). `length` is an int32 in device memory (the
// TPU kernel's length_ref), read by every block and clamped to [1, S], so a CUDA graph can
// replay the same launch as the cache fills. Scores, the online softmax and the accumulators are f32; the
// running max is floored at -1e4 (_M_FLOOR of the TPU kernel), so an empty share of the window
// contributes exactly 0. An int8 cache carries one bf16 scale per (slot, head); the output is
// written in q's dtype.
//
// What bounds it: HBM bytes. One query has no reuse of K/V, so the kernel streams the valid
// window once: B * (hi - lo) * H * D * 2 elements of K+V (1 byte each when int8, plus
// 2 * B * (hi - lo) * H bf16 scales), plus q and out. What the design does about it (machinery
// shared with int4_decode_attention.cu in decode_common.cuh):
//   * split-S over a thread-block cluster: the grid is (n, H, B) in clusters of n (1 to 8,
//     chosen by the wrapper from B, H, the cache's capacity S and the SM count: the host does
//     not know the window), so a small batch still puts two or more blocks on every SM; each
//     block walks its share of the window's 32-slot tiles (a share past the window's end is
//     empty and contributes 0) and the cluster combines the shares' (m, l, acc) through
//     distributed shared memory, in rank order, in the same launch (no workspace, no second
//     pass, no atomics);
//   * loads kept in flight: each tile's K and V rows (and the int8 scales) come through a ring
//     of 4 shared-memory stages (2 for f32 caches) by cp.async, 16-byte copies where a row is
//     16-byte aligned, 8 or 4 where it is less, a plain copy where it is only 2-byte aligned
//     (int8 with D % 4 == 2); tile t + 3 (t + 1 for f32) is requested before tile t is computed;
//   * shared memory lets the two passes read a tile in different mappings: 4 lanes per slot
//     for the scores, a lane per 16-byte chunk of a V row for the accumulator (each warp
//     takes 8 slots of the tile), with 16-byte shared-memory reads and the chunks of odd rows
//     swizzled so that neither pass has bank conflicts ("wide" rows: 64 or 128 head dims of
//     bf16 or int8, or 32 of bf16); every other D takes pairs of elements per lane ("pair");
//   * one max and one rescale per tile, not per slot, with exp2f: q carries log2(e) / sqrt(D);
//   * int8 without per-element dequantisation: the score is ks[s] * (q . k_int8) and the
//     weight p * vs[s], one multiply per (slot, head); int8 becomes f32 by a byte permute into
//     the mantissa of 2^23 and one subtraction, bf16 by a shift.
//
// C interface (bound with ctypes): decode_attention_launch(...) returns the launch's error or
// cudaGetLastError(); `length` points to one int32 on the device, past_context < 0 means no
// window, n_split is the cluster size.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

enum KVDType { kKVF32 = 0, kKVBF16 = 1, kKVI8 = 2 };

constexpr int kTile = 32;  // slots per tile: 4 score lanes per slot

template <typename TKV> __host__ __device__ constexpr int stages() {
  return sizeof(TKV) == 4 ? 2 : 4;
}

// Bytes between two rows of a stage: wide rows (L 16-byte chunks, L a power of two) are not
// padded, other rows by 16 bytes (pairs of elements per lane: distinct banks).
template <int L> __host__ __device__ constexpr int row_stride(int row_bytes) {
  return L ? 16 * L : (row_bytes + 15) / 16 * 16 + 16;
}

// Where chunk c of wide row j sits in its row: odd rows swap the halves of every 8 chunks
// (L >= 8), so the 8 lanes of a 16-byte shared-memory phase (2 slots x 4 chunks in the score
// pass, 8 chunks of a row in the value pass) fall on distinct banks; with L == 4 consecutive
// rows already do.
template <int L> __device__ __forceinline__ int chunk_pos(int j, int c) {
  return L >= 8 ? c ^ ((j & 1) << 2) : c;
}

// One stage: K rows, V rows, then (int8) the scale words of K and V.
template <typename TKV, int L> __host__ __device__ constexpr int stage_bytes(int D) {
  return 2 * kTile * row_stride<L>(D * static_cast<int>(sizeof(TKV))) +
         (sizeof(TKV) == 1 ? 2 * kTile * 4 : 0);
}

// int8 byte k of w, biased to x + 128 (w ^ 0x80808080), as f32: the byte goes into the low
// mantissa byte of 2^23 (0x4B000000) by a byte permute, then 2^23 + 128 is subtracted.
__device__ __forceinline__ float biased_i8(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}

// Elements 2i and 2i + 1 of a row in shared memory, as f32 (the pair path).
template <typename T> __device__ __forceinline__ float2 load_pair(const T* p);
template <> __device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load_pair<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
template <> __device__ __forceinline__ float2 load_pair<int8_t>(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
  return make_float2(biased_i8(w, 0x7540), biased_i8(w, 0x7541));
}

// 16 bytes of a row in shared memory, as 16 / sizeof(T) f32 (the wide path).
template <typename T>
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&f)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16>(const unsigned char* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void load_chunk<int8_t>(const unsigned char* p, float (&f)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) f[4 * i + k] = biased_i8(w[i], 0x7540 + k);
}

// Grid (n, H, B), clusters of (n, 1, 1), kThreads threads. DMAX (64 or 128) bounds D. L > 0:
// the wide path, rows of exactly L 16-byte chunks (D = 16 L / sizeof(TKV)); L == 0: the pair
// path, any even D <= DMAX, rows copied in 16-, 8-, 4- or 2-byte chunks.
template <typename TQ, typename TKV, int DMAX, int L>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale, TQ* __restrict__ out,
                   const int* __restrict__ length, int S, int H, int D, int past_context,
                   float q_scale) {
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr int kStages = stages<TKV>();
  constexpr int kEpc = 16 / sizeof(TKV);            // elements per 16-byte chunk
  constexpr int kChunksPerLane = (L + 3) / 4;       // wide scores: chunks q, q + 4, ...
  constexpr int kSlotsPerRound = L ? 32 / L : 1;    // wide values: slots a warp takes at once
  constexpr int kScorePairs = DMAX / 8;             // pair scores: pairs q, q + 4, ...
  constexpr int kAccPairs = DMAX / 64;              // pair values: pairs lane, lane + 32
  constexpr int kAcc = L ? kEpc : 2 * kAccPairs;
  constexpr int kQRegs = L ? kChunksPerLane * kEpc : 2 * kScorePairs;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float sc[kTile];
  __shared__ float red[kWarps][DMAX];
  __shared__ float part[2 + DMAX];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // the valid window, from the device-resident length (clamped to [1, S])
  const int hi = min(max(__ldg(length), 1), S);
  const int lo = past_context < 0 ? 0 : max(0, hi - 1 - past_context);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_bytes = D * static_cast<int>(sizeof(TKV));
  const int stride = row_stride<L>(row_bytes);
  const int chunk = L ? 16 : chunk_of(row_bytes);
  const int chunks_per_row = row_bytes / chunk;
  const int sbytes = stage_bytes<TKV, L>(D);
  const size_t slot_elems = static_cast<size_t>(H) * D;  // elements between slots s, s + 1
  const size_t head = static_cast<size_t>(b) * S * slot_elems + static_cast<size_t>(h) * D;
  const unsigned char* kh = reinterpret_cast<const unsigned char*>(k + head);
  const unsigned char* vh = reinterpret_cast<const unsigned char*>(v + head);
  const size_t slot_bytes = slot_elems * sizeof(TKV);
  const size_t scale_head = static_cast<size_t>(b) * S * H + h;
  const Share share =
      tile_share<kTile>(lo, hi, static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x));
  const int n_tiles = share.end - share.begin;
  // this thread's first (row, chunk) of a tile's copy and its step, without a division per copy
  const int copy_r0 = tid / chunks_per_row;
  const int copy_c0 = tid - copy_r0 * chunks_per_row;
  const int copy_dr = kThreads / chunks_per_row;
  const int copy_dc = kThreads - copy_dr * chunks_per_row;

  // Tile t of the share into stage t % kStages: its valid rows of K and V (and their scale
  // words), then one commit group (empty past the share's end, so the wait count holds).
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int base = (share.begin + t) * kTile;
      const int s0 = max(base, lo);
      const int rows = min(base + kTile, hi) - s0;
      unsigned char* st = ring + (t % kStages) * sbytes + (s0 - base) * stride;
      const unsigned char* ks0 = kh + static_cast<size_t>(s0) * slot_bytes;
      const unsigned char* vs0 = vh + static_cast<size_t>(s0) * slot_bytes;
      for (int r = copy_r0, c = copy_c0; r < rows;) {
        const size_t src = static_cast<size_t>(r) * slot_bytes + c * chunk;
        const int dst = r * stride + (L ? 16 * chunk_pos<L>(s0 - base + r, c) : c * chunk);
        copy_chunk(st + dst, ks0 + src, chunk);
        copy_chunk(st + kTile * stride + dst, vs0 + src, chunk);
        r += copy_dr;
        c += copy_dc;
        if (c >= chunks_per_row) {
          c -= chunks_per_row;
          ++r;
        }
      }
      if (kQuant) {
        uint32_t* words = reinterpret_cast<uint32_t*>(ring + (t % kStages) * sbytes +
                                                      2 * kTile * stride) + (s0 - base);
        for (int r = tid; r < rows; r += kThreads) {
          const size_t si = scale_head + static_cast<size_t>(s0 + r) * H;
          copy_scale_word(words + r, k_scale + si);
          copy_scale_word(words + kTile + r, v_scale + si);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  const int slot = tid >> 2;  // score pass: 4 lanes per slot
  const int quarter = tid & 3;
  // q * log2(e) / sqrt(D): the lane's chunks (wide) or pairs (pair path) of the row
  float qr[kQRegs];
  const TQ* qrow = q + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kQRegs; ++i) {
    const int e = L ? (quarter + 4 * (i / kEpc)) * kEpc + i % kEpc
                    : 2 * (quarter + 4 * (i / 2)) + i % 2;
    qr[i] = e < D ? to_f32<TQ>(qrow[e]) * q_scale : 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m = kMFloor2;
  float l = 0.f;  // this lane's slots' share of the sum; the warp's lanes add up at the end

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    issue(t + kStages - 1);
    const int base = (share.begin + t) * kTile;
    const int j0 = max(base, lo) - base;
    const int j1 = min(base + kTile, hi) - base;
    const unsigned char* st = ring + (t % kStages) * sbytes;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(st + 2 * kTile * stride);

    // scores: 4 lanes per slot
    const bool valid = slot >= j0 && slot < j1;
    float dot0 = 0.f, dot1 = 0.f;
    if (valid) {
      const unsigned char* row = st + slot * stride;
      if constexpr (L > 0) {
#pragma unroll
        for (int j = 0; j < kChunksPerLane; ++j) {
          if (quarter + 4 * j < L) {
            float f[kEpc];
            load_chunk<TKV>(row + 16 * chunk_pos<L>(slot, quarter + 4 * j), f);
#pragma unroll
            for (int e = 0; e < kEpc; e += 2) {
              dot0 = fmaf(qr[j * kEpc + e], f[e], dot0);
              dot1 = fmaf(qr[j * kEpc + e + 1], f[e + 1], dot1);
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kScorePairs; ++i) {
          const int e = 2 * (quarter + 4 * i);
          if (e < D) {
            const float2 kv = load_pair<TKV>(reinterpret_cast<const TKV*>(row) + e);
            dot0 = fmaf(qr[2 * i], kv.x, dot0);
            dot1 = fmaf(qr[2 * i + 1], kv.y, dot1);
          }
        }
      }
    }
    float dot = dot0 + dot1;
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (quarter == 0) {
      float s = -INFINITY;
      if (valid) {
        s = dot;
        if (kQuant)
          s *= scale_pick(words[slot], k_scale + scale_head + static_cast<size_t>(base + slot) * H);
      }
      sc[slot] = s;
    }
    __syncthreads();

    // one max and one rescale for the tile; every warp holds the same m, lane = slot
    const float s = sc[lane];
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = exp2f(m - m_new);
    float p = exp2f(s - m_new);  // 0 for the slots outside the window
    l = l * alpha + p;
    m = m_new;
    if (kQuant && lane >= j0 && lane < j1)
      p *= scale_pick(words[kTile + lane],
                      v_scale + scale_head + static_cast<size_t>(base + lane) * H);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha;
    if constexpr (L > 0) {
      // values: warp w takes slots 8w .. 8w + 7, kSlotsPerRound at once, a 16-byte chunk a lane
      const int sub = lane / L;
      const int c = lane % L;
#pragma unroll
      for (int rr = 0; rr < 8 / kSlotsPerRound; ++rr) {
        const int j = 8 * warp + rr * kSlotsPerRound + sub;
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (j >= j0 && j < j1) {  // unloaded rows may hold anything
          float f[kEpc];
          load_chunk<TKV>(st + (kTile + j) * stride + 16 * chunk_pos<L>(j, c), f);
#pragma unroll
          for (int e = 0; e < kEpc; ++e) acc[e] = fmaf(pj, f[e], acc[e]);
        }
      }
    } else {
      // values: warp w takes slots w, w + 4, ...; a lane per pair of head dims
      for (int j = warp; j < kTile; j += kWarps) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (j < j0 || j >= j1) continue;  // warp-uniform; unloaded rows may hold anything
        const TKV* row = reinterpret_cast<const TKV*>(st + (kTile + j) * stride);
#pragma unroll
        for (int i = 0; i < kAccPairs; ++i) {
          const int e = 2 * (lane + 32 * i);
          if (e < D) {
            const float2 vv = load_pair<TKV>(row + e);
            acc[2 * i] = fmaf(pj, vv.x, acc[2 * i]);
            acc[2 * i + 1] = fmaf(pj, vv.y, acc[2 * i + 1]);
          }
        }
      }
    }
  }

  // the block's partial: the warps' accumulators summed; then the cluster's combine
  l = warp_sum(l);
  if constexpr (L > 0) {
#pragma unroll
    for (int off = L; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < kEpc; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    if (lane < L)
#pragma unroll
      for (int e = 0; e < kEpc; ++e) red[warp][lane * kEpc + e] = acc[e];
  } else {
#pragma unroll
    for (int i = 0; i < kAccPairs; ++i) {
      const int e = 2 * (lane + 32 * i);
      if (e < D) {
        red[warp][e] = acc[2 * i];
        red[warp][e + 1] = acc[2 * i + 1];
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w][d];
    part[2 + d] = a;
  }
  if (tid == 0) {
    part[0] = m;
    part[1] = l;
  }
  cluster_combine_store<TQ>(part, D, out + (static_cast<size_t>(b) * H + h) * D);
}

template <typename TQ, typename TKV, int DMAX, int L>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           void* out, const int* length, int B, int S, int H, int D, int past_context,
           cudaStream_t stream, int n_split) {
  const size_t smem = static_cast<size_t>(stages<TKV>()) * stage_bytes<TKV, L>(D);
  const float q_scale = kLog2e / sqrtf(static_cast<float>(D));
  return static_cast<int>(launch_cluster<decode_attn_kernel<TQ, TKV, DMAX, L>>(
      n_split, H, B, smem, stream, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<TQ*>(out), length, S, H, D,
      past_context, q_scale));
}

// The wide path where a row is 4, 8 or 16 chunks of 16 bytes of a bf16 or int8 cache (D 32,
// 64 or 128 in bf16; 64 or 128 in int8); the pair path for every other D and the f32 cache.
template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             void* out, const int* length, int B, int S, int H, int D, int past_context,
             cudaStream_t stream, int n_split) {
#define DA_LAUNCH(DMAX, L) \
  launch<TQ, TKV, DMAX, L>(q, k, v, ks, vs, out, length, B, S, H, D, past_context, stream, \
                           n_split)
  if constexpr (sizeof(TKV) == 2) {
    if (D == 32) return DA_LAUNCH(64, 4);
    if (D == 64) return DA_LAUNCH(64, 8);
    if (D == 128) return DA_LAUNCH(128, 16);
  } else if constexpr (sizeof(TKV) == 1) {
    if (D == 64) return DA_LAUNCH(64, 4);
    if (D == 128) return DA_LAUNCH(128, 8);
  }
  if (D <= 64) return DA_LAUNCH(64, 0);
  return DA_LAUNCH(128, 0);
#undef DA_LAUNCH
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale, void* out,
                                       const int* length, int B, int S, int H, int D,
                                       int past_context, int q_dtype, int kv_dtype, void* stream,
                                       int n_split) {
  if (D <= 0 || D > 128 || D % 2 != 0 || S <= 0 || B <= 0 || H <= 0 || length == nullptr ||
      n_split < 1 || n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_ARGS q, k, v, k_scale, v_scale, out, length, B, S, H, D, past_context, st, n_split
  if (q_dtype == kF32) {
    if (kv_dtype == kKVF32) return dispatch<float, float>(DA_ARGS);
    if (kv_dtype == kKVBF16) return dispatch<float, __nv_bfloat16>(DA_ARGS);
    if (kv_dtype == kKVI8) return dispatch<float, int8_t>(DA_ARGS);
  } else if (q_dtype == kBF16) {
    if (kv_dtype == kKVF32) return dispatch<__nv_bfloat16, float>(DA_ARGS);
    if (kv_dtype == kKVBF16) return dispatch<__nv_bfloat16, __nv_bfloat16>(DA_ARGS);
    if (kv_dtype == kKVI8) return dispatch<__nv_bfloat16, int8_t>(DA_ARGS);
  }
#undef DA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
