// Single-query (decode) attention over a static KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiocraft_tpu/ops/flash_attention.py::decode_attention
// (body _decode_attn_kernel). For one query per (row b, head h):
//
//     out[b, h] = softmax_s(q[b, h] . K[b, s, h] / sqrt(D)) . V[b, s, h]
//
// over the valid slots s in [lo, hi): hi = length, lo = max(0, length - 1 - past_context)
// (lo = 0 without a window). Scores, the online softmax and the accumulators are f32;
// the running max is floored at -1e4 (_M_FLOOR of the TPU kernel). With an int8 cache each
// element is dequantized in f32 as int8 -> f32 times its per-(step, head) bf16 scale -> f32.
// The output is written in q's dtype.
//
// What bounds it: HBM bytes. One query has no reuse of K/V, so the kernel streams the valid
// prefix of the cache once: B * (hi - lo) * H * D * 2 elements of K+V (1 byte each when int8,
// plus 2 * B * (hi - lo) * H bf16 scales), plus q and out. The design answers that with:
//   * one thread block per (head, row): no cross-block reduction, no second pass;
//   * a loop inside the block over the valid slots only, bounded by [lo, hi) and never by the
//     cache's capacity S, so the cache can be allocated once at full size;
//   * each cache row of one head (D contiguous elements) read by a few lanes with 16-byte
//     vector loads where D allows it; two rows per lane group in flight per iteration;
//   * the max and the sum reduced across lanes with warp shuffles and across row groups once,
//     at the end, through shared memory; f32 accumulators in registers.
// Split-S flash-decoding, TMA and a persistent schedule are left for later work.
//
// C interface (bound with ctypes): decode_attention_launch(...) returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMFloor = -1e4f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// row groups * D never exceeds kThreads * 16 (see the launch below)
constexpr int kMaxAccFloats = kThreads * 16;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = unsigned int; };
template <> struct RawVec<2> { using type = unsigned short; };

// VEC consecutive elements at p (aligned to their size) -> f32 registers.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&r)[VEC]) {
  using V = typename RawVec<VEC * sizeof(T)>::type;
  V raw = __ldg(reinterpret_cast<const V*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) r[i] = to_f32<T>(e[i]);
}

// Grid (H, B), kThreads threads. A row of one head (D elements) is split into chunks of VEC
// elements; `tpr` lanes (a power of two) share a row, each holding NCH chunks. A warp works on
// 32 / tpr rows at once, the block on n_grp = kWarps * 32 / tpr rows ("row groups").
template <typename TQ, typename TKV, int VEC, int NCH, bool QUANT>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale, TQ* __restrict__ out,
                   int S, int H, int D, int tpr, int lo, int hi, float sm_scale) {
  __shared__ float sm_m[kThreads];
  __shared__ float sm_l[kThreads];
  __shared__ float sm_acc[kMaxAccFloats];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_warp = 32 / tpr;
  const int sub = lane % tpr;
  const int grp = warp * rows_per_warp + lane / tpr;
  const int n_grp = kWarps * rows_per_warp;
  const int n_chunks = D / VEC;

  bool active[NCH];
  int doff[NCH];
  float qf[NCH][VEC];
  float acc[NCH][VEC];
  const TQ* qrow = q + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = sub + j * tpr;
    active[j] = c < n_chunks;
    doff[j] = c * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qf[j][i] = active[j] ? to_f32<TQ>(qrow[doff[j] + i]) * sm_scale : 0.f;
      acc[j][i] = 0.f;
    }
  }

  const size_t row_stride = static_cast<size_t>(H) * D;  // elements between slots s, s+1
  const size_t head_base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * D;
  const size_t scale_base = static_cast<size_t>(b) * S * H + h;

  float m = kMFloor;
  float l = 0.f;

  // Warp-uniform loop (shuffles need every lane): lanes whose row lies past hi compute on
  // nothing and skip the update.
  for (int s0 = lo + warp * rows_per_warp; s0 < hi; s0 += 2 * n_grp) {
    int s[2];
    bool valid[2];
    s[0] = s0 + lane / tpr;
    s[1] = s[0] + n_grp;
    valid[0] = s[0] < hi;
    valid[1] = s[1] < hi;
    float kf[2][NCH][VEC];
    float vf[2][NCH][VEC];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t base = head_base + static_cast<size_t>(s[r]) * row_stride;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        if (valid[r] && active[j]) {
          load_vec<TKV, VEC>(k + base + doff[j], kf[r][j]);
          load_vec<TKV, VEC>(v + base + doff[j], vf[r][j]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) kf[r][j][i] = vf[r][j][i] = 0.f;
        }
      }
    }
    float score[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (QUANT && valid[r]) {
        const size_t si = scale_base + static_cast<size_t>(s[r]) * H;
        const float ks = __bfloat162float(k_scale[si]);
        const float vs = __bfloat162float(v_scale[si]);
#pragma unroll
        for (int j = 0; j < NCH; ++j)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            kf[r][j][i] *= ks;
            vf[r][j][i] *= vs;
          }
      }
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) part += qf[j][i] * kf[r][j][i];
      for (int off = tpr >> 1; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      score[r] = part;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!valid[r]) continue;
      const float m_new = fmaxf(m, score[r]);
      const float alpha = expf(m - m_new);
      const float p = expf(score[r] - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[j][i] = acc[j][i] * alpha + p * vf[r][j][i];
      m = m_new;
    }
  }

  // Combine the row groups: rescale each to the block's max and sum.
  if (sub == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j)
    if (active[j])
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[grp * D + doff[j] + i] = acc[j][i];
  __syncthreads();

  float m_all = kMFloor;
  for (int g = 0; g < n_grp; ++g) m_all = fmaxf(m_all, sm_m[g]);
  const int d = threadIdx.x;
  if (d < D) {
    float l_all = 0.f;
    float a_all = 0.f;
    for (int g = 0; g < n_grp; ++g) {
      const float w = expf(sm_m[g] - m_all);
      l_all += sm_l[g] * w;
      a_all += sm_acc[g * D + d] * w;
    }
    out[(static_cast<size_t>(b) * H + h) * D + d] = from_f32<TQ>(a_all / l_all);
  }
}

template <typename TQ, typename TKV, int VEC, int NCH>
void launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
            void* out, int B, int S, int H, int D, int tpr, int lo, int hi,
            cudaStream_t stream) {
  constexpr bool kQuant = sizeof(TKV) == 1;
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(H, B);
  decode_attn_kernel<TQ, TKV, VEC, NCH, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
      static_cast<TQ*>(out), S, H, D, tpr, lo, hi, sm_scale);
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Pick the vector width and lanes per row for D, then launch.
template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             void* out, int B, int S, int H, int D, int lo, int hi, cudaStream_t stream) {
  constexpr int kVecMax = 16 / sizeof(TKV);
  if (D % kVecMax == 0) {
    // D / kVecMax <= 32 for every dtype when D <= 128
    launch<TQ, TKV, kVecMax, 1>(q, k, v, ks, vs, out, B, S, H, D, next_pow2(D / kVecMax), lo,
                                hi, stream);
  } else if (D / 2 <= 32) {
    launch<TQ, TKV, 2, 1>(q, k, v, ks, vs, out, B, S, H, D, next_pow2(D / 2), lo, hi, stream);
  } else {
    launch<TQ, TKV, 2, 2>(q, k, v, ks, vs, out, B, S, H, D, 32, lo, hi, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale, void* out,
                                       int B, int S, int H, int D, int lo, int hi,
                                       int q_dtype, int kv_dtype, void* stream) {
  if (D <= 0 || D > 128 || D % 2 != 0 || lo < 0 || hi > S || lo >= hi || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_ARGS q, k, v, k_scale, v_scale, out, B, S, H, D, lo, hi, st
  if (q_dtype == kF32) {
    if (kv_dtype == kF32) return dispatch<float, float>(DA_ARGS);
    if (kv_dtype == kBF16) return dispatch<float, __nv_bfloat16>(DA_ARGS);
    if (kv_dtype == kI8) return dispatch<float, int8_t>(DA_ARGS);
  } else if (q_dtype == kBF16) {
    if (kv_dtype == kF32) return dispatch<__nv_bfloat16, float>(DA_ARGS);
    if (kv_dtype == kBF16) return dispatch<__nv_bfloat16, __nv_bfloat16>(DA_ARGS);
    if (kv_dtype == kI8) return dispatch<__nv_bfloat16, int8_t>(DA_ARGS);
  }
#undef DA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
