// Single-query (decode) attention over an int4-packed KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/pallas_int4_decode.py::int4_decode_attention (body
// _int4_decode_kernel). Layout, with D2 = D / 2 and HD2 = H * D2:
//   k4  [B, S, HD2] int8: byte (s, h * D2 + d2) holds dim d2 in its low nibble and dim D2 + d2
//       in its high nibble, both signed (two's complement, -8..7);
//   v4t [B, HD2, S] int8: the same packing for V, transposed (each (h, d2) row runs along S);
//   k_scale / v_scale [B, S, 2, H] bf16: one scale per (step, plane, head), plane 0 = dims
//       [0, D2), plane 1 = dims [D2, D).
// For one query per (row b, head h), over the valid slots s in [lo, hi):
//   qs      = bf16(q * (1 / sqrt(D)))
//   score_s = (qs[:D2] . lo(k_s)) * ks[s, 0] + (qs[D2:] . hi(k_s)) * ks[s, 1]      (f32)
//   m       = max(max_s score_s, -1e4);  e_s = exp(score_s - m);  l = sum_s e_s
//   out[p * D2 + d2] = sum_s bf16(e_s * vs[s, p]) * nibble_p(v[d2, s]) / l          (f32)
// written in q's dtype. The TPU kernel keeps a running max per 256-slot block; one max over
// the window (as the plain version takes it) moves the bf16 weights by at most one ulp.
//
// What bounds it: HBM bytes. Each packed byte of the valid window is read once (K and V: half a
// byte per element), plus the bf16 scales, q and out. The TPU design (a block-diagonal query
// matrix and a transposed-V product on the MXU, 15/16 of whose operations are zeros) does not
// carry over; here:
//   * one thread block per (head, row): grid (H, B), 128 threads, no cross-block reduction;
//   * phase 1 (scores): D2 / 16 lanes share a K row and read it with 16-byte loads; the nibbles
//     are decoded in registers with two shifts each; f32 dot products are reduced across those
//     lanes with warp shuffles; the scores go to shared memory and the block reduces the max;
//   * phase 2 (weights): each slot's e and its two bf16-rounded weights replace the score in
//     shared memory, and the block sums l;
//   * phase 3 (values): each warp owns D2 / 4 rows of v4t; its lanes read consecutive 4-byte
//     words along S (coalesced, 4 slots a lane) and keep the weights of those slots in registers
//     across the rows; the accumulators are reduced across the warp with shuffles at the end.
// Only the valid window (rounded out to the 4-slot words, whose extra slots get weight 0) is read.
// Split-S for small batches, TMA and a persistent schedule are left for later work.
//
// C interface (bound with ctypes): int4_decode_attention_launch(...) returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMFloor = -1e4f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

enum DType { kF32 = 0, kBF16 = 1 };

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Signed low / high nibble of byte i of the little-endian word w: shift the nibble's top bit
// to bit 31, then shift back arithmetically.
__device__ __forceinline__ float nib_lo(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (28 - 8 * i)) >> 28);
}
__device__ __forceinline__ float nib_hi(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 28);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// LPR = lanes per K row = D2 / 16; VW = slots per lane load of V (4, or 1 when S % 4 != 0).
// Shared memory: g_lo[W], g_hi[W] f32 for the window [s_begin, s_end), W = s_end - s_begin.
template <typename TQ, int LPR, int VW>
__global__ void __launch_bounds__(kThreads)
int4_decode_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k4,
                   const int8_t* __restrict__ v4t, const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale, TQ* __restrict__ out, int S, int H,
                   int lo, int hi, int s_begin, int s_end, float sm_scale) {
  constexpr int D2 = LPR * 16;
  constexpr int D = 2 * D2;
  constexpr int kRowsPerWarp = 32 / LPR;     // K rows a warp scores at once
  constexpr int kRows = kWarps * kRowsPerWarp;
  constexpr int kVRows = D2 / kWarps;        // v4t rows each warp accumulates
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_m[kWarps];
  __shared__ float red_l[kWarps];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = s_end - s_begin;
  float* g_lo = smem;
  float* g_hi = smem + W;
  const size_t HD2 = static_cast<size_t>(H) * D2;
  const size_t scale_base = static_cast<size_t>(b) * S * 2 * H + h;  // + s * 2H + p * H

  // ---- phase 1: scores of the valid slots (into g_lo) and their max
  const int sub = lane % LPR;
  float qlo[16], qhi[16];
  const TQ* qrow = q + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    qlo[j] = bf16_round(to_f32<TQ>(qrow[sub * 16 + j]) * sm_scale);
    qhi[j] = bf16_round(to_f32<TQ>(qrow[D2 + sub * 16 + j]) * sm_scale);
  }
  const int8_t* krow = k4 + static_cast<size_t>(b) * S * HD2 + static_cast<size_t>(h) * D2 +
                       sub * 16;
  float m = kMFloor;
  // warp-uniform loop (the shuffles need every lane); lanes past hi compute on nothing
  for (int s0 = lo + warp * kRowsPerWarp; s0 < hi; s0 += kRows) {
    const int s = s0 + lane / LPR;
    const bool valid = s < hi;
    float dot_lo = 0.f, dot_hi = 0.f;
    if (valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(krow + static_cast<size_t>(s) * HD2));
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dot_lo = fmaf(qlo[wi * 4 + i], nib_lo(words[wi], i), dot_lo);
          dot_hi = fmaf(qhi[wi * 4 + i], nib_hi(words[wi], i), dot_hi);
        }
    }
#pragma unroll
    for (int off = LPR >> 1; off > 0; off >>= 1) {
      dot_lo += __shfl_xor_sync(0xffffffffu, dot_lo, off);
      dot_hi += __shfl_xor_sync(0xffffffffu, dot_hi, off);
    }
    if (valid) {
      const size_t si = scale_base + static_cast<size_t>(s) * 2 * H;
      const float score = __fadd_rn(__fmul_rn(dot_lo, __bfloat162float(k_scale[si])),
                                    __fmul_rn(dot_hi, __bfloat162float(k_scale[si + H])));
      m = fmaxf(m, score);
      if (sub == 0) g_lo[s - s_begin] = score;
    }
  }
  m = warp_max(m);
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
  m = red_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_m[w]);

  // ---- phase 2: e, l and the bf16 weights of each plane (slots outside [lo, hi) weigh 0)
  float l = 0.f;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const int s = s_begin + i;
    float gl = 0.f, gh = 0.f;
    if (s >= lo && s < hi) {
      const float e = expf(g_lo[i] - m);
      const size_t si = scale_base + static_cast<size_t>(s) * 2 * H;
      l += e;
      gl = bf16_round(e * __bfloat162float(v_scale[si]));
      gh = bf16_round(e * __bfloat162float(v_scale[si + H]));
    }
    g_lo[i] = gl;
    g_hi[i] = gh;
  }
  l = warp_sum(l);
  if (lane == 0) red_l[warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += red_l[w];

  // ---- phase 3: out[p * D2 + d2] = sum_s g_p[s] * nibble_p(v4t[d2, s]) / l
  float acc_lo[kVRows], acc_hi[kVRows];
#pragma unroll
  for (int r = 0; r < kVRows; ++r) acc_lo[r] = acc_hi[r] = 0.f;
  const int8_t* vbase = v4t + (static_cast<size_t>(b) * HD2 + static_cast<size_t>(h) * D2 +
                               warp * kVRows) * S + s_begin;
  for (int c = lane; c < W / VW; c += 32) {
    float gl[VW], gh[VW];
    if constexpr (VW == 4) {
      const float4 a = *reinterpret_cast<const float4*>(g_lo + c * VW);
      const float4 z = *reinterpret_cast<const float4*>(g_hi + c * VW);
      gl[0] = a.x; gl[1] = a.y; gl[2] = a.z; gl[3] = a.w;
      gh[0] = z.x; gh[1] = z.y; gh[2] = z.z; gh[3] = z.w;
    } else {
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        gl[i] = g_lo[c * VW + i];
        gh[i] = g_hi[c * VW + i];
      }
    }
    uint32_t words[kVRows];
#pragma unroll
    for (int r = 0; r < kVRows; ++r) {
      const int8_t* p = vbase + static_cast<size_t>(r) * S + c * VW;
      words[r] = VW == 4 ? __ldg(reinterpret_cast<const unsigned int*>(p))
                         : static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p)));
    }
#pragma unroll
    for (int r = 0; r < kVRows; ++r)
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        acc_lo[r] = fmaf(gl[i], nib_lo(words[r], i), acc_lo[r]);
        acc_hi[r] = fmaf(gh[i], nib_hi(words[r], i), acc_hi[r]);
      }
  }
  TQ* orow = out + (static_cast<size_t>(b) * H + h) * D + warp * kVRows;
#pragma unroll
  for (int r = 0; r < kVRows; ++r) {
    const float lo_sum = warp_sum(acc_lo[r]);
    const float hi_sum = warp_sum(acc_hi[r]);
    if (lane == 0) {
      orow[r] = from_f32<TQ>(lo_sum / l);
      orow[D2 + r] = from_f32<TQ>(hi_sum / l);
    }
  }
}

template <typename TQ, int LPR, int VW>
int launch(const void* q, const void* k4, const void* v4t, const void* ks, const void* vs,
           void* out, int B, int S, int H, int lo, int hi, float sm_scale, cudaStream_t stream) {
  const int s_begin = lo - lo % VW;
  const int s_end = (hi + VW - 1) / VW * VW;  // <= S, since VW divides S
  const size_t smem = 2 * static_cast<size_t>(s_end - s_begin) * sizeof(float);
  auto kernel = int4_decode_kernel<TQ, LPR, VW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(k4),
      static_cast<const int8_t*>(v4t), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<TQ*>(out), S, H, lo, hi, s_begin,
      s_end, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, int LPR>
int dispatch_vw(const void* q, const void* k4, const void* v4t, const void* ks, const void* vs,
                void* out, int B, int S, int H, int lo, int hi, float sm_scale,
                cudaStream_t stream) {
  if (S % 4 == 0)
    return launch<TQ, LPR, 4>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, sm_scale, stream);
  return launch<TQ, LPR, 1>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, sm_scale, stream);
}

template <typename TQ>
int dispatch(const void* q, const void* k4, const void* v4t, const void* ks, const void* vs,
             void* out, int B, int S, int H, int D, int lo, int hi, cudaStream_t stream) {
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  if (D == 32) return dispatch_vw<TQ, 1>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, sm_scale, stream);
  if (D == 64) return dispatch_vw<TQ, 2>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, sm_scale, stream);
  return dispatch_vw<TQ, 4>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, sm_scale, stream);
}

}  // namespace

extern "C" int int4_decode_attention_launch(const void* q, const void* k4, const void* v4t,
                                            const void* k_scale, const void* v_scale, void* out,
                                            int B, int S, int H, int D, int lo, int hi,
                                            int q_dtype, void* stream) {
  if ((D != 32 && D != 64 && D != 128) || lo < 0 || hi > S || lo >= hi || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch<float>(q, k4, v4t, k_scale, v_scale, out, B, S, H, D, lo, hi, st);
  if (q_dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, k4, v4t, k_scale, v_scale, out, B, S, H, D, lo, hi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
