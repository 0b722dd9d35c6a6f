// Single-query (decode) attention over an int4-packed KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/pallas_int4_decode.py::int4_decode_attention (body
// _int4_decode_kernel). Layout, with D2 = D / 2 and HD2 = H * D2:
//   k4  [B, S, HD2] int8: byte (s, h * D2 + d2) holds dim d2 in its low nibble and dim D2 + d2
//       in its high nibble, both signed (two's complement, -8..7);
//   v4t [B, HD2, S] int8: the same packing for V, transposed (each (h, d2) row runs along S);
//   k_scale / v_scale [B, S, 2, H] bf16: one scale per (step, plane, head), plane 0 = dims
//       [0, D2), plane 1 = dims [D2, D).
// For one query per (row b, head h), over the valid slots s in [lo, hi), in tiles of 128 slots
// with a running max m (as the TPU kernel keeps one per 256-slot block):
//   qs      = bf16(q * (1 / sqrt(D)))
//   score_s = (qs[:D2] . lo(k_s)) * ks[s, 0] + (qs[D2:] . hi(k_s)) * ks[s, 1]      (f32)
//   m       = max(m, max_tile score_s, -1e4);  e_s = exp(score_s - m);  l += sum_tile e_s
//   acc[p * D2 + d2] += sum_tile bf16(e_s * vs[s, p]) * nibble_p(v[d2, s])        (f32)
// with l and acc rescaled by exp(m_old - m) when m grows; out = acc / l in q's dtype. The bf16
// weights follow the running max, as on the TPU; one max over the window (the plain version's)
// moves each by at most one ulp.
//
// What bounds it: HBM bytes. Each packed byte of the valid window is read once (K and V: half a
// byte per element), plus the bf16 scales, q and out. The TPU design (a block-diagonal query
// matrix and a transposed-V product on the MXU, 15/16 of whose operations are zeros) does not
// carry over. Here, with decode_attention.cu's machinery (decode_common.cuh):
//   * split-S over a thread-block cluster: grid (n, H, B) in clusters of n; each block walks
//     its share of the window's 128-slot tiles, the cluster combines (m, l, acc) through
//     distributed shared memory in rank order; no window-sized buffer, so the window has no cap;
//   * a ring of 4 shared-memory stages per block: a tile's K rows (16-byte cp.async), its
//     bytes of the D2 rows of v4t (contiguous along S: 128 bytes a row, 16-byte cp.async where
//     S allows it, smaller copies where it does not) and its scale words are requested
//     together, 3 tiles ahead of the one computed;
//   * scores with D2 / 16 lanes per slot (16 K bytes each, the nibbles decoded in registers by
//     two shifts); one max and one rescale per tile (exp2f); e and the two bf16 weights with a
//     thread per slot, into shared memory; the values with a lane per 4-slot word of v4t and
//     each warp over D2 / 4 rows, the 8 weights of a lane's word read once per tile.
//
// C interface (bound with ctypes): int4_decode_attention_launch(...) returns the launch's
// error or cudaGetLastError(); n_split is the cluster size.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

constexpr int kTile = 128;  // slots per tile: a thread per slot for the weights
constexpr int kStages = 4;

// One stage: kTile K rows of D2 bytes, D2 rows of kTile V bytes, then the scale words of each
// slot (ks plane 0, ks plane 1, vs plane 0, vs plane 1: 4 x kTile words).
__host__ __device__ constexpr int stage_bytes(int D2) {
  return kTile * D2 + D2 * kTile + 4 * kTile * 4;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The signed low and high nibbles of the 4 bytes of w, as f32: each nibble's top bit shifted
// to bit 31, then shifted back arithmetically.
__device__ __forceinline__ void nibbles(uint32_t w, float (&lo)[4], float (&hi)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = static_cast<float>(static_cast<int>(w << (28 - 8 * i)) >> 28);
    hi[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 28);
  }
}

// Grid (n, H, B), clusters of (n, 1, 1), kThreads threads, stage_bytes(D / 2) * kStages bytes
// of dynamic shared memory.
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
int4_decode_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k4,
                   const int8_t* __restrict__ v4t, const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale, TQ* __restrict__ out, int S, int H,
                   int lo, int hi, float sm_scale) {
  constexpr int D2 = D / 2;
  constexpr int kLps = D2 / 16;               // score lanes per slot, 16 K bytes each
  constexpr int kSlotsPerPass = kThreads / kLps;
  constexpr int kRows = D2 / kWarps;          // v4t rows per warp
  constexpr int kSBytes = stage_bytes(D2);
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float sc[kTile];
  __shared__ __align__(16) float g[2][kTile];  // the tile's bf16 weights, per plane
  __shared__ float red[kWarps];
  __shared__ float part[2 + D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t HD2 = static_cast<size_t>(H) * D2;
  const int8_t* kh = k4 + static_cast<size_t>(b) * S * HD2 + static_cast<size_t>(h) * D2;
  const int8_t* vh = v4t + (static_cast<size_t>(b) * HD2 + static_cast<size_t>(h) * D2) * S;
  const size_t scale_head = static_cast<size_t>(b) * S * 2 * H + h;  // + s * 2H + p * H
  // this thread's V copies: bytes [vc, vc + vchunk) of tile rows vr0, vr0 + vdr, ... (no
  // division per copy)
  const int vchunk = min(16, chunk_of(S));
  const int vcpr = kTile / vchunk;
  const int vr0 = tid / vcpr;
  const int vc = (tid - vr0 * vcpr) * vchunk;
  const int vdr = kThreads / vcpr;  // vcpr <= kTile == kThreads
  const Share share =
      tile_share<kTile>(lo, hi, static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x));
  const int n_tiles = share.end - share.begin;

  // Tile t of the share into stage t % kStages, then one commit group (empty past the end).
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int base = (share.begin + t) * kTile;
      const int s0 = max(base, lo);
      const int s1 = min(base + kTile, hi);
      unsigned char* st = ring + (t % kStages) * kSBytes;
      // K: the valid rows, 16 bytes a copy
      for (int i = tid; i < (s1 - s0) * kLps; i += kThreads) {
        const int r = i / kLps;
        const int c = 16 * (i - r * kLps);
        copy_chunk(st + (s0 - base + r) * D2 + c, kh + static_cast<size_t>(s0 + r) * HD2 + c, 16);
      }
      // V: bytes [v0, v1) of each of the D2 rows, the valid slots rounded out to vchunk
      // (which divides S, so the rounded range stays inside the row)
      const int v0 = s0 - (s0 - base) % vchunk - base;
      const int v1 = min(S, (s1 + vchunk - 1) / vchunk * vchunk) - base;
      unsigned char* vst = st + kTile * D2;
      const int8_t* vsrc = vh + base;
      if (vc >= v0 && vc < v1)
        for (int r = vr0; r < D2; r += vdr)
          copy_chunk(vst + r * kTile + vc, vsrc + static_cast<size_t>(r) * S + vc, vchunk);
      // scale words of slot base + tid: ks plane 0, ks plane 1, vs plane 0, vs plane 1
      if (base + tid >= s0 && base + tid < s1) {
        uint32_t* words = reinterpret_cast<uint32_t*>(st + 2 * kTile * D2) + tid;
        const size_t si = scale_head + static_cast<size_t>(base + tid) * 2 * H;
        copy_scale_word(words, k_scale + si);
        copy_scale_word(words + kTile, k_scale + si + H);
        copy_scale_word(words + 2 * kTile, v_scale + si);
        copy_scale_word(words + 3 * kTile, v_scale + si + H);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // score lanes: slot tid / kLps of each pass, K bytes [16 part, 16 part + 16) of its row
  const int part4 = tid % kLps;
  float qlo[16], qhi[16];
  const TQ* qrow = q + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    qlo[j] = bf16_round(to_f32<TQ>(qrow[16 * part4 + j]) * sm_scale);
    qhi[j] = bf16_round(to_f32<TQ>(qrow[D2 + 16 * part4 + j]) * sm_scale);
  }
  // value lanes: word `lane` (slots 4 lane .. 4 lane + 3) of rows kRows warp .. + kRows - 1
  float acc_lo[kRows], acc_hi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_lo[r] = acc_hi[r] = 0.f;
  float m = kMFloor2;
  float l = 0.f;  // this thread's slots' share of the sum

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1 (stage, sc, g)
    issue(t + kStages - 1);
    const int base = (share.begin + t) * kTile;
    const int j0 = max(base, lo) - base;
    const int j1 = min(base + kTile, hi) - base;
    const unsigned char* st = ring + (t % kStages) * kSBytes;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(st + 2 * kTile * D2);

#pragma unroll
    for (int pass = 0; pass < kLps; ++pass) {
      const int slot = pass * kSlotsPerPass + tid / kLps;
      const bool valid = slot >= j0 && slot < j1;
      float dot_lo = 0.f, dot_hi = 0.f;
      if (valid) {
        const uint4 raw = *reinterpret_cast<const uint4*>(st + slot * D2 + 16 * part4);
        const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
          float lo4[4], hi4[4];
          nibbles(w4[wi], lo4, hi4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dot_lo = fmaf(qlo[wi * 4 + i], lo4[i], dot_lo);
            dot_hi = fmaf(qhi[wi * 4 + i], hi4[i], dot_hi);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < kLps; off <<= 1) {
        dot_lo += __shfl_xor_sync(0xffffffffu, dot_lo, off);
        dot_hi += __shfl_xor_sync(0xffffffffu, dot_hi, off);
      }
      if (part4 == 0) {
        float s = -INFINITY;
        if (valid) {
          const __nv_bfloat16* ks = k_scale + scale_head + static_cast<size_t>(base + slot) * 2 * H;
          s = __fadd_rn(__fmul_rn(dot_lo, scale_pick(words[slot], ks)),
                        __fmul_rn(dot_hi, scale_pick(words[kTile + slot], ks + H))) * kLog2e;
        }
        sc[slot] = s;
      }
    }
    __syncthreads();

    // the tile's max (every warp the same), then e and the bf16 weights of slot tid
    float tile_max = fmaxf(fmaxf(sc[lane], sc[lane + 32]), fmaxf(sc[lane + 64], sc[lane + 96]));
    const float m_new = fmaxf(m, warp_max(tile_max));
    const float alpha = exp2f(m - m_new);
    const float e = exp2f(sc[tid] - m_new);  // 0 outside the window
    l = l * alpha + e;
    m = m_new;
    float g_lo = 0.f, g_hi = 0.f;
    if (tid >= j0 && tid < j1) {
      const __nv_bfloat16* vs = v_scale + scale_head + static_cast<size_t>(base + tid) * 2 * H;
      g_lo = bf16_round(e * scale_pick(words[2 * kTile + tid], vs));
      g_hi = bf16_round(e * scale_pick(words[3 * kTile + tid], vs + H));
    }
    g[0][tid] = g_lo;
    g[1][tid] = g_hi;
    __syncthreads();

    // values: slots outside the window weigh 0 (their bytes are finite ints)
    const float4 gl = *reinterpret_cast<const float4*>(&g[0][4 * lane]);
    const float4 gh = *reinterpret_cast<const float4*>(&g[1][4 * lane]);
    const unsigned char* vrows = st + kTile * D2 + (kRows * warp) * kTile + 4 * lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float lo4[4], hi4[4];
      nibbles(*reinterpret_cast<const uint32_t*>(vrows + r * kTile), lo4, hi4);
      float a = acc_lo[r] * alpha, z = acc_hi[r] * alpha;
      a = fmaf(gl.x, lo4[0], a);
      z = fmaf(gh.x, hi4[0], z);
      a = fmaf(gl.y, lo4[1], a);
      z = fmaf(gh.y, hi4[1], z);
      a = fmaf(gl.z, lo4[2], a);
      z = fmaf(gh.z, hi4[2], z);
      a = fmaf(gl.w, lo4[3], a);
      z = fmaf(gh.w, hi4[3], z);
      acc_lo[r] = a;
      acc_hi[r] = z;
    }
  }

  // the block's partial: each row's words summed over the warp's lanes, l over the block;
  // then the cluster's combine
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float a = warp_sum(acc_lo[r]);
    const float z = warp_sum(acc_hi[r]);
    if (lane == 0) {
      part[2 + kRows * warp + r] = a;
      part[2 + D2 + kRows * warp + r] = z;
    }
  }
  __syncthreads();
  if (tid == 0) {
    part[0] = m;
    part[1] = red[0] + red[1] + red[2] + red[3];
  }
  cluster_combine_store<TQ>(part, D, out + (static_cast<size_t>(b) * H + h) * D);
}

template <typename TQ, int D>
int launch(const void* q, const void* k4, const void* v4t, const void* ks, const void* vs,
           void* out, int B, int S, int H, int lo, int hi, cudaStream_t stream, int n_split) {
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return static_cast<int>(launch_cluster<int4_decode_kernel<TQ, D>>(
      n_split, H, B, static_cast<size_t>(kStages) * stage_bytes(D / 2), stream,
      static_cast<const TQ*>(q), static_cast<const int8_t*>(k4),
      static_cast<const int8_t*>(v4t), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<TQ*>(out), S, H, lo, hi, sm_scale));
}

template <typename TQ>
int dispatch(const void* q, const void* k4, const void* v4t, const void* ks, const void* vs,
             void* out, int B, int S, int H, int D, int lo, int hi, cudaStream_t stream,
             int n_split) {
  if (D == 32) return launch<TQ, 32>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, stream, n_split);
  if (D == 64) return launch<TQ, 64>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, stream, n_split);
  return launch<TQ, 128>(q, k4, v4t, ks, vs, out, B, S, H, lo, hi, stream, n_split);
}

}  // namespace

extern "C" int int4_decode_attention_launch(const void* q, const void* k4, const void* v4t,
                                            const void* k_scale, const void* v_scale, void* out,
                                            int B, int S, int H, int D, int lo, int hi,
                                            int q_dtype, void* stream, int n_split) {
  if ((D != 32 && D != 64 && D != 128) || lo < 0 || hi > S || lo >= hi || B <= 0 || H <= 0 ||
      n_split < 1 || n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch<float>(q, k4, v4t, k_scale, v_scale, out, B, S, H, D, lo, hi, st, n_split);
  if (q_dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, k4, v4t, k_scale, v_scale, out, B, S, H, D, lo, hi, st,
                                   n_split);
  return static_cast<int>(cudaErrorInvalidValue);
}
