// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel behind audiocraft_tpu/ops/attention.py::flash_causal_attention
// (jax.experimental.pallas.ops.tpu.flash_attention: a forward plus a custom-VJP backward made
// of a dK/dV kernel and a dQ kernel). For q, k, v [B, T, H, D] and each (b, h):
//
//     out = softmax(q k^T / sqrt(D) + causal mask) v        lse[b, h, t] = log sum_s exp(...)
//
// Scores, the softmax and every product's accumulator are f32; the output is written in q's
// dtype. The backward is three kernels: a pre-pass delta = rowsum(dO * O), a dK/dV kernel (one
// block per key tile, looping over the query tiles from the diagonal down) and a dQ kernel
// (one block per query tile, looping over the key tiles up to the diagonal). No T x T tensor
// is written to device memory, and no float atomics are used, so the backward is
// deterministic.
//
// What bounds it: tensor-core operations. At the training shape (B=16, T=1501, H=16, D=64,
// bf16) the forward does 4 * B * H * D * T(T+1)/2 = 74 GFLOP of products on 0.2 GB of inputs
// and outputs: about 370 operations per byte, above the H100's ~295 bf16 operations per byte
// of HBM, so the bound is 989 TFLOP/s (0.075 ms forward, 2.5 times that backward).
//
// The design, simple first:
//   * bf16 (the training dtype): mma.sync m16n8k16 on the tensor cores with f32 accumulators
//     held in registers. A block of 4 warps owns a 64-row tile (queries, or keys in the dK/dV
//     kernel); each warp owns 16 of its rows. Scores S (or S^T), the probabilities, dP and
//     dS never leave registers: an accumulator tile is repacked in registers as the A operand
//     of the next product (P V, P^T dO, dS^T Q, dS K). Only the 64-row tiles of q, k, v and
//     dO go through shared memory; the streamed ones are double-buffered, the next tile
//     copied by cp.async while the current one is used, and operand fragments are read with
//     ldmatrix; the softmax runs in base 2 (exp2 of prescaled scores);
//   * f32 (the checking dtype): a plain FMA loop over 32-row tiles in shared memory;
//   * q, k, v are read through their strides, so the chunks of a fused qkv projection (row
//     stride 3E) are read in place; rows are loaded with 16-byte vector loads;
//   * the ragged last tile is masked, not padded: rows past T load as zeros and are never
//     stored, and the backward gives them P = 0; tiles above the diagonal are never visited;
//   * the tiles with the most work start first (causal load balance).
// wgmma, TMA and warp-specialised producers are later work.
//
// C interface (bound with ctypes): flash_causal_fwd_launch(...) and flash_causal_bwd_launch(...)
// return cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum DType { kF32 = 0, kBF16 = 1 };

struct Strides {
  long long b, t, h;
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Rows [t0, t0 + R) of one (b, h) slice (src points at t = 0, rows `st` elements apart) into
// shared memory dst [R][ld]; rows at or past T load as zeros. NT threads share the work.
template <typename T, int R, int D, int NT>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long st, int t0,
                                          int T_len) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int idx = threadIdx.x; idx < R * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * VEC;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_len) val = *reinterpret_cast<const uint4*>(src + t * st + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// dst[r] = src[t0 + r] for rows inside T, else 0.
template <int R, int NT>
__device__ __forceinline__ void load_vector(float* dst, const float* src, int t0, int T_len) {
  for (int r = threadIdx.x; r < R; r += NT) dst[r] = t0 + r < T_len ? src[t0 + r] : 0.f;
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in f32; dO and O contiguous
// [B, T, H, D]. One warp per (b, t, h) row, 8 rows per block.
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ dout, const T* __restrict__ out, float* __restrict__ delta,
             int H, int T_len, int D, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = dout + row * D;
  const T* o = out + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f32<T>(a[d]) * to_f32<T>(o[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const long long h = row % H;
    const long long t = (row / H) % T_len;
    const long long b = row / (static_cast<long long>(H) * T_len);
    delta[(b * H + h) * T_len + t] = s;
  }
}

// =============================================================================== bf16 path
//
// Fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulate), for lane = 4 * g + c:
//   A 16x16 row-major, 4 x 32 bits: (g, 2c..2c+1), (g+8, 2c..), (g, 8+2c..), (g+8, 8+2c..)
//   B 16x8 (k x n), 2 x 32 bits:   (k = 2c..2c+1, n = g), (k = 8+2c..8+2c+1, n = g)
//   C 16x8 f32, 4 floats:          (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)
// A 16 x 64 accumulator tile is 8 C fragments ("n-tiles"); n-tiles 2k and 2k+1 repacked to
// bf16 are exactly the A fragment of k-chunk k, so P, P^T and dS feed the next product
// straight from registers.

namespace mma_path {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BM = 64;         // rows of a tile (queries or keys); 16 per warp
constexpr int NT = BM / 8;     // n-tiles of a 16 x BM score tile
constexpr int PAD = 8;         // shared-memory row padding in bf16 elements
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane (lanes 8m..8m+7 give
// the rows of matrix m); lane 4g+c receives (row g, columns 2c, 2c+1) of matrix m in r[m],
// or with `.trans` (row 2c and 2c+1, column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Asynchronous global -> shared copies (cp.async): 16 bytes, or 4, zero-filled where `valid`
// is false; a commit closes a group, and a wait lets at most N groups stay in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start copying rows [t0, t0 + BM) of one (b, h) slice into dst [BM][ld]; rows at or past T
// are zero-filled.
template <int D>
__device__ __forceinline__ void copy_rows_async(bf16* dst, int ld, const bf16* src,
                                                long long st, int t0, int T_len) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < BM * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 8;
    const bool valid = t0 + r < T_len;
    cp_async16(dst + r * ld + c, valid ? src + (t0 + r) * st + c : src, valid);
  }
}

// A fragment of rows r0.., columns c0.. of a row-major bf16 tile: matrices (r0, c0),
// (r0 + 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int r0,
                                       int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, s + (r0 + lane % 8 + (lane / 8 % 2) * 8) * ld + c0 + lane / 16 * 8);
}

// B fragments of n-tiles n0 and n0 + 8 whose transpose is stored:
// B(k, n) = s[(n0 + n) * ld + k0 + k] (e.g. K^T from the rows of K).
__device__ __forceinline__ void load_bt2(uint32_t (&b)[2][2], const bf16* s, int ld, int n0,
                                         int k0) {
  const int lane = threadIdx.x % 32;
  uint32_t r[4];
  ldmatrix_x4(r, s + (n0 + lane % 8 + lane / 16 * 8) * ld + k0 + (lane / 8 % 2) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// B fragments of n-tiles n0 and n0 + 8 stored row-major: B(k, n) = s[(k0 + k) * ld + n0 + n]
// (e.g. V from its rows).
__device__ __forceinline__ void load_b2(uint32_t (&b)[2][2], const bf16* s, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x % 32;
  uint32_t r[4];
  ldmatrix_x4_trans(r, s + (k0 + lane % 8 + (lane / 8 % 2) * 8) * ld + n0 + lane / 16 * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// The A fragment of k-chunk kc of a 16 x BM accumulator tile, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&t)[NT][4], int kc) {
  a[0] = pack(t[2 * kc][0], t[2 * kc][1]);
  a[1] = pack(t[2 * kc][2], t[2 * kc][3]);
  a[2] = pack(t[2 * kc + 1][0], t[2 * kc + 1][1]);
  a[3] = pack(t[2 * kc + 1][2], t[2 * kc + 1][3]);
}

// acc[16 x BM] = A[rows r0.. of sa, D wide] . B^T where B's rows are the BM rows of sb.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[NT][4], const bf16* sa, int r0,
                                       const bf16* sb, int ld) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    load_a(a, sa, ld, r0, kc * 16);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[2][2];
      load_bt2(b, sb, ld, n * 8, kc * 16);
      mma(acc[n], a, b[0]);
      mma(acc[n + 1], a, b[1]);
    }
  }
}

// out[16 x D] += P[16 x BM] (registers) . S[BM x D] (rows of sb).
template <int D>
__device__ __forceinline__ void accumulate(float (&out)[D / 8][4], const float (&p)[NT][4],
                                           const bf16* sb, int ld) {
#pragma unroll
  for (int kc = 0; kc < BM / 16; ++kc) {
    uint32_t a[4];
    acc_to_a(a, p, kc);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[2][2];
      load_b2(b, sb, ld, kc * 16, n * 8);
      mma(out[n], a, b[0]);
      mma(out[n + 1], a, b[1]);
    }
  }
}

// Rows g and g+8 of a warp's 16 x D accumulator, times mul (divided by div[0|1]), into rows
// t_row.. of one (b, h) slice; rows at or past T are not stored.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, long long st, const float (&acc)[D / 8][4],
                                          int t_row, int T_len, float mul, const float (&div)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t_row + lane / 4 + 8 * half;
    if (t >= T_len) continue;
    const float f = mul / div[half];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + t * st + n * 8 + 2 * (lane % 4)) =
          pack(acc[n][2 * half] * f, acc[n][2 * half + 1] * f);
  }
}

template <int D> struct Smem {
  static constexpr int LD = D + PAD;
  static constexpr int kTile = align128(BM * LD * 2);
};

// Grid (query tiles, B * H). Each warp owns 16 query rows and walks the key tiles 0..i with
// an online softmax; S, P and O stay in registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ out, float* __restrict__ lse, int H, int T_len, Strides sq,
           Strides sk, Strides sv, Strides so, float scale) {
  constexpr int LD = Smem<D>::LD;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  // two buffers each of K and V, kTile bytes apart: tile j + 1 is copied while tile j is used
  bf16* sK = reinterpret_cast<bf16*>(smem + kTile);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * kTile);

  const int i = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = i * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const int tq[2] = {t0 + r0 + lane / 4, t0 + r0 + lane / 4 + 8};
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_rows<bf16, BM, D, kThreads>(sQ, LD, q + b * sq.b + h * sq.h, sq.t, t0, T_len);
  const float scale2 = scale * kLog2e;  // scores in base 2: exp(x) = exp2(x * log2 e)
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  constexpr int kBuf = kTile / 2;  // elements from one buffer to the other
  copy_rows_async<D>(sK, LD, kb, sk.t, 0, T_len);
  copy_rows_async<D>(sV, LD, vb, sv.t, 0, T_len);
  cp_async_commit();
  for (int j = 0; j <= i; ++j) {
    const int cur = (j % 2) * kBuf;
    const int next = kBuf - cur;
    if (j < i) {  // the other buffers were released by the barrier ending tile j - 1
      copy_rows_async<D>(sK + next, LD, kb, sk.t, (j + 1) * BM, T_len);
      copy_rows_async<D>(sV + next, LD, vb, sv.t, (j + 1) * BM, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every warp
    float s[NT][4];
    scores<D>(s, sQ, r0, sK + cur, LD);
    // scale (to base 2), causal mask (a key is allowed iff it is not after the query), row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tk = j * BM + n * 8 + 2 * (lane % 4) + (e & 1);
        const float x = (j < i || tk <= tq[e / 2]) ? s[n][e] * scale2 : -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: key 0 is allowed for every row
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e / 2]);
        s[n][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];
    accumulate<D>(o, s, sV + cur, LD);
    __syncthreads();  // every warp is done with buffers `cur`
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_acc<D>(out + b * so.b + h * so.h, so.t, o, t0 + r0, T_len, 1.0f, l);
  if (lane % 4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (tq[r] < T_len)
        lse[static_cast<long long>(bh) * T_len + tq[r]] = (m[r] + log2f(l[r])) * kLn2;
}

// Grid (key tiles, B * H). Each warp owns 16 keys, keeps their dK and dV rows in registers,
// and walks the query tiles j..last computing S^T = K Q^T, P^T, dP^T = V dO^T and dS^T.
// Capped at 170 registers so that 3 blocks share an SM (left alone, the compiler takes 184
// and fits 2; measured 14 % faster with 3 on an H100 at B=16, T=1500, H=16, D=64, at the
// price of a few spilled bytes).
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
            int T_len, Strides sq, Strides sk, Strides sv, Strides sd, float scale) {
  constexpr int LD = Smem<D>::LD;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + kTile);
  // two buffers each of Q and dO (kTile bytes apart) and of lse and delta (BM floats apart):
  // tile i + 1 is copied while tile i is used
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * kTile);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 4 * kTile);
  float* sLse = reinterpret_cast<float*>(smem + 6 * kTile);
  float* sDelta = sLse + 2 * BM;
  constexpr int kBuf = kTile / 2;

  const int j = blockIdx.x;  // key tile; the first ones see the most query tiles
  const int n_tiles = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tk0 = j * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int tk[2] = {tk0 + r0 + lane / 4, tk0 + r0 + lane / 4 + 8};
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;
  const float* lse_b = lse + static_cast<long long>(bh) * T_len;
  const float* delta_b = delta + static_cast<long long>(bh) * T_len;

  load_rows<bf16, BM, D, kThreads>(sK, LD, k + b * sk.b + h * sk.h, sk.t, tk0, T_len);
  load_rows<bf16, BM, D, kThreads>(sV, LD, v + b * sv.b + h * sv.h, sv.t, tk0, T_len);
  float dk_acc[D / 8][4] = {};
  float dv_acc[D / 8][4] = {};
  // start copying query tile i into buffers `buf`
  auto copy_tile = [&](int i, int buf) {
    copy_rows_async<D>(sQ + buf * kBuf, LD, qb, sq.t, i * BM, T_len);
    copy_rows_async<D>(sDO + buf * kBuf, LD, db, sd.t, i * BM, T_len);
    const int r = threadIdx.x % BM;
    const bool valid = i * BM + r < T_len;
    const float* src = threadIdx.x < BM ? lse_b : delta_b;
    float* dst = (threadIdx.x < BM ? sLse : sDelta) + buf * BM;
    cp_async4(dst + r, valid ? src + i * BM + r : src, valid);
    cp_async_commit();
  };

  copy_tile(j, 0);
  for (int i = j; i < n_tiles; ++i) {
    const int tq0 = i * BM;
    const int cur = (i - j) % 2;
    if (i + 1 < n_tiles) {  // the other buffers were released by the barrier ending tile i - 1
      copy_tile(i + 1, 1 - cur);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i has landed for every warp
    const float* lse_t = sLse + cur * BM;
    const float* delta_t = sDelta + cur * BM;
    const bf16* q_t = sQ + cur * kBuf;
    const bf16* do_t = sDO + cur * kBuf;
    float p[NT][4];   // S^T, then P^T
    float ds[NT][4];  // dP^T, then dS^T
    scores<D>(p, sK, r0, q_t, LD);
    scores<D>(ds, sV, r0, do_t, LD);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane % 4) + (e & 1);  // query column in the tile
        const int tq = tq0 + c;
        const bool allowed = tk[e / 2] <= tq && tq < T_len;
        const float pe = allowed ? exp2f((p[n][e] * scale - lse_t[c]) * kLog2e) : 0.f;
        p[n][e] = pe;
        ds[n][e] = pe * (ds[n][e] - delta_t[c]);
      }
    accumulate<D>(dv_acc, p, do_t, LD);  // dV += P^T dO
    accumulate<D>(dk_acc, ds, q_t, LD);  // dK += dS^T Q
    __syncthreads();  // every warp is done with buffers `cur`
  }
  const float one[2] = {1.f, 1.f};
  store_acc<D>(dk + b * sd.b + h * sd.h, sd.t, dk_acc, tk0 + r0, T_len, scale, one);
  store_acc<D>(dv + b * sd.b + h * sd.h, sd.t, dv_acc, tk0 + r0, T_len, 1.f, one);
}

// Grid (query tiles, B * H). Each warp owns 16 queries, keeps their dQ rows in registers, and
// walks the key tiles 0..i.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, int H, int T_len, Strides sq,
          Strides sk, Strides sv, Strides sd, float scale) {
  constexpr int LD = Smem<D>::LD;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + kTile);
  // two buffers each of K and V, kTile bytes apart: tile j + 1 is copied while tile j is used
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * kTile);
  bf16* sV = reinterpret_cast<bf16*>(smem + 4 * kTile);
  constexpr int kBuf = kTile / 2;

  const int i = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tq0 = i * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int tq[2] = {tq0 + r0 + lane / 4, tq0 + r0 + lane / 4 + 8};
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_rows<bf16, BM, D, kThreads>(sQ, LD, q + b * sq.b + h * sq.h, sq.t, tq0, T_len);
  load_rows<bf16, BM, D, kThreads>(sDO, LD, dout + b * sd.b + h * sd.h, sd.t, tq0, T_len);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = tq[r] < T_len;
    row_lse[r] = in ? lse[static_cast<long long>(bh) * T_len + tq[r]] : 0.f;
    row_delta[r] = in ? delta[static_cast<long long>(bh) * T_len + tq[r]] : 0.f;
  }
  float dq_acc[D / 8][4] = {};

  copy_rows_async<D>(sK, LD, kb, sk.t, 0, T_len);
  copy_rows_async<D>(sV, LD, vb, sv.t, 0, T_len);
  cp_async_commit();
  for (int j = 0; j <= i; ++j) {
    const int tk0 = j * BM;
    const int cur = (j % 2) * kBuf;
    const int next = kBuf - cur;
    if (j < i) {  // the other buffers were released by the barrier ending tile j - 1
      copy_rows_async<D>(sK + next, LD, kb, sk.t, tk0 + BM, T_len);
      copy_rows_async<D>(sV + next, LD, vb, sv.t, tk0 + BM, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every warp
    float s[NT][4];   // S, then dS
    float dp[NT][4];  // dP
    scores<D>(s, sQ, r0, sK + cur, LD);
    scores<D>(dp, sDO, r0, sV + cur, LD);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tkey = tk0 + n * 8 + 2 * (lane % 4) + (e & 1);
        const int r = e / 2;
        const bool allowed = tkey <= tq[r] && tq[r] < T_len;
        const float pe = allowed ? exp2f((s[n][e] * scale - row_lse[r]) * kLog2e) : 0.f;
        s[n][e] = pe * (dp[n][e] - row_delta[r]);
      }
    accumulate<D>(dq_acc, s, sK + cur, LD);  // dQ += dS K
    __syncthreads();  // every warp is done with buffers `cur`
  }
  const float one[2] = {1.f, 1.f};
  store_acc<D>(dq + b * sd.b + h * sd.h, sd.t, dq_acc, tq0 + r0, T_len, scale, one);
}

}  // namespace mma_path

// ================================================================================ f32 path
//
// Everything in shared memory: products by a plain FMA loop, one output element per thread
// at a time; the softmax with one row per 8 threads.

namespace fma_path {

constexpr int kThreads = 256;
constexpr int BM = 32;   // rows of a tile
constexpr int PAD = 4;   // shared-memory row padding in floats

// Operand layouts: element (r, c) of a row-major operand is at r * ld + c, of a column-major
// one at r + c * ld.
struct RowMajor {
  static __device__ __forceinline__ int at(int r, int c, int ld) { return r * ld + c; }
};
struct ColMajor {
  static __device__ __forceinline__ int at(int r, int c, int ld) { return r + c * ld; }
};

// C[M][N] (row-major, ldc) = (or +=) A[M][K] . B[K][N], everything in shared memory.
template <typename AL, typename BL, int M, int N, int K>
__device__ __forceinline__ void gemm(float* c, int ldc, const float* a, int lda, const float* b,
                                     int ldb, bool accumulate) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N;
    const int n = e % N;
    float s = accumulate ? c[m * ldc + n] : 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk) s = fmaf(a[AL::at(m, kk, lda)], b[BL::at(kk, n, ldb)], s);
    c[m * ldc + n] = s;
  }
}

// Shared rows [R][ld] times `mul` (divided by row_div[r] if given) into rows [t0, t0 + R) of
// one (b, h) slice of a [B, T, H, D] output; rows at or past T are not stored.
template <int R, int D>
__device__ __forceinline__ void store_rows(float* dst, long long st, const float* src, int ld,
                                           int t0, int T_len, float mul, const float* row_div) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int t = t0 + r;
    if (t >= T_len) continue;
    float x = src[r * ld + c] * mul;
    if (row_div != nullptr) x = x / row_div[r];
    dst[t * st + c] = x;
  }
}

template <int D> struct Smem {
  static constexpr int LDT = D + PAD;   // q, k, v, dO tiles [BM][LDT]
  static constexpr int LDF = BM + PAD;  // scores, probabilities, dP, dS [BM][LDF]
  static constexpr int kTile = align128(BM * LDT * 4);
  static constexpr int kScore = align128(BM * LDF * 4);
  static constexpr int kRow = align128(BM * 4);
  // forward: q, k, v, S, P, O, m, l
  static constexpr int kFwdBytes = 4 * kTile + 2 * kScore + 2 * kRow;
  // dK/dV: q, dO, k, v, S, dP, P, dS, lse, delta, dK, dV;  dQ: the same without dV
  static constexpr int kDkdvBytes = 6 * kTile + 4 * kScore + 2 * kRow;
  static constexpr int kDqBytes = 5 * kTile + 4 * kScore + 2 * kRow;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse, int H,
           int T_len, Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  using L = Smem<D>;
  constexpr int TPR = kThreads / BM;  // threads per row in the softmax
  constexpr int CPT = BM / TPR;       // score columns per thread
  constexpr int OPT = D / TPR;        // output columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + L::kTile);
  float* sV = reinterpret_cast<float*>(smem + 2 * L::kTile);
  float* sO = reinterpret_cast<float*>(smem + 3 * L::kTile);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::kTile);
  float* sP = reinterpret_cast<float*>(smem + 4 * L::kTile + L::kScore);
  float* sM = reinterpret_cast<float*>(smem + 4 * L::kTile + 2 * L::kScore);
  float* sL = reinterpret_cast<float*>(smem + 4 * L::kTile + 2 * L::kScore + L::kRow);

  const int i = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = i * BM;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_rows<float, BM, D, kThreads>(sQ, L::LDT, q + b * sq.b + h * sq.h, sq.t, t0, T_len);
  for (int e = threadIdx.x; e < BM * D; e += kThreads) sO[(e / D) * L::LDT + e % D] = 0.f;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;

  for (int j = 0; j <= i; ++j) {
    __syncthreads();  // the previous tile's products are done with sK, sV, sP
    load_rows<float, BM, D, kThreads>(sK, L::LDT, kb, sk.t, j * BM, T_len);
    load_rows<float, BM, D, kThreads>(sV, L::LDT, vb, sv.t, j * BM, T_len);
    __syncthreads();
    gemm<RowMajor, ColMajor, BM, BM, D>(sS, L::LDF, sQ, L::LDT, sK, L::LDT, false);
    __syncthreads();
    // Online softmax of row `row`, TPR neighbouring lanes per row. A key is allowed iff it
    // is not after the query (rows past T see only finite scores and are never stored).
    {
      const int tq = t0 + row;
      float* srow = sS + row * L::LDF + part * CPT;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int tk = j * BM + part * CPT + c;
        const float s = tk <= tq ? srow[c] * scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);  // finite: key 0 is allowed for every row
      const float corr = expf(m_old - m_new);
      float* prow = sP + row * L::LDF + part * CPT;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(srow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      float* orow = sO + row * L::LDT + part * OPT;
#pragma unroll
      for (int c = 0; c < OPT; ++c) orow[c] *= corr;
      if (part == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * corr + sum;
      }
    }
    __syncthreads();
    gemm<RowMajor, RowMajor, BM, D, BM>(sO, L::LDT, sP, L::LDF, sV, L::LDT, true);
  }
  __syncthreads();
  store_rows<BM, D>(out + b * so.b + h * so.h, so.t, sO, L::LDT, t0, T_len, 1.0f, sL);
  for (int r = threadIdx.x; r < BM; r += kThreads)
    if (t0 + r < T_len) lse[static_cast<long long>(bh) * T_len + t0 + r] = sM[r] + logf(sL[r]);
}

// P = exp(S * scale - lse) where the key is allowed and the query lies inside T, else 0;
// dS = P * (dP - delta). Query tile at tq0, key tile at tk0.
template <int D>
__device__ __forceinline__ void probs_and_dscores(const float* sS, const float* sDP,
                                                  const float* sLse, const float* sDelta,
                                                  float* sP, float* sDS, int tq0, int tk0,
                                                  int T_len, float scale) {
  constexpr int LDF = Smem<D>::LDF;
  for (int e = threadIdx.x; e < BM * BM; e += kThreads) {
    const int r = e / BM;
    const int c = e % BM;
    const int tq = tq0 + r;
    const bool allowed = tk0 + c <= tq && tq < T_len;
    const float p = allowed ? expf(sS[r * LDF + c] * scale - sLse[r]) : 0.f;
    sP[r * LDF + c] = p;
    sDS[r * LDF + c] = p * (sDP[r * LDF + c] - sDelta[r]);
  }
}

// Grid (key tiles, B * H): dK and dV of BM keys, walking the query tiles j..last.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int H, int T_len, Strides sq,
            Strides sk, Strides sv, Strides sd, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = reinterpret_cast<float*>(smem + L::kTile);
  float* sK = reinterpret_cast<float*>(smem + 2 * L::kTile);
  float* sV = reinterpret_cast<float*>(smem + 3 * L::kTile);
  float* sDK = reinterpret_cast<float*>(smem + 4 * L::kTile);
  float* sDV = reinterpret_cast<float*>(smem + 5 * L::kTile);
  float* sS = reinterpret_cast<float*>(smem + 6 * L::kTile);
  float* sDP = sS + L::kScore / 4;
  float* sP = sDP + L::kScore / 4;
  float* sDS = sP + L::kScore / 4;
  float* sLse = sDS + L::kScore / 4;
  float* sDelta = sLse + L::kRow / 4;

  const int j = blockIdx.x;  // key tile; the first ones see the most query tiles
  const int n_tiles = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tk0 = j * BM;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* db = dout + b * sd.b + h * sd.h;
  const float* lse_b = lse + static_cast<long long>(bh) * T_len;
  const float* delta_b = delta + static_cast<long long>(bh) * T_len;

  load_rows<float, BM, D, kThreads>(sK, L::LDT, k + b * sk.b + h * sk.h, sk.t, tk0, T_len);
  load_rows<float, BM, D, kThreads>(sV, L::LDT, v + b * sv.b + h * sv.h, sv.t, tk0, T_len);
  for (int e = threadIdx.x; e < BM * D; e += kThreads) {
    sDK[(e / D) * L::LDT + e % D] = 0.f;
    sDV[(e / D) * L::LDT + e % D] = 0.f;
  }
  for (int i = j; i < n_tiles; ++i) {
    const int tq0 = i * BM;
    __syncthreads();  // the previous tile's products are done with sQ, sDO, sP, sDS
    load_rows<float, BM, D, kThreads>(sQ, L::LDT, qb, sq.t, tq0, T_len);
    load_rows<float, BM, D, kThreads>(sDO, L::LDT, db, sd.t, tq0, T_len);
    load_vector<BM, kThreads>(sLse, lse_b, tq0, T_len);
    load_vector<BM, kThreads>(sDelta, delta_b, tq0, T_len);
    __syncthreads();
    gemm<RowMajor, ColMajor, BM, BM, D>(sS, L::LDF, sQ, L::LDT, sK, L::LDT, false);    // Q K^T
    gemm<RowMajor, ColMajor, BM, BM, D>(sDP, L::LDF, sDO, L::LDT, sV, L::LDT, false);  // dO V^T
    __syncthreads();
    probs_and_dscores<D>(sS, sDP, sLse, sDelta, sP, sDS, tq0, tk0, T_len, scale);
    __syncthreads();
    gemm<ColMajor, RowMajor, BM, D, BM>(sDV, L::LDT, sP, L::LDF, sDO, L::LDT, true);  // P^T dO
    gemm<ColMajor, RowMajor, BM, D, BM>(sDK, L::LDT, sDS, L::LDF, sQ, L::LDT, true);  // dS^T Q
  }
  __syncthreads();
  store_rows<BM, D>(dk + b * sd.b + h * sd.h, sd.t, sDK, L::LDT, tk0, T_len, scale, nullptr);
  store_rows<BM, D>(dv + b * sd.b + h * sd.h, sd.t, sDV, L::LDT, tk0, T_len, 1.0f, nullptr);
}

// Grid (query tiles, B * H): dQ of BM queries, walking the key tiles 0..i.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int H, int T_len,
          Strides sq, Strides sk, Strides sv, Strides sd, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = reinterpret_cast<float*>(smem + L::kTile);
  float* sK = reinterpret_cast<float*>(smem + 2 * L::kTile);
  float* sV = reinterpret_cast<float*>(smem + 3 * L::kTile);
  float* sDQ = reinterpret_cast<float*>(smem + 4 * L::kTile);
  float* sS = reinterpret_cast<float*>(smem + 5 * L::kTile);
  float* sDP = sS + L::kScore / 4;
  float* sP = sDP + L::kScore / 4;
  float* sDS = sP + L::kScore / 4;
  float* sLse = sDS + L::kScore / 4;
  float* sDelta = sLse + L::kRow / 4;

  const int i = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tq0 = i * BM;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_rows<float, BM, D, kThreads>(sQ, L::LDT, q + b * sq.b + h * sq.h, sq.t, tq0, T_len);
  load_rows<float, BM, D, kThreads>(sDO, L::LDT, dout + b * sd.b + h * sd.h, sd.t, tq0, T_len);
  load_vector<BM, kThreads>(sLse, lse + static_cast<long long>(bh) * T_len, tq0, T_len);
  load_vector<BM, kThreads>(sDelta, delta + static_cast<long long>(bh) * T_len, tq0, T_len);
  for (int e = threadIdx.x; e < BM * D; e += kThreads) sDQ[(e / D) * L::LDT + e % D] = 0.f;
  for (int j = 0; j <= i; ++j) {
    const int tk0 = j * BM;
    __syncthreads();  // the previous tile's product is done with sK, sDS
    load_rows<float, BM, D, kThreads>(sK, L::LDT, kb, sk.t, tk0, T_len);
    load_rows<float, BM, D, kThreads>(sV, L::LDT, vb, sv.t, tk0, T_len);
    __syncthreads();
    gemm<RowMajor, ColMajor, BM, BM, D>(sS, L::LDF, sQ, L::LDT, sK, L::LDT, false);    // Q K^T
    gemm<RowMajor, ColMajor, BM, BM, D>(sDP, L::LDF, sDO, L::LDT, sV, L::LDT, false);  // dO V^T
    __syncthreads();
    probs_and_dscores<D>(sS, sDP, sLse, sDelta, sP, sDS, tq0, tk0, T_len, scale);
    __syncthreads();
    gemm<RowMajor, RowMajor, BM, D, BM>(sDQ, L::LDT, sDS, L::LDF, sK, L::LDT, true);  // dS K
  }
  __syncthreads();
  store_rows<BM, D>(dq + b * sd.b + h * sd.h, sd.t, sDQ, L::LDT, tq0, T_len, scale, nullptr);
}

}  // namespace fma_path

// --------------------------------------------------------------------------------- launch

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

Strides strides_at(const long long* s, int which) {
  return {s[3 * which], s[3 * which + 1], s[3 * which + 2]};
}

// Shared-memory bytes and threads of each kernel of a dtype.
template <typename T, int D> struct Plan;
template <int D> struct Plan<bf16, D> {
  static constexpr int BM = mma_path::BM;
  static constexpr int kThreads = mma_path::kThreads;
  static constexpr int kFwd = 5 * mma_path::Smem<D>::kTile;   // q, 2 x (k, v)
  // k, v, 2 x (q, dO), 2 x (lse, delta)
  static constexpr int kDkdv = 6 * mma_path::Smem<D>::kTile + align128(4 * BM * 4);
  static constexpr int kDq = 6 * mma_path::Smem<D>::kTile;    // q, dO, 2 x (k, v)
  static constexpr auto fwd = mma_path::fwd_kernel<D>;
  static constexpr auto dkdv = mma_path::dkdv_kernel<D>;
  static constexpr auto dq = mma_path::dq_kernel<D>;
};
template <int D> struct Plan<float, D> {
  static constexpr int BM = fma_path::BM;
  static constexpr int kThreads = fma_path::kThreads;
  static constexpr int kFwd = fma_path::Smem<D>::kFwdBytes;
  static constexpr int kDkdv = fma_path::Smem<D>::kDkdvBytes;
  static constexpr int kDq = fma_path::Smem<D>::kDqBytes;
  static constexpr auto fwd = fma_path::fwd_kernel<D>;
  static constexpr auto dkdv = fma_path::dkdv_kernel<D>;
  static constexpr auto dq = fma_path::dq_kernel<D>;
};

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
        int T_len, const long long* s, cudaStream_t stream) {
  using P = Plan<T, D>;
  if (int err = set_smem(P::fwd, P::kFwd)) return err;
  const dim3 grid((T_len + P::BM - 1) / P::BM, B * H);
  P::fwd<<<grid, P::kThreads, P::kFwd, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), H, T_len, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int T_len,
        const long long* s, cudaStream_t stream) {
  using P = Plan<T, D>;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const long long rows = static_cast<long long>(B) * T_len * H;
  delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out), static_cast<float*>(delta), H,
      T_len, D, rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (int err = set_smem(P::dkdv, P::kDkdv)) return err;
  if (int err = set_smem(P::dq, P::kDq)) return err;
  const dim3 grid((T_len + P::BM - 1) / P::BM, B * H);
  // strides: q, k, v, then dO, whose contiguous layout out, dq, dk and dv share
  P::dkdv<<<grid, P::kThreads, P::kDkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), H, T_len,
      strides_at(s, 0), strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  P::dq<<<grid, P::kThreads, P::kDq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, T_len, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64, (b, t, h) element strides of q, k, v, out.
extern "C" int flash_causal_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int T, int H, int D, int dtype,
                                       const long long* strides, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && D == 64) return fwd<bf16, 64>(q, k, v, out, lse, B, H, T, strides, st);
  if (dtype == kBF16 && D == 128) return fwd<bf16, 128>(q, k, v, out, lse, B, H, T, strides, st);
  if (dtype == kF32 && D == 64) return fwd<float, 64>(q, k, v, out, lse, B, H, T, strides, st);
  if (dtype == kF32 && D == 128) return fwd<float, 128>(q, k, v, out, lse, B, H, T, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: 12 int64, (b, t, h) element strides of q, k, v and dout; out, dq, dk and dv have
// dout's layout.
extern "C" int flash_causal_bwd_launch(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int T,
                                       int H, int D, int dtype, const long long* strides,
                                       void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FC_BWD_ARGS q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, T, strides, st
  if (dtype == kBF16 && D == 64) return bwd<bf16, 64>(FC_BWD_ARGS);
  if (dtype == kBF16 && D == 128) return bwd<bf16, 128>(FC_BWD_ARGS);
  if (dtype == kF32 && D == 64) return bwd<float, 64>(FC_BWD_ARGS);
  if (dtype == kF32 && D == 128) return bwd<float, 128>(FC_BWD_ARGS);
#undef FC_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
