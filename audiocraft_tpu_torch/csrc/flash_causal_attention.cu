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
// block per key tile, walking the query tiles from the diagonal down) and a dQ kernel (one
// block per query tile, walking the key tiles up to the diagonal). dQ has its own pass rather
// than float atomics, so the backward is deterministic: the same inputs give bit-identical
// dq, dk, dv. No T x T tensor is written to device memory.
//
// What bounds it: tensor-core operations. At the training shape (B=16, T=1501, H=16, D=64,
// bf16) the forward does 4 * B * H * D * T(T+1)/2 = 74 GFLOP of products on 0.2 GB of inputs
// and outputs: about 370 operations per byte, above the H100's ~295 bf16 operations per byte
// of HBM, so the bound is 989 TFLOP/s (0.075 ms forward, 2.5 times that backward; the
// separate dQ pass recomputes S and dP, 7 products where 5 would do).
//
// The design (bf16, the training dtype): every product is a wgmma.mma_async on tiles that TMA
// loads into shared memory, swizzled 128B, through a ring of stages with full/empty mbarriers.
// Warpgroup 0 of a block is the producer (one thread issues the TMA copies; setmaxnreg gives
// its registers to the others); the consumer warpgroups, three at D = 64 and two at D = 128,
// own 64 rows each (queries in the forward and dQ kernels, keys in the dK/dV kernel). Scores,
// probabilities, dP and dS stay in registers: an accumulator repacked to bf16 is the register
// A operand of the next product, and V, dO, Q and K enter the second products MN-major through
// the transpose bit, so nothing is transposed in memory. The forward issues S_j = Q K_j^T with
// O += P_{j-1} V_{j-1} and runs the softmax of S_j while P V finishes, and its consumers take
// turns on named barriers so that one's softmax overlaps the others' products. Rows past T
// arrive as zeros from TMA and are masked, never stored; tiles above the diagonal are never
// loaded; within each (b, h) the tiles with the most work start first, and the tiles of one
// (b, h) run side by side so that its K and V (or Q and dO) are read from HBM about once.
// The f32 path (the checking dtype) is a plain FMA loop over 32-row tiles in shared memory.
//
// Measured (scripts/torch_kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W, B 16, T 1500, H 16,
// D 64): forward 0.24 ms, backward 0.74 ms, against 0.41 / 1.59 ms for the mma.sync + cp.async
// design it replaced. That is 310 and 250 TFLOP/s by the bound's count, about 0.31 and 0.25
// of it. Neither the exp2 work, nor the P V product, nor the K/V loads held the two-consumer
// forward back: removing each in turn moved it by at most 3 %, while a third consumer
// warpgroup gained 11 %: the chain of dependent steps in each tile (wait for S, softmax, wait
// for P V) is the suspect. A persistent grid alone gained nothing measurable. In the
// full-width MusicGen-small train step (scripts/torch_profile_train.py, both designs in turns
// on one card) the K2 kernels took 24.3 ms of a step instead of 48.8, and the step 0.220 s
// instead of 0.245.
//
// Inputs are read through their strides (q, k, v as chunks of a fused [B, T, 3HD] projection):
// each TMA map is 4-D (D, T, H, B) with the caller's strides.
//
// C interface (bound with ctypes): flash_causal_fwd_launch(...) and flash_causal_bwd_launch(...)
// return cudaGetLastError() after their launches, or the error of a TMA map that could not be
// built.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
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
// [B, T, H, D]. Each thread reads 16 bytes of both; the D / VEC threads of a row sum by
// shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ dout, const T* __restrict__ out, float* __restrict__ delta,
             int H, int T_len, long long rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;  // threads per row: 8 to 32, so a row never straddles warps
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long row = idx / CPR;
  float s = 0.f;
  if (row < rows) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(dout + row * D) + idx % CPR);
    const uint4 o = __ldg(reinterpret_cast<const uint4*>(out + row * D) + idx % CPR);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* ov = reinterpret_cast<const T*>(&o);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += to_f32<T>(av[e]) * to_f32<T>(ov[e]);
  }
#pragma unroll
  for (int off = CPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && idx % CPR == 0) {
    const long long h = row % H;
    const long long t = (row / H) % T_len;
    const long long b = row / (static_cast<long long>(H) * T_len);
    delta[(b * H + h) * T_len + t] = s;
  }
}

// =============================================================================== bf16 path
//
// Shared-memory tiles are written by TMA in 128-byte rows (64 bf16 of the head dim; D = 128 is
// two such boxes side by side), swizzled 128B, every tile 1024-byte aligned: exactly the layout
// a wgmma descriptor of swizzle mode 128B reads. Used K-major (the head dim is the product's
// depth: Q K^T, dO V^T, K Q^T, V dO^T) a k-step of 16 moves the start address by 32 bytes
// inside the 128-byte row; used MN-major (rows are the depth: P V, P^T dO, dS^T Q, dS K) a
// k-step moves it by 16 rows, and the second 64-column box is the descriptor's leading offset.
//
// Accumulator of wgmma m64nN for thread t of a warpgroup (warp w = t / 32, lane = 4 g + c):
// element i is row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 c + i % 2. Elements
// 8 k .. 8 k + 7 packed to bf16 pairs are the register A fragment of k-chunk k of the next
// product, so P, P^T and dS^T never leave registers.

namespace wgmma_path {

constexpr int kRow = 128;                         // bytes of one swizzled row (64 bf16)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int align1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, cp.async, named barriers, register reallocation

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA traffic before the phase can complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// rows [t, t + box rows) x columns [d, d + 64) of head h of batch b; rows past T arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int t, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(t), "r"(h), "r"(b)
      : "memory");
}

// a [ROWS][D] tile as D / 64 boxes of [ROWS][64], ROWS * 128 bytes apart
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int t,
                                          int h, int b) {
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb) tma_load(dst + nb * ROWS * kRow, map, bar, nb * 64, t, h, b);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// named barriers 1, 2, ...: each joins two consumer warpgroups, one waiting and one arriving
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Warp roles, the same in the three kernels: warpgroup 0 produces (one thread or warp issues
// every copy), the others consume, 64 rows each. Three consumers at D = 64 (a third chain of
// dependent steps to interleave: 11 % faster forward, 8 % faster backward than two on an
// H100), two at D = 128, whose accumulators need the registers; setmaxnreg splits the 65536.
template <int D> struct Roles {
  static constexpr int kWG = D == 64 ? 3 : 2;
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kConsumerWarps = 4 * kWG;
  static constexpr int kProducerRegs = kWG == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 232;
};

// A block's mbarriers: one for the tiles loaded once, then a ring of S stages, each with a
// full barrier (the stage's copies have landed) and an empty one (lane 0 of every consumer
// warp is done with it). Iteration j uses stage j % S in phase j / S.
template <int S> struct Ring {
  static constexpr int kBytes = 8 * (1 + 2 * S);
  uint32_t at;
  __device__ __forceinline__ uint32_t once() const { return at; }
  __device__ __forceinline__ uint32_t full(int j) const { return at + 8 * (1 + j % S); }
  __device__ __forceinline__ uint32_t empty(int j) const { return at + 8 * (1 + S + j % S); }
  // by one thread, before the block's first __syncthreads
  __device__ __forceinline__ void init(uint32_t full_arrivals, uint32_t empty_arrivals) const {
    mbar_init(once(), 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), full_arrivals);
      mbar_init(empty(s), empty_arrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ __forceinline__ void wait_full(int j) const { mbar_wait(full(j), (j / S) & 1); }
  __device__ __forceinline__ void wait_empty(int j) const {
    mbar_wait(empty(j), ((j / S) & 1) ^ 1);
  }
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes at this point of the program.
template <int N> __device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, swizzle mode 128B: 8-row atoms 1024 bytes apart (stride
// offset); `lbo` bytes between 64-column boxes (leading offset, read for MN-major operands).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulators: ss() reads A and B from shared memory
// (both K-major) and overwrites d when scale_d is 0; rs() takes A from registers and B
// MN-major (the transpose bit), and accumulates.
template <int N> struct Wgmma;

#define FC_ACC8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FC_ACC16 FC_ACC8(0), FC_ACC8(8)
#define FC_ACC32 FC_ACC16, FC_ACC8(16), FC_ACC8(24)
#define FC_ACC64 FC_ACC32, FC_ACC8(32), FC_ACC8(40), FC_ACC8(48), FC_ACC8(56)

template <> struct Wgmma<32> {
  __device__ static __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : FC_ACC16
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : FC_ACC16
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  __device__ static __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FC_ACC32
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FC_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  __device__ static __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FC_ACC64
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FC_ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef FC_ACC8
#undef FC_ACC16
#undef FC_ACC32
#undef FC_ACC64

// acc[64 x N] = A . B^T: A's 64 rows at `a`, B's N rows at `b`, both [rows][D] K-major in
// D / 64 boxes (a_box, b_box bytes apart).
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 2], uint32_t a, uint32_t a_box, uint32_t b,
                                        uint32_t b_box) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = (k % 4) * 32;
    Wgmma<N>::ss(acc, desc(a + (k / 4) * a_box + off, 16), desc(b + (k / 4) * b_box + off, 16),
                 k > 0);
  }
}

// acc[64 x N] += A . B: A [64 x K] as register fragments, B [K rows][N] at `b` in N / 64 boxes
// b_box bytes apart (MN-major).
template <int K, int N>
__device__ __forceinline__ void mma_ab(float (&acc)[N / 2], const uint32_t (&a)[K / 16][4],
                                       uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) Wgmma<N>::rs(acc, a[k], desc(b + k * 16 * kRow, b_box));
}

// The A fragments of the N / 16 k-chunks of a [64 x N] accumulator, rounded to bf16.
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    a[k][0] = pack(acc[8 * k], acc[8 * k + 1]);
    a[k][1] = pack(acc[8 * k + 2], acc[8 * k + 3]);
    a[k][2] = pack(acc[8 * k + 4], acc[8 * k + 5]);
    a[k][3] = pack(acc[8 * k + 6], acc[8 * k + 7]);
  }
}

// column (within the tile) and row half (0: row, 1: row + 8) of accumulator element i
__device__ __forceinline__ int col_of(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2; }
__device__ __forceinline__ int half_of(int i) { return (i / 2) % 2; }

// Rows `row` and `row + 8` of a [64 x D] accumulator, times mul / div[half], into a (b, h)
// slice with row stride st; rows at or past T are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long st, const float (&acc)[D / 2],
                                           int row, int T_len, float mul, const float (&div)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row + 8 * r;
    if (t >= T_len) continue;
    const float f = mul / div[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + t * st + n * 8 + 2 * (threadIdx.x % 4)) =
          pack(acc[4 * n + 2 * r] * f, acc[4 * n + 2 * r + 1] * f);
  }
}

// One online-softmax step over a [64 x N] score tile of keys k0.. (raw Q K^T): masks keys after
// the row on the diagonal tile, updates the running max m (base 2, scaled) and sum l, leaves
// P = exp2(s * scale2 - m) in s and the factor for the earlier output in corr.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool diagonal, int k0, int row,
                                             float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    if (diagonal && k0 + col_of(i) > row + 8 * half_of(i)) s[i] = -INFINITY;
    mx[half_of(i)] = fmaxf(mx[half_of(i)], s[i]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale2);  // finite: key 0 is allowed for every row
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float p = fast_exp2(fmaf(s[i], scale2, -m[half_of(i)]));
    s[i] = p;
    sum[half_of(i)] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// ---- forward

template <int D> struct Fwd : Roles<D> {
  static constexpr int BM = 64 * Roles<D>::kWG;  // query rows per block
  static constexpr int BN = 128;                 // keys per stage
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQ = BM * D * 2;
  static constexpr int kKV = BN * D * 2;  // K, then V, in each stage
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kSmem = kBars + Ring<kStages>::kBytes + 1024;  // + alignment slack
};

// Grid (query tiles, B * H): the tiles of one (b, h) run side by side and share its K and V in
// L2. The producer loads the block's query rows once and streams the key tiles up to the
// diagonal (K and V) through a ring of stages; each consumer warpgroup owns 64 query rows.
// Iteration j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} together, then runs the softmax of
// S_j while the P V product finishes; the consumers take turns issuing, in a ring of named
// barriers, so that one's softmax overlaps the others' products. The products of a key tile
// wholly after a warpgroup's rows are run all the same (a zero contribution): skipping them
// measured slower, as a branch inside this loop or as empty turns after it.
template <int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
           float* __restrict__ lse, int H, int T_len, Strides so, float scale) {
  using C = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Ring<C::kStages> ring{base + C::kBars};
  auto stage = [&](int j) { return base + C::kQ + (j % C::kStages) * C::kStage; };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int i = gridDim.x - 1 - blockIdx.x;  // the longest rows of each (b, h) first
  const int q0 = i * C::BM;
  // key tiles up to the block's last row, and none wholly past T
  const int n_tiles = min((q0 + C::BM - 1) / C::BN + 1, (T_len + C::BN - 1) / C::BN);
  if (threadIdx.x == 0) ring.init(1, C::kConsumerWarps);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: one thread issues every copy
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.once(), C::kQ);
      load_tile<D, C::BM>(base, &tm_q, ring.once(), q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        ring.wait_empty(j);
        mbar_expect_tx(ring.full(j), C::kStage);
        load_tile<D, C::BN>(stage(j), &tm_k, ring.full(j), j * C::BN, h, b);
        load_tile<D, C::BN>(stage(j) + C::kKV, &tm_v, ring.full(j), j * C::BN, h, b);
      }
    }
  } else {
    reg_alloc<C::kConsumerRegs>();
    const int c = wg - 1;
    const int lane = threadIdx.x % 32;
    const int row = q0 + 64 * c + 16 * (threadIdx.x % 128 / 32) + lane / 4;  // and row + 8
    const uint32_t qa = base + c * 64 * kRow;  // this warpgroup's 64 query rows
    const float scale2 = scale * kLog2e;       // scores in base 2: exp(x) = exp2(x log2 e)
    // named barriers 1..kWG: consumer c issues after c - 1, consumer 0 first
    const int me = 1 + c, next = 1 + (c + 1) % C::kWG;
    const int first_masked = (q0 + 64 * c) / C::BN;  // the first key tile past a row here
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float s[C::BN / 2];
    uint32_t p[C::BN / 16][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float corr[2];
    if (c == C::kWG - 1) bar_arrive(1);
    mbar_wait(ring.once(), 0);

    ring.wait_full(0);
    bar_sync(me);
    wg_fence();
    mma_abt<D, C::BN>(s, qa, C::BM * kRow, stage(0), C::BN * kRow);
    wg_commit();
    bar_arrive(next);
    wg_wait<0>();
    keep(s);
    softmax_step<C::BN>(s, m, l, corr, first_masked == 0, 0, row, scale2);
    to_frags<C::BN>(p, s);
    for (int j = 1; j < n_tiles; ++j) {
      ring.wait_full(j);
      bar_sync(me);
      wg_fence();
      mma_abt<D, C::BN>(s, qa, C::BM * kRow, stage(j), C::BN * kRow);
      wg_commit();
      mma_ab<C::BN, D>(o, p, stage(j - 1) + C::kKV, C::BN * kRow);
      wg_commit();
      bar_arrive(next);
      wg_wait<1>();
      keep(s);
      softmax_step<C::BN>(s, m, l, corr, j >= first_masked, j * C::BN, row, scale2);
      wg_wait<0>();
      keep(o);
      keep(p);
      if (lane == 0) mbar_arrive(ring.empty(j - 1));
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= corr[half_of(e)];
      to_frags<C::BN>(p, s);
    }
    bar_sync(me);
    wg_fence();
    mma_ab<C::BN, D>(o, p, stage(n_tiles - 1) + C::kKV, C::BN * kRow);
    wg_commit();
    if (c != C::kWG - 1) bar_arrive(next);  // the last consumer arrived once ahead
    wg_wait<0>();
    keep(o);
    keep(p);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    store_rows<D>(out + b * so.b + h * so.h, so.t, o, row, T_len, 1.f, l);
    if (lane % 4 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < T_len)
          lse[static_cast<long long>(bh) * T_len + row + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// ---- backward

template <int D> struct Dkdv : Roles<D> {
  static constexpr int BK = 64 * Roles<D>::kWG;  // keys per block
  static constexpr int BQ = D == 64 ? 64 : 32;   // queries per stage (registers cap it at D 128)
  static constexpr int kStages = 3;
  static constexpr int kKV = BK * D * 2;         // the K tile, then the V tile
  static constexpr int kQ = BQ * D * 2;          // Q, then dO, then lse and delta in each stage
  static constexpr int kStage = align1024(2 * kQ + 2 * BQ * 4);
  static constexpr int kBars = 2 * kKV + kStages * kStage;
  static constexpr int kSmem = kBars + Ring<kStages>::kBytes + 1024;
};

// Grid (key tiles, B * H). The producer warp loads the block's keys (K, V) once and streams
// the query tiles from the diagonal down: Q and dO by TMA, lse and delta by cp.async, all
// completing on the stage's barrier. Each consumer warpgroup owns 64 keys and keeps their dK
// and dV in registers: S^T = K Q^T and dP^T = V dO^T, then P^T and dV += P^T dO while dP^T
// finishes, then dS^T and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(Dkdv<D>::kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T_len, Strides sd,
            float scale) {
  using C = Dkdv<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Ring<C::kStages> ring{base + C::kBars};
  auto stage = [&](int it) { return base + 2 * C::kKV + (it % C::kStages) * C::kStage; };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * C::BK;  // the first key tiles see the most query tiles
  const int i0 = k0 / BQ;             // the first query tile reaching these keys
  const int n_q = (T_len + BQ - 1) / BQ;
  // a stage is full after the TMA arrival and the producer warp's 32 cp.async arrivals
  if (threadIdx.x == 0) ring.init(1 + 32, C::kConsumerWarps);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x < 32) {
      const float* lse_b = lse + static_cast<long long>(bh) * T_len;
      const float* delta_b = delta + static_cast<long long>(bh) * T_len;
      if (lane == 0) {
        mbar_expect_tx(ring.once(), 2 * C::kKV);
        load_tile<D, C::BK>(base, &tm_k, ring.once(), k0, h, b);
        load_tile<D, C::BK>(base + C::kKV, &tm_v, ring.once(), k0, h, b);
      }
      for (int it = 0; i0 + it < n_q; ++it) {
        const int t0 = (i0 + it) * BQ;
        ring.wait_empty(it);
        if (lane == 0) {
          mbar_expect_tx(ring.full(it), 2 * C::kQ);
          load_tile<D, BQ>(stage(it), &tm_q, ring.full(it), t0, h, b);
          load_tile<D, BQ>(stage(it) + C::kQ, &tm_do, ring.full(it), t0, h, b);
        }
        for (int r = lane; r < BQ; r += 32) {
          const bool valid = t0 + r < T_len;
          const uint32_t dst = stage(it) + 2 * C::kQ + 4 * r;
          cp_async4(dst, lse_b + (valid ? t0 + r : 0), valid);
          cp_async4(dst + BQ * 4, delta_b + (valid ? t0 + r : 0), valid);
        }
        cp_async_arrive(ring.full(it));
      }
    }
  } else {
    reg_alloc<C::kConsumerRegs>();
    const int c = wg - 1;
    const int key = k0 + 64 * c + 16 * (threadIdx.x % 128 / 32) + lane / 4;  // and key + 8
    const uint32_t ka = base + c * 64 * kRow;  // this warpgroup's 64 keys
    const uint32_t va = ka + C::kKV;
    const float scale2 = scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
    float st[BQ / 2];   // S^T, then P^T
    float dpt[BQ / 2];  // dP^T, then dS^T
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    mbar_wait(ring.once(), 0);
    for (int it = 0; i0 + it < n_q; ++it) {
      const int q0 = (i0 + it) * BQ;
      ring.wait_full(it);
      if (k0 + 64 * c <= q0 + BQ - 1) {  // else every key here is after every query of the tile
        const uint32_t sq = stage(it);
        const uint32_t sdo = sq + C::kQ;
        const float* s_lse = reinterpret_cast<const float*>(smem_raw + (sq + 2 * C::kQ - raw));
        const float* s_delta = s_lse + BQ;
        wg_fence();
        mma_abt<D, BQ>(st, ka, C::BK * kRow, sq, BQ * kRow);
        wg_commit();
        mma_abt<D, BQ>(dpt, va, C::BK * kRow, sdo, BQ * kRow);
        wg_commit();
        wg_wait<1>();
        keep(st);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int tq = q0 + col_of(e);
          const bool allowed = key + 8 * half_of(e) <= tq && tq < T_len;
          st[e] = allowed ? fast_exp2(fmaf(st[e], scale2, -s_lse[col_of(e)] * kLog2e)) : 0.f;
        }
        to_frags<BQ>(pa, st);
        wg_fence();
        mma_ab<BQ, D>(dv_acc, pa, sdo, BQ * kRow);  // dV += P^T dO
        wg_commit();
        wg_wait<1>();
        keep(dpt);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) dpt[e] = st[e] * (dpt[e] - s_delta[col_of(e)]);
        to_frags<BQ>(dsa, dpt);
        wg_fence();
        mma_ab<BQ, D>(dk_acc, dsa, sq, BQ * kRow);  // dK += dS^T Q
        wg_commit();
        wg_wait<0>();
        keep(dk_acc);
        keep(dv_acc);
        keep(pa);
        keep(dsa);
      }
      if (lane == 0) mbar_arrive(ring.empty(it));
    }
    const float one[2] = {1.f, 1.f};
    store_rows<D>(dk + b * sd.b + h * sd.h, sd.t, dk_acc, key, T_len, scale, one);
    store_rows<D>(dv + b * sd.b + h * sd.h, sd.t, dv_acc, key, T_len, 1.f, one);
  }
}

template <int D> struct Dq : Roles<D> {
  static constexpr int BM = 64 * Roles<D>::kWG;  // query rows per block
  static constexpr int BN = 64;                  // keys per stage
  static constexpr int kStages = 3;
  static constexpr int kQ = BM * D * 2;   // the Q tile, then the dO tile
  static constexpr int kKV = BN * D * 2;  // K, then V, in each stage
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBars = 2 * kQ + kStages * kStage;
  static constexpr int kSmem = kBars + Ring<kStages>::kBytes + 1024;
};

// Grid (query tiles, B * H). The producer loads the block's Q and dO tiles once and streams the
// key tiles up to the diagonal; each consumer warpgroup owns 64 query rows and keeps their dQ
// in registers: S = Q K^T and dP = dO V^T, P and dS, then dQ += dS K.
template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
          int H, int T_len, Strides sd, float scale) {
  using C = Dq<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Ring<C::kStages> ring{base + C::kBars};
  auto stage = [&](int j) { return base + 2 * C::kQ + (j % C::kStages) * C::kStage; };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int i = gridDim.x - 1 - blockIdx.x;  // the longest rows of each (b, h) first
  const int q0 = i * C::BM;
  const int n_k = min((q0 + C::BM - 1) / C::BN + 1, (T_len + C::BN - 1) / C::BN);
  if (threadIdx.x == 0) ring.init(1, C::kConsumerWarps);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.once(), 2 * C::kQ);
      load_tile<D, C::BM>(base, &tm_q, ring.once(), q0, h, b);
      load_tile<D, C::BM>(base + C::kQ, &tm_do, ring.once(), q0, h, b);
      for (int j = 0; j < n_k; ++j) {
        ring.wait_empty(j);
        mbar_expect_tx(ring.full(j), C::kStage);
        load_tile<D, C::BN>(stage(j), &tm_k, ring.full(j), j * C::BN, h, b);
        load_tile<D, C::BN>(stage(j) + C::kKV, &tm_v, ring.full(j), j * C::BN, h, b);
      }
    }
  } else {
    reg_alloc<C::kConsumerRegs>();
    const int c = wg - 1;
    const int row = q0 + 64 * c + 16 * (threadIdx.x % 128 / 32) + lane / 4;  // and row + 8
    const uint32_t qa = base + c * 64 * kRow;
    const uint32_t da = qa + C::kQ;
    const float scale2 = scale * kLog2e;
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row + 8 * r < T_len;
      const long long at = static_cast<long long>(bh) * T_len + row + 8 * r;
      lse2[r] = in ? lse[at] * kLog2e : 0.f;
      dlt[r] = in ? delta[at] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq_acc[e] = 0.f;
    float s[C::BN / 2];   // S, then P
    float dp[C::BN / 2];  // dP, then dS
    uint32_t dsa[C::BN / 16][4];
    mbar_wait(ring.once(), 0);
    for (int j = 0; j < n_k; ++j) {
      ring.wait_full(j);
      if (j * C::BN <= q0 + 64 * c + 63) {  // else every key of the tile is after every row
        const uint32_t kt = stage(j);
        wg_fence();
        mma_abt<D, C::BN>(s, qa, C::BM * kRow, kt, C::BN * kRow);
        wg_commit();
        mma_abt<D, C::BN>(dp, da, C::BM * kRow, kt + C::kKV, C::BN * kRow);
        wg_commit();
        wg_wait<1>();
        keep(s);
#pragma unroll
        for (int e = 0; e < C::BN / 2; ++e) {
          const int t = row + 8 * half_of(e);
          const bool allowed = j * C::BN + col_of(e) <= t && t < T_len;
          s[e] = allowed ? fast_exp2(fmaf(s[e], scale2, -lse2[half_of(e)])) : 0.f;
        }
        wg_wait<0>();
        keep(dp);
#pragma unroll
        for (int e = 0; e < C::BN / 2; ++e) dp[e] = s[e] * (dp[e] - dlt[half_of(e)]);
        to_frags<C::BN>(dsa, dp);
        wg_fence();
        mma_ab<C::BN, D>(dq_acc, dsa, kt, C::BN * kRow);  // dQ += dS K
        wg_commit();
        wg_wait<0>();
        keep(dq_acc);
        keep(dsa);
      }
      if (lane == 0) mbar_arrive(ring.empty(j));
    }
    const float one[2] = {1.f, 1.f};
    store_rows<D>(dq + b * sd.b + h * sd.h, sd.t, dq_acc, row, T_len, scale, one);
  }
}

}  // namespace wgmma_path

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

// cuTensorMapEncodeTiled is a driver-API function: it is looked up through the runtime, so the
// library links against nothing but the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map over one bf16 [B, T, H, D] operand read through its element strides s: boxes of
// `rows` rows by 64 columns (one 128-byte swizzled row each), rows past T zero-filled.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int T_len, int H, int D, Strides s,
               int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t) * 2,
                                 static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
             int T_len, const long long* s, cudaStream_t stream) {
  using C = wgmma_path::Fwd<D>;
  CUtensorMap mq, mk, mv;
  if (int err = tensor_map(&mq, q, B, T_len, H, D, strides_at(s, 0), C::BM)) return err;
  if (int err = tensor_map(&mk, k, B, T_len, H, D, strides_at(s, 1), C::BN)) return err;
  if (int err = tensor_map(&mv, v, B, T_len, H, D, strides_at(s, 2), C::BN)) return err;
  const auto kernel = wgmma_path::fwd_kernel<D>;
  if (int err = set_smem(kernel, C::kSmem)) return err;
  const dim3 grid((T_len + C::BM - 1) / C::BM, B * H);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse), H, T_len, strides_at(s, 3),
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
            int T_len, const long long* s, cudaStream_t stream) {
  using L = fma_path::Smem<D>;
  const auto kernel = fma_path::fwd_kernel<D>;
  if (int err = set_smem(kernel, L::kFwdBytes)) return err;
  const dim3 grid((T_len + fma_path::BM - 1) / fma_path::BM, B * H);
  kernel<<<grid, fma_path::kThreads, L::kFwdBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), H, T_len, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_delta(const void* dout, const void* out, void* delta, int B, int H, int T_len,
                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * T_len * H;
  const long long threads = rows * (D * static_cast<int>(sizeof(T)) / 16);
  delta_kernel<T, D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out), static_cast<float*>(delta), H,
      T_len, rows);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, then dO, whose contiguous layout out, dq, dk and dv share
template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int T_len,
             const long long* s, cudaStream_t stream) {
  using KV = wgmma_path::Dkdv<D>;
  using Q = wgmma_path::Dq<D>;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (int err = launch_delta<bf16, D>(dout, out, delta, B, H, T_len, stream)) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (int err = tensor_map(&mq, q, B, T_len, H, D, strides_at(s, 0), KV::BQ)) return err;
  if (int err = tensor_map(&mk, k, B, T_len, H, D, strides_at(s, 1), KV::BK)) return err;
  if (int err = tensor_map(&mv, v, B, T_len, H, D, strides_at(s, 2), KV::BK)) return err;
  if (int err = tensor_map(&mdo, dout, B, T_len, H, D, strides_at(s, 3), KV::BQ)) return err;
  const auto dkdv = wgmma_path::dkdv_kernel<D>;
  if (int err = set_smem(dkdv, KV::kSmem)) return err;
  dkdv<<<dim3((T_len + KV::BK - 1) / KV::BK, B * H), KV::kThreads, KV::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T_len, strides_at(s, 3), scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (int err = tensor_map(&mq, q, B, T_len, H, D, strides_at(s, 0), Q::BM)) return err;
  if (int err = tensor_map(&mk, k, B, T_len, H, D, strides_at(s, 1), Q::BN)) return err;
  if (int err = tensor_map(&mv, v, B, T_len, H, D, strides_at(s, 2), Q::BN)) return err;
  if (int err = tensor_map(&mdo, dout, B, T_len, H, D, strides_at(s, 3), Q::BM)) return err;
  const auto dq_k = wgmma_path::dq_kernel<D>;
  if (int err = set_smem(dq_k, Q::kSmem)) return err;
  dq_k<<<dim3((T_len + Q::BM - 1) / Q::BM, B * H), Q::kThreads, Q::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, T_len, strides_at(s, 3), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
            const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int T_len,
            const long long* s, cudaStream_t stream) {
  using L = fma_path::Smem<D>;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (int err = launch_delta<float, D>(dout, out, delta, B, H, T_len, stream)) return err;
  const auto dkdv = fma_path::dkdv_kernel<D>;
  const auto dq_k = fma_path::dq_kernel<D>;
  if (int err = set_smem(dkdv, L::kDkdvBytes)) return err;
  if (int err = set_smem(dq_k, L::kDqBytes)) return err;
  const dim3 grid((T_len + fma_path::BM - 1) / fma_path::BM, B * H);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  dkdv<<<grid, fma_path::kThreads, L::kDkdvBytes, stream>>>(
      qf, kf, vf, df, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, T_len, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  dq_k<<<grid, fma_path::kThreads, L::kDqBytes, stream>>>(
      qf, kf, vf, df, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, T_len, strides_at(s, 0), strides_at(s, 1), strides_at(s, 2),
      strides_at(s, 3), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64, (b, t, h) element strides of q, k, v, out.
extern "C" int flash_causal_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int T, int H, int D, int dtype,
                                       const long long* strides, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && D == 64) return fwd_bf16<64>(q, k, v, out, lse, B, H, T, strides, st);
  if (dtype == kBF16 && D == 128) return fwd_bf16<128>(q, k, v, out, lse, B, H, T, strides, st);
  if (dtype == kF32 && D == 64) return fwd_f32<64>(q, k, v, out, lse, B, H, T, strides, st);
  if (dtype == kF32 && D == 128) return fwd_f32<128>(q, k, v, out, lse, B, H, T, strides, st);
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
  if (dtype == kBF16 && D == 64) return bwd_bf16<64>(FC_BWD_ARGS);
  if (dtype == kBF16 && D == 128) return bwd_bf16<128>(FC_BWD_ARGS);
  if (dtype == kF32 && D == 64) return bwd_f32<64>(FC_BWD_ARGS);
  if (dtype == kF32 && D == 128) return bwd_f32<128>(FC_BWD_ARGS);
#undef FC_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
