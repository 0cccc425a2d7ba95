// An IEEE f32 SIMT GEMM mainloop for Hopper's SMs (sm_90a), shared by the
// kernels that compute a dense f32 product on the CUDA cores:
//
//     acc += x[m0 : m0 + BM, kbeg : kend] @ w[kbeg : kend, n0 : n0 + BN]
//
// x (M, K) row-major, w (K, N) row-major, acc a BM x BN tile held in
// registers by 256 threads. Every product is an fmaf in a fixed order, so
// a tile's sum is the same from run to run; no tensor cores, no TF32.
//
// What bounds such a product on the H100 is the FMA pipe: 67 TFLOP/s of
// f32 on 132 SMs. The design keeps the other pipes off the critical path:
//  - register tile: a 16 x 16 thread grid, each thread owning TM x TN
//    outputs (8 x 8 for a 128 x 128 tile) in groups of 4 rows / 4 columns
//    64 apart. A k-step reads RG + CG float4s from shared memory for
//    TM * TN FMAs (4 loads for 64 at 128 x 128). Each warp covers 4 x 8
//    threads of the grid, so a float4 load touches at most 128 bytes and
//    costs one shared-memory wavefront;
//  - a ring of kStages 16-deep slabs in shared memory. While slab t's FMAs
//    run, slabs t+1 .. t+kStages-1 are in flight:
//    * w's slab is k-major already and goes by cp.async, 16 bytes a copy
//      (4 bytes where N % 4 != 0 or w is unaligned), zero-filled past N
//      and past kend;
//    * x is row-major and cp.async cannot transpose it. Its slab is loaded
//      into registers by float4 before slab t's FMAs and stored
//      transposed, k-major, after them, so the loads' latency hides behind
//      the FMAs. A transposed copy of x made by the caller would cost
//      2 M K 4 bytes of device memory traffic and a launch; the register
//      stage costs 4-8 registers. The edge path (K or N not a multiple of
//      4, or an unaligned base; a template instance of its own) copies 4
//      bytes at a time and loads x after the FMAs;
//  - one __syncthreads per slab. Rows of a slab are padded by 4 floats,
//    so the transposed stores of x hit at most 2 threads a bank and the
//    float4 reads stay 16-byte aligned.
// The caller picks the tile (64 or 128 on each side) and the depth range;
// a split over K is the caller's (lora_apply.cu's planner).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sgemm {

constexpr int kThreads = 256;
constexpr int kBK = 16;       // slab depth
constexpr int kStages = 3;    // slabs in the shared-memory ring
constexpr int kPad = 4;       // floats of padding after each slab row

template <int BM_, int BN_>
struct Tile {
  static_assert((BM_ == 64 || BM_ == 128) && (BN_ == 64 || BN_ == 128),
                "tiles are 64 or 128 on each side");
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int RG = BM / 64, CG = BN / 64;   // 4-row / 4-col groups
  static constexpr int TM = 4 * RG, TN = 4 * CG;     // outputs a thread
  static constexpr int LDX = BM + kPad, LDW = BN + kPad;
  static constexpr int kXFloats = kBK * LDX, kWFloats = kBK * LDW;
  static constexpr int kXVec = BM * kBK / 4 / kThreads;   // float4s a thread
  static constexpr int kWVec = BN * kBK / 4 / kThreads;
  static constexpr int kRingBytes = kStages * (kXFloats + kWFloats) * 4;
};

// The thread's place in the 16 x 16 grid: warp w covers grid rows
// 4 (w / 2) .. +3 and columns 8 (w % 2) .. +7.
__device__ __forceinline__ int grid_row() {
  return (threadIdx.x >> 6) * 4 + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int grid_col() {
  return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7);
}
// tile-local row of accumulator row i (column j: likewise with tx)
__device__ __forceinline__ int tile_row(int i, int ty) {
  return (i >> 2) * 64 + ty * 4 + (i & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ws[k][n] = w[k0 + k][n0 + n] by cp.async, zero past N and past kend.
template <class T, bool kVec>
__device__ __forceinline__ void load_w_slab(float* ws,
                                            const float* __restrict__ w,
                                            int N, int k0, int kend,
                                            int n0) {
  constexpr int Q = T::BN / 4;
#pragma unroll
  for (int it = 0; it < T::kWVec; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int k = e / Q, n = (e % Q) * 4;
    float* dst = ws + k * T::LDW + n;
    const int gk = k0 + k, gn = n0 + n;
    const bool in_k = gk < kend;
    if (kVec) {
      // N % 4 == 0: a copy is all in or all out
      const bool in = in_k && gn < N;
      cp_async16(dst, in ? w + (size_t)gk * N + gn : w, in ? 16 : 0);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = in_k && gn + c < N;
        cp_async4(dst + c, in ? w + (size_t)gk * N + gn + c : w,
                  in ? 4 : 0);
      }
    }
  }
}

// x's slab in registers: float4 `it` holds x[m0 + m][k0 + 4 q .. + 3] with
// m = e % BM, q = e / BM (neighbouring threads on neighbouring rows, so
// the transposed stores are conflict-free); zero past M and kend.
template <class T>
struct XStage {
  float4 v[T::kXVec];
};

template <class T, bool kVec>
__device__ __forceinline__ void fetch_x_slab(XStage<T>& r,
                                             const float* __restrict__ x,
                                             int M, int K, int m0, int k0,
                                             int kend) {
#pragma unroll
  for (int it = 0; it < T::kXVec; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int gm = m0 + e % T::BM, gk = k0 + (e / T::BM) * 4;
    const float* src = x + (size_t)gm * K + gk;
    if (kVec) {
      // K % 4 == 0 and kend % 4 == 0: a float4 is all in or all out
      r.v[it] = (gm < M && gk < kend)
                    ? *reinterpret_cast<const float4*>(src)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool row = gm < M;
      r.v[it] = make_float4(row && gk < kend ? src[0] : 0.f,
                            row && gk + 1 < kend ? src[1] : 0.f,
                            row && gk + 2 < kend ? src[2] : 0.f,
                            row && gk + 3 < kend ? src[3] : 0.f);
    }
  }
}

template <class T>
__device__ __forceinline__ void store_x_slab(float* xs, const XStage<T>& r) {
#pragma unroll
  for (int it = 0; it < T::kXVec; ++it) {
    const int e = threadIdx.x + it * kThreads;
    float* d = xs + (e / T::BM) * 4 * T::LDX + e % T::BM;
    d[0] = r.v[it].x;
    d[T::LDX] = r.v[it].y;
    d[2 * T::LDX] = r.v[it].z;
    d[3 * T::LDX] = r.v[it].w;
  }
}

// acc[i][j] += xs[k][row i] * ws[k][col j] for one k of a slab. With
// kMasked, only the accumulator rows whose bit is set in `rows` change
// (the others see no product at all, so a non-finite ws entry cannot
// reach them).
template <class T, bool kMasked = false>
__device__ __forceinline__ void fma_step(const float* xs, const float* ws,
                                         float (&acc)[T::TM][T::TN], int ty,
                                         int tx, int k, unsigned rows = ~0u) {
  float a[T::TM], b[T::TN];
#pragma unroll
  for (int g = 0; g < T::RG; ++g) {
    const float4 v =
        *reinterpret_cast<const float4*>(xs + k * T::LDX + g * 64 + ty * 4);
    a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z;
    a[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int g = 0; g < T::CG; ++g) {
    const float4 v =
        *reinterpret_cast<const float4*>(ws + k * T::LDW + g * 64 + tx * 4);
    b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z;
    b[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    if (kMasked && !((rows >> i) & 1u)) continue;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the whole slab, k in order, unrolled (the mainloop's hot path)
template <class T>
__device__ __forceinline__ void fma_slab(const float* xs, const float* ws,
                                         float (&acc)[T::TM][T::TN], int ty,
                                         int tx) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) fma_step<T>(xs, ws, acc, ty, tx, k);
}

// acc += x[m0:, kbeg:kend] @ w[kbeg:kend, n0:] through the slab ring in
// `smem` (T::kRingBytes). kVec: K % 4 == 0 and N % 4 == 0 with x and w
// 16-byte aligned, so both go by 16-byte loads and x's next slab is held
// in registers across the FMAs. Otherwise the 4-byte edge path, which
// loads and stores x's next slab after the FMAs (no registers held).
// Leaves every copy landed and the ring free.
template <class T, bool kVec>
__device__ __forceinline__ void mainloop(float* smem,
                                         const float* __restrict__ x,
                                         const float* __restrict__ w, int M,
                                         int K, int N, int m0, int n0,
                                         int kbeg, int kend,
                                         float (&acc)[T::TM][T::TN]) {
  const int ty = grid_row(), tx = grid_col();
  float* xs = smem;
  float* ws = smem + kStages * T::kXFloats;
  const int slabs = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  XStage<T> r;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) {
      const int k0 = kbeg + s * kBK;
      load_w_slab<T, kVec>(ws + s * T::kWFloats, w, N, k0, kend, n0);
      fetch_x_slab<T, kVec>(r, x, M, K, m0, k0, kend);
      store_x_slab<T>(xs + s * T::kXFloats, r);
    }
    cp_async_commit();          // empty groups keep the count uniform
  }
  int cur = 0, nxt = kStages - 1;
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<kStages - 2>();   // slab t's copies have landed
    __syncthreads();                // x stores seen; slab t - 1 read by all
    const bool more = t + kStages - 1 < slabs;
    const int k0 = kbeg + (t + kStages - 1) * kBK;
    if (more) {
      load_w_slab<T, kVec>(ws + nxt * T::kWFloats, w, N, k0, kend, n0);
      if (kVec) fetch_x_slab<T, kVec>(r, x, M, K, m0, k0, kend);
    }
    cp_async_commit();
    fma_slab<T>(xs + cur * T::kXFloats, ws + cur * T::kWFloats, acc, ty, tx);
    if (more) {
      if (!kVec) fetch_x_slab<T, kVec>(r, x, M, K, m0, k0, kend);
      store_x_slab<T>(xs + nxt * T::kXFloats, r);
    }
    cur = cur + 1 == kStages ? 0 : cur + 1;
    nxt = nxt + 1 == kStages ? 0 : nxt + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// out[m0 + row i][n0 + col j] = acc[i][j] inside (M, N); float4 stores
// where N % 4 == 0 (out 16-byte aligned).
template <class T>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[T::TM][T::TN],
                                           int M, int N, int m0, int n0,
                                           bool vec) {
  const int ty = grid_row(), tx = grid_col();
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = m0 + tile_row(i, ty);
    if (row >= M) continue;
    float* o = out + (size_t)row * N;
#pragma unroll
    for (int g = 0; g < T::CG; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      if (vec && col + 3 < N) {
        *reinterpret_cast<float4*>(o + col) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < N) o[col + c] = acc[i][4 * g + c];
      }
    }
  }
}

}  // namespace sgemm
