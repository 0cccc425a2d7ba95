// bf16 operand sides for the f32 SIMT mainloop of sgemm_f32.cuh: K4's bf16
// instances (lora_apply.cu) read x (M, K) and W (K, N) as __nv_bfloat16 and
// run the same k-major f32 slabs, the same register tile and the same fmaf
// order as the f32 instances. A bf16 x bf16 product is exact in f32, so the
// sum is the reference's f32 dot at Precision.HIGHEST of the bf16 operands
// (src/repro/kernels/lora_apply.py::_batched_kernel upcasts each tile).
//
// cp.async copies bytes and cannot convert, so both sides go through
// registers: each thread loads its share of the next slab as raw bf16 bits
// (8 bytes = 4 values a load, half the registers of the f32 stage) before
// the current slab's FMAs, and converts and stores it after them (a bf16 to
// f32 conversion is a 16-bit shift). The f32 slab layout in shared memory
// is unchanged, so K2's and K3's f32 instances (which include only
// sgemm_f32.cuh) compile to the same code as before.
//  - AlongKBf16: x, row-major along the depth; stored transposed, k-major,
//    as sgemm::AlongK stores its f32 registers.
//  - KMajorBf16: W, k-major in memory; stored as it stands, a float4 a
//    thread (sgemm::KMajor's cp.async layout).
// kVec: 8-byte loads (the row length a multiple of 4 and 8-byte aligned
// bases; kend is K or a multiple of the slab depth, so a load is all in or
// all out); otherwise 2-byte loads, each masked.
#pragma once

#include <cuda_bf16.h>

#include "sgemm_f32.cuh"

namespace sgemm {

template <int E>
struct RegStageBf16 {
  uint2 v[E * kBK / 4 / kThreads];
};

__device__ __forceinline__ float bf16_bits_to_float(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// 4 bf16 values (element 0 in the low half of u.x) as a float4
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned short bf16_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// 4 masked elements p[0], p[step], p[2 step], p[3 step] packed as raw bits
__device__ __forceinline__ uint2 pack4(const __nv_bfloat16* p, size_t step,
                                       bool in0, bool in1, bool in2,
                                       bool in3) {
  const unsigned e0 = in0 ? bf16_bits(p) : 0u;
  const unsigned e1 = in1 ? bf16_bits(p + step) : 0u;
  const unsigned e2 = in2 ? bf16_bits(p + 2 * step) : 0u;
  const unsigned e3 = in3 ? bf16_bits(p + 3 * step) : 0u;
  return make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
}

// x side: element (e, k) at p[e * K + k], e < rows
template <int E, int LD, bool kVec>
struct AlongKBf16 {
  using Stage = RegStageBf16<E>;
  const __nv_bfloat16* __restrict__ p;
  int rows, K, e0;
  __device__ __forceinline__ void fetch(Stage& r, int k0, int kend) const {
#pragma unroll
    for (int it = 0; it < E * kBK / 4 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int ge = e0 + e % E, gk = k0 + (e / E) * 4;
      const __nv_bfloat16* src = p + (size_t)ge * K + gk;
      const bool row = ge < rows;
      if (kVec)
        r.v[it] = (row && gk < kend) ? *reinterpret_cast<const uint2*>(src)
                                     : make_uint2(0u, 0u);
      else
        r.v[it] = pack4(src, 1, row && gk < kend, row && gk + 1 < kend,
                        row && gk + 2 < kend, row && gk + 3 < kend);
    }
  }
  __device__ __forceinline__ void store(float* s, const Stage& r) const {
#pragma unroll
    for (int it = 0; it < E * kBK / 4 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      float* d = s + (e / E) * 4 * LD + e % E;
      const float4 f = bf16x4_to_float4(r.v[it]);
      d[0] = f.x;
      d[LD] = f.y;
      d[2 * LD] = f.z;
      d[3 * LD] = f.w;
    }
  }
  __device__ __forceinline__ void load(float* s, Stage& r, int k0,
                                       int kend) const {
    fetch(r, k0, kend);
    store(s, r);
  }
  __device__ __forceinline__ void early(float*, Stage& r, int k0,
                                        int kend) const {
    if (kVec) fetch(r, k0, kend);
  }
  __device__ __forceinline__ void late(float* s, Stage& r, int k0,
                                       int kend) const {
    if (!kVec) fetch(r, k0, kend);
    store(s, r);
  }
};

// W side: element (k, e) at p[k * n + e], e < n
template <int E, int LD, bool kVec>
struct KMajorBf16 {
  using Stage = RegStageBf16<E>;
  const __nv_bfloat16* __restrict__ p;
  int n, e0;
  __device__ __forceinline__ void fetch(Stage& r, int k0, int kend) const {
    constexpr int Q = E / 4;
#pragma unroll
    for (int it = 0; it < E * kBK / 4 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int gk = k0 + e / Q, gn = e0 + (e % Q) * 4;
      const __nv_bfloat16* src = p + (size_t)gk * n + gn;
      const bool in_k = gk < kend;
      if (kVec)
        r.v[it] = (in_k && gn < n) ? *reinterpret_cast<const uint2*>(src)
                                   : make_uint2(0u, 0u);
      else
        r.v[it] = pack4(src, 1, in_k && gn < n, in_k && gn + 1 < n,
                        in_k && gn + 2 < n, in_k && gn + 3 < n);
    }
  }
  __device__ __forceinline__ void store(float* s, const Stage& r) const {
    constexpr int Q = E / 4;
#pragma unroll
    for (int it = 0; it < E * kBK / 4 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      *reinterpret_cast<float4*>(s + (e / Q) * LD + (e % Q) * 4) =
          bf16x4_to_float4(r.v[it]);
    }
  }
  __device__ __forceinline__ void load(float* s, Stage& r, int k0,
                                       int kend) const {
    fetch(r, k0, kend);
    store(s, r);
  }
  __device__ __forceinline__ void early(float*, Stage& r, int k0,
                                        int kend) const {
    if (kVec) fetch(r, k0, kend);
  }
  __device__ __forceinline__ void late(float* s, Stage& r, int k0,
                                       int kend) const {
    if (!kVec) fetch(r, k0, kend);
    store(s, r);
  }
};

// K4's bf16 product: x (M, K) and w (K, N) row-major bf16, the depth [kbeg,
// kend), summed in f32 into acc in the f32 mainloop's order.
template <class T, bool kVec>
__device__ __forceinline__ void mainloop_bf16(
    float* smem, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, int M, int K, int N, int m0, int n0,
    int kbeg, int kend, float (&acc)[T::TM][T::TN]) {
  const int slabs = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  mainloop_sides<T>(smem, AlongKBf16<T::BM, T::LDX, kVec>{x, M, K, m0},
                    KMajorBf16<T::BN, T::LDW, kVec>{w, N, n0},
                    SlabRun{kbeg, slabs}, kend, acc);
}

// out[m0 + row i][n0 + col j] = bf16(acc[i][j]) inside (M, N), rounded to
// nearest even once; 8-byte stores where N % 4 == 0 (out 8-byte aligned).
template <class T>
__device__ __forceinline__ void store_tile_bf16(
    __nv_bfloat16* __restrict__ out, const float (&acc)[T::TM][T::TN], int M,
    int N, int m0, int n0, bool vec) {
  const int ty = grid_row(), tx = grid_col();
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = m0 + tile_row(i, ty);
    if (row >= M) continue;
    __nv_bfloat16* o = out + (size_t)row * N;
#pragma unroll
    for (int g = 0; g < T::CG; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      if (vec && col + 3 < N) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][4 * g],
                                                  acc[i][4 * g + 1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][4 * g + 2],
                                                  acc[i][4 * g + 3]);
        uint2 u;
        u.x = *reinterpret_cast<unsigned*>(&lo);
        u.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(o + col) = u;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < N) o[col + c] = __float2bfloat16_rn(acc[i][4 * g + c]);
      }
    }
  }
}

}  // namespace sgemm
