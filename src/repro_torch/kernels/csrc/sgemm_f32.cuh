// An IEEE f32 SIMT GEMM mainloop for Hopper's SMs (sm_90a), shared by the
// kernels that compute a dense f32 product on the CUDA cores (K2 gram.cu,
// K3 rank_partition_agg.cu, K4/K5 lora_apply.cu):
//
//     acc += x[m0 : m0 + BM, kbeg : kend] @ w[kbeg : kend, n0 : n0 + BN]
//
// acc is a BM x BN tile held in registers by 256 threads. Every product is
// an fmaf in a fixed order, so a tile's sum is the same from run to run; no
// tensor cores, no TF32.
//
// What bounds such a product on the H100 is the FMA pipe: 67 TFLOP/s of
// f32 on 132 SMs. The design keeps the other pipes off the critical path:
//  - register tile: a 16 x 16 thread grid, each thread owning TM x TN
//    outputs (8 x 8 for a 128 x 128 tile) in groups of 4 rows / 4 columns
//    64 apart. A k-step reads RG + CG float4s from shared memory for
//    TM * TN FMAs (4 loads for 64 at 128 x 128). Each warp covers 4 x 8
//    threads of the grid, so a float4 load touches at most 128 bytes and
//    costs one shared-memory wavefront;
//  - a ring of kStages 16-deep slabs in shared memory, both operands stored
//    k-major (s[k][row] and s[k][col]). While slab t's FMAs run, slabs
//    t+1 .. t+kStages-1 are in flight. Each side of the product is an
//    operand policy that fills its slabs one of two ways:
//    * KMajor: the operand is k-major in memory (K4/K5's w, K3's A, both
//      sides of K2-left's U_c^T U_c) and goes by cp.async, 16 bytes a copy
//      (4 bytes where its rows are not 16-byte aligned), zero-filled past
//      its extent and past kend;
//    * AlongK (and K3's client rows): the operand is row-major along the
//      depth (K4/K5's x, both sides of K2-right's V_c V_c^T) and
//      cp.async cannot transpose it. Its slab is loaded into registers by
//      float4 before slab t's FMAs and stored transposed, k-major, after
//      them, so the loads' latency hides behind the FMAs. A transposed
//      copy made by the caller would cost 2 M K 4 bytes of device memory
//      traffic and a launch; the register stage costs 4-8 registers. The
//      edge path (a row not 16-byte aligned; a template instance of its
//      own) copies 4 bytes at a time and loads after the FMAs;
//  - one __syncthreads per slab. Rows of a slab are padded by 4 floats,
//    so the transposed stores hit at most 2 threads a bank and the float4
//    reads stay 16-byte aligned;
//  - the slabs a block runs are a contiguous range (SlabRun) or a list it
//    built in shared memory (SlabList: K3 skips the slabs whose weights
//    are all zero); a square tile on the diagonal of a symmetric product
//    (K2) loads one panel and points both sides at it.
// The caller picks the tile (64 or 128 on each side) and the depth range
// (gemm_plan.py). A split over the depth is summed either by a second
// kernel (lora_apply.cu) or in the same launch by the last block of each
// tile to finish (split_sum, K2 and K3), in split order both ways.
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

// Operand policies. A side fills k-major slabs s[k][e] (kBK rows of LD
// floats) for E entries from e0: output rows (the x side, E = BM) or
// columns (the w side, E = BN). In the ring:
//   load(s, r, k0, kend)   the whole slab, now (the prologue);
//   early(s, r, k0, kend)  before the current slab's FMAs;
//   late(s, r, k0, kend)   after them.
// Each zero-fills past its extent and past kend.

// element (k, e) at p[k * n + e], e < n; by cp.async, no registers held
template <int E, int LD, bool kVec>
struct KMajor {
  const float* __restrict__ p;
  int n, e0;
  struct Stage {};
  __device__ __forceinline__ void issue(float* s, int k0, int kend) const {
    constexpr int Q = E / 4;
#pragma unroll
    for (int it = 0; it < E * kBK / 4 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int k = e / Q, c = (e % Q) * 4;
      float* dst = s + k * LD + c;
      const int gk = k0 + k, gn = e0 + c;
      const bool in_k = gk < kend;
      if (kVec) {
        // n % 4 == 0: a copy is all in or all out
        const bool in = in_k && gn < n;
        cp_async16(dst, in ? p + (size_t)gk * n + gn : p, in ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = in_k && gn + q < n;
          cp_async4(dst + q, in ? p + (size_t)gk * n + gn + q : p,
                    in ? 4 : 0);
        }
      }
    }
  }
  __device__ __forceinline__ void load(float* s, Stage&, int k0,
                                       int kend) const {
    issue(s, k0, kend);
  }
  __device__ __forceinline__ void early(float* s, Stage&, int k0,
                                        int kend) const {
    issue(s, k0, kend);
  }
  __device__ __forceinline__ void late(float*, Stage&, int, int) const {}
};

// A slab in registers. Float4 `it` of a thread, e = threadIdx.x + it *
// kThreads, holds entry slab_entry(e), depths 4 slab_quad(e) .. + 3:
//  - by entries (the default): entry e % E, quad e / E. Neighbouring
//    threads on neighbouring entries: the transposed stores are
//    conflict-free, but a warp's loads touch 32 rows;
//  - by rows (kByRows): entry e / 4, quad e % 4. An entry's 16-deep row is
//    64 contiguous bytes in 4 neighbouring threads, so a warp's loads touch
//    8 rows and the L1 serves them in a quarter of the passes; the
//    transposed stores then conflict 2 ways. For a side whose both operands
//    come through registers (K2-right), the loads' passes are what fill
//    the load/store pipe.
template <int E>
struct RegStage {
  float4 v[E * kBK / 4 / kThreads];
};

template <int E, bool kByRows>
__device__ __forceinline__ int slab_entry(int e) {
  return kByRows ? e >> 2 : e % E;
}
template <int E, bool kByRows>
__device__ __forceinline__ int slab_quad(int e) {
  return kByRows ? e & 3 : e / E;
}

template <int E, int LD, bool kByRows = false>
__device__ __forceinline__ void store_slab(float* s, const RegStage<E>& r) {
#pragma unroll
  for (int it = 0; it < E * kBK / 4 / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    float* d = s + slab_quad<E, kByRows>(e) * 4 * LD +
               slab_entry<E, kByRows>(e);
    d[0] = r.v[it].x;
    d[LD] = r.v[it].y;
    d[2 * LD] = r.v[it].z;
    d[3 * LD] = r.v[it].w;
  }
}

// A side staged through registers; Side::fetch(r, k0, kend) fills the
// registers in the kByRows mapping. kVec: 16-byte loads, issued before the
// FMAs and held across them; otherwise 4-byte loads after them (no
// registers held).
template <class Side, int E, int LD, bool kVec, bool kByRows = false>
struct ThroughRegisters {
  using Stage = RegStage<E>;
  __device__ __forceinline__ void load(float* s, Stage& r, int k0,
                                       int kend) const {
    static_cast<const Side&>(*this).fetch(r, k0, kend);
    store_slab<E, LD, kByRows>(s, r);
  }
  __device__ __forceinline__ void early(float*, Stage& r, int k0,
                                        int kend) const {
    if (kVec) static_cast<const Side&>(*this).fetch(r, k0, kend);
  }
  __device__ __forceinline__ void late(float* s, Stage& r, int k0,
                                       int kend) const {
    if (!kVec) static_cast<const Side&>(*this).fetch(r, k0, kend);
    store_slab<E, LD, kByRows>(s, r);
  }
};

// element (e, k) at p[e * K + k], e < rows. kVec: K % 4 == 0 and kend % 4
// == 0 with p 16-byte aligned.
template <int E, int LD, bool kVec, bool kByRows = false>
struct AlongK : ThroughRegisters<AlongK<E, LD, kVec, kByRows>, E, LD, kVec,
                                 kByRows> {
  const float* __restrict__ p;
  int rows, K, e0;
  __device__ __forceinline__ AlongK(const float* p_, int rows_, int K_,
                                    int e0_)
      : p(p_), rows(rows_), K(K_), e0(e0_) {}
  __device__ __forceinline__ void fetch(RegStage<E>& r, int k0,
                                        int kend) const {
#pragma unroll
    for (int it = 0; it < E * kBK / 4 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int ge = e0 + slab_entry<E, kByRows>(e),
                gk = k0 + slab_quad<E, kByRows>(e) * 4;
      const float* src = p + (size_t)ge * K + gk;
      if (kVec) {
        // a float4 is all in or all out
        r.v[it] = (ge < rows && gk < kend)
                      ? *reinterpret_cast<const float4*>(src)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool row = ge < rows;
        r.v[it] = make_float4(row && gk < kend ? src[0] : 0.f,
                              row && gk + 1 < kend ? src[1] : 0.f,
                              row && gk + 2 < kend ? src[2] : 0.f,
                              row && gk + 3 < kend ? src[3] : 0.f);
      }
    }
  }
};

// The slabs a block runs: kbeg, kbeg + kBK, ... (count of them) ...
struct SlabRun {
  int kbeg, count;
  __device__ __forceinline__ int k0(int t) const { return kbeg + t * kBK; }
};
// ... or the depths listed in shared memory (k0(t) may be read up to
// kStages - 1 past count: the list has that much room).
struct SlabList {
  const int* k;
  int count;
  __device__ __forceinline__ int k0(int t) const { return k[t]; }
};

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

// acc += x-side slabs @ w-side slabs over the slabs of `sl` (each cut at
// kend), through the ring in `smem` (T::kRingBytes). With kShare and
// `same` (a diagonal tile of a symmetric product, BM == BN, both sides
// reading the same panel), only x's slabs are loaded and both sides read
// them. Leaves every copy landed and the ring free.
template <class T, class XSide, class WSide, class Slabs,
          bool kShare = false>
__device__ __forceinline__ void mainloop_sides(
    float* smem, const XSide& xo, const WSide& wo, const Slabs& sl,
    int kend, float (&acc)[T::TM][T::TN], bool same = false) {
  static_assert(!kShare || T::BM == T::BN, "a shared panel is square");
  const int ty = grid_row(), tx = grid_col();
  float* xs = smem;
  float* ws = smem + kStages * T::kXFloats;
  const bool share = kShare && same;
  const int slabs = sl.count;
  typename XSide::Stage rx;
  typename WSide::Stage rw;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) {
      const int k0 = sl.k0(s);
      if (!share) wo.load(ws + s * T::kWFloats, rw, k0, kend);
      xo.load(xs + s * T::kXFloats, rx, k0, kend);
    }
    cp_async_commit();          // empty groups keep the count uniform
  }
  int cur = 0, nxt = kStages - 1;
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<kStages - 2>();   // slab t's copies have landed
    __syncthreads();                // stores seen; slab t - 1 read by all
    const bool more = t + kStages - 1 < slabs;
    const int k0 = sl.k0(t + kStages - 1);
    if (more) {
      if (!share) wo.early(ws + nxt * T::kWFloats, rw, k0, kend);
      xo.early(xs + nxt * T::kXFloats, rx, k0, kend);
    }
    cp_async_commit();
    fma_slab<T>(xs + cur * T::kXFloats,
                share ? xs + cur * T::kXFloats : ws + cur * T::kWFloats,
                acc, ty, tx);
    if (more) {
      if (!share) wo.late(ws + nxt * T::kWFloats, rw, k0, kend);
      xo.late(xs + nxt * T::kXFloats, rx, k0, kend);
    }
    cur = cur + 1 == kStages ? 0 : cur + 1;
    nxt = nxt + 1 == kStages ? 0 : nxt + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// K4/K5's product: x (M, K) row-major, w (K, N) row-major, the depth
// [kbeg, kend). kVec: K % 4 == 0 and N % 4 == 0 with x and w 16-byte
// aligned, so both go by 16-byte loads and x's next slab is held in
// registers across the FMAs. Otherwise the 4-byte edge path, which loads
// and stores x's next slab after the FMAs (no registers held).
template <class T, bool kVec>
__device__ __forceinline__ void mainloop(float* smem,
                                         const float* __restrict__ x,
                                         const float* __restrict__ w, int M,
                                         int K, int N, int m0, int n0,
                                         int kbeg, int kend,
                                         float (&acc)[T::TM][T::TN]) {
  const int slabs = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  mainloop_sides<T>(smem, AlongK<T::BM, T::LDX, kVec>(x, M, K, m0),
                    KMajor<T::BN, T::LDW, kVec>{w, N, n0},
                    SlabRun{kbeg, slabs}, kend, acc);
}

// A split over the depth in one launch. Block `split` of `tile` (of
// `tiles`, for `splits` ranges) writes its partial tile to part (splits x
// tiles x BM BN floats, in the threads' own order: float4 v of thread i at
// v * kThreads + i, so the writes and the reads back are coalesced), then
// counts itself in count[tile]. The last block to arrive resets the count
// to 0 (the next launch finds it so) and sums the partials into acc in
// split order, part[0] + part[1] + ..., whatever order the blocks finished
// in. Returns true in the block that holds the tile's sum (every block
// with one split), false in the others, which then have nothing left to
// do. `count` starts at zero: the wrapper allocates it zeroed, once.
template <class T>
__device__ __forceinline__ bool split_sum(float (&acc)[T::TM][T::TN],
                                          float* __restrict__ part,
                                          unsigned* __restrict__ count,
                                          int tile, int tiles, int split,
                                          int splits) {
  if (splits == 1) return true;
  constexpr int kV = T::TM * T::TN / 4;
  __shared__ int last;
  const size_t plane = (size_t)tiles * kV * kThreads;
  float4* mine = reinterpret_cast<float4*>(part) + split * plane +
                 (size_t)tile * kV * kThreads + threadIdx.x;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int i = 4 * v / T::TN, j = 4 * v % T::TN;
    mine[v * kThreads] = make_float4(acc[i][j], acc[i][j + 1],
                                     acc[i][j + 2], acc[i][j + 3]);
  }
  __threadfence();                 // the partial is seen before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count + tile, 1u) == (unsigned)(splits - 1);
    if (last) atomicExch(count + tile, 0u);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();                 // the count is seen before the partials
  // split 0 straight into acc (its kV loads in flight together), then
  // each later split added in order
  const float4* p = reinterpret_cast<const float4*>(part) +
                    (size_t)tile * kV * kThreads + threadIdx.x;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const float4 u = __ldcg(p + v * kThreads);
    const int i = 4 * v / T::TN, j = 4 * v % T::TN;
    acc[i][j] = u.x; acc[i][j + 1] = u.y; acc[i][j + 2] = u.z;
    acc[i][j + 3] = u.w;
  }
  for (int q = 1; q < splits; ++q) {
    p += plane;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const float4 u = __ldcg(p + v * kThreads);
      const int i = 4 * v / T::TN, j = 4 * v % T::TN;
      acc[i][j] += u.x; acc[i][j + 1] += u.y; acc[i][j + 2] += u.z;
      acc[i][j + 3] += u.w;
    }
  }
  return true;
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
