// K4: paged multi-adapter LoRA apply (the serving engine's q/k/v/o
// projections), in f32 and in bf16, and K5: the single-adapter fused LoRA
// apply; f32.
//
// K4 replaces src/repro/kernels/lora_apply.py::batched_lora_apply_pallas
// and the SGMV grouping of repro/kernels/ops.py::batched_lora_apply.
// Contract (repro/kernels/ref.py::batched_lora_apply_ref), row t of x
// using the adapter page p = ids[t]:
//
//     y[t] = x[t] @ W + s[p] * (x[t] @ A_p^T) @ B_p^T
//
// K5 replaces src/repro/kernels/lora_apply.py::lora_apply_pallas (contract
// ref.lora_apply_ref): y = x @ W + s * (x @ A^T) @ B^T with one adapter
// A (R, K), B (N, R) and a scalar s. Its shrink, GEMV and split reduce are
// K4's device code instantiated with kPaged = false: no ids, no page
// gather, the scale a kernel argument; above 32 rows its base product runs
// on the tensor cores instead (lora_tc_kernel, below). The TPU kernel kept
// z = x A^T in a VMEM scratch across
// its K loop; here z goes to a small (M, R) buffer the wrapper allocates
// (M*R*4 bytes, 2 MB at 4096 rows and r = 128), written once by the shrink
// and read by the base product's epilogue.
//
// x (M, K), W (K, N), A pages (P, R, K), B pages (P, N, R), scales (P,),
// ids (M,) int32; each page is contiguous, pages lie a_stride / b_stride
// floats apart (so a per-layer slice of a layer-stacked adapter tree is
// passed without a copy).
//
// The TPU kernel sorted rows by page and padded each group to 8-row blocks
// so that a block had one page. Here every row reads its own page (as in
// BGMV), so there are no filler rows at all. One call runs two launches on
// the caller's stream (three with a split over K):
//   1. lora_shrink_kernel: z[t, j] = x[t] . A_p[j], one warp per (t, j),
//      reduced by a fixed xor-shuffle tree (deterministic);
//   2. the base product x @ W with the expand term s_p * z[t] . B_p[n]
//      added in its epilogue:
//      - M <= 32 (decode): lora_gemv_kernel. Each block owns 8 rows and
//        4*NG columns; its 256 threads split K into 256/NG interleaved
//        slices, stream W with 16-byte loads, and sum the slices through
//        shared memory in a fixed order (no atomics, identical run to run).
//        W is read once from device memory, so this shape is bound by
//        bytes (W is 51.4 MB for Qwen2-7B's q/o, 7.3 MB for k/v);
//      - M > 32 (prefill): lora_gemm_kernel, the f32 SGEMM of
//        sgemm_f32.cuh (128x128 or 64x128 output tiles, 8x8 / 4x8
//        register tiles, a 3-stage cp.async ring; a tile past M or N is
//        zero-filled, so no smaller tile is built). It is
//        bound by f32 operations (K4's Qwen2-7B prefill layer: 7.6 GFLOP
//        against 0.47 GB). At 128 rows the tiles alone leave most of the
//        132 SMs idle (28 tiles for q, 8 for k), so the wrapper's planner
//        (lora_apply.py::plan_gemm) splits K into S ranges, one block
//        each: the blocks write partial tiles to an (S, M, N) workspace
//        and lora_split_reduce_kernel sums them in split order, then adds
//        the expand. No atomics: every output is summed in one fixed
//        order, x W over its K/S-deep range plus S - 1 additions.
//        Epilogue: the tile's z rows and B_p's rows are staged in shared
//        memory from contiguous reads and summed by the same register
//        tile; K4 walks the tile's distinct pages;
//      - K5, M > 32: lora_tc_kernel, x @ W as 3xTF32 on mma.sync
//        (mma_tf32x3.cuh), f32-accurate at up to a third of the tensor
//        cores' 495 TFLOP/s where the SIMT SGEMM stops at 67. 128 x 128
//        tiles, 8 warps of 64 x 32, a 3-stage cp.async ring of 32-deep
//        slabs (112 KB, and at most 128 registers a thread: two blocks
//        an SM): x's slab row-major along K (mma's A layout as it stands,
//        rows padded to 8 mod 32 floats) and W's k-major (rows padded to 4
//        mod 16), every fragment load conflict-free. The split over K
//        (gemm_plan.py::plan_gemm_tc) goes through the same (S, M, N)
//        workspace and lora_split_reduce_kernel; unsplit, the tile adds
//        the expand itself, in IEEE f32 as above.
// K4's bf16 instances (batched_lora_apply_bf16, a bf16 model's serve) read
// x, W and the A and B pages as __nv_bfloat16 and run every launch above
// with the same f32 arithmetic: each operand is converted to f32 in
// registers (the shrink, the GEMV's W stream and the expand) or on its way
// into the shared-memory slabs (the GEMV's x chunk; the SGEMM's two sides,
// through registers: sgemm_bf16.cuh), the products of bf16 values are
// exact in f32 and summed in f32 as the f32 instances sum them, scales stay
// f32, z and the split partials stay f32, and y is rounded to bf16 once,
// when it is stored. That is the reference kernel's arithmetic (each tile
// upcast, an f32 dot at Precision.HIGHEST, the output written in x's
// dtype). They move half the f32 instances' bytes: the decode GEMV, bound
// by W's bytes, reads 25.7 MB a Qwen2-7B q projection instead of 51.4.
//
// K4's products and K5's shrink and expand are IEEE f32 FMAs (no TF32). A
// row whose page id lies outside [0, P) gets NaN in every column: the
// wrapper does not read ids back to the host, so a bad id shows in the
// output instead.
#include <climits>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"
#include "sgemm_bf16.cuh"
#include "sgemm_f32.cuh"

namespace {

// The operand element type of an instance: f32, or bf16 (kBf16)
template <bool kBf16>
using Elem = std::conditional_t<kBf16, __nv_bfloat16, float>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return sgemm::bf16_bits_to_float(
      *reinterpret_cast<const unsigned short*>(&v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// 4 consecutive elements as a float4: one 16-byte (f32) or 8-byte (bf16)
// load, 4 * sizeof(T)-aligned
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return sgemm::bf16x4_to_float4(*reinterpret_cast<const uint2*>(p));
}

// The adapter side of one call: pages and ids (K4), or one adapter at page
// 0 with the scale by value (K5).
template <bool kBf16>
struct Adapter {
  const Elem<kBf16>* a;     // A pages, a_stride elements apart
  const Elem<kBf16>* b;     // B pages, b_stride elements apart
  const float* scales;      // (P,) for K4
  const int* ids;           // (M,) page per row for K4
  long long a_stride, b_stride;
  int P;
  float scale;              // K5's scale
};

// page of a row, or -1 for an id outside [0, P)
template <bool kPaged, bool kBf16>
__device__ __forceinline__ int page_of(const Adapter<kBf16>& ad, int row) {
  if (!kPaged) return 0;
  const int p = ad.ids[row];
  return (p < 0 || p >= ad.P) ? -1 : p;
}

template <bool kPaged, bool kBf16>
__device__ __forceinline__ float scale_of(const Adapter<kBf16>& ad, int p) {
  return kPaged ? ad.scales[p] : ad.scale;
}

constexpr int kThreads = 256;
constexpr int kShrinkWarps = kThreads / 32;
constexpr int kGemvRows = 8;
constexpr int kGemvChunk = 1024;           // x rows staged per chunk of K
constexpr int kGemvMaxRows = 32;           // M above: the SGEMM route

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

template <bool kPaged, bool kBf16>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const Elem<kBf16>* __restrict__ x, const Adapter<kBf16> ad,
                   float* __restrict__ z, int M, int K, int R, int vec) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.y * kShrinkWarps + warp;
  if (t >= M || j >= R) return;
  const int p = page_of<kPaged, kBf16>(ad, t);
  if (p < 0) {
    if (lane == 0) z[(size_t)t * R + j] = nan_f32();
    return;
  }
  const Elem<kBf16>* xr = x + (size_t)t * K;
  const Elem<kBf16>* ar = ad.a + (size_t)p * ad.a_stride + (size_t)j * K;
  float acc = 0.f;
  if (vec) {
    for (int k = lane; k < K / 4; k += 32) {
      const float4 u = ld4(xr + 4 * k), v = ld4(ar + 4 * k);
      acc = fmaf(u.x, v.x, acc);
      acc = fmaf(u.y, v.y, acc);
      acc = fmaf(u.z, v.z, acc);
      acc = fmaf(u.w, v.w, acc);
    }
  } else {
    for (int k = lane; k < K; k += 32)
      acc = fmaf(to_f(xr[k]), to_f(ar[k]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) z[(size_t)t * R + j] = acc;
}

// acc + s_p * (z[row] . B_p[col])
template <bool kPaged, bool kBf16>
__device__ __forceinline__ float expand(float acc, int row, int col,
                                        const Adapter<kBf16>& ad,
                                        const float* __restrict__ z, int R) {
  const int p = page_of<kPaged, kBf16>(ad, row);
  if (p < 0) return nan_f32();
  const float* zr = z + (size_t)row * R;
  const Elem<kBf16>* br = ad.b + (size_t)p * ad.b_stride + (size_t)col * R;
  float d = 0.f;
  for (int j = 0; j < R; ++j) d = fmaf(zr[j], to_f(br[j]), d);
  return fmaf(scale_of<kPaged, kBf16>(ad, p), d, acc);
}

template <int NG, bool kPaged, bool kBf16>
__global__ void __launch_bounds__(kThreads)
lora_gemv_kernel(const Elem<kBf16>* __restrict__ x,
                 const Elem<kBf16>* __restrict__ w, const Adapter<kBf16> ad,
                 const float* __restrict__ z, Elem<kBf16>* __restrict__ y,
                 int M, int K, int N, int R, int vec) {
  constexpr int BM = kGemvRows, BN = 4 * NG, KS = kThreads / NG;
  static_assert(KS * BM * BN <= kGemvChunk * BM, "partials must fit");
  static_assert(BM * BN <= kThreads, "one output per thread");
  // x chunk as xs[m][k]; after the K loop, the split-K partials
  __shared__ float smem[kGemvChunk * BM];
  const int tid = threadIdx.x, ng = tid % NG, ks = tid / NG;
  const int n0 = blockIdx.x * BN + ng * 4;
  const int m0 = blockIdx.y * BM;
  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int kc = 0; kc < K; kc += kGemvChunk) {
    const int kn = min(kGemvChunk, K - kc);
    __syncthreads();
#pragma unroll 8
    for (int e = tid; e < BM * kGemvChunk; e += kThreads) {
      const int m = e / kGemvChunk, k = e % kGemvChunk;
      smem[e] = (k < kn && m0 + m < M)
                    ? to_f(x[(size_t)(m0 + m) * K + kc + k]) : 0.f;
    }
    __syncthreads();
    const Elem<kBf16>* wk = w + (size_t)kc * N;
#pragma unroll 4
    for (int k = ks; k < kn; k += KS) {
      float wv[4];
      if (vec && n0 < N) {
        const float4 v = ld4(wk + (size_t)k * N + n0);
        wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wv[c] = (n0 + c < N) ? to_f(wk[(size_t)k * N + n0 + c]) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = smem[m * kGemvChunk + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      smem[(ks * BM + m) * BN + ng * 4 + c] = acc[m][c];
  __syncthreads();
  if (tid < BM * BN) {
    const int m = tid / BN, c = tid % BN;
    const int row = m0 + m, col = blockIdx.x * BN + c;
    float s = 0.f;
    for (int q = 0; q < KS; ++q) s += smem[(q * BM + m) * BN + c];
    if (row < M && col < N)
      put(y + (size_t)row * N + col,
          expand<kPaged, kBf16>(s, row, col, ad, z, R));
  }
}

// ---- M > 32: the SGEMM of sgemm_f32.cuh, with the expand in its epilogue

constexpr int kNoRow = -2;    // page slot of a tile row past M

// acc[i][j] += s_p * z[row] . B_p[col] for each row of the tile on page p,
// and NaN in every column of a row whose page id is bad. The tile's z rows
// and B_p's BN rows are staged r-major in shared memory (zs: BK x LDX,
// bs: BK x LDW, each read from contiguous memory with neighbouring threads
// on neighbouring floats), z pre-multiplied by s_p, and summed by the
// mainloop's register tile in r order. K4 walks the distinct pages of the
// tile's rows in increasing order; a row only ever sees its own page.
// kStage unrolls the staging loops: 1 (rolled) in the SGEMM's epilogue,
// where the accumulators fill the registers and an unrolled epilogue
// pushes the 128 x 128 tile past 128 registers; fully in the split
// reduce, so that its staging loads are in flight together. The FMA loop
// stays rolled in both.
template <bool kPaged, bool kBf16, class T, int kStage>
__device__ void expand_tile(float* zs, float* bs, int* pg,
                            const Adapter<kBf16>& ad,
                            const float* __restrict__ z, int M, int N, int R,
                            int m0, int n0, float (&acc)[T::TM][T::TN]) {
  const int tid = threadIdx.x, ty = sgemm::grid_row(),
            tx = sgemm::grid_col();
  for (int i = tid; i < T::BM; i += sgemm::kThreads)
    pg[i] = m0 + i < M ? page_of<kPaged, kBf16>(ad, m0 + i) : kNoRow;
  __syncthreads();
  int last = -1;                 // pages above `last` are still to do
  while (R > 0) {
    int p = 0;
    if (kPaged) {
      if (tid < 32) {
        int lo = INT_MAX;
        for (int i = tid; i < T::BM; i += 32)
          if (pg[i] > last && pg[i] < lo) lo = pg[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        if (tid == 0) pg[T::BM] = lo;
      }
      __syncthreads();
      p = pg[T::BM];
      if (p == INT_MAX) break;
    }
    unsigned rows = 0;
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
      rows |= (pg[sgemm::tile_row(i, ty)] == p ? 1u : 0u) << i;
    const float s = scale_of<kPaged, kBf16>(ad, p);
    const Elem<kBf16>* bp = ad.b + (size_t)p * ad.b_stride;
    for (int r0 = 0; r0 < R; r0 += sgemm::kBK) {
      __syncthreads();           // the last slab (and pg[BM]) read by all
#pragma unroll (kStage)
      for (int it = 0; it < T::BM * sgemm::kBK / sgemm::kThreads; ++it) {
        const int e = tid + it * sgemm::kThreads;
        const int m = e / sgemm::kBK, r = r0 + e % sgemm::kBK;
        zs[(e % sgemm::kBK) * T::LDX + m] =
            (pg[m] == p && r < R) ? s * z[(size_t)(m0 + m) * R + r] : 0.f;
      }
#pragma unroll (kStage)
      for (int it = 0; it < T::BN * sgemm::kBK / sgemm::kThreads; ++it) {
        const int e = tid + it * sgemm::kThreads;
        const int n = e / sgemm::kBK, r = r0 + e % sgemm::kBK;
        bs[(e % sgemm::kBK) * T::LDW + n] =
            (n0 + n < N && r < R) ? to_f(bp[(size_t)(n0 + n) * R + r]) : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < sgemm::kBK; ++k)
        sgemm::fma_step<T, true>(zs, bs, acc, ty, tx, k, rows);
    }
    if (!kPaged) break;
    last = p;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
    if (pg[sgemm::tile_row(i, ty)] == -1)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = nan_f32();
}

// y's tile in its element type: f32 as it stands, bf16 rounded once
template <class T>
__device__ __forceinline__ void store_out(float* y,
                                          const float (&acc)[T::TM][T::TN],
                                          int M, int N, int m0, int n0,
                                          bool vec) {
  sgemm::store_tile<T>(y, acc, M, N, m0, n0, vec);
}
template <class T>
__device__ __forceinline__ void store_out(__nv_bfloat16* y,
                                          const float (&acc)[T::TM][T::TN],
                                          int M, int N, int m0, int n0,
                                          bool vec) {
  sgemm::store_tile_bf16<T>(y, acc, M, N, m0, n0, vec);
}

// One BM x BN output tile over the depth [z * depth, (z + 1) * depth) of
// K. One split (gridDim.z == 1): the expand is added and y written. More:
// the partial tile goes to part[z] of (S, M, N) and
// lora_split_reduce_kernel finishes it. __launch_bounds__(256, 2): at most
// 128 registers a thread, so two blocks share an SM.
template <bool kPaged, int BM, int BN, bool kVec, bool kBf16>
__global__ void __launch_bounds__(sgemm::kThreads, 2)
lora_gemm_kernel(const Elem<kBf16>* __restrict__ x,
                 const Elem<kBf16>* __restrict__ w, const Adapter<kBf16> ad,
                 const float* __restrict__ z, Elem<kBf16>* __restrict__ y,
                 float* __restrict__ part, int M, int K, int N, int R,
                 int depth) {
  using T = sgemm::Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * depth, kend = min(K, kbeg + depth);
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  if constexpr (kBf16)
    sgemm::mainloop_bf16<T, kVec>(smem, x, w, M, K, N, m0, n0, kbeg, kend,
                                  acc);
  else
    sgemm::mainloop<T, kVec>(smem, x, w, M, K, N, m0, n0, kbeg, kend, acc);
  if (gridDim.z > 1) {
    sgemm::store_tile<T>(part + (size_t)blockIdx.z * M * N, acc, M, N, m0,
                         n0, kVec);
    return;
  }
  int* pg = reinterpret_cast<int*>(smem + T::kRingBytes / 4);
  expand_tile<kPaged, kBf16, T, 1>(smem, smem + sgemm::kStages * T::kXFloats,
                                   pg, ad, z, M, N, R, m0, n0, acc);
  store_out<T>(y, acc, M, N, m0, n0, kVec);
}

constexpr int kRedStage = 4;   // the reduce's 4-trip staging loops, unrolled

// y = part[0] + part[1] + ... + part[S - 1] in that order, then the
// expand; 64 x 64 tiles, 4 x 4 outputs a thread, float4 reads of the
// partials where N % 4 == 0. (Row by row with 4 splits' loads in flight
// measured faster on the H100 than all 4 rows' loads at once.)
template <bool kPaged, bool kBf16>
__global__ void __launch_bounds__(sgemm::kThreads)
lora_split_reduce_kernel(const float* __restrict__ part, int S,
                         const Adapter<kBf16> ad, const float* __restrict__ z,
                         Elem<kBf16>* __restrict__ y, int M, int N, int R,
                         int vec_y) {
  using T = sgemm::Tile<64, 64>;
  __shared__ __align__(16) float smem[T::kXFloats + T::kWFloats];
  __shared__ int pg[T::BM + 1];
  const int ty = sgemm::grid_row(), tx = sgemm::grid_col();
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int col = n0 + tx * 4;
  const size_t plane = (size_t)M * N;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = m0 + sgemm::tile_row(i, ty);
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
    if (row >= M) continue;
    const float* src = part + (size_t)row * N + col;
    if (vec_y && col + 3 < N) {
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float4 v =
            *reinterpret_cast<const float4*>(src + (size_t)s * plane);
        acc[i][0] += v.x; acc[i][1] += v.y; acc[i][2] += v.z;
        acc[i][3] += v.w;
      }
    } else {
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < N) acc[i][c] += src[(size_t)s * plane + c];
    }
  }
  expand_tile<kPaged, kBf16, T, kRedStage>(smem, smem + T::kXFloats, pg, ad,
                                           z, M, N, R, m0, n0, acc);
  store_out<T>(y, acc, M, N, m0, n0, vec_y);
}

template <bool kPaged, int BM, int BN, bool kVec, bool kBf16>
int launch_gemm(const Elem<kBf16>* x, const Elem<kBf16>* w,
                const Adapter<kBf16>& ad, const float* z, Elem<kBf16>* y,
                float* part, int M, int K, int N, int R, int splits,
                int depth, cudaStream_t s) {
  using T = sgemm::Tile<BM, BN>;
  const int smem = T::kRingBytes + (BM + 1) * (int)sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      lora_gemm_kernel<kPaged, BM, BN, kVec, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  lora_gemm_kernel<kPaged, BM, BN, kVec, kBf16>
      <<<grid, sgemm::kThreads, smem, s>>>(x, w, ad, z, y, part, M, K, N, R,
                                            depth);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 rgrid((N + 63) / 64, (M + 63) / 64);
    lora_split_reduce_kernel<kPaged, kBf16><<<rgrid, sgemm::kThreads, 0, s>>>(
        part, splits, ad, z, y, M, N, R, kVec);
  }
  return static_cast<int>(cudaGetLastError());
}

// kVec (loads and stores of 4 elements) where x's and w's rows are 4 *
// sizeof(element)-byte aligned: K % 4 == 0 and N % 4 == 0, aligned bases
// (y and part come from the allocator).
template <bool kPaged, int BM, int BN, bool kBf16>
int launch_gemm_tile(const Elem<kBf16>* x, const Elem<kBf16>* w,
                     const Adapter<kBf16>& ad, const float* z,
                     Elem<kBf16>* y, float* part, int M, int K, int N, int R,
                     int splits, int depth, cudaStream_t s) {
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w)) %
                           (4 * sizeof(Elem<kBf16>)) == 0;
  return vec ? launch_gemm<kPaged, BM, BN, true, kBf16>(
                   x, w, ad, z, y, part, M, K, N, R, splits, depth, s)
             : launch_gemm<kPaged, BM, BN, false, kBf16>(
                   x, w, ad, z, y, part, M, K, N, R, splits, depth, s);
}

// The host planner's choice (lora_apply.py::plan_gemm): a bm x bn tile and
// `splits` ranges of K, each `depth` deep (a multiple of the slab) but the
// last. Refused unless the splits cover K exactly.
template <bool kPaged, bool kBf16>
int launch_sgemm(const Elem<kBf16>* x, const Elem<kBf16>* w,
                 const Adapter<kBf16>& ad, const float* z, Elem<kBf16>* y,
                 float* part, int M, int K, int N, int R, int bm, int bn,
                 int splits, int depth, cudaStream_t s) {
  const bool covers =
      splits >= 1 && depth > 0 && depth % sgemm::kBK == 0 &&
      (long long)splits * depth >= K &&
      (splits == 1 || ((long long)(splits - 1) * depth < K && part));
  if (!covers) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128 && bn == 128)
    return launch_gemm_tile<kPaged, 128, 128, kBf16>(x, w, ad, z, y, part, M,
                                                     K, N, R, splits, depth,
                                                     s);
  if (bm == 64 && bn == 128)
    return launch_gemm_tile<kPaged, 64, 128, kBf16>(x, w, ad, z, y, part, M,
                                                    K, N, R, splits, depth,
                                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- K5, M > 32: x @ W on the tensor cores (3xTF32), expand in f32

namespace tc {

constexpr int kBM = 128, kBN = 128, kBK = 32;  // tile; slab depth
constexpr int kStages = 3;                      // slabs in the ring
constexpr int kThreads = 256;                   // 2 x 4 warps of 64 x 32
constexpr int kLDA = kBK + 8;     // x slab rows: 8 (mod 32) floats
constexpr int kLDB = kBN + 4;     // W slab rows: 4 (mod 16) floats
constexpr int kAFloats = kBM * kLDA, kBFloats = kBK * kLDB;
constexpr int kSmemBytes = kStages * (kAFloats + kBFloats) * 4;
constexpr int kR = 32;            // rank columns the expand stages at once
constexpr int kLDE = kR + 1;
static_assert(2 * kBM * kLDE <= kStages * (kAFloats + kBFloats),
              "the expand's staging fits the ring");

// slab [k0, k0 + kBK) of x's rows m0.. into as (as[m][k]) and of W's rows
// into bs (bs[k][n]), zero past M, N and kend. kVec: 16-byte copies (K % 4
// == 0, N % 4 == 0, aligned bases; kend is K or a multiple of kBK, so a
// copy is all in or all out); else 4-byte ones.
template <bool kVec>
__device__ __forceinline__ void load_slab(float* as, float* bs,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w, int M,
                                          int K, int N, int m0, int n0,
                                          int k0, int kend) {
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / 4 / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e >> 3, c = (e & 7) * 4;
      const bool in = m0 + r < M && k0 + c < kend;
      sgemm::cp_async16(as + r * kLDA + c,
                        in ? x + (size_t)(m0 + r) * K + k0 + c : x,
                        in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / 4 / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e >> 5, c = (e & 31) * 4;
      const bool in = k0 + r < kend && n0 + c < N;
      sgemm::cp_async16(bs + r * kLDB + c,
                        in ? w + (size_t)(k0 + r) * N + n0 + c : w,
                        in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e >> 5, c = e & 31;
      const bool in = m0 + r < M && k0 + c < kend;
      sgemm::cp_async4(as + r * kLDA + c,
                       in ? x + (size_t)(m0 + r) * K + k0 + c : x,
                       in ? 4 : 0);
    }
#pragma unroll 4
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e >> 7, c = e & 127;
      const bool in = k0 + r < kend && n0 + c < N;
      sgemm::cp_async4(bs + r * kLDB + c,
                       in ? w + (size_t)(k0 + r) * N + n0 + c : w,
                       in ? 4 : 0);
    }
  }
}

// out[row][col] for the warp's accumulator (mma C fragments), inside
// (M, N); 8-byte stores where N is even
__device__ __forceinline__ void store_frags(float* __restrict__ out,
                                            const float (&acc)[4][4][4],
                                            int M, int N, int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      float* o = out + (size_t)row * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
        const float u = acc[mt][nt][2 * h], v = acc[mt][nt][2 * h + 1];
        if (col + 1 < N && N % 2 == 0) {
          *reinterpret_cast<float2*>(o + col) = make_float2(u, v);
        } else {
          if (col < N) o[col] = u;
          if (col + 1 < N) o[col + 1] = v;
        }
      }
    }
}

}  // namespace tc

// One 128 x 128 output tile of K5 over the depth [z * depth, (z + 1) *
// depth) of K, as lora_gemm_kernel: one split adds the expand and writes
// y; more write the partial tile to part[z] for lora_split_reduce_kernel.
template <bool kVec>
__global__ void __launch_bounds__(tc::kThreads, 2)
lora_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const Adapter<false> ad, const float* __restrict__ z,
               float* __restrict__ y, float* __restrict__ part, int M,
               int K, int N, int R, int depth) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + tc::kStages * tc::kAFloats;
  const int m0 = blockIdx.y * tc::kBM, n0 = blockIdx.x * tc::kBN;
  const int kbeg = blockIdx.z * depth, kend = min(K, kbeg + depth);
  const int slabs = kend > kbeg ? (kend - kbeg + tc::kBK - 1) / tc::kBK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;  // the warp's tile
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < tc::kStages - 1; ++st) {
    if (st < slabs)
      tc::load_slab<kVec>(as + st * tc::kAFloats, bs + st * tc::kBFloats, x,
                          w, M, K, N, m0, n0, kbeg + st * tc::kBK, kend);
    sgemm::cp_async_commit();       // empty groups keep the count uniform
  }
  for (int it = 0; it < slabs; ++it) {
    sgemm::cp_async_wait<tc::kStages - 2>();   // slab it has landed
    __syncthreads();                           // ... for all; slab it-1 read
    const int nx = it + tc::kStages - 1;
    if (nx < slabs) {
      const int st = nx % tc::kStages;
      tc::load_slab<kVec>(as + st * tc::kAFloats, bs + st * tc::kBFloats, x,
                          w, M, K, N, m0, n0, kbeg + nx * tc::kBK, kend);
    }
    sgemm::cp_async_commit();
    const float* a = as + (it % tc::kStages) * tc::kAFloats + wr * tc::kLDA;
    const float* b = bs + (it % tc::kStages) * tc::kBFloats + wc;
#pragma unroll
    for (int kk = 0; kk < tc::kBK / 8; ++kk) {
      tf32x3::FragA fa[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        fa[mt] = tf32x3::load_a_rows(a + mt * 16 * tc::kLDA, tc::kLDA,
                                     8 * kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const tf32x3::FragB fb =
            tf32x3::load_b_cols(b + nt * 8, tc::kLDB, 8 * kk, g, t);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) tf32x3::mma3(acc[mt][nt], fa[mt], fb);
      }
    }
  }
  sgemm::cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the epilogue

  if (gridDim.z > 1) {
    tc::store_frags(part + (size_t)blockIdx.z * M * N, acc, M, N, m0 + wr,
                    n0 + wc);
    return;
  }
  // acc += s * z[row] . B[col], r in order (the IEEE arithmetic of
  // expand_tile): the tile's z rows (times s) and B's rows staged r-major
  // in chunks of kR, each read from contiguous memory
  float* zs = smem;                 // zs[m * kLDE + r]
  float* bt = smem + tc::kBM * tc::kLDE;   // bt[n * kLDE + r]
  for (int r0 = 0; r0 < R; r0 += tc::kR) {
    __syncthreads();                // the last chunk read by all
    for (int e = threadIdx.x; e < tc::kBM * tc::kR; e += tc::kThreads) {
      const int m = e / tc::kR, r = e % tc::kR;
      zs[m * tc::kLDE + r] = (m0 + m < M && r0 + r < R)
                                 ? ad.scale * z[(size_t)(m0 + m) * R + r0 + r]
                                 : 0.f;
      bt[m * tc::kLDE + r] = (n0 + m < N && r0 + r < R)
                                 ? ad.b[(size_t)(n0 + m) * R + r0 + r]
                                 : 0.f;
    }
    __syncthreads();
    const int rn = min(tc::kR, R - r0);
#pragma unroll 1
    for (int r = 0; r < rn; ++r) {
      float zr[4][2], bc[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          zr[mt][h] = zs[(wr + mt * 16 + g + 8 * h) * tc::kLDE + r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          bc[nt][c] = bt[(wc + nt * 8 + 2 * t + c) * tc::kLDE + r];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] =
                fmaf(zr[mt][e >> 1], bc[nt][e & 1], acc[mt][nt][e]);
    }
  }
  tc::store_frags(y, acc, M, N, m0 + wr, n0 + wc);
}

// K5's base product above 32 rows: the host planner's split
// (lora_apply.py::plan_gemm_tc): 128 x 128 tiles, `splits` ranges of K,
// each `depth` deep (a multiple of the slab) but the last. Refused unless
// the splits cover K exactly.
int launch_tc(const float* x, const float* w, const Adapter<false>& ad,
              const float* z, float* y, float* part, int M, int K, int N,
              int R, int bm, int bn, int splits, int depth, cudaStream_t s) {
  const bool covers =
      bm == tc::kBM && bn == tc::kBN && splits >= 1 && depth > 0 &&
      depth % tc::kBK == 0 && (long long)splits * depth >= K &&
      (splits == 1 || ((long long)(splits - 1) * depth < K && part));
  if (!covers || (M + tc::kBM - 1) / tc::kBM > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  // the ring's shared memory, granted once a device (setting it costs the
  // host about a launch)
  constexpr int kDevices = 16;
  static bool granted[2][kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !granted[vec][dev]) {
    err = cudaFuncSetAttribute(
        vec ? lora_tc_kernel<true> : lora_tc_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) granted[vec][dev] = true;
  }
  dim3 grid((N + tc::kBN - 1) / tc::kBN, (M + tc::kBM - 1) / tc::kBM, splits);
  if (vec)
    lora_tc_kernel<true><<<grid, tc::kThreads, tc::kSmemBytes, s>>>(
        x, w, ad, z, y, part, M, K, N, R, depth);
  else
    lora_tc_kernel<false><<<grid, tc::kThreads, tc::kSmemBytes, s>>>(
        x, w, ad, z, y, part, M, K, N, R, depth);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 rgrid((N + 63) / 64, (M + 63) / 64);
    lora_split_reduce_kernel<false, false><<<rgrid, sgemm::kThreads, 0, s>>>(
        part, splits, ad, z, y, M, N, R, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NG, bool kPaged, bool kBf16>
void launch_gemv(const Elem<kBf16>* x, const Elem<kBf16>* w,
                 const Adapter<kBf16>& ad, const float* z, Elem<kBf16>* y,
                 int M, int K, int N, int R, int vec, cudaStream_t s) {
  dim3 grid((N + 4 * NG - 1) / (4 * NG), (M + kGemvRows - 1) / kGemvRows);
  lora_gemv_kernel<NG, kPaged, kBf16><<<grid, kThreads, 0, s>>>(
      x, w, ad, z, y, M, K, N, R, vec);
}

// The shrink, then the base product with the expand in its epilogue. The
// plan (bm, bn, splits, depth, part) is read only for M > 32.
template <bool kPaged, bool kBf16>
int lora_apply_launch(const Elem<kBf16>* x, const Elem<kBf16>* w,
                      const Adapter<kBf16>& ad, float* z, Elem<kBf16>* y,
                      float* part, int M, int K, int N, int R, int bm, int bn,
                      int splits, int depth, cudaStream_t s) {
  constexpr int kAlign = 4 * sizeof(Elem<kBf16>);   // a 4-element load
  if (M <= 0 || N <= 0) return 0;
  if (R > 0) {
    const int vec_a = (K % 4 == 0) && (ad.a_stride % 4 == 0) &&
                      ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(ad.a)) % kAlign == 0);
    dim3 grid(M, (R + kShrinkWarps - 1) / kShrinkWarps);
    lora_shrink_kernel<kPaged, kBf16><<<grid, kThreads, 0, s>>>(x, ad, z, M,
                                                                K, R, vec_a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (M > kGemvMaxRows) {
    if constexpr (kPaged)
      return launch_sgemm<true, kBf16>(x, w, ad, z, y, part, M, K, N, R, bm,
                                       bn, splits, depth, s);
    else
      return launch_tc(x, w, ad, z, y, part, M, K, N, R, bm, bn, splits,
                       depth, s);
  }
  const int vec_w =
      (N % 4 == 0) && reinterpret_cast<uintptr_t>(w) % kAlign == 0;
  const int row_blocks = (M + kGemvRows - 1) / kGemvRows;
  // widest column tile that still gives every SM a block (132 SMs)
  if ((N + 31) / 32 * row_blocks >= 132)
    launch_gemv<8, kPaged, kBf16>(x, w, ad, z, y, M, K, N, R, vec_w, s);
  else if ((N + 15) / 16 * row_blocks >= 132)
    launch_gemv<4, kPaged, kBf16>(x, w, ad, z, y, M, K, N, R, vec_w, s);
  else
    launch_gemv<2, kPaged, kBf16>(x, w, ad, z, y, M, K, N, R, vec_w, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: one call = two launches on `stream` (shrink, then GEMV or SGEMM),
// three with a split over K (the SGEMM, then the partials' sum). part is
// the (splits, M, N) workspace, null for one split.
extern "C" int batched_lora_apply_f32(const float* x, const float* w,
                                      const float* a, const float* b,
                                      const float* scales, const int* ids,
                                      float* z, float* y, float* part, int M,
                                      int K, int N, int R, int P,
                                      long long a_stride, long long b_stride,
                                      int bm, int bn, int splits, int depth,
                                      void* stream) {
  const Adapter<false> ad{a, b, scales, ids, a_stride, b_stride, P, 0.f};
  return lora_apply_launch<true, false>(x, w, ad, z, y, part, M, K, N, R, bm,
                                        bn, splits, depth,
                                        static_cast<cudaStream_t>(stream));
}

// K4 in bf16: x, w, the A and B pages and y are __nv_bfloat16 (page
// strides in elements); scales, z and part f32, as for the f32 entry.
extern "C" int batched_lora_apply_bf16(const void* x, const void* w,
                                       const void* a, const void* b,
                                       const float* scales, const int* ids,
                                       float* z, void* y, float* part, int M,
                                       int K, int N, int R, int P,
                                       long long a_stride,
                                       long long b_stride, int bm, int bn,
                                       int splits, int depth, void* stream) {
  using B = __nv_bfloat16;
  const Adapter<true> ad{static_cast<const B*>(a), static_cast<const B*>(b),
                         scales, ids, a_stride, b_stride, P, 0.f};
  return lora_apply_launch<true, true>(
      static_cast<const B*>(x), static_cast<const B*>(w), ad, z,
      static_cast<B*>(y), part, M, K, N, R, bm, bn, splits, depth,
      static_cast<cudaStream_t>(stream));
}

// K5: x (M, K), W (K, N), A (R, K), B (N, R), both contiguous; z (M, R)
// scratch; y (M, N); part as for K4, the plan plan_gemm_tc's (128 x 128,
// depth a multiple of 32).
extern "C" int lora_apply_f32(const float* x, const float* w, const float* a,
                              const float* b, float* z, float* y, float* part,
                              int M, int K, int N, int R, float scale, int bm,
                              int bn, int splits, int depth, void* stream) {
  const Adapter<false> ad{a, b, nullptr, nullptr, 0, 0, 1, scale};
  return lora_apply_launch<false, false>(x, w, ad, z, y, part, M, K, N, R,
                                         bm, bn, splits, depth,
                                         static_cast<cudaStream_t>(stream));
}
