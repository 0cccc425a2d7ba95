// K2: (R x R) Gram cores of the fused factored aggregation
// (DESIGN.md section 4.3), the input of core/svd.py::svd_realloc_gram.
//
// Replaces: src/repro/kernels/rank_partition_agg.py
//   gram_left_layered_pallas  (G_u = U_c^T U_c, u (L, d, R)) and
//   gram_right_layered_pallas (G_v = V_c V_c^T, v (L, R, n)).
//
// Bound on the card: f32 arithmetic. G is symmetric, so each layer needs
// its R(R+1)/2 distinct dot products of depth FMAs each (L*depth*R*(R+1)
// FLOP, ~1.37 GFLOP per side at the vit-base attention bucket) on
// L*depth*R*4 input bytes, about R/4 FLOP per byte -- above the card's f32
// ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP per byte) for R = 192. The
// products stay IEEE f32 FMAs on the CUDA cores: no TF32 and no tensor
// cores, because the Gram route already spends half the f32 mantissa
// (svd.py, DESIGN.md section 4.3).
//
// Design: the SGEMM mainloop of sgemm_f32.cuh on 64 x 64 tiles (4 x 4
// registers a thread, a 3-stage ring of 16-deep slabs). Left, U_c is
// k-major in memory and both sides go by cp.async; right, V_c is
// row-major along the depth and both sides are staged through registers
// (four threads to a row's 64 bytes, so a warp's loads touch 8 rows, not
// 32) and stored transposed. Only the tiles on or above the diagonal are
// launched (the reference's pl.when(j >= i)); a diagonal tile loads one
// panel and points both sides at it. The Pallas grid carried the depth sum
// through a sequential grid axis; here the host planner
// (gemm_plan.py::plan_gram) splits the depth where the (layer, tile) blocks
// alone would not fill the card (the vit-base round's up and down
// buckets: 72 blocks over a depth of 3072), and the last block of each
// tile to finish sums the partials in split order (sgemm::split_sum): one
// launch, no atomics on the values, the same bits on every run. The tile
// is staged in shared memory and written to both (i, j) and (j, i) with
// coalesced stores; a diagonal tile writes its i <= j values to both, so
// the output is exactly symmetric (torch.linalg.eigh reads one triangle).
// Ragged R and depth extents are zero-filled, which adds nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_f32.cuh"

namespace {

constexpr int kTile = 64;                // gemm_plan.py's GRAM_TILE
using T = sgemm::Tile<kTile, kTile>;
constexpr int kLd = kTile + 1;           // staged tile row: conflict-free
static_assert(kTile * kLd * 4 <= T::kRingBytes, "the tile fits the ring");

// LEFT: x is u (L, depth, R), element (k, i) at x[k*R + i].
// RIGHT: x is v (L, R, depth), element (i, k) at x[i*depth + k].
// Grid (upper tiles, splits, layers); splits ranges of `split` depth.
// __launch_bounds__(256, 4): at most 64 registers, four blocks an SM.
template <bool LEFT, bool kVec>
__global__ void __launch_bounds__(sgemm::kThreads, 4)
gram_kernel(const float* __restrict__ x, float* __restrict__ g,
            float* __restrict__ part, unsigned* __restrict__ count,
            int depth, int rr, int tiles, int split) {
  __shared__ __align__(16) float smem[T::kRingBytes / 4];
  const int layer = blockIdx.z;
  int t = blockIdx.x, bi = 0;       // linear index -> upper tile (bi <= bj)
  while (t >= tiles - bi) {
    t -= tiles - bi;
    ++bi;
  }
  const int bj = bi + t;
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int kbeg = blockIdx.y * split, kend = min(depth, kbeg + split);
  const sgemm::SlabRun slabs{
      kbeg, kend > kbeg ? (kend - kbeg + sgemm::kBK - 1) / sgemm::kBK : 0};
  const float* xl = x + (size_t)layer * depth * rr;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  if constexpr (LEFT) {
    sgemm::mainloop_sides<T, sgemm::KMajor<kTile, T::LDX, kVec>,
                          sgemm::KMajor<kTile, T::LDW, kVec>, sgemm::SlabRun,
                          true>(
        smem, {xl, rr, i0}, {xl, rr, j0}, slabs, kend, acc, bi == bj);
  } else {
    using X = sgemm::AlongK<kTile, T::LDX, kVec, true>;
    using W = sgemm::AlongK<kTile, T::LDW, kVec, true>;
    sgemm::mainloop_sides<T, X, W, sgemm::SlabRun, true>(
        smem, X(xl, rr, depth, i0), W(xl, rr, depth, j0), slabs, kend, acc,
        bi == bj);
  }
  if (!sgemm::split_sum<T>(acc, part, count,
                           layer * gridDim.x + blockIdx.x,
                           gridDim.x * gridDim.z, blockIdx.y, gridDim.y))
    return;

  // stage the tile (the ring is free), then write (i0 + a, j0 + b) and its
  // mirror (j0 + b, i0 + a), neighbouring threads on neighbouring columns
  const int ty = sgemm::grid_row(), tx = sgemm::grid_col();
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      smem[sgemm::tile_row(i, ty) * kLd + sgemm::tile_row(j, tx)] =
          acc[i][j];
  __syncthreads();
  float* gl = g + (size_t)layer * rr * rr;
  const bool diag = bi == bj;
  for (int e = threadIdx.x; e < kTile * kTile; e += sgemm::kThreads) {
    const int a = e / kTile, b = e % kTile;
    const int i = i0 + a, j = j0 + b;
    if (i < rr && j < rr)
      gl[(size_t)i * rr + j] =
          diag && a > b ? smem[b * kLd + a] : smem[a * kLd + b];
    // mirror row j0 + a, column i0 + b: the tile's (b, a)
    if (!diag && j0 + a < rr && i0 + b < rr)
      gl[(size_t)(j0 + a) * rr + i0 + b] = smem[b * kLd + a];
  }
}

// The host planner's choice: `splits` ranges of `split` depth (a multiple
// of the slab) but the last. Refused unless the splits cover the depth
// exactly, and with more than one split unless part and count are given.
template <bool LEFT>
int launch(const float* x, float* g, float* part, unsigned* count,
           int layers, int depth, int rr, int splits, int split,
           cudaStream_t stream) {
  if (layers < 0 || depth < 0 || rr < 0) return (int)cudaErrorInvalidValue;
  if (layers == 0 || rr == 0) return 0;
  const bool covers =
      splits >= 1 && split > 0 && split % sgemm::kBK == 0 &&
      (long long)splits * split >= depth &&
      (splits == 1 || ((long long)(splits - 1) * split < depth && part &&
                       count));
  const int tiles = (rr + kTile - 1) / kTile;
  if (!covers || layers > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(tiles * (tiles + 1) / 2, splits, layers);
  // kVec: the rows the copies read are 16-byte aligned
  const bool vec = (LEFT ? rr : depth) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    gram_kernel<LEFT, true><<<grid, sgemm::kThreads, 0, stream>>>(
        x, g, part, count, depth, rr, tiles, split);
  else
    gram_kernel<LEFT, false><<<grid, sgemm::kThreads, 0, stream>>>(
        x, g, part, count, depth, rr, tiles, split);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream` each. part: (splits, layers x upper tiles, 64 x
// 64) floats of workspace and count: layers x upper tiles counters, zero
// (and left zero), both only read with more than one split.
extern "C" int gram_left_f32(const float* u, float* g, float* part,
                             unsigned* count, int layers, int d, int rr,
                             int splits, int split, void* stream) {
  return launch<true>(u, g, part, count, layers, d, rr, splits, split,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int gram_right_f32(const float* v, float* g, float* part,
                              unsigned* count, int layers, int n, int rr,
                              int splits, int split, void* stream) {
  return launch<false>(v, g, part, count, layers, n, rr, splits, split,
                       static_cast<cudaStream_t>(stream));
}
