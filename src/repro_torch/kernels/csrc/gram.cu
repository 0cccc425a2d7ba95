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
// Design. The Pallas grid carried the depth sum through a sequential grid
// axis; Hopper's blocks run in no order, so each block owns one 64x64
// output tile and loops over the whole depth itself, staging 32-deep
// slabs of both operand panels in shared memory (each thread then does
// 4x4 register-blocked FMAs per staged depth step, reusing every loaded
// value 4 times from registers and 64 times from shared memory). No
// split-K and no atomics, so results are the same on every run. Only tiles
// on or above the diagonal are launched; each writes its values to both
// (i, j) and (j, i), and diagonal tiles write only i <= j, so the output
// is exactly symmetric (torch.linalg.eigh reads one triangle). Ragged R
// and depth extents are masked with zeros, which add nothing to a sum.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // output tile edge (R direction)
constexpr int kDepth = 32;           // depth slab staged per step
constexpr int kThreadsSide = 16;     // 16 x 16 threads
constexpr int kPerThread = kTile / kThreadsSide;   // 4 x 4 outputs each
constexpr int kThreads = kThreadsSide * kThreadsSide;

// LEFT: x is u (L, depth, R), element (k, i) at x[k*R + i].
// RIGHT: x is v (L, R, depth), element (k, i) at x[i*depth + k].
template <bool LEFT>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x, float* __restrict__ g, int depth,
            int rr, int tiles) {
  __shared__ float si[kDepth][kTile + 1];
  __shared__ float sj[kDepth][kTile + 1];
  const int layer = blockIdx.y;
  int t = blockIdx.x, bi = 0;       // linear index -> upper tile (bi <= bj)
  while (t >= tiles - bi) {
    t -= tiles - bi;
    ++bi;
  }
  const int bj = bi + t;
  const int i0 = bi * kTile, j0 = bj * kTile;
  const float* xl = x + (size_t)layer * depth * rr;
  const int tx = threadIdx.x % kThreadsSide;
  const int ty = threadIdx.x / kThreadsSide;

  float acc[kPerThread][kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p)
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) acc[p][q] = 0.0f;

  for (int k0 = 0; k0 < depth; k0 += kDepth) {
    for (int e = threadIdx.x; e < kDepth * kTile; e += kThreads) {
      int kk, ii;
      if (LEFT) {        // neighbouring threads along R (contiguous rows)
        kk = e / kTile;
        ii = e % kTile;
      } else {           // neighbouring threads along depth
        ii = e / kDepth;
        kk = e % kDepth;
      }
      const int k = k0 + kk;
      const int ri = i0 + ii, rj = j0 + ii;
      float vi = 0.0f, vj = 0.0f;
      if (k < depth) {
        if (ri < rr)
          vi = LEFT ? xl[(size_t)k * rr + ri] : xl[(size_t)ri * depth + k];
        if (rj < rr)
          vj = LEFT ? xl[(size_t)k * rr + rj] : xl[(size_t)rj * depth + k];
      }
      si[kk][ii] = vi;
      sj[kk][ii] = vj;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[kPerThread], b[kPerThread];
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        a[p] = si[kk][ty + kThreadsSide * p];
        b[p] = sj[kk][tx + kThreadsSide * p];
      }
#pragma unroll
      for (int p = 0; p < kPerThread; ++p)
#pragma unroll
        for (int q = 0; q < kPerThread; ++q)
          acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }

  float* gl = g + (size_t)layer * rr * rr;
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = i0 + ty + kThreadsSide * p;
      const int j = j0 + tx + kThreadsSide * q;
      if (i >= rr || j >= rr) continue;
      if (bi == bj && i > j) continue;   // (j, i) writes this one
      gl[(size_t)i * rr + j] = acc[p][q];
      gl[(size_t)j * rr + i] = acc[p][q];
    }
  }
}

template <bool LEFT>
int launch(const float* x, float* g, int layers, int depth, int rr,
           cudaStream_t stream) {
  if (layers == 0 || rr == 0) return 0;
  const int tiles = (rr + kTile - 1) / kTile;
  dim3 grid(tiles * (tiles + 1) / 2, layers);
  gram_kernel<LEFT><<<grid, kThreads, 0, stream>>>(x, g, depth, rr, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gram_left_f32(const float* u, float* g, int layers, int d,
                             int rr, cudaStream_t stream) {
  return launch<true>(u, g, layers, d, rr, stream);
}

extern "C" int gram_right_f32(const float* v, float* g, int layers, int n,
                              int rr, cudaStream_t stream) {
  return launch<false>(v, g, layers, n, rr, stream);
}
