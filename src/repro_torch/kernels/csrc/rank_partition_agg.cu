// K3: dense rank-partitioned aggregate (the paper's Eq. 8 as one
// contraction), f32.
//
// Replaces: src/repro/kernels/rank_partition_agg.py
//   rank_partition_agg_pallas         (bs (M, d, r) -> dW (d, n)) and
//   rank_partition_agg_layered_pallas (bs (L, M, d, r) -> dW (L, d, n)).
//
//   dW[l] = sum_m B[l, m] diag(omega[m]) A[l, m]
//   bs (L, M, d, r), as (L, M, r, n), omega (M, r) shared by all layers.
//
// omega is applied as given: no sqrt and no clamp (K1 takes
// sqrt(max(omega, 0)); here a negative weight subtracts). The Eq. 8
// fallback arrives as one more client (ops.py), and r is zero-padded by the
// wrapper; this kernel takes any r and ragged d / n.
//
// Bound on the card: f32 arithmetic. The contraction depth is only M*r
// (192 at the vit-base buckets), so each output element costs 2*M*r FLOP
// against one 4-byte write: about M*r/2 FLOP per byte of output, above the
// card's f32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP per byte) from
// M*r = 40 up. The products stay IEEE f32 FMAs on the CUDA cores (the
// reference contracts at Precision.HIGHEST): no TF32, no tensor cores.
//
// Design. The Pallas grid carried the client sum in a VMEM accumulator
// through a sequential grid axis; here one block owns one 64x64 output tile
// of one layer and walks the whole depth t = m*r + c itself, in order
// (client 0 first, rank columns in order), staging 16-deep slabs of
// (B * omega)^T and of A in shared memory. Each thread keeps a 4x4
// register tile and reads both operands as float4. The weight is folded
// into the B slab as it is staged (one multiply per element, as the
// reference scales its B tile), so the weighting costs no extra pass.
// No split over depth and no atomics: every launch gives the same bits.
// Ragged d, n and depth are masked with zeros, which add nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;             // output tile edge (d and n)
constexpr int kDepth = 16;            // depth slab staged per step
constexpr int kPad = 4;               // keeps float4 rows aligned, eases banks
constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
rank_partition_agg_kernel(const float* __restrict__ bs,
                          const float* __restrict__ as,
                          const float* __restrict__ omega,
                          float* __restrict__ out, int M, int d, int r,
                          int n) {
  __shared__ __align__(16) float sb[kDepth][kTile + kPad];   // (B w)^T
  __shared__ __align__(16) float sa[kDepth][kTile + kPad];   // A
  const int layer = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int depth = M * r;
  // B[l, m, i, c] at bl[(m*d + i)*r + c]; A[l, m, c, j] at al[t*n + j]
  const float* bl = bs + (size_t)layer * M * d * r;
  const float* al = as + (size_t)layer * depth * n;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int t0 = 0; t0 < depth; t0 += kDepth) {
    // neighbouring threads along depth: a client's rank columns are
    // contiguous in each row of B
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int ii = e / kDepth, kk = e % kDepth;
      const int t = t0 + kk, i = i0 + ii;
      float v = 0.f;
      if (t < depth && i < d) {
        const int m = t / r, c = t - m * r;
        v = bl[((size_t)m * d + i) * r + c] * omega[t];
      }
      sb[kk][ii] = v;
    }
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int kk = e / kTile, jj = e % kTile;
      const int t = t0 + kk, j = j0 + jj;
      sa[kk][jj] = (t < depth && j < n) ? al[(size_t)t * n + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][ty * 4]);
      const float4 av = *reinterpret_cast<const float4*>(&sa[kk][tx * 4]);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(b4[p], a4[q], acc[p][q]);
    }
    __syncthreads();
  }

  float* ol = out + (size_t)layer * d * n;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
    if (i >= d) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < n) ol[(size_t)i * n + j] = acc[p][q];
    }
  }
}

}  // namespace

// One launch on `stream`: grid (n tiles, d tiles, layers). The
// single-layer entry of the wrapper calls it with layers = 1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the grid cannot
// hold.
extern "C" int rank_partition_agg_f32(const float* bs, const float* as,
                                      const float* omega, float* out,
                                      int layers, int M, int d, int r, int n,
                                      void* stream) {
  if (layers < 0 || M < 0 || d < 0 || r < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (layers == 0 || d == 0 || n == 0) return 0;
  const int d_tiles = (d + kTile - 1) / kTile;
  if (d_tiles > 65535 || layers > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kTile - 1) / kTile, d_tiles, layers);
  rank_partition_agg_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      bs, as, omega, out, M, d, r, n);
  return (int)cudaGetLastError();
}
