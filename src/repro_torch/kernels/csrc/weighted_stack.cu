// K1: sqrt(omega)-weighted client factor stacks of the fused factored
// aggregation (DESIGN.md section 4.3).
//
// Replaces: src/repro/kernels/rank_partition_agg.py
//   weighted_stack_b_layered_pallas (U_c) and
//   weighted_stack_a_layered_pallas (V_c).
//
//   stack_b: bs (L, M, d, r), omega (M, r) -> u (L, d, M*r)
//            u[l, i, m*r + c] = bs[l, m, i, c] * sqrt(max(omega[m, c], 0))
//   stack_a: as (L, M, r, n), omega (M, r) -> v (L, M*r, n)
//            v[l, m*r + c, k] = as[l, m, c, k] * sqrt(max(omega[m, c], 0))
//
// Bound on the card: bytes. Each element is read once and written once
// (L*M*r*(d or n)*4 bytes each way) with one multiply, far below the
// ~20 FLOP/byte where f32 arithmetic would bind. The design therefore
// only has to keep the traffic coalesced: one block per (layer, client,
// tile), neighbouring threads on neighbouring addresses on both the read
// and the write side (client m's r columns are contiguous in each output
// row of u; stack_a's input and output share one flat layout). Ragged d / n
// extents are masked, so the inputs are never padded. Arithmetic is
// IEEE sqrtf and one f32 multiply, bit-identical to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsB = 32;    // stack_b: rows of one client per block
constexpr int kColsA = 256;   // stack_a: columns of one client per block

__global__ void stack_b_kernel(const float* __restrict__ bs,
                               const float* __restrict__ omega,
                               float* __restrict__ u, int m, int d, int r) {
  const int client = blockIdx.y;
  const int layer = blockIdx.z;
  const int row0 = blockIdx.x * kRowsB;
  const float* src = bs + ((size_t)layer * m + client) * (size_t)d * r;
  float* dst = u + (size_t)layer * d * (size_t)(m * r);
  const float* om = omega + (size_t)client * r;
  const int rows = min(kRowsB, d - row0);
  for (int e = threadIdx.x; e < rows * r; e += kThreads) {
    const int i = row0 + e / r;
    const int c = e % r;
    const float w = sqrtf(fmaxf(om[c], 0.0f));
    dst[(size_t)i * (m * r) + (size_t)client * r + c] =
        src[(size_t)i * r + c] * w;
  }
}

__global__ void stack_a_kernel(const float* __restrict__ as,
                               const float* __restrict__ omega,
                               float* __restrict__ v, int m, int r, int n) {
  const int client = blockIdx.y;
  const int layer = blockIdx.z;
  const int col0 = blockIdx.x * kColsA;
  // (L, M, r, n) and (L, M*r, n) share one flat layout
  const size_t base = ((size_t)layer * m + client) * (size_t)r * n;
  const float* om = omega + (size_t)client * r;
  const int cols = min(kColsA, n - col0);
  for (int e = threadIdx.x; e < r * cols; e += kThreads) {
    const int c = e / cols;
    const int k = col0 + e % cols;
    const float w = sqrtf(fmaxf(om[c], 0.0f));
    const size_t at = base + (size_t)c * n + k;
    v[at] = as[at] * w;
  }
}

}  // namespace

extern "C" int weighted_stack_b_f32(const float* bs, const float* omega,
                                    float* u, int layers, int m, int d, int r,
                                    cudaStream_t stream) {
  if (layers == 0 || m == 0 || d == 0 || r == 0) return 0;
  dim3 grid((d + kRowsB - 1) / kRowsB, m, layers);
  stack_b_kernel<<<grid, kThreads, 0, stream>>>(bs, omega, u, m, d, r);
  return (int)cudaGetLastError();
}

extern "C" int weighted_stack_a_f32(const float* as, const float* omega,
                                    float* v, int layers, int m, int r, int n,
                                    cudaStream_t stream) {
  if (layers == 0 || m == 0 || r == 0 || n == 0) return 0;
  dim3 grid((n + kColsA - 1) / kColsA, m, layers);
  stack_a_kernel<<<grid, kThreads, 0, stream>>>(as, omega, v, m, r, n);
  return (int)cudaGetLastError();
}
