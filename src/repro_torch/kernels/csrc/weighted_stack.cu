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
// ~20 FLOP/byte where f32 arithmetic would bind, so the kernels are one
// coalesced memory pass:
//  - a block computes the M*r weights once, into shared memory (IEEE sqrtf
//    and one f32 multiply an element: bit-identical to the plain version);
//  - both kernels walk output rows, a thread keeping one column position
//    (and for stack_b its source offset and weights) for every row it
//    visits, so no element pays an index divide: stack_a's rows are
//    as's rows (one weight a row), stack_b's rows of u are M*r contiguous
//    floats gathered from the M client planes, r contiguous floats each;
//  - 16-byte loads and stores where r (stack_b) or n (stack_a) and the
//    pointers allow, 4-byte ones otherwise (ragged shapes);
//  - each block owns a contiguous range of rows and keeps kUnroll rows'
//    loads in flight; the host sizes the grid to one wave of resident
//    blocks (the threads an SM holds over the block's size, times SMs).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;      // rows a thread has in flight

template <int W> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float4 mul(float4 a, float4 w) {
  return make_float4(a.x * w.x, a.y * w.y, a.z * w.z, a.w * w.w);
}
__device__ __forceinline__ float4 mul(float4 a, float w) {
  return make_float4(a.x * w, a.y * w, a.z * w, a.w * w);
}
__device__ __forceinline__ float mul(float a, float w) { return a * w; }

// the M*r weights into shared memory, once a block
__device__ __forceinline__ void load_weights(float* ws, const float* omega,
                                             int mr) {
  for (int k = threadIdx.x; k < mr; k += blockDim.x)
    ws[k] = sqrtf(fmaxf(omega[k], 0.0f));
  __syncthreads();
}

// A block's threads in `rows_in_flight` groups of `lanes`: thread t takes
// column e0 = t % lanes (then e0 + lanes, ...) of rows rsub = t / lanes,
// rsub + R, ... of the block's range [row0, row1).
struct Walk {
  int lanes, R, rsub, e0;
  long long row0, row1;
  __device__ Walk(int per_row, long long rows, long long rows_per_block) {
    lanes = min(per_row, (int)blockDim.x);
    R = blockDim.x / lanes;
    rsub = threadIdx.x / lanes;
    e0 = threadIdx.x - rsub * lanes;
    row0 = (long long)blockIdx.x * rows_per_block;
    row1 = min(rows, row0 + rows_per_block);
  }
};

// stack_a: v and as share one flat layout of rows (l, m, c) of n floats;
// row j is scaled by ws[j mod M r], tracked as the rows advance
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
stack_a_kernel(const float* __restrict__ as, const float* __restrict__ omega,
               float* __restrict__ v, int mr, int n, long long rows,
               long long rows_per_block) {
  using T = typename Vec<W>::T;
  extern __shared__ float ws[];
  load_weights(ws, omega, mr);
  const int per_row = n / W;
  const Walk wk(per_row, rows, rows_per_block);
  if (wk.rsub >= wk.R) return;
  const T* src = reinterpret_cast<const T*>(as);
  T* dst = reinterpret_cast<T*>(v);
  long long row = wk.row0 + wk.rsub;
  int wr = (int)(row % mr);
  const int step = wk.R % mr;
  for (; row < wk.row1; row += (long long)kUnroll * wk.R) {
    float w[kUnroll];
    long long at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = ws[wr];
      at[u] = (row + (long long)u * wk.R) * per_row;
      wr += step;
      if (wr >= mr) wr -= mr;
    }
    for (int e = wk.e0; e < per_row; e += wk.lanes) {
      T a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + (long long)u * wk.R < wk.row1) a[u] = src[at[u] + e];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + (long long)u * wk.R < wk.row1) dst[at[u] + e] = mul(a[u], w[u]);
    }
  }
}

// stack_b: u's row (l, i) is M*r contiguous floats; its column c = m r +
// cc reads bs[l, m, i, cc]. A thread's column gives a fixed source offset
// m d r + cc and fixed weights; the row gives the base (l m d + i) r,
// tracked as the rows advance.
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
stack_b_kernel(const float* __restrict__ bs, const float* __restrict__ omega,
               float* __restrict__ u, int m, int d, int r, long long rows,
               long long rows_per_block) {
  using T = typename Vec<W>::T;
  extern __shared__ float ws[];
  const int mr = m * r;
  load_weights(ws, omega, mr);
  const int per_row = mr / W;
  const Walk wk(per_row, rows, rows_per_block);
  if (wk.rsub >= wk.R) return;
  for (int e = wk.e0; e < per_row; e += wk.lanes) {
    const int c = e * W, mm = c / r;          // once a column, not an element
    const long long off = (long long)mm * d * r + (c - mm * r);
    T w;
    if constexpr (W == 4) {
      w = make_float4(ws[c], ws[c + 1], ws[c + 2], ws[c + 3]);
    } else {
      w = ws[c];
    }
    long long row = wk.row0 + wk.rsub;
    long long l = row / d;
    int i = (int)(row - l * d);
    for (; row < wk.row1; row += (long long)kUnroll * wk.R) {
      long long at[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        at[k] = (l * m * d + i) * r + off;
        i += wk.R;
        while (i >= d) {
          i -= d;
          ++l;
        }
      }
      T a[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (row + (long long)k * wk.R < wk.row1)
          a[k] = *reinterpret_cast<const T*>(bs + at[k]);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (row + (long long)k * wk.R < wk.row1)
          *reinterpret_cast<T*>(u + (row + (long long)k * wk.R) * mr + c) =
              mul(a[k], w);
    }
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// threads a block: whole rows of per_row accesses, as many rows as fit in
// kMaxThreads (one row of kMaxThreads where a row is longer)
int block_threads(int per_row) {
  return per_row >= kMaxThreads ? kMaxThreads
                                : per_row * (kMaxThreads / per_row);
}

template <typename K, typename... Args>
int launch(K kernel, int per_row, long long rows, int mr, int sms,
           cudaStream_t stream, Args... args) {
  const int threads = block_threads(per_row);
  const int R = threads / std::min(per_row, threads);
  // one wave of resident blocks, each a contiguous range of rows
  const long long wave = (long long)sms * (2048 / threads);
  const long long blocks = std::max(
      1LL, std::min(wave, (rows + (long long)kUnroll * R - 1) /
                              ((long long)kUnroll * R)));
  const long long per_block = (rows + blocks - 1) / blocks;
  kernel<<<(unsigned)((rows + per_block - 1) / per_block), threads,
           mr * sizeof(float), stream>>>(args..., rows, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch each on `stream`; `sms`: the card's SMs, to size the grid.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape whose
// weights exceed a block's shared memory.
extern "C" int weighted_stack_b_f32(const float* bs, const float* omega,
                                    float* u, int layers, int m, int d, int r,
                                    int sms, cudaStream_t stream) {
  if (layers == 0 || m == 0 || d == 0 || r == 0) return 0;
  if ((size_t)m * r * sizeof(float) > 48 * 1024 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)layers * d;
  if (r % 4 == 0 && aligned16(bs, u))
    return launch(stack_b_kernel<4>, m * r / 4, rows, m * r, sms, stream, bs,
                  omega, u, m, d, r);
  return launch(stack_b_kernel<1>, m * r, rows, m * r, sms, stream, bs, omega,
                u, m, d, r);
}

extern "C" int weighted_stack_a_f32(const float* as, const float* omega,
                                    float* v, int layers, int m, int r, int n,
                                    int sms, cudaStream_t stream) {
  if (layers == 0 || m == 0 || r == 0 || n == 0) return 0;
  if ((size_t)m * r * sizeof(float) > 48 * 1024 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)layers * m * r;
  if (n % 4 == 0 && aligned16(as, v))
    return launch(stack_a_kernel<4>, n / 4, rows, m * r, sms, stream, as,
                  omega, v, m * r, n);
  return launch(stack_a_kernel<1>, n, rows, m * r, sms, stream, as, omega, v,
                m * r, n);
}
