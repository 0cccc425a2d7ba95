// K4: paged multi-adapter LoRA apply (the serving engine's q/k/v/o
// projections), and K5: the single-adapter fused LoRA apply; f32.
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
// A (R, K), B (N, R) and a scalar s. It runs the same device code as K4
// instantiated with kPaged = false: no ids, no page gather, the scale a
// kernel argument. The TPU kernel kept z = x A^T in a VMEM scratch across
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
// the caller's stream:
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
//      - M > 32 (prefill): lora_gemm_kernel, a 64x64 output tile per block
//        over the whole K in 16-deep shared-memory slabs, a 4x4 register
//        tile per thread. At 128 rows it is bound by f32 operations.
// Every product is an IEEE f32 FMA (no TF32). A row whose page id lies
// outside [0, P) gets NaN in every column: the wrapper does not read ids
// back to the host, so a bad id shows in the output instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The adapter side of one call: pages and ids (K4), or one adapter at page
// 0 with the scale by value (K5).
struct Adapter {
  const float* a;           // A pages, a_stride floats apart
  const float* b;           // B pages, b_stride floats apart
  const float* scales;      // (P,) for K4
  const int* ids;           // (M,) page per row for K4
  long long a_stride, b_stride;
  int P;
  float scale;              // K5's scale
};

// page of a row, or -1 for an id outside [0, P)
template <bool kPaged>
__device__ __forceinline__ int page_of(const Adapter& ad, int row) {
  if (!kPaged) return 0;
  const int p = ad.ids[row];
  return (p < 0 || p >= ad.P) ? -1 : p;
}

template <bool kPaged>
__device__ __forceinline__ float scale_of(const Adapter& ad, int p) {
  return kPaged ? ad.scales[p] : ad.scale;
}

constexpr int kThreads = 256;
constexpr int kShrinkWarps = kThreads / 32;
constexpr int kGemvRows = 8;
constexpr int kGemvChunk = 1024;           // x rows staged per chunk of K

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

template <bool kPaged>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const float* __restrict__ x, const Adapter ad,
                   float* __restrict__ z, int M, int K, int R, int vec) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.y * kShrinkWarps + warp;
  if (t >= M || j >= R) return;
  const int p = page_of<kPaged>(ad, t);
  if (p < 0) {
    if (lane == 0) z[(size_t)t * R + j] = nan_f32();
    return;
  }
  const float* xr = x + (size_t)t * K;
  const float* ar = ad.a + (size_t)p * ad.a_stride + (size_t)j * K;
  float acc = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    for (int k = lane; k < K / 4; k += 32) {
      const float4 u = x4[k], v = a4[k];
      acc = fmaf(u.x, v.x, acc);
      acc = fmaf(u.y, v.y, acc);
      acc = fmaf(u.z, v.z, acc);
      acc = fmaf(u.w, v.w, acc);
    }
  } else {
    for (int k = lane; k < K; k += 32) acc = fmaf(xr[k], ar[k], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) z[(size_t)t * R + j] = acc;
}

// acc + s_p * (z[row] . B_p[col])
template <bool kPaged>
__device__ __forceinline__ float expand(float acc, int row, int col,
                                        const Adapter& ad,
                                        const float* __restrict__ z, int R) {
  const int p = page_of<kPaged>(ad, row);
  if (p < 0) return nan_f32();
  const float* zr = z + (size_t)row * R;
  const float* br = ad.b + (size_t)p * ad.b_stride + (size_t)col * R;
  float d = 0.f;
  for (int j = 0; j < R; ++j) d = fmaf(zr[j], br[j], d);
  return fmaf(scale_of<kPaged>(ad, p), d, acc);
}

template <int NG, bool kPaged>
__global__ void __launch_bounds__(kThreads)
lora_gemv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const Adapter ad, const float* __restrict__ z,
                 float* __restrict__ y, int M, int K, int N, int R, int vec) {
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
                    ? x[(size_t)(m0 + m) * K + kc + k] : 0.f;
    }
    __syncthreads();
    const float* wk = w + (size_t)kc * N;
#pragma unroll 4
    for (int k = ks; k < kn; k += KS) {
      float wv[4];
      if (vec && n0 < N) {
        const float4 v = *reinterpret_cast<const float4*>(wk + (size_t)k * N + n0);
        wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wv[c] = (n0 + c < N) ? wk[(size_t)k * N + n0 + c] : 0.f;
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
      y[(size_t)row * N + col] = expand<kPaged>(s, row, col, ad, z, R);
  }
}

constexpr int kTileM = 64, kTileN = 64, kTileK = 16, kRegM = 4, kRegN = 4;

template <bool kPaged>
__global__ void __launch_bounds__(kThreads)
lora_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const Adapter ad, const float* __restrict__ z,
                 float* __restrict__ y, int M, int K, int N, int R) {
  __shared__ float xs[kTileK][kTileM + 1];               // x tile, transposed
  __shared__ __align__(16) float ws[kTileK][kTileN];
  const int tid = threadIdx.x;
  const int tx = tid % (kTileN / kRegN), ty = tid / (kTileN / kRegN);
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  float acc[kRegM][kRegN];
#pragma unroll
  for (int i = 0; i < kRegM; ++i)
#pragma unroll
    for (int j = 0; j < kRegN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int e = tid; e < kTileM * kTileK; e += kThreads) {
      const int m = e / kTileK, k = e % kTileK;
      xs[k][m] = (m0 + m < M && k0 + k < K)
                     ? x[(size_t)(m0 + m) * K + k0 + k] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kTileK * kTileN; e += kThreads) {
      const int k = e / kTileN, n = e % kTileN;
      ws[k][n] = (k0 + k < K && n0 + n < N)
                     ? w[(size_t)(k0 + k) * N + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float xv[kRegM];
#pragma unroll
      for (int i = 0; i < kRegM; ++i) xv[i] = xs[k][ty * kRegM + i];
      const float4 wv = *reinterpret_cast<const float4*>(&ws[k][tx * kRegN]);
      const float wr[kRegN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < kRegM; ++i)
#pragma unroll
        for (int j = 0; j < kRegN; ++j)
          acc[i][j] = fmaf(xv[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRegM; ++i) {
    const int row = m0 + ty * kRegM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kRegN; ++j) {
      const int col = n0 + tx * kRegN + j;
      if (col < N)
        y[(size_t)row * N + col] =
            expand<kPaged>(acc[i][j], row, col, ad, z, R);
    }
  }
}

template <int NG, bool kPaged>
void launch_gemv(const float* x, const float* w, const Adapter& ad,
                 const float* z, float* y, int M, int K, int N, int R,
                 int vec, cudaStream_t s) {
  dim3 grid((N + 4 * NG - 1) / (4 * NG), (M + kGemvRows - 1) / kGemvRows);
  lora_gemv_kernel<NG, kPaged><<<grid, kThreads, 0, s>>>(x, w, ad, z, y, M,
                                                         K, N, R, vec);
}

// The shrink, then the base product with the expand in its epilogue.
template <bool kPaged>
int lora_apply_launch(const float* x, const float* w, const Adapter& ad,
                      float* z, float* y, int M, int K, int N, int R,
                      cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  if (R > 0) {
    const int vec_a = (K % 4 == 0) && (ad.a_stride % 4 == 0) &&
                      ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(ad.a)) % 16 == 0);
    dim3 grid(M, (R + kShrinkWarps - 1) / kShrinkWarps);
    lora_shrink_kernel<kPaged><<<grid, kThreads, 0, s>>>(x, ad, z, M, K, R,
                                                         vec_a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (M <= 32) {
    const int vec_w = (N % 4 == 0) &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const int row_blocks = (M + kGemvRows - 1) / kGemvRows;
    // widest column tile that still gives every SM a block (132 SMs)
    if ((N + 31) / 32 * row_blocks >= 132)
      launch_gemv<8, kPaged>(x, w, ad, z, y, M, K, N, R, vec_w, s);
    else if ((N + 15) / 16 * row_blocks >= 132)
      launch_gemv<4, kPaged>(x, w, ad, z, y, M, K, N, R, vec_w, s);
    else
      launch_gemv<2, kPaged>(x, w, ad, z, y, M, K, N, R, vec_w, s);
  } else {
    dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    lora_gemm_kernel<kPaged><<<grid, kThreads, 0, s>>>(x, w, ad, z, y, M, K,
                                                       N, R);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: one call = two launches on `stream` (shrink, then GEMV or SGEMM).
extern "C" int batched_lora_apply_f32(const float* x, const float* w,
                                      const float* a, const float* b,
                                      const float* scales, const int* ids,
                                      float* z, float* y, int M, int K,
                                      int N, int R, int P,
                                      long long a_stride, long long b_stride,
                                      void* stream) {
  const Adapter ad{a, b, scales, ids, a_stride, b_stride, P, 0.f};
  return lora_apply_launch<true>(x, w, ad, z, y, M, K, N, R,
                                 static_cast<cudaStream_t>(stream));
}

// K5: x (M, K), W (K, N), A (R, K), B (N, R), both contiguous; z (M, R)
// scratch; y (M, N).
extern "C" int lora_apply_f32(const float* x, const float* w, const float* a,
                              const float* b, float* z, float* y, int M,
                              int K, int N, int R, float scale,
                              void* stream) {
  const Adapter ad{a, b, nullptr, nullptr, 0, 0, 1, scale};
  return lora_apply_launch<false>(x, w, ad, z, y, M, K, N, R,
                                  static_cast<cudaStream_t>(stream));
}
