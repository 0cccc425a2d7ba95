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
// A (R, K), B (N, R) and a scalar s. Its shrink and GEMV are K4's device
// code instantiated with kPaged = false: no ids, no page gather, the scale
// a kernel argument. The TPU kernel kept z = x A^T in a VMEM scratch
// across its K loop; here z goes to a small (M, R) buffer the wrapper
// allocates (M*R*4 bytes, 2 MB at 4096 rows and r = 128), written once by
// the shrink and read by the base product's epilogue.
//
// x (M, K), W (K, N), A pages (P, R, K), B pages (P, N, R), scales (P,),
// ids (M,) int32; each page is contiguous, pages lie a_stride / b_stride
// elements apart (so a per-layer slice of a layer-stacked adapter tree is
// passed without a copy).
//
// The TPU kernel sorted rows by page and padded each group to 8-row blocks
// so that a block had one page. Here every row reads its own page (as in
// BGMV), so there are no filler rows at all. One call runs two launches on
// the caller's stream (three on K4's f32 and K5's routes above 32 rows
// with a split over K):
//   1. lora_shrink_kernel: z[t, j] = x[t] . A_p[j], one warp per (t, j),
//      reduced by a fixed xor-shuffle tree (deterministic);
//   2. the base product x @ W with the expand term s_p * z[t] . B_p[n]
//      added in its epilogue, in IEEE f32 from the f32 z:
//      - M <= 32 (decode), both dtypes: lora_gemv_kernel. x @ W reads each
//        byte of W once for a few FMAs, so it is bound by W's bytes (51.4
//        MB a Qwen2-7B q projection in f32, 52.4 MB Llama-4's in bf16:
//        15.3 and 15.6 us at 3.35 TB/s), and reaching that rate takes
//        about 23 KB of loads in flight on each of the 132 SMs. A block
//        owns a strip of W 128 bytes wide (32 f32 or 64 bf16 columns: 8
//        lanes, 16 bytes each, neighbouring lanes on neighbouring bytes of
//        a row) over a range of K that the host plans
//        (gemm_plan.plan_gemv: strips x row blocks x splits cover the 132
//        SMs at every served shape); its 32 row-slices stream the
//        range 4 rows each a step (2 in the 8-row instances), the next
//        step's loads issued before this step's FMAs (16-32 KB in flight
//        a block at 4 rows, half that at 8). x's rows of the
//        range are read into shared memory once, as f32, while the first
//        loads fly; no barrier inside the stream. The 32 slices' sums meet
//        by an xor shuffle (within a warp) and through shared memory (the
//        8 warps, in warp order), and the splits by split_sum: the last
//        block of a tile to arrive adds the partials in split order, then
//        the expand;
//      - M > 32, K4 f32: lora_gemm_kernel, the f32 SGEMM of sgemm_f32.cuh
//        (128x128 or 64x128 output tiles, 8x8 / 4x8 register tiles, a
//        3-stage cp.async ring; a tile past M or N is zero-filled, so no
//        smaller tile is built). It is bound by f32 operations (K4's
//        Qwen2-7B prefill layer: 7.6 GFLOP against 0.47 GB). The planner
//        (gemm_plan.plan_gemm) splits K into S ranges, one block each:
//        the blocks write partial tiles to an (S, M, N) workspace and
//        lora_split_reduce_kernel sums them in split order, then adds the
//        expand. Epilogue: the tile's z rows and B_p's rows are staged in
//        shared memory from contiguous reads and summed by the same
//        register tile; K4 walks the tile's distinct pages;
//      - M > 32, K4 bf16: lora_mma_bf16_kernel, x @ W on the bf16 tensor
//        cores (mma.sync m16n8k16, f32 accumulators; mma_bf16.cuh): a
//        4-stage cp.async ring of 32-deep bf16 slabs (copies of bytes, no
//        conversion), fragments by ldmatrix (.trans for W, k-major), 128 x
//        128 or 64 x 64 tiles of 8 warps, a split over K planned by
//        gemm_plan.plan_gemm_bf16. The epilogue goes through the tile in
//        shared memory: split_sum_tile (the last block of a tile sums the
//        partials in split order), then expand_store (a column a thread,
//        the expand in IEEE f32 from the f32 z, y rounded once). mma.sync
//        and not wgmma: at the path's 128 rows the layer does 117 FLOP a
//        byte of W, under the 295 at which the H100's bf16 tensor cores
//        (at wgmma's full rate) and not its memory would set the pace;
//        wgmma and TMA are left for a bf16 prefill long enough to be bound
//        by operations (the mainloop still runs short of W's stream at 128
//        rows: PERF.md, section 7);
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
// x, W and the A and B pages as __nv_bfloat16: the shrink, the GEMV's W
// stream and the expand convert in registers (a bf16 to f32 conversion is
// a 16-bit shift), the GEMV's x range on its way into shared memory, and
// above 32 rows the tensor cores take the bf16 operands as they are. The
// products of bf16 values are exact in f32 and summed in f32, scales stay
// f32, z and the split partials stay f32, and y is rounded to bf16 once,
// when it is stored: the reference kernel's arithmetic (each tile upcast,
// an f32 dot at Precision.HIGHEST, the output written in x's dtype), its
// sums in another order.
//
// Every sum has one fixed order (no atomic adds), so a repeat gives the
// same bits. K4's f32 products and K5's shrink and expand are IEEE f32
// FMAs (no TF32). A row's page id is taken as the reference's gathers
// take it (ref.py's a_pages[ids]): a negative id counts from the end, then
// the id is clamped to [0, P), on the device, with no read to the host.
#include <climits>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "sgemm_f32.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The operand element type of an instance: f32, or bf16 (kBf16)
template <bool kBf16>
using Elem = std::conditional_t<kBf16, bf16, float>;

__device__ __forceinline__ float bf16_bits_to_float(unsigned h) {
  return __uint_as_float(h << 16);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) {
  return bf16_bits_to_float(*reinterpret_cast<const unsigned short*>(&v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// 4 consecutive elements as a float4: one 16-byte (f32) or 8-byte (bf16)
// load, 4 * sizeof(T)-aligned
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
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

// page of a row: p + P for a negative id p, then clamped to [0, P - 1]
// (the wrapper refuses rows with no page, P = 0)
template <bool kPaged, bool kBf16>
__device__ __forceinline__ int page_of(const Adapter<kBf16>& ad, int row) {
  if (!kPaged) return 0;
  const int p = ad.ids[row];
  return min(max(p < 0 ? p + ad.P : p, 0), ad.P - 1);
}

template <bool kPaged, bool kBf16>
__device__ __forceinline__ float scale_of(const Adapter<kBf16>& ad, int p) {
  return kPaged ? ad.scales[p] : ad.scale;
}

constexpr int kThreads = 256;
constexpr int kShrinkWarps = kThreads / 32;
constexpr int kGemvMaxRows = 32;           // M above: an SGEMM / mma route
constexpr int kDevices = 16;               // shared-memory grants kept

template <bool kPaged, bool kBf16>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const Elem<kBf16>* __restrict__ x, const Adapter<kBf16> ad,
                   float* __restrict__ z, int M, int K, int R, int vec) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.y * kShrinkWarps + warp;
  if (t >= M || j >= R) return;
  const int p = page_of<kPaged, kBf16>(ad, t);
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

constexpr int kExpandChunk = 16;   // rank columns an expand loads at once

// acc + s_p * (z[row] . B_p[col]), the dot in j order; each chunk's loads
// are issued together before its FMAs (one memory round trip a chunk)
template <bool kPaged, bool kBf16>
__device__ __forceinline__ float expand(float acc, int row, int col,
                                        const Adapter<kBf16>& ad,
                                        const float* __restrict__ z, int R) {
  const int p = page_of<kPaged, kBf16>(ad, row);
  const float* zr = z + (size_t)row * R;
  const Elem<kBf16>* br = ad.b + (size_t)p * ad.b_stride + (size_t)col * R;
  float d = 0.f;
  int j = 0;
  for (; j + kExpandChunk <= R; j += kExpandChunk) {
    float zv[kExpandChunk], bv[kExpandChunk];
#pragma unroll
    for (int q = 0; q < kExpandChunk; ++q) {
      zv[q] = zr[j + q];
      bv[q] = to_f(br[j + q]);
    }
#pragma unroll
    for (int q = 0; q < kExpandChunk; ++q) d = fmaf(zv[q], bv[q], d);
  }
  for (; j < R; ++j) d = fmaf(zr[j], to_f(br[j]), d);
  return fmaf(scale_of<kPaged, kBf16>(ad, p), d, acc);
}

// A split over K summed in the same launch (sgemm::split_sum's protocol
// for the few values a GEMV thread holds). Block `split` of `tile` (of
// `tiles`, for `splits` ranges) writes its kN values to part, laid out
// [split][tile][value][thread], so that the writes and the reads back are
// coalesced, then counts itself in count[tile]. The last block to arrive
// resets the count to 0 (the next launch finds it so) and sums the
// partials into v in split order, part[0] + part[1] + ..., whatever order
// the blocks finished in. Returns true in the block that holds the tile's
// sum (every block of an unsplit launch), false in the others, which then
// have nothing left to do. `count` starts at zero: the wrapper allocates it
// zeroed, once a device.
template <int kN>
__device__ __forceinline__ bool split_sum(float (&v)[kN],
                                          float* __restrict__ part,
                                          unsigned* __restrict__ count,
                                          int tile, int tiles, int split,
                                          int splits) {
  if (splits == 1) return true;
  __shared__ int last;
  const size_t plane = (size_t)tiles * kN * kThreads;   // floats a split
  float* mine = part + (size_t)tile * kN * kThreads + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kN; ++i) mine[split * plane + i * kThreads] = v[i];
  __threadfence();                 // the partial is seen before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count + tile, 1u) == (unsigned)(splits - 1);
    if (last) atomicExch(count + tile, 0u);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();                 // the count is seen before the partials
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = __ldcg(mine + i * kThreads);
  // 8 splits' loads in flight at once
#pragma unroll 8
  for (int s = 1; s < splits; ++s)
#pragma unroll
    for (int i = 0; i < kN; ++i)
      v[i] += __ldcg(mine + s * plane + i * kThreads);
  return true;
}

// ---- M <= 32: the GEMV, W streamed in 128-byte strips

constexpr int kGemvLanes = 8;     // lanes along one W row: 128 bytes
constexpr int kGemvSlices = kThreads / kGemvLanes;   // W rows a step (32)
constexpr int kGemvSlab = 128;    // a split's depth is a multiple
// x's range of BM rows in 40 KB, under the 48 KB a block may take without
// a grant (split_sum keeps a word of static shared memory beside it)
constexpr int kGemvSmemFloats = 40 * 1024 / 4;
constexpr int kGemvWarps = kThreads / 32;

template <int BM_, bool kBf16>
struct Gemv {
  static constexpr int BM = BM_;
  // W rows a thread loads ahead: 4 at 4 rows, 2 at 8 (the 8-row bf16
  // instance holds 64 sums a thread, and 8 loads would push it past the
  // 128 registers of two blocks an SM)
  static constexpr int U = 16 / BM;
  static constexpr int kStep = kGemvSlices * U;         // rows a step
  static constexpr int kV = 16 / sizeof(Elem<kBf16>);   // W elements a load
  static constexpr int BN = kGemvLanes * kV;            // 32 f32, 64 bf16
  static constexpr int kOut = (BM * BN + kThreads - 1) / kThreads;
  static constexpr int kRedFloats = kGemvWarps * BM * BN;
  static_assert(BM % 4 == 0, "x's rows of a depth are read as float4s");
  static_assert(kGemvSlab % kStep == 0, "a split is whole steps");
  static_assert(kRedFloats <= kGemvSmemFloats, "the warps' sums fit");
};

// 16 bytes of a W row from column `col` as raw bits, zero past n: one
// 16-byte load where `vec` (n a multiple of the load, W 16-byte aligned),
// element by element otherwise
template <bool kBf16>
__device__ __forceinline__ uint4 load_w16(const Elem<kBf16>* row, int col,
                                          int n, int vec) {
  constexpr int kV = 16 / sizeof(Elem<kBf16>), kPer = kV / 4;
  if (vec)
    return col < n ? __ldg(reinterpret_cast<const uint4*>(row + col))
                   : make_uint4(0u, 0u, 0u, 0u);
  unsigned u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    if (col + c >= n) continue;
    unsigned bits;
    if constexpr (kBf16)
      bits = *reinterpret_cast<const unsigned short*>(row + col + c);
    else
      bits = *reinterpret_cast<const unsigned*>(row + col + c);
    u[c / kPer] |= bits << (32 / kPer * (c % kPer));
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Rows m0 .. m0 + BM - 1 (blockIdx.x), W's strip of BN columns
// (blockIdx.y) over the depth [z * depth, (z + 1) * depth) of K
// (blockIdx.z, depth a multiple of kGemvSlab). Thread (slice, lane8):
// rows slice, slice + 32, ... of the range, columns lane8 * kV .. + kV.
// Dynamic shared memory: max(BM * depth, the warps' sums) floats.
template <int BM, bool kPaged, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
lora_gemv_kernel(const Elem<kBf16>* __restrict__ x,
                 const Elem<kBf16>* __restrict__ w, const Adapter<kBf16> ad,
                 const float* __restrict__ z, Elem<kBf16>* __restrict__ y,
                 float* __restrict__ part, unsigned* __restrict__ count,
                 int M, int K, int N, int R, int depth, int vec) {
  using G = Gemv<BM, kBf16>;
  constexpr int kV = G::kV, BN = G::BN, U = G::U, kStep = G::kStep;
  extern __shared__ __align__(16) float xs[];   // xs[k * BM + m]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = tid / kGemvLanes;
  const int n0 = blockIdx.y * BN, col = n0 + (tid % kGemvLanes) * kV;
  const int m0 = blockIdx.x * BM;
  const int kbeg = blockIdx.z * depth;
  const int kn = max(0, min(K, kbeg + depth) - kbeg);
  const int steps = (kn + kStep - 1) / kStep;
  const Elem<kBf16>* wrow = w + (size_t)(kbeg + slice) * N;
  const size_t wstep = (size_t)kGemvSlices * N;   // elements a step row
  // step j's rows of this thread: slice + j * kStep + u * kGemvSlices
  auto fetch = [&](uint4 (&r)[U], int j) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = j * kStep + u * kGemvSlices + slice;
      r[u] = kk < kn ? load_w16<kBf16>(wrow + (size_t)(j * U + u) * wstep,
                                       col, N, vec)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 cur[U], nxt[U];
  fetch(cur, 0);                    // in flight while x's range is read
  const int kpad = steps * kStep;
  for (int e = tid; e < BM * kpad; e += kThreads) {
    const int m = e / kpad, kk = e - m * kpad;
    xs[kk * BM + m] = (m0 + m < M && kk < kn)
                          ? to_f(x[(size_t)(m0 + m) * K + kbeg + kk])
                          : 0.f;
  }
  __syncthreads();
  float acc[BM][kV];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kV; ++c) acc[m][c] = 0.f;
  for (int j = 0; j < steps; ++j) {
    fetch(nxt, j + 1);              // past the range: no load, zeros
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float wv[kV];
      unpack(cur[u], wv);
      const float4* xk = reinterpret_cast<const float4*>(
          xs + (j * kStep + u * kGemvSlices + slice) * BM);
      float xv[BM];
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 f = xk[q];
        xv[4 * q] = f.x; xv[4 * q + 1] = f.y; xv[4 * q + 2] = f.z;
        xv[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int c = 0; c < kV; ++c) acc[m][c] = fmaf(xv[m], wv[c], acc[m][c]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }
  // the slices of a warp that share columns (the lane bits above the
  // strip's), by an xor tree: every lane ends with the same sum
#pragma unroll
  for (int off = kGemvLanes; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int c = 0; c < kV; ++c)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  __syncthreads();                  // x's range read by all
  float* red = xs;                  // red[(warp * BM + m) * BN + column]
  if (lane < kGemvLanes)
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int c = 0; c < kV; ++c)
        red[(warp * BM + m) * BN + lane * kV + c] = acc[m][c];
  __syncthreads();
  float v[G::kOut];                 // output e = tid + i * kThreads
#pragma unroll
  for (int i = 0; i < G::kOut; ++i) {
    const int e = tid + i * kThreads;
    float s = 0.f;
    if (e < BM * BN) {
      s = red[e];
#pragma unroll
      for (int q = 1; q < kGemvWarps; ++q) s += red[q * BM * BN + e];
    }
    v[i] = s;
  }
  if (!split_sum(v, part, count, blockIdx.y * gridDim.x + blockIdx.x,
                 gridDim.x * gridDim.y, blockIdx.z, gridDim.z))
    return;
#pragma unroll
  for (int i = 0; i < G::kOut; ++i) {
    const int e = tid + i * kThreads;
    const int row = m0 + e / BN, cc = n0 + e % BN;
    if (e < BM * BN && row < M && cc < N)
      put(y + (size_t)row * N + cc,
          expand<kPaged, kBf16>(v[i], row, cc, ad, z, R));
  }
}

// ---- M > 32, K4 in f32: the SGEMM of sgemm_f32.cuh, expand in its epilogue

constexpr int kNoRow = -2;    // page slot of a tile row past M

// acc[i][j] += s_p * z[row] . B_p[col] for each row of the tile on page p. The
// tile's z rows and B_p's BN rows are staged r-major in shared memory (zs: BK
// x LDX, bs: BK x LDW, each read from contiguous memory with neighbouring
// threads on neighbouring floats), z pre-multiplied by s_p, and summed by the
// mainloop's register tile in r order. K4 walks the distinct pages of the
// tile's rows in increasing order; a row only ever sees its own page. kStage
// unrolls the staging loops: 1 (rolled) in the SGEMM's epilogue, where the
// accumulators fill the registers and an unrolled epilogue pushes the 128 x
// 128 tile past 128 registers; fully in the split reduce, so that its staging
// loads are in flight together. The FMA loop stays rolled in both.
template <bool kPaged, class T, int kStage>
__device__ void expand_tile(float* zs, float* bs, int* pg,
                            const Adapter<false>& ad,
                            const float* __restrict__ z, int M, int N, int R,
                            int m0, int n0, float (&acc)[T::TM][T::TN]) {
  const int tid = threadIdx.x, ty = sgemm::grid_row(),
            tx = sgemm::grid_col();
  for (int i = tid; i < T::BM; i += sgemm::kThreads)
    pg[i] = m0 + i < M ? page_of<kPaged, false>(ad, m0 + i) : kNoRow;
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
    const float s = scale_of<kPaged, false>(ad, p);
    const float* bp = ad.b + (size_t)p * ad.b_stride;
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
            (n0 + n < N && r < R) ? bp[(size_t)(n0 + n) * R + r] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < sgemm::kBK; ++k)
        sgemm::fma_step<T, true>(zs, bs, acc, ty, tx, k, rows);
    }
    if (!kPaged) break;
    last = p;
  }
}

// One BM x BN output tile over the depth [z * depth, (z + 1) * depth) of
// K. One split (gridDim.z == 1): the expand is added and y written. More:
// the partial tile goes to part[z] of (S, M, N) and
// lora_split_reduce_kernel finishes it. __launch_bounds__(256, 2): at most
// 128 registers a thread, so two blocks share an SM.
template <bool kPaged, int BM, int BN, bool kVec>
__global__ void __launch_bounds__(sgemm::kThreads, 2)
lora_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const Adapter<false> ad, const float* __restrict__ z,
                 float* __restrict__ y, float* __restrict__ part, int M,
                 int K, int N, int R, int depth) {
  using T = sgemm::Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * depth, kend = min(K, kbeg + depth);
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  sgemm::mainloop<T, kVec>(smem, x, w, M, K, N, m0, n0, kbeg, kend, acc);
  if (gridDim.z > 1) {
    sgemm::store_tile<T>(part + (size_t)blockIdx.z * M * N, acc, M, N, m0,
                         n0, kVec);
    return;
  }
  int* pg = reinterpret_cast<int*>(smem + T::kRingBytes / 4);
  expand_tile<kPaged, T, 1>(smem, smem + sgemm::kStages * T::kXFloats, pg,
                            ad, z, M, N, R, m0, n0, acc);
  sgemm::store_tile<T>(y, acc, M, N, m0, n0, kVec);
}

constexpr int kRedStage = 4;   // the reduce's 4-trip staging loops, unrolled

// y = part[0] + part[1] + ... + part[S - 1] in that order, then the
// expand; 64 x 64 tiles, 4 x 4 outputs a thread, float4 reads of the
// partials where N % 4 == 0. (Row by row with 4 splits' loads in flight
// measured faster on the H100 than all 4 rows' loads at once.)
template <bool kPaged>
__global__ void __launch_bounds__(sgemm::kThreads)
lora_split_reduce_kernel(const float* __restrict__ part, int S,
                         const Adapter<false> ad, const float* __restrict__ z,
                         float* __restrict__ y, int M, int N, int R,
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
  expand_tile<kPaged, T, kRedStage>(smem, smem + T::kXFloats, pg, ad, z, M,
                                    N, R, m0, n0, acc);
  sgemm::store_tile<T>(y, acc, M, N, m0, n0, vec_y);
}

template <bool kPaged, int BM, int BN, bool kVec>
int launch_gemm(const float* x, const float* w, const Adapter<false>& ad,
                const float* z, float* y, float* part, int M, int K, int N,
                int R, int splits, int depth, cudaStream_t s) {
  using T = sgemm::Tile<BM, BN>;
  const int smem = T::kRingBytes + (BM + 1) * (int)sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      lora_gemm_kernel<kPaged, BM, BN, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  lora_gemm_kernel<kPaged, BM, BN, kVec>
      <<<grid, sgemm::kThreads, smem, s>>>(x, w, ad, z, y, part, M, K, N, R,
                                            depth);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 rgrid((N + 63) / 64, (M + 63) / 64);
    lora_split_reduce_kernel<kPaged><<<rgrid, sgemm::kThreads, 0, s>>>(
        part, splits, ad, z, y, M, N, R, kVec);
  }
  return static_cast<int>(cudaGetLastError());
}

// kVec (loads and stores of 4 floats) where x's and w's rows are 16-byte
// aligned: K % 4 == 0 and N % 4 == 0, aligned bases (y and part come from
// the allocator).
template <bool kPaged, int BM, int BN>
int launch_gemm_tile(const float* x, const float* w, const Adapter<false>& ad,
                     const float* z, float* y, float* part, int M, int K,
                     int N, int R, int splits, int depth, cudaStream_t s) {
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  return vec ? launch_gemm<kPaged, BM, BN, true>(x, w, ad, z, y, part, M, K,
                                                 N, R, splits, depth, s)
             : launch_gemm<kPaged, BM, BN, false>(x, w, ad, z, y, part, M, K,
                                                  N, R, splits, depth, s);
}

// The host planner's choice (gemm_plan.plan_gemm): a bm x bn tile and
// `splits` ranges of K, each `depth` deep (a multiple of the slab) but the
// last. Refused unless the splits cover K exactly.
int launch_sgemm(const float* x, const float* w, const Adapter<false>& ad,
                 const float* z, float* y, float* part, int M, int K, int N,
                 int R, int bm, int bn, int splits, int depth,
                 cudaStream_t s) {
  const bool covers =
      splits >= 1 && depth > 0 && depth % sgemm::kBK == 0 &&
      (long long)splits * depth >= K &&
      (splits == 1 || ((long long)(splits - 1) * depth < K && part));
  if (!covers) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128 && bn == 128)
    return launch_gemm_tile<true, 128, 128>(x, w, ad, z, y, part, M, K, N, R,
                                            splits, depth, s);
  if (bm == 64 && bn == 128)
    return launch_gemm_tile<true, 64, 128>(x, w, ad, z, y, part, M, K, N, R,
                                           splits, depth, s);
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

// x[row, kbeg:kend] . w[kbeg:kend, col] in IEEE f32 FMAs, k in order: the
// repair of an output the 3xTF32 passes gave NaN (mma_tf32x3.cuh)
__device__ __forceinline__ float ieee_dot(const float* __restrict__ xr,
                                          const float* __restrict__ wc,
                                          int N, int kbeg, int kend) {
  float acc = 0.f;
  for (int k = kbeg; k < kend; ++k)
    acc = fmaf(xr[k], wc[(size_t)k * N], acc);
  return acc;
}

// the thread's 64 outputs parked at `mine`: each NaN one summed again
__device__ __noinline__ void repair(float* mine, const float* __restrict__ x,
                                    const float* __restrict__ w, int M, int K,
                                    int N, int r0, int c0, int kbeg,
                                    int kend, int g, int t) {
  for (int q = 0; q < 64; ++q) {
    const int row = r0 + (q >> 4) * 16 + g + 8 * ((q & 3) >> 1);
    const int col = c0 + ((q >> 2) & 3) * 8 + 2 * t + (q & 1);
    if (mine[q] != mine[q] && row < M && col < N)
      mine[q] = ieee_dot(x + (size_t)row * K, w + col, N, kbeg, kend);
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
  // an output the passes gave NaN (it met an inf or NaN operand) summed
  // again in IEEE f32: the f32 product's +-inf or NaN. The rare path parks
  // the thread's 64 outputs in its own part of the free ring and repairs
  // them there in a function not inlined, so that it adds no register to
  // the mainloop's (the epilogue's first barrier orders its reuse of the
  // ring)
  bool nan = false;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) nan |= acc[mt][nt][e] != acc[mt][nt][e];
  if (nan) {
    float* mine = smem + threadIdx.x * 64;
#pragma unroll
    for (int q = 0; q < 64; ++q) mine[q] = acc[q >> 4][(q >> 2) & 3][q & 3];
    tc::repair(mine, x, w, M, K, N, m0 + wr, n0 + wc, kbeg, kend, g, t);
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q >> 4][(q >> 2) & 3][q & 3] = mine[q];
  }

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
    lora_split_reduce_kernel<false><<<rgrid, sgemm::kThreads, 0, s>>>(
        part, splits, ad, z, y, M, N, R, vec);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---- M > 32, K4 in bf16: x @ W on the bf16 tensor cores (mma_bf16.cuh)

namespace bfmma {

constexpr int kBK = 32;           // slab depth: two k16 steps
constexpr int kStages = 4;        // slabs in the cp.async ring
constexpr int kPad = 8;           // bf16 after each slab row: 16 bytes
constexpr int kR = 16;            // rank columns the expand stages at once

// A BM x BN tile of 8 warps, 2 x 4, each WM x WN as MT x NT mma tiles.
// Slab rows: x's 32 + 8 bf16 (80 bytes), W's BN + 8 (272 or 144 bytes):
// the 8 rows an ldmatrix matrix reads land on 8 distinct 16-byte bank
// groups, and every row start stays 16-byte aligned for cp.async.
template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WM = BM / 2, WN = BN / 4;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = kBK + kPad, LDB = BN + kPad;
  static constexpr int kAElems = BM * LDA, kBElems = kBK * LDB;
  static constexpr int kSmemBytes = kStages * (kAElems + kBElems) * 2;
  // the summed tile, row-major (4 floats of padding a row), then z's chunk
  static constexpr int LDT = BN + 4;
  static_assert(MT >= 1 && NT % 2 == 0, "B's fragments load in n8 pairs");
  static_assert((BM * LDT + BM * kR) * 4 <= kSmemBytes,
                "the expand's tile and z's chunk fit the ring");
  static_assert(BM * kR % kThreads == 0 && kThreads % BN == 0,
                "z's chunk stages in whole rounds, a column a thread");
};

// slab [k0, k0 + kBK) of x's rows m0.. into as (as[m][k]) and of W's rows
// into bs (bs[k][n]), zero past M, N and kend. kVec: 16-byte cp.async
// copies (K % 8 == 0, N % 8 == 0, aligned bases; kend is K or a multiple
// of kBK, so a copy is all in or all out); else element by element through
// registers (a row start that is not 16-byte aligned cannot be copied so).
template <class T, bool kVec>
__device__ __forceinline__ void load_slab(bf16* as, bf16* bs,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ w, int M,
                                          int K, int N, int m0, int n0,
                                          int k0, int kend) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kAC = kBK / 8, kBC = T::BN / 8;   // 16-byte chunks a row
#pragma unroll
    for (int it = 0; it < T::BM * kAC / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kAC, c = (e % kAC) * 8;
      const bool in = m0 + r < M && k0 + c < kend;
      mma_bf16::cp_async16(as + r * T::LDA + c,
                           in ? x + (size_t)(m0 + r) * K + k0 + c : x,
                           in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < kBK * kBC / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kBC, c = (e % kBC) * 8;
      const bool in = k0 + r < kend && n0 + c < N;
      mma_bf16::cp_async16(bs + r * T::LDB + c,
                           in ? w + (size_t)(k0 + r) * N + n0 + c : w,
                           in ? 16 : 0);
    }
  } else {
    const bf16 zero = __ushort_as_bfloat16(0);
    for (int e = tid; e < T::BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      as[r * T::LDA + c] = (m0 + r < M && k0 + c < kend)
                               ? x[(size_t)(m0 + r) * K + k0 + c]
                               : zero;
    }
    for (int e = tid; e < kBK * T::BN; e += kThreads) {
      const int r = e / T::BN, c = e % T::BN;
      bs[r * T::LDB + c] = (k0 + r < kend && n0 + c < N)
                               ? w[(size_t)(k0 + r) * N + n0 + c]
                               : zero;
    }
  }
}

// The warp's C fragments into the BM x BN tile in shared memory, row-major
// (rows LDT floats apart), two columns a store
template <class T>
__device__ __forceinline__ void store_tile_frags(
    float* tile, const float (&acc)[T::MT][T::NT][4], int wr, int wc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
        *reinterpret_cast<float2*>(tile + (wr + mt * 16 + g + 8 * h) * T::LDT +
                                   wc + nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// split_sum's protocol for a tile held in shared memory: block `split`
// writes the tile to part ([split][tile][row][column], float4 by float4,
// coalesced) and counts itself; the last block of the tile to arrive sums
// part[0] + part[1] + ... back into the tile, in split order, each thread
// on the same float4s every split (so no barrier between splits). The
// epilogue runs once a tile and its instructions are fetched cold, so its
// loops stay rolled where that keeps the loads of one split in flight.
template <class T>
__device__ __forceinline__ bool split_sum_tile(float* tile,
                                               float* __restrict__ part,
                                               unsigned* __restrict__ count,
                                               int t, int tiles, int split,
                                               int splits) {
  constexpr int kQ = T::BM * T::BN / 4, kRowQ = T::BN / 4;
  static_assert(kQ % kThreads == 0, "whole float4s a thread");
  if (splits == 1) return true;
  __shared__ int last;
  const size_t plane = (size_t)tiles * T::BM * T::BN / 4;   // float4s a split
  float4* base = reinterpret_cast<float4*>(part) + (size_t)t * kQ;
#pragma unroll 4
  for (int i = threadIdx.x; i < kQ; i += kThreads)
    base[split * plane + i] = *reinterpret_cast<const float4*>(
        tile + i / kRowQ * T::LDT + i % kRowQ * 4);
  __threadfence();                 // the partial is seen before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count + t, 1u) == (unsigned)(splits - 1);
    if (last) atomicExch(count + t, 0u);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();                 // the count is seen before the partials
  for (int s = 0; s < splits; ++s) {
#pragma unroll
    for (int j = 0; j < kQ / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const float4 u = __ldcg(base + s * plane + i);
      float4* d = reinterpret_cast<float4*>(tile + i / kRowQ * T::LDT +
                                            i % kRowQ * 4);
      if (s == 0) {
        *d = u;
      } else {
        float4 w = *d;
        w.x += u.x; w.y += u.y; w.z += u.z; w.w += u.w;
        *d = w;
      }
    }
  }
  return true;
}

// The expand and the store of K4's bf16 tile, once its splits are summed into
// the tile in shared memory. Each thread owns one column and walks every
// kStep-th row (the lanes of a warp share their row, so its page is
// warp-uniform): acc + s_p z[row] . B_p[col] in r order (expand_tile's IEEE
// arithmetic, acc = fma(s_p z, b, acc)), then y rounded to bf16 once. Rank
// columns go kR at a time: the chunk of z (times each row's scale) is staged
// in shared memory, and a thread holds its column's chunk of B_p in registers,
// reloaded when its next row's page differs (a serving batch lays a slot's
// rows out together), so a row only ever sees its own page. The loops stay
// rolled: the code runs once a tile, its instructions fetched cold.
template <class T>
__device__ void expand_store(float* tile, float* zs, int* pg,
                             float* sc, const Adapter<true>& ad,
                             const float* __restrict__ z,
                             bf16* __restrict__ y, int M, int N, int R,
                             int m0, int n0) {
  constexpr int LDT = T::LDT, kStep = kThreads / T::BN;
  constexpr int kRows = T::BM / kStep, kGroup = 8;
  static_assert(kRows % kGroup == 0, "whole groups of rows");
  const int tid = threadIdx.x;
  for (int i = tid; i < T::BM; i += kThreads) {
    const int p = m0 + i < M ? page_of<true, true>(ad, m0 + i) : kNoRow;
    pg[i] = p;
    sc[i] = p >= 0 ? ad.scales[p] : 0.f;
  }
  const int col = tid % T::BN, row0 = tid / T::BN;
  const bool in_n = n0 + col < N;
  const bf16* bcol = ad.b + (size_t)(n0 + col) * R;
  for (int r0 = 0; r0 < R; r0 += kR) {
    __syncthreads();             // the tile, pg and sc, or the last chunk
    float zv[T::BM * kR / kThreads];
#pragma unroll
    for (int j = 0; j < T::BM * kR / kThreads; ++j) {
      const int e = tid + j * kThreads, m = e / kR, r = e % kR;
      zv[j] = (pg[m] >= 0 && r0 + r < R) ? z[(size_t)(m0 + m) * R + r0 + r]
                                         : 0.f;
    }
#pragma unroll
    for (int j = 0; j < T::BM * kR / kThreads; ++j) {
      const int e = tid + j * kThreads;
      zs[e] = sc[e / kR] * zv[j];      // zs[m * kR + r]
    }
    __syncthreads();
    const int rn = min(kR, R - r0);
    float bv[kR];
    int cur = -1;                // the page bv holds
    // kGroup rows at a time: where they share a page (the common case)
    // their kGroup sums run side by side, each still in r order
#pragma unroll 1
    for (int i0 = 0; i0 < kRows; i0 += kGroup) {
      const int p = pg[row0 + i0 * kStep];
      bool same = p >= 0;
#pragma unroll
      for (int j = 1; j < kGroup; ++j) same &= pg[row0 + (i0 + j) * kStep] == p;
      if (same) {
        if (p != cur) {
          cur = p;
          const bf16* br = bcol + (size_t)p * ad.b_stride + r0;
#pragma unroll
          for (int r = 0; r < kR; ++r)
            bv[r] = (in_n && r < rn) ? to_f(br[r]) : 0.f;
        }
        float v[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          v[j] = tile[(row0 + (i0 + j) * kStep) * LDT + col];
#pragma unroll
        for (int r4 = 0; r4 < kR / 4; ++r4)
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float4 zq = reinterpret_cast<const float4*>(
                zs + (row0 + (i0 + j) * kStep) * kR)[r4];
            if (4 * r4 < rn) v[j] = fmaf(zq.x, bv[4 * r4], v[j]);
            if (4 * r4 + 1 < rn) v[j] = fmaf(zq.y, bv[4 * r4 + 1], v[j]);
            if (4 * r4 + 2 < rn) v[j] = fmaf(zq.z, bv[4 * r4 + 2], v[j]);
            if (4 * r4 + 3 < rn) v[j] = fmaf(zq.w, bv[4 * r4 + 3], v[j]);
          }
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          tile[(row0 + (i0 + j) * kStep) * LDT + col] = v[j];
        continue;
      }
      // rows of several pages: one row at a time
#pragma unroll 1
      for (int i = i0; i < i0 + kGroup; ++i) {
        const int row = row0 + i * kStep, q = pg[row];
        if (q < 0) continue;
        if (q != cur) {
          cur = q;
          const bf16* br = bcol + (size_t)q * ad.b_stride + r0;
#pragma unroll
          for (int r = 0; r < kR; ++r)
            bv[r] = (in_n && r < rn) ? to_f(br[r]) : 0.f;
        }
        const float4* zr = reinterpret_cast<const float4*>(zs + row * kR);
        float v = tile[row * LDT + col];
#pragma unroll
        for (int r4 = 0; r4 < kR / 4; ++r4) {
          const float4 zq = zr[r4];
          if (4 * r4 < rn) v = fmaf(zq.x, bv[4 * r4], v);
          if (4 * r4 + 1 < rn) v = fmaf(zq.y, bv[4 * r4 + 1], v);
          if (4 * r4 + 2 < rn) v = fmaf(zq.z, bv[4 * r4 + 2], v);
          if (4 * r4 + 3 < rn) v = fmaf(zq.w, bv[4 * r4 + 3], v);
        }
        tile[row * LDT + col] = v;
      }
    }
  }
  __syncthreads();               // the tile and pg written by all
#pragma unroll 8
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i * kStep;
    if (m0 + row < M && in_n)
      y[(size_t)(m0 + row) * N + n0 + col] =
          __float2bfloat16_rn(tile[row * LDT + col]);
  }
}

}  // namespace bfmma

// One BM x BN output tile of K4's bf16 product over the depth [z * depth,
// (z + 1) * depth) of K (blockIdx.x: the tile's columns, .y its rows, .z
// the split). The splits' partials meet in split_sum; the block holding
// the sum adds the expand and writes y. __launch_bounds__(256, 2): at
// most 128 registers a thread, so two blocks share an SM.
template <int BM, int BN, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
lora_mma_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const Adapter<true> ad, const float* __restrict__ z,
                     bf16* __restrict__ y, float* __restrict__ part,
                     unsigned* __restrict__ count, int M, int K, int N,
                     int R, int depth) {
  using T = bfmma::Tile<BM, BN>;
  constexpr int kS = bfmma::kStages, kBK = bfmma::kBK;
  extern __shared__ __align__(16) float smem[];   // the ring, then staging
  __shared__ int pg[BM];
  __shared__ float sc[BM];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kS * T::kAElems;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * depth, kend = min(K, kbeg + depth);
  const int slabs = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp >> 2) * T::WM, wc = (warp & 3) * T::WN;
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < slabs)
      bfmma::load_slab<T, kVec>(as + st * T::kAElems, bs + st * T::kBElems,
                                x, w, M, K, N, m0, n0, kbeg + st * kBK,
                                kend);
    sgemm::cp_async_commit();       // empty groups keep the count uniform
  }
  for (int it = 0; it < slabs; ++it) {
    sgemm::cp_async_wait<kS - 2>();  // slab it has landed
    __syncthreads();                 // ... for all; slab it - 1 read
    const int nx = it + kS - 1;
    if (nx < slabs) {
      const int st = nx % kS;
      bfmma::load_slab<T, kVec>(as + st * T::kAElems, bs + st * T::kBElems,
                                x, w, M, K, N, m0, n0, kbeg + nx * kBK,
                                kend);
    }
    sgemm::cp_async_commit();
    const bf16* a = as + (it % kS) * T::kAElems + wr * T::LDA;
    const bf16* b = bs + (it % kS) * T::kBElems + wc;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        mma_bf16::load_a(fa[mt], a + mt * 16 * T::LDA, T::LDA, kk, lane);
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t fb[4];
        mma_bf16::load_b_pair(fb, b, T::LDB, kk, 16 * np, lane);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          mma_bf16::mma(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
          mma_bf16::mma(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
        }
      }
    }
  }
  sgemm::cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the epilogue

  // the epilogue goes through the tile in shared memory (the ring's bytes)
  float* tile = smem;
  bfmma::store_tile_frags<T>(tile, acc, wr, wc);
  __syncthreads();
  if (!bfmma::split_sum_tile<T>(tile, part, count,
                                blockIdx.y * gridDim.x + blockIdx.x,
                                gridDim.x * gridDim.y, blockIdx.z, gridDim.z))
    return;
  bfmma::expand_store<T>(tile, smem + BM * T::LDT, pg, sc, ad, z, y, M, N,
                         R, m0, n0);
}

template <int BM, int BN, bool kVec>
int launch_mma_bf16_tile(const bf16* x, const bf16* w,
                         const Adapter<true>& ad, const float* z, bf16* y,
                         float* part, unsigned* count, int M, int K, int N,
                         int R, int splits, int depth, cudaStream_t s) {
  using T = bfmma::Tile<BM, BN>;
  // the ring's shared memory, granted once a device (setting it costs the
  // host about a launch)
  static bool granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !granted[dev]) {
    err = cudaFuncSetAttribute(lora_mma_bf16_kernel<BM, BN, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) granted[dev] = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  lora_mma_bf16_kernel<BM, BN, kVec><<<grid, kThreads, T::kSmemBytes, s>>>(
      x, w, ad, z, y, part, count, M, K, N, R, depth);
  return static_cast<int>(cudaGetLastError());
}

// K4's bf16 product above 32 rows, the host planner's choice
// (gemm_plan.plan_gemm_bf16): a 128 x 128 or 64 x 64 tile and `splits`
// ranges of K, each `depth` deep (a multiple of the slab) but the last.
// Refused unless the splits cover K exactly.
int launch_mma_bf16(const bf16* x, const bf16* w, const Adapter<true>& ad,
                    const float* z, bf16* y, float* part, unsigned* count,
                    int M, int K, int N, int R, int bm, int bn, int splits,
                    int depth, cudaStream_t s) {
  const bool covers =
      splits >= 1 && depth > 0 && depth % bfmma::kBK == 0 &&
      (long long)splits * depth >= K &&
      (splits == 1 ||
       ((long long)(splits - 1) * depth < K && part && count));
  if (!covers || bm <= 0 || (M + bm - 1) / bm > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (bm == 128 && bn == 128)
    return vec ? launch_mma_bf16_tile<128, 128, true>(
                     x, w, ad, z, y, part, count, M, K, N, R, splits, depth,
                     s)
               : launch_mma_bf16_tile<128, 128, false>(
                     x, w, ad, z, y, part, count, M, K, N, R, splits, depth,
                     s);
  if (bm == 64 && bn == 64)
    return vec ? launch_mma_bf16_tile<64, 64, true>(
                     x, w, ad, z, y, part, count, M, K, N, R, splits, depth,
                     s)
               : launch_mma_bf16_tile<64, 64, false>(
                     x, w, ad, z, y, part, count, M, K, N, R, splits, depth,
                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BM, bool kPaged, bool kBf16>
int launch_gemv(const Elem<kBf16>* x, const Elem<kBf16>* w,
                const Adapter<kBf16>& ad, const float* z, Elem<kBf16>* y,
                float* part, unsigned* count, int M, int K, int N, int R,
                int splits, int depth, int vec, cudaStream_t s) {
  using G = Gemv<BM, kBf16>;
  const int smem =
      (BM * depth > G::kRedFloats ? BM * depth : G::kRedFloats) * 4;
  dim3 grid((M + BM - 1) / BM, (N + G::BN - 1) / G::BN, splits);
  lora_gemv_kernel<BM, kPaged, kBf16><<<grid, kThreads, smem, s>>>(
      x, w, ad, z, y, part, count, M, K, N, R, depth, vec);
  return static_cast<int>(cudaGetLastError());
}

// The GEMV at most 32 rows, the host planner's choice (gemm_plan.
// plan_gemv): bm (4 or 8) rows and the instance's bn columns a block,
// `splits` ranges of K each `depth` deep (a multiple of kGemvSlab) but the
// last, x's range in at most 48 KB. Refused unless the splits cover K.
template <bool kPaged, bool kBf16>
int launch_gemv_plan(const Elem<kBf16>* x, const Elem<kBf16>* w,
                     const Adapter<kBf16>& ad, const float* z,
                     Elem<kBf16>* y, float* part, unsigned* count, int M,
                     int K, int N, int R, int bm, int bn, int splits,
                     int depth, cudaStream_t s) {
  using G4 = Gemv<4, kBf16>;
  const bool covers =
      splits >= 1 && depth > 0 && depth % kGemvSlab == 0 &&
      (long long)splits * depth >= K &&
      (splits == 1 ||
       ((long long)(splits - 1) * depth < K && part && count));
  if (!covers || bn != G4::BN || (bm != 4 && bm != 8) ||
      (long long)bm * depth > kGemvSmemFloats ||
      (N + bn - 1) / bn > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = N % G4::kV == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return bm == 4
             ? launch_gemv<4, kPaged, kBf16>(x, w, ad, z, y, part, count, M,
                                             K, N, R, splits, depth, vec, s)
             : launch_gemv<8, kPaged, kBf16>(x, w, ad, z, y, part, count, M,
                                             K, N, R, splits, depth, vec, s);
}

// The shrink, then the base product with the expand in its epilogue, on
// the plan (bm, bn, splits, depth; part and count for a split) of the
// route the wrapper chose for M rows and the operand type.
template <bool kPaged, bool kBf16>
int lora_apply_launch(const Elem<kBf16>* x, const Elem<kBf16>* w,
                      const Adapter<kBf16>& ad, float* z, Elem<kBf16>* y,
                      float* part, unsigned* count, int M, int K, int N,
                      int R, int bm, int bn, int splits, int depth,
                      cudaStream_t s) {
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
  if (M <= kGemvMaxRows)
    return launch_gemv_plan<kPaged, kBf16>(x, w, ad, z, y, part, count, M, K,
                                           N, R, bm, bn, splits, depth, s);
  if constexpr (kBf16)
    return launch_mma_bf16(x, w, ad, z, y, part, count, M, K, N, R, bm, bn,
                           splits, depth, s);
  else if constexpr (kPaged)
    return launch_sgemm(x, w, ad, z, y, part, M, K, N, R, bm, bn, splits,
                        depth, s);
  else
    return launch_tc(x, w, ad, z, y, part, M, K, N, R, bm, bn, splits, depth,
                     s);
}

}  // namespace

// K4: one call = two launches on `stream` (the shrink, then the GEMV or
// the SGEMM), three where the SGEMM splits K (its partials summed by
// lora_split_reduce_kernel). part: the GEMV's split partials and count its
// tiles' counters (both from the wrapper's per-device scratch), or the
// SGEMM's (splits, M, N) workspace; null for one split.
extern "C" int batched_lora_apply_f32(const float* x, const float* w,
                                      const float* a, const float* b,
                                      const float* scales, const int* ids,
                                      float* z, float* y, float* part,
                                      unsigned* count, int M, int K, int N,
                                      int R, int P, long long a_stride,
                                      long long b_stride, int bm, int bn,
                                      int splits, int depth, void* stream) {
  const Adapter<false> ad{a, b, scales, ids, a_stride, b_stride, P, 0.f};
  return lora_apply_launch<true, false>(x, w, ad, z, y, part, count, M, K, N,
                                        R, bm, bn, splits, depth,
                                        static_cast<cudaStream_t>(stream));
}

// K4 in bf16: x, w, the A and B pages and y are __nv_bfloat16 (page
// strides in elements); scales, z and the partials f32. Two launches a
// call: the shrink, then the GEMV or the tensor-core product, either
// summing its splits in the same launch (part and count: the wrapper's
// per-device scratch).
extern "C" int batched_lora_apply_bf16(const void* x, const void* w,
                                       const void* a, const void* b,
                                       const float* scales, const int* ids,
                                       float* z, void* y, float* part,
                                       unsigned* count, int M, int K, int N,
                                       int R, int P, long long a_stride,
                                       long long b_stride, int bm, int bn,
                                       int splits, int depth, void* stream) {
  const Adapter<true> ad{static_cast<const bf16*>(a),
                         static_cast<const bf16*>(b), scales, ids, a_stride,
                         b_stride, P, 0.f};
  return lora_apply_launch<true, true>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), ad, z,
      static_cast<bf16*>(y), part, count, M, K, N, R, bm, bn, splits, depth,
      static_cast<cudaStream_t>(stream));
}

// K5: x (M, K), W (K, N), A (R, K), B (N, R), both contiguous; z (M, R)
// scratch; y (M, N); part and count as for K4's f32 entry (above 32 rows
// the plan is plan_gemm_tc's: 128 x 128, depth a multiple of 32).
extern "C" int lora_apply_f32(const float* x, const float* w, const float* a,
                              const float* b, float* z, float* y, float* part,
                              unsigned* count, int M, int K, int N, int R,
                              float scale, int bm, int bn, int splits,
                              int depth, void* stream) {
  const Adapter<false> ad{a, b, nullptr, nullptr, 0, 0, 1, scale};
  return lora_apply_launch<false, false>(x, w, ad, z, y, part, count, M, K,
                                         N, R, bm, bn, splits, depth,
                                         static_cast<cudaStream_t>(stream));
}
