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
// Design: dW[l] = (B omega) A as one GEMM over the depth t = m*r + c on the
// SGEMM mainloop of sgemm_f32.cuh, 64 x 128 tiles (4 x 8 registers a
// thread) at three blocks an SM: the depth is short (6 live slabs at the
// vit-base buckets), so a block's load ramp and its store are a large
// share of its time, and three blocks overlap them better than two of
// 128 x 128. The plan is gemm_plan.py::plan_agg's:
//  - the x side is B with omega folded in as its slab is stored (one
//    multiply per element, as the reference scales its B tile): row i of
//    layer l is M runs of r contiguous floats, x[i, t] = bs[m, i, c] *
//    omega[t], staged through registers (four threads to a row's 16-deep
//    run) and stored transposed; a 16-deep slab crosses a client
//    boundary wherever r % 16 != 0. float4 loads
//    where r % 4 == 0 and n % 4 == 0 with aligned bases, else 4-byte ones;
//  - the w side is A viewed as (M*r, n), already k-major: cp.async;
//  - the slabs whose 16 weights are all zero are skipped: each block reads
//    omega over its depth range at its start and lists its live slabs in
//    shared memory, on the device, with no copy of omega to the host. At
//    the round's raFLoRA weights 6 of 12 slabs are live. On finite inputs
//    a skipped slab would have added only products with a zero factor.
//    With inf or NaN in B or A at a zero-weight column of a skipped slab
//    the reference gives NaN and this kernel does not (ROADMAP.md queue 3);
//  - where the tiles alone do not fill the card (one layer of M 10, d 768,
//    r 64: 36 tiles), the planner splits the depth and the last block of
//    each tile to finish sums the partials in split order
//    (sgemm::split_sum): one launch, the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_f32.cuh"

namespace {

// x[i, t] = bs[m, i, c] * omega[t] with t = m r + c, i < d: row i is M
// runs of r contiguous floats, d r floats apart. kVec: r % 4 == 0 (a
// float4 never crosses a client) with bs and omega 16-byte aligned.
template <int E, int LD, bool kVec>
struct ClientRows
    : sgemm::ThroughRegisters<ClientRows<E, LD, kVec>, E, LD, kVec, true> {
  const float* __restrict__ bs;
  const float* __restrict__ omega;
  int d, r, e0;
  __device__ __forceinline__ ClientRows(const float* bs_,
                                        const float* omega_, int d_, int r_,
                                        int e0_)
      : bs(bs_), omega(omega_), d(d_), r(r_), e0(e0_) {}
  __device__ __forceinline__ float at(int i, int t) const {
    const int m = t / r;
    return bs[((size_t)m * d + i) * r + (t - m * r)] * omega[t];
  }
  __device__ __forceinline__ void fetch(sgemm::RegStage<E>& st, int k0,
                                        int kend) const {
#pragma unroll
    for (int it = 0; it < E * sgemm::kBK / 4 / sgemm::kThreads; ++it) {
      const int e = threadIdx.x + it * sgemm::kThreads;
      const int i = e0 + sgemm::slab_entry<E, true>(e),
                t = k0 + sgemm::slab_quad<E, true>(e) * 4;
      if (kVec) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < d && t < kend) {
          const int m = t / r;
          v = *reinterpret_cast<const float4*>(
              bs + ((size_t)m * d + i) * r + (t - m * r));
          const float4 w = *reinterpret_cast<const float4*>(omega + t);
          v.x *= w.x; v.y *= w.y; v.z *= w.z; v.w *= w.w;
        }
        st.v[it] = v;
      } else {
        const bool row = i < d;
        st.v[it] = make_float4(row && t < kend ? at(i, t) : 0.f,
                               row && t + 1 < kend ? at(i, t + 1) : 0.f,
                               row && t + 2 < kend ? at(i, t + 2) : 0.f,
                               row && t + 3 < kend ? at(i, t + 3) : 0.f);
      }
    }
  }
};

// Lists in `live` the depth k0 of each slab in [kbeg, kend) with a nonzero
// weight (NaN counts as nonzero), in depth order; returns their count.
__device__ __forceinline__ int live_slabs(int* live,
                                          const float* __restrict__ omega,
                                          int kbeg, int kend) {
  __shared__ int warp_live[sgemm::kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slabs =
      kend > kbeg ? (kend - kbeg + sgemm::kBK - 1) / sgemm::kBK : 0;
  int count = 0;
  for (int s0 = 0; s0 < slabs; s0 += sgemm::kThreads) {
    const int s = s0 + threadIdx.x;
    const int k0 = kbeg + s * sgemm::kBK;
    bool on = false;
    if (s < slabs) {
#pragma unroll
      for (int q = 0; q < sgemm::kBK; ++q)   // the 16 loads in flight
        on |= k0 + q < kend && omega[k0 + q] != 0.f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int at = count, total = 0;
#pragma unroll
    for (int w = 0; w < sgemm::kThreads / 32; ++w) {
      at += w < warp ? warp_live[w] : 0;
      total += warp_live[w];
    }
    if (on) live[at + __popc(ballot & ((1u << lane) - 1u))] = k0;
    count += total;
    __syncthreads();             // the list is seen; warp_live free again
  }
  return count;
}

constexpr int BM = 64, BN = 128;    // gemm_plan.py's AGG_TILE
using T = sgemm::Tile<BM, BN>;

// Grid (n tiles x splits, d tiles, layers); `split` depth a range. Dynamic
// shared memory: the ring, then the live list (split / 16 + kStages ints).
// __launch_bounds__(256, 3): at most 85 registers, three blocks an SM.
template <bool kVec>
__global__ void __launch_bounds__(sgemm::kThreads, 3)
rank_partition_agg_kernel(const float* __restrict__ bs,
                          const float* __restrict__ as,
                          const float* __restrict__ omega,
                          float* __restrict__ out, float* __restrict__ part,
                          unsigned* __restrict__ count, int M, int d, int r,
                          int n, int split, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  int* live = reinterpret_cast<int*>(smem + T::kRingBytes / 4);
  const int layer = blockIdx.z;
  const int tn = blockIdx.x % n_tiles, s = blockIdx.x / n_tiles;
  const int m0 = blockIdx.y * BM, n0 = tn * BN;
  const int depth = M * r;
  const int kbeg = s * split, kend = min(depth, kbeg + split);
  const sgemm::SlabList slabs{live, live_slabs(live, omega, kbeg, kend)};
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  sgemm::mainloop_sides<T>(
      smem,
      ClientRows<BM, T::LDX, kVec>(bs + (size_t)layer * M * d * r, omega, d,
                                   r, m0),
      sgemm::KMajor<BN, T::LDW, kVec>{as + (size_t)layer * depth * n, n, n0},
      slabs, kend, acc);
  const int tiles = n_tiles * gridDim.y;
  if (!sgemm::split_sum<T>(acc, part, count,
                           layer * tiles + blockIdx.y * n_tiles + tn,
                           tiles * gridDim.z, s, gridDim.x / n_tiles))
    return;
  sgemm::store_tile<T>(out + (size_t)layer * d * n, acc, d, n, m0, n0,
                       n % 4 == 0);
}

constexpr int kDevices = 16;   // devices whose granted smem is remembered

template <bool kVec>
int launch(const float* bs, const float* as, const float* omega, float* out,
           float* part, unsigned* count, int layers, int M, int d, int r,
           int n, int splits, int split, cudaStream_t stream) {
  const int smem = T::kRingBytes +
                   (split / sgemm::kBK + sgemm::kStages) * (int)sizeof(int);
  // the shared memory this instance may take, per device: raised only when
  // a launch needs more (setting it costs the host more than the launch)
  static int granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices || smem > granted[dev]) {
    err = cudaFuncSetAttribute(rank_partition_agg_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kDevices) granted[dev] = smem;
  }
  const int n_tiles = (n + BN - 1) / BN;
  dim3 grid(n_tiles * splits, (d + BM - 1) / BM, layers);
  rank_partition_agg_kernel<kVec><<<grid, sgemm::kThreads, smem, stream>>>(
      bs, as, omega, out, part, count, M, d, r, n, split, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`. The plan (gemm_plan.py::plan_agg): `splits`
// ranges of `split` depth (a multiple of the slab) but the last; part:
// (splits, tiles, 64 x 128) floats of workspace and count: `tiles`
// counters, zero (and left zero), both only read with more than one split.
// The single-layer entry of the wrapper calls it with layers = 1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the grid cannot
// hold or a plan that does not cover the depth.
extern "C" int rank_partition_agg_f32(const float* bs, const float* as,
                                      const float* omega, float* out,
                                      float* part, unsigned* count,
                                      int layers, int M, int d, int r, int n,
                                      int splits, int split, void* stream) {
  if (layers < 0 || M < 0 || d < 0 || r < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (layers == 0 || d == 0 || n == 0) return 0;
  const long long depth = (long long)M * r;
  const bool covers =
      depth <= 0x7fffffff && splits >= 1 && split > 0 &&
      split % sgemm::kBK == 0 && (long long)splits * split >= depth &&
      (splits == 1 ||
       ((long long)(splits - 1) * split < depth && part && count));
  if (!covers || (d + BM - 1) / BM > 65535 || layers > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row they read is 16-byte aligned
  const bool vec = r % 4 == 0 && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(bs) |
                    reinterpret_cast<uintptr_t>(as) |
                    reinterpret_cast<uintptr_t>(omega)) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(bs, as, omega, out, part, count, layers, M, d, r,
                            n, splits, split, s)
             : launch<false>(bs, as, omega, out, part, count, layers, M, d,
                             r, n, splits, split, s);
}
