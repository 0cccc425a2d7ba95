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
//    a skipped slab would have added only products with a zero factor;
//    the reference's dot(b * om, a) still turns an inf or NaN there into
//    NaN (0 * inf): a B entry at a dead column NaNs its output row, an A
//    entry at a dead depth its output column. So a flag kernel of F
//    blocks reads the dead slabs once, 16 bytes a load and with no
//    products, and tags the rows and columns that hold one (flag_pass);
//    the tile kernel, its programmatic dependent, runs beside it, and a
//    storing thread reads the flag blocks' verdict, one word read as its
//    block starts, and NaNs its tagged outputs, while the last flag block
//    NaNs those of tiles stored before the verdict was complete. No block
//    waits. Weights that leave no slab dead cost the flag blocks one pass
//    over omega;
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
// With `dead`, the other slabs instead: those whose weights are all zero.
__device__ __forceinline__ int live_slabs(int* live,
                                          const float* __restrict__ omega,
                                          int kbeg, int kend,
                                          bool dead = false) {
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
      on ^= dead;
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

// whether v is inf or NaN
__device__ __forceinline__ bool not_finite(float v) {
  return !(fabsf(v) < __uint_as_float(0x7f800000u));
}

// tags with `epoch` the row (layer l, row i) or column (l, j) of each of
// the kU x 4 values a thread loaded that is inf or NaN; whether one was
template <int kU>
__device__ __forceinline__ bool tag(const float (&v)[kU][4],
                                    const int (&at)[kU], int* flag,
                                    int step, int epoch) {
  bool hit = false;
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (not_finite(v[u][k])) {
        flag[at[u] + k * step] = epoch;
        hit = true;
      }
  return hit;
}

// The flag pass of one launch, a kernel of its own (flag_kernel), F
// blocks: each lists the dead slabs (every weight zero) of the whole depth
// in `dead` (shared memory) and takes the units (layer l, dead slab q), q
// fastest, F apart: B at the slab's 16 depths for every row, in runs of
// one client's columns, and A at them for every column, four floats a
// load (16 bytes where kVec), kU loads a thread in flight, no products.
// A row or column holding an inf or NaN is tagged with `epoch` in
// row_flag (L, d) / col_flag (L, n) and bit 31 of `word` set; then the
// block adds one to `word`'s count, and the block that brings it to F,
// if bit 31 is set, writes NaN over every tagged row and column of `out`.
template <bool kVec>
__device__ void flag_pass(int* dead, const float* __restrict__ bs,
                          const float* __restrict__ as,
                          const float* __restrict__ omega, float* out,
                          int layers, int M, int d, int r, int n, int F,
                          int epoch, unsigned* word, int* row_flag,
                          int* col_flag) {
  constexpr int kU = 8;
  const int depth = M * r;
  const int nd = live_slabs(dead, omega, 0, depth, /*dead=*/true);
  bool hit = false;
  for (int u0 = blockIdx.x; u0 < layers * nd; u0 += F) {
    const int l = u0 / nd, t0 = dead[u0 % nd];
    const int t_end = min(t0 + sgemm::kBK, depth);
    // B: each client run [t, t1) of the slab, rows i of four depths
    for (int t = t0; t < t_end;) {
      const int m = t / r, t1 = min(t_end, (m + 1) * r);
      const float* run = bs + (((size_t)l * M + m) * d) * r + (t - m * r);
      const int quads = (t1 - t + 3) / 4, items = d * quads;
      for (int e0 = threadIdx.x; e0 < items; e0 += kU * sgemm::kThreads) {
        float v[kU][4];
        int at[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = e0 + u * sgemm::kThreads;
          const int i = e / quads, c = 4 * (e - i * quads);
          at[u] = l * d + i;
          if (kVec && e < items) {
            const float4 w = *reinterpret_cast<const float4*>(
                run + (size_t)i * r + c);
            v[u][0] = w.x; v[u][1] = w.y; v[u][2] = w.z; v[u][3] = w.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[u][k] = e < items && t + c + k < t1
                            ? run[(size_t)i * r + c + k] : 0.f;
          }
        }
        hit |= tag<kU>(v, at, row_flag, 0, epoch);
      }
      t = t1;
    }
    // A: its rows t0 .. t_end - 1, four columns a load
    const int quads = (n + 3) / 4, items = (t_end - t0) * quads;
    const float* rows = as + ((size_t)l * depth + t0) * n;
    for (int e0 = threadIdx.x; e0 < items; e0 += kU * sgemm::kThreads) {
      float v[kU][4];
      int at[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * sgemm::kThreads;
        const int tt = e / quads, j = 4 * (e - tt * quads);
        at[u] = l * n + j;
        if (kVec && e < items) {
          const float4 w = *reinterpret_cast<const float4*>(
              rows + (size_t)tt * n + j);
          v[u][0] = w.x; v[u][1] = w.y; v[u][2] = w.z; v[u][3] = w.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[u][k] = e < items && j + k < n ? rows[(size_t)tt * n + j + k]
                                             : 0.f;
        }
      }
      hit |= tag<kU>(v, at, col_flag, 1, epoch);
    }
  }
  if (hit) atomicOr(word, 0x80000000u);
  __shared__ unsigned old;
  __threadfence();               // the tags before the count
  __syncthreads();
  if (threadIdx.x == 0) old = atomicAdd(word, 1u);
  __syncthreads();
  if ((old & 0x7fffffffu) != (unsigned)F - 1 || !(old >> 31)) return;
  // the last flag block, with an inf or NaN flagged: NaN over every tagged
  // row and column of `out`, after every tile store that read the count
  // before it was complete (a tile stored later NaNs its own)
  __threadfence();
  const float nan = __uint_as_float(0x7fc00000u);
  for (int e = threadIdx.x; e < layers * d; e += sgemm::kThreads)
    if (__ldcg(row_flag + e) == epoch)
      for (int j = 0; j < n; ++j) out[(size_t)e * n + j] = nan;
  for (int e = threadIdx.x; e < layers * n; e += sgemm::kThreads)
    if (__ldcg(col_flag + e) == epoch)
      for (int i = 0; i < d; ++i)
        out[((size_t)(e / n) * d + i) * n + e % n] = nan;
}

// F blocks of flag_pass; each first lets the launch's tile kernel start
// (programmatic dependent launch), so that the two run side by side.
// Block 0 clears the word of the other epoch, the next launch's. Dynamic
// shared memory: the dead list (depth / 16 + kStages ints).
template <bool kVec>
__global__ void __launch_bounds__(sgemm::kThreads)
flag_kernel(const float* __restrict__ bs, const float* __restrict__ as,
            const float* __restrict__ omega, float* out, int* flags,
            int layers, int M, int d, int r, int n, int epoch) {
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ int dead[];
  unsigned* words = reinterpret_cast<unsigned*>(flags);
  if (blockIdx.x == 0 && threadIdx.x == 0) words[(epoch + 1) & 1] = 0u;
  int* row_flag = flags + 2;
  flag_pass<kVec>(dead, bs, as, omega, out, layers, M, d, r, n, gridDim.x,
                  epoch, words + (epoch & 1), row_flag,
                  row_flag + (size_t)layers * d);
}

constexpr int BM = 64, BN = 128;    // gemm_plan.py's AGG_TILE
using T = sgemm::Tile<BM, BN>;

// NaN over a thread's stored outputs of the tile at (m0, n0) (store_tile's
// map) whose row or column is tagged `epoch`; not inlined, as flag_pass
__device__ __noinline__ void mark_tagged(float* o, const int* row_flag,
                                         const int* col_flag, int d, int n,
                                         int m0, int n0, int epoch) {
  const int ty = sgemm::grid_row(), tx = sgemm::grid_col();
  for (int i = 0; i < T::TM; ++i) {
    const int row = m0 + sgemm::tile_row(i, ty);
    if (row >= d) continue;
    const bool bad = __ldcg(row_flag + row) == epoch;
    for (int j = 0; j < T::TN; ++j) {
      const int col = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (col < n && (bad || __ldcg(col_flag + col) == epoch))
        o[(size_t)row * n + col] = __uint_as_float(0x7fc00000u);
    }
  }
}

// Grid (n tiles x splits, d tiles, layers); `split` depth a range. Dynamic
// shared memory: the ring, then the live list (split / 16 + kStages ints).
// Launched as the programmatic dependent of this launch's flag_kernel, so
// that both run at once, and no block waits for the other kernel: a tile
// block reads this epoch's word as it starts (most start after the flag
// blocks are done); a thread of the block that stores a tile stores it,
// and if the word was not complete, reads it again after a fence;
// complete (either read), it NaNs what it stored on tagged rows and
// columns; still not, the last flag block's NaN comes after its stores.
// flags: the two epochs' words, then a tag a row (L, d) and a column (L,
// n). __launch_bounds__(256, 3): at most 85 registers, three blocks an SM.
template <bool kVec>
__global__ void __launch_bounds__(sgemm::kThreads, 3)
rank_partition_agg_kernel(const float* __restrict__ bs,
                          const float* __restrict__ as,
                          const float* __restrict__ omega,
                          float* __restrict__ out, float* __restrict__ part,
                          unsigned* __restrict__ count, const int* flags,
                          int M, int d, int r, int n, int split, int n_tiles,
                          int F, int epoch) {
  extern __shared__ __align__(16) float smem[];
  int* live = reinterpret_cast<int*>(smem + T::kRingBytes / 4);
  const int layer = blockIdx.z;
  const int tn = blockIdx.x % n_tiles, s = blockIdx.x / n_tiles;
  const int m0 = blockIdx.y * BM, n0 = tn * BN;
  const int depth = M * r;
  const int kbeg = s * split, kend = min(depth, kbeg + split);
  // this epoch's word, read as the block starts: its load overlaps the
  // slab list's loads of omega, and it waits in shared memory, not in a
  // register, over the mainloop
  const volatile unsigned* word =
      reinterpret_cast<const volatile unsigned*>(flags) + (epoch & 1);
  __shared__ unsigned early;
  const unsigned first = threadIdx.x == 0 ? *word : 0u;
  const sgemm::SlabList slabs{live, live_slabs(live, omega, kbeg, kend)};
  if (threadIdx.x == 0) early = first;
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
  unsigned verdict = early;      // stored before the mainloop's barriers
  if ((verdict & 0x7fffffffu) < (unsigned)F) {
    __threadfence();             // the stores before the second read
    verdict = *word;
    if ((verdict & 0x7fffffffu) < (unsigned)F) return;
  }
  if (!(verdict >> 31)) return;
  // an inf or NaN in a dead slab somewhere: NaN over this thread's stored
  // outputs on tagged rows and columns
  __threadfence();               // the count before the tags
  const int* row_flag = flags + 2;
  mark_tagged(out + (size_t)blockIdx.z * d * n,
              row_flag + (size_t)blockIdx.z * d,
              row_flag + (size_t)gridDim.z * d + (size_t)blockIdx.z * n, d,
              n, blockIdx.y * BM, (blockIdx.x % n_tiles) * BN, epoch);
}

constexpr int kDevices = 16;   // devices whose granted smem is remembered

template <bool kVec>
int launch(const float* bs, const float* as, const float* omega, float* out,
           float* part, unsigned* count, int* flags, int layers, int M,
           int d, int r, int n, int splits, int split, int F, int epoch,
           cudaStream_t stream) {
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
  const int depth = M * r;
  flag_kernel<kVec><<<F, sgemm::kThreads,
                      (depth / sgemm::kBK + sgemm::kStages) * sizeof(int),
                      stream>>>(bs, as, omega, out, flags, layers, M, d, r,
                                n, epoch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * splits, (d + BM - 1) / BM, layers);
  cfg.blockDim = dim3(sgemm::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int* cflags = flags;
  return (int)cudaLaunchKernelEx(&cfg, rank_partition_agg_kernel<kVec>, bs,
                                 as, omega, out, part, count, cflags, M, d,
                                 r, n, split, n_tiles, F, epoch);
}

}  // namespace

// One launch on `stream`. The plan (gemm_plan.py::plan_agg): `splits`
// ranges of `split` depth (a multiple of the slab) but the last; part:
// (splits, tiles, 64 x 128) floats of workspace and count: `tiles`
// counters, zero (and left zero), both only read with more than one split;
// flags: 2 + layers (d + n) ints, zero before the first launch, `F` >= 1
// flag blocks and `epoch` >= 1, one more than the last launch's on these
// flags (the words alternate between launches and the tags are compared
// to the epoch, so nothing else is cleared). Two kernels: the flag pass
// and, as its programmatic dependent, the tiles. The single-layer entry
// of the wrapper calls it with layers = 1. Returns the first error, or
// cudaErrorInvalidValue for a shape the grid cannot hold or a plan that
// does not cover the depth.
extern "C" int rank_partition_agg_f32(const float* bs, const float* as,
                                      const float* omega, float* out,
                                      float* part, unsigned* count,
                                      int* flags, int layers, int M, int d,
                                      int r, int n, int splits, int split,
                                      int F, int epoch, void* stream) {
  if (layers < 0 || M < 0 || d < 0 || r < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (layers == 0 || d == 0 || n == 0) return 0;
  const long long depth = (long long)M * r;
  const bool covers =
      depth <= 0x7fffffff && splits >= 1 && split > 0 &&
      split % sgemm::kBK == 0 && (long long)splits * split >= depth &&
      (splits == 1 ||
       ((long long)(splits - 1) * split < depth && part && count));
  // a flag block lists the dead slabs of the whole depth in its 48 KiB of
  // shared memory, and counts a unit's items and the tags in an int
  const bool fits =
      depth / sgemm::kBK + sgemm::kStages <= 48 * 1024 / 4 &&
      (long long)sgemm::kBK * (d + n) < 0x7fffffff;
  if (!covers || !fits || !flags || F < 1 || epoch < 1 ||
      (long long)layers * (d + n) > 0x7fffffff - 2 ||
      (long long)layers * depth > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row they read is 16-byte aligned
  const bool vec = r % 4 == 0 && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(bs) |
                    reinterpret_cast<uintptr_t>(as) |
                    reinterpret_cast<uintptr_t>(omega)) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(bs, as, omega, out, part, count, flags, layers,
                            M, d, r, n, splits, split, F, epoch, s)
             : launch<false>(bs, as, omega, out, part, count, flags, layers,
                             M, d, r, n, splits, split, F, epoch, s);
}
