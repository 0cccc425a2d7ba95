// K6: Mamba-2 SSD chunked scan (the dual form), f32 accuracy on the
// tensor cores (3xTF32).
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_pallas and the group
// expansion of repro/kernels/ops.py::ssd_scan. Contract
// (repro/models/layers/ssd.py::ssd_scan_chunked), per batch row b and
// head h, with A = -exp(a_log[h]) and chunks of Q tokens:
//
//     cum_i   = sum_{q <= i} dt_q A                (inclusive, in the chunk)
//     y_i     = sum_{j <= i} ((C_i . B_j) exp(cum_i - cum_j)) dtx_j
//             + exp(cum_i) C_i . S_c               (S_c: state entering chunk c)
//             + D x_i,                             dtx_j = x_j dt_j
//     S_{c+1} = exp(cum_{Q-1}) S_c + dS_c,
//     dS_c    = sum_q (dtx_q exp(cum_{Q-1} - cum_q)) B_q^T
//
// x (B, L, H, P), dt (B, L, H), b and c (B, L, G, N), a_log and d_skip
// (H,), init (B, H, P, N) or null (a zero state); y (B, L, H, P) and the
// final state (B, H, P, N). All contiguous f32. Head h reads group
// h / (H / G) in place: the (B, L, H, N) expansion the TPU wrapper built
// is never materialised.
//
// Design. The TPU kernel walked the chunks in order with the state in
// VMEM. dS_c depends on chunk c's tokens alone, so here the chunks run in
// parallel, in four launches on one stream, sharing one scratch buffer
// (and a fifth, 5. repair, which reads one flag unless an output is NaN):
//   1. cb:    C B^T once per (batch, chunk, group), 64 x 64 tiles on and
//             below the diagonal, into scratch (B, nc, G, Qp, Qp); it does
//             not depend on the head, and the group's heads all read it.
//             The diagonal tiles, which hold every row of the chunk's C and
//             B between them, also write their rows' max |C| and max |B|;
//   2. state: one block per (b, chunk, h, P slice): the chunk's cumsum by
//             a block scan (written to scratch for launches 3 and 4), then
//             dS_c = (dtx o decay)^T B over the chunk's tokens, decay_q =
//             exp(cum_last - cum_q), into scratch (B, nc, H, P, N);
//   3. carry: a thread per four entries (b, h, p, n..n+3) walks the chunks
//             in order, replacing dS_c by S_c and writing the final state;
//   4. out:   one block per (b, chunk, h, P slice, 128 rows of the chunk):
//             y = (C exp(cum)) S_c^T + (C B^T o L) dtx + D x, with
//             L_ij = exp(cum_i - cum_j) for j <= i, masked before it is
//             used (a select, so an exp of a positive difference, or a C B^T
//             entry above the diagonal, never reaches a sum); the tiles
//             above the diagonal are skipped.
// Outputs that the 3xTF32 passes gave NaN (they met an inf or NaN
// operand) are summed again in IEEE f32 from the same operand values
// (mma_tf32x3.cuh): launches 1 and 2 repair their own in place, launch 4
// flags its, and launch 5 repairs them.
// The reference's intermediates. The kernel forms dtx = x dt, C B^T, L,
// C B^T o L and the decays as the reference names them, so that an
// intermediate that overflows or underflows does so as there: dtx as an x
// element's fragment loads (launches 2 and 4), never folded into a decay
// or into C B^T. The file is compiled with -ftz=true (kernels/build.py):
// every f32 result below 2^-126 is 0 and every such operand read as 0, as
// XLA's CPU backend and the TPU compute f32, so a decay exp(cum_i - cum_j)
// beyond -87.3 is 0 and 0 * inf = NaN beside it as in the reference.
// Above the diagonal. The reference multiplies C B^T by L = exp(-1e30) = 0
// there and takes the product with dtx over the whole chunk, so y[i, p]
// is NaN wherever a token j > i of the chunk has a non-finite dtx[j, p]
// or C[i] . B[j]: 0 * inf. Launch 4 never reads those tokens for row i;
// the rule is applied where the inputs are already read. A non-finite
// dtx[j, p], dt[j] or B[j] makes the chunk-local state dS_c non-finite
// (inf * 0 is NaN too, where a decay is 0), which launch 3 tests as it
// loads it (no byte added), and a non-finite C[i] makes row i NaN in
// launch 4's passes; either raises the (b, chunk, h)'s flag. Finite C[i]
// and B[j] whose product overflows can do so only where max |C| max |B| N
// reaches 2^127 (launch 1's maxima, which launch 2 reads as it writes the
// flag). Launch 5 visits every output of a flagged (b, chunk, h): NaN
// where the rule says so, the IEEE re-sum where launch 4 gave NaN, launch
// 4's bits elsewhere. Out of scope, as order-dependent in both packages:
// the overflow of a partial sum inside a contraction or the cumsum, the
// grouping that XLA picks inside the reference's three-operand products,
// and a denormal input that a product reads straight from memory (B and C
// in C B^T, B in the states, the states in the readout).
// The products (C B^T, depth N; (dtx o decay)^T B, depth Q; C S^T, depth
// N; the causal (C B^T o L) dtx, depth Q) run as 3xTF32 mma.sync (see
// mma_tf32x3.cuh): f32 accuracy, the reference's tolerance unchanged. A
// warp owns two 16-row m tiles; both operands of every product reach it
// from shared memory, filled by cp.async through a ring of two slots (one
// barrier a stage: the copy of stage k + 1 runs during stage k's products)
// and padded so that every fragment load is conflict-free. The decay's
// exps, 8 a lane each k-step of launch 4, are exp2 of the difference of
// two cumsums times log2(e), the difference formed first, as the
// reference forms cum_i - cum_j: cumsums kept in log2 units round each
// product cum log2(e) on its own, and near 1e9 their difference can lie
// hundreds from the reference's, an exp of 0 turned into a normal number.
// Every sum runs in a fixed order with no atomics: two launches on the
// same inputs are bit-equal.
//
// On an H100 (PERF.md) launch 4 takes most of the time; in design probes
// three output blocks an SM with a two-slot ring ran faster than two
// blocks with a deeper ring, and exp2 faster than expf.
//
// Bound. Every token needs the recurrence's two state products, the
// update S += B dtx^T and the readout C . S: 2 P N multiply-adds per
// (token, head), 8.59 GFLOP for mamba2-1.3b's prefill layer (B 4, L 1024,
// H 64, P 64, N 128), against 148 MB of inputs and outputs: bound by
// operations, 0.052 ms at 3xTF32's 165 TFLOP/s. The chunked form also does
// the intra-chunk products (13.0 GFLOP in all at that shape, 0.13 of it
// C B^T), which a smaller chunk would avoid, so the bound leaves them out.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_tf32x3.cuh"
#include "sgemm_f32.cuh"   // the cp.async helpers

namespace {

constexpr int kMaxPS = 64;        // state rows P a block owns
constexpr int kMaxN = 128;        // state width N
constexpr int kCB = 64;           // C B^T tile
constexpr int kCBWarps = 4;       // 16 rows each
constexpr int kTok = 32;          // tokens a ring stage of launches 2 and 4
constexpr int kRing = 2;          // ring slots of launches 2 and 4
constexpr int kOutBlocks = 3;     // output blocks an SM (<= 170 registers)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kOutWarps = 4;      // 32 rows each (two m tiles)
constexpr int kOutRows = 32 * kOutWarps;
constexpr int kCarryThreads = 256;
constexpr int kCarryAhead = 4;    // chunks' dS a carry thread loads at once
constexpr int kDevices = 16;      // devices whose granted smem is kept

__host__ __device__ constexpr int up8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr long long up4(long long n) {
  return (n + 3) / 4 * 4;
}
// row strides (floats): 8 (mod 32) for 8-byte A / B^T row loads, 4 (mod 16)
// for 4-byte column loads (mma_tf32x3.cuh)
__host__ __device__ constexpr int ld_rows(int w) {
  return w + (40 - w % 32) % 32;
}
__host__ __device__ constexpr int ld_cols(int w) {
  return w + (w % 16 ? 12 : 4);
}

// a ring slot of the output kernel (floats): kOutRows rows of C or C B^T,
// kTok deep, and the S chunk (8 PT rows, kTok deep) or the x tile (kTok
// rows of 8 PT)
__host__ __device__ constexpr int out_slot(int pt) {
  return kOutRows * ld_rows(kTok) +
         (8 * pt * ld_rows(kTok) > kTok * ld_cols(8 * pt)
              ? 8 * pt * ld_rows(kTok)
              : kTok * ld_cols(8 * pt));
}

template <int W> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
// exp(d) as exp2 of d log2(e); d a cumsum or a difference of two, formed
// as the reference forms it before its exp
__device__ __forceinline__ float exp_of(float d) {
  return exp2f(d * kLog2e);
}
// s d + x
__device__ __forceinline__ float axpy(float s, float d, float x) {
  return s * d + x;
}
__device__ __forceinline__ float4 axpy(float4 s, float d, float4 x) {
  return make_float4(s.x * d + x.x, s.y * d + x.y, s.z * d + x.z,
                     s.w * d + x.w);
}

// rows [r0, r0 + rows) of a (.., stride)-strided operand into a tile (row
// stride ld): `cols` floats a row, zero past `limit` rows and from `cols`
// to `width`
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, size_t stride,
                                          int r0, int rows, int limit,
                                          int cols, int width, bool vec) {
  if (vec) {                       // cols % 4 == 0: a 16-byte copy is all in or out
    const int per_row = width / 4;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * 4;
      const bool in = r0 + r < limit && c < cols;
      sgemm::cp_async16(dst + r * ld + c,
                        in ? src + (size_t)(r0 + r) * stride + c : src,
                        in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
      const int r = e / width, c = e - r * width;
      const bool in = r0 + r < limit && c < cols;
      sgemm::cp_async4(dst + r * ld + c,
                       in ? src + (size_t)(r0 + r) * stride + c : src,
                       in ? 4 : 0);
    }
  }
}

// the largest |v| over a rows x cols tile of v (row stride ld), by the
// whole block; every thread gets it, NaN entries left out
__device__ float block_absmax(const float* v, int rows, int cols, int ld,
                              float* red) {
  float m = 0.f;
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x)
    m = fmaxf(m, fabsf(v[e / cols * ld + e % cols]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  __syncthreads();                      // red free for the next call
  return m;
}

// whether C[i] . B[j] of a (b, chunk, group) can overflow f32 for some
// rows i, j: |C[i] . B[j]| <= N max |C| max |B|, and a factor 2 covers the
// rounding of the partial sums. An infinite maximum counts, a NaN one
// cannot arise (block_absmax leaves NaN out).
__device__ __forceinline__ bool cb_may_overflow(const float2* cbmax,
                                                size_t bcg, int tiles,
                                                int N) {
  float mc = 0.f, mb = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float2 m = cbmax[bcg * tiles + t];
    mc = fmaxf(mc, m.x);
    mb = fmaxf(mb, m.y);
  }
  return !((double)mc * (double)mb * N < 0x1p127);
}

// 1. C B^T tile (it, jt), jt <= it, of one (b, chunk, group); a diagonal
// tile writes the max |C| and max |B| of its rows to cbmax[bcg tiles + it]
__global__ void __launch_bounds__(32 * kCBWarps)
ssd_scan_cb(const float* __restrict__ bmat, const float* __restrict__ cmat,
          float* __restrict__ cb, float2* __restrict__ cbmax,
          int* __restrict__ flag, int L, int G, int N, int Q, int Qp,
          int vec) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *flag = 0;
  const int Np = up8(N), ld = ld_rows(Np);
  float* cs = smem;                     // C rows i0.., cs[i * ld + n]
  float* bs = smem + kCB * ld;          // B rows j0.., bs[j * ld + n]
  int it = 0, pair = blockIdx.y;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int bcg = blockIdx.x;           // (b * nc + chunk) * G + g
  const int g_idx = bcg % G, bc = bcg / G;
  const int nc = L / Q, bi = bc / nc, ci = bc - bi * nc;
  const size_t row_stride = (size_t)G * N;
  const size_t base = ((size_t)bi * L + (size_t)ci * Q) * row_stride +
                      (size_t)g_idx * N;
  load_rows(cs, ld, cmat + base, row_stride, it * kCB, kCB, Q, N, Np, vec);
  load_rows(bs, ld, bmat + base, row_stride, jt * kCB, kCB, Q, N, Np, vec);
  sgemm::cp_async_commit();
  sgemm::cp_async_wait<0>();
  __syncthreads();
  if (it == jt) {                       // rows past Q, columns past N are 0
    __shared__ float red[kCBWarps];
    const float mc = block_absmax(cs, kCB, Np, ld, red);
    const float mb = block_absmax(bs, kCB, Np, ld, red);
    if (threadIdx.x == 0)
      cbmax[(size_t)bcg * (Qp / kCB) + it] = make_float2(mc, mb);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[kCB / 8][4];
#pragma unroll
  for (int n = 0; n < kCB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* cw = cs + 16 * warp * ld;
#pragma unroll 2
  for (int k0 = 0; k0 < Np; k0 += 8) {
    const tf32x3::FragA a = tf32x3::load_a_rows(cw, ld, k0, g, t);
#pragma unroll
    for (int n = 0; n < kCB / 8; ++n)
      tf32x3::mma3(acc[n], a, tf32x3::load_b_rows(bs + 8 * n * ld, ld, k0, g, t));
  }
  float* out = cb + ((size_t)bcg * Qp + it * kCB + 16 * warp) * Qp + jt * kCB;
#pragma unroll
  for (int n = 0; n < kCB / 8; ++n) {
    *reinterpret_cast<float2*>(out + (size_t)g * Qp + 8 * n + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (size_t)(g + 8) * Qp + 8 * n + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
  // an entry the 3xTF32 passes gave NaN summed again in IEEE f32 from the
  // same rows (mma_tf32x3.cuh), in place, by the thread that stored it: a
  // rolled loop apart from the products, so it adds no register to them
  bool nan = false;
#pragma unroll
  for (int n = 0; n < kCB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) nan |= acc[n][e] != acc[n][e];
  if (!nan) return;
#pragma unroll 1
  for (int q = 0; q < kCB / 2; ++q) {
    const int n = q / 4, e = q % 4;
    float* o = out + (size_t)(g + 8 * (e >> 1)) * Qp + 8 * n + 2 * t + (e & 1);
    if (*o == *o) continue;
    const float* ci = cw + (g + 8 * (e >> 1)) * ld;
    const float* bj = bs + (8 * n + 2 * t + (e & 1)) * ld;
    float d = 0.f;
#pragma unroll 1
    for (int k = 0; k < N; ++k) d = fmaf(ci[k], bj[k], d);
    *o = d;
  }
}

// inclusive scan of v[0 .. Q) in place by the whole block: each thread
// sums a contiguous run, the runs' totals are scanned across the warps,
// then each run is rewritten from its prefix. A fixed order: every block
// that scans the same values gets the same bits.
__device__ void block_scan(float* v, int Q, float* warp_sums) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int run = (Q + T - 1) / T, q0 = min(Q, tid * run),
            q1 = min(Q, q0 + run);
  float tot = 0.f;
  for (int q = q0; q < q1; ++q) tot += v[q];
  float inc = tot;                      // inclusive over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sums[warp] = inc;
  float prefix = __shfl_up_sync(0xffffffffu, inc, 1);   // exclusive
  if (lane == 0) prefix = 0.f;
  __syncthreads();
  for (int w = 0; w < warp; ++w) prefix += warp_sums[w];
  for (int q = q0; q < q1; ++q) {
    prefix += v[q];
    v[q] = prefix;
  }
  __syncthreads();
}

// 2. the chunk-local state of one (b, chunk, h, P slice): dS[p][n] =
// sum_q (x[q][p] dt_q) decay_q B[q][n]. Warp w owns p rows 32 (w / 2) ..
// + 31 (two m tiles) and n tiles NTW (w % 2) .. + NTW - 1. The P slice 0
// block writes the (b, chunk, h)'s flag, flag[1 + (b nc + chunk) H + h]:
// 1 where its group's C B^T may overflow (launch 1's maxima; the call's
// flag raised with it), else 0.
template <int NTW>
__global__ void __launch_bounds__(128)
ssd_scan_state(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a_log, const float* __restrict__ bmat,
             const float2* __restrict__ cbmax, float* __restrict__ cum_out,
             float* __restrict__ dstate, int* __restrict__ flag, int L, int H,
             int P, int G, int N, int Q, int ps_width, int vec_x, int vec_b) {
  constexpr int NW = 16 * NTW;          // the instance's state width
  constexpr int LDB = ld_cols(NW);
  extern __shared__ __align__(16) float smem[];
  const int slice = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int nc = L / Q, bi = bc / nc, ci = bc - bi * nc;
  const int p0 = slice * ps_width, ps = min(ps_width, P - p0);
  const int PW = 32 * (blockDim.x / 64);   // padded slice rows
  const int g_idx = h / (H / G);
  if (slice == 0 && threadIdx.x == 0) {
    const bool may = cb_may_overflow(cbmax, (size_t)bc * G + g_idx,
                                     (Q + kCB - 1) / kCB, N);
    flag[1 + (size_t)bc * H + h] = may;
    if (may) flag[0] = 1;
  }
  const int LDX = ld_cols(PW);
  const int Qt = (Q + kTok - 1) / kTok * kTok;
  float* cum = smem;                    // Qt each
  float* ws = cum + Qt;                 // the decays
  float* dts = ws + Qt;                 // dt
  float* warp_sums = dts + Qt;          // 32
  float* ring = warp_sums + 32;         // 2 x (xs, bs)
  const int slot = kTok * (LDX + LDB);
  const size_t tok0 = (size_t)bi * L + (size_t)ci * Q;
  const float* xsrc = x + tok0 * H * P + (size_t)h * P + p0;
  const float* bsrc = bmat + tok0 * G * N + (size_t)g_idx * N;
  const int ntile = Qt / kTok;
  auto issue = [&](int tile) {
    if (tile >= ntile) return;
    float* s = ring + (tile % kRing) * slot;
    load_rows(s, LDX, xsrc, (size_t)H * P, tile * kTok, kTok, Q, ps, PW,
              vec_x);
    load_rows(s + kTok * LDX, LDB, bsrc, (size_t)G * N, tile * kTok, kTok, Q,
              N, NW, vec_b);
  };
  for (int tile = 0; tile < kRing - 1; ++tile) {
    issue(tile);
    sgemm::cp_async_commit();           // an empty group keeps the count
  }

  // the cumsum, dt and the decays, while the first tile is in flight
  const float A = -expf(a_log[h]);
  for (int q = threadIdx.x; q < Qt; q += blockDim.x) {
    dts[q] = q < Q ? dt[(tok0 + q) * H + h] : 0.f;
    cum[q] = q < Q ? dts[q] * A : 0.f;
  }
  __syncthreads();
  block_scan(cum, Q, warp_sums);
  const float last = cum[Q - 1];
  for (int q = threadIdx.x; q < Qt; q += blockDim.x) {
    ws[q] = q < Q ? expf(last - cum[q]) : 0.f;
    if (slice == 0 && q < Q) cum_out[((size_t)bc * H + h) * Q + q] = cum[q];
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int prow = 32 * (warp >> 1), ncol = 8 * NTW * (warp & 1);
  float acc[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int tile = 0; tile < ntile; ++tile) {
    sgemm::cp_async_wait<kRing - 2>();  // this tile has landed
    __syncthreads();                    // ... for every thread (and ws); the
                                        // last tile's slot is free
    issue(tile + kRing - 1);
    sgemm::cp_async_commit();
    const float* xs = ring + (tile % kRing) * slot;
    const float* bs = xs + kTok * LDX;
    const float* wt = ws + tile * kTok;
    const float* dtt = dts + tile * kTok;
#pragma unroll
    for (int k0 = 0; k0 < kTok; k0 += 8) {
      const float w0 = wt[k0 + 2 * t], w1 = wt[k0 + 2 * t + 1];
      const float d0 = dtt[k0 + 2 * t], d1 = dtt[k0 + 2 * t + 1];
      const float* r0 = xs + (k0 + 2 * t) * LDX + prow + g;
      const float* r1 = r0 + LDX;
      tf32x3::FragA a[2];   // (x dt) decay: dtx first, as the reference
#pragma unroll
      for (int m = 0; m < 2; ++m)
        a[m] = tf32x3::frag_a(r0[16 * m] * d0 * w0, r0[16 * m + 8] * d0 * w0,
                              r1[16 * m] * d1 * w1, r1[16 * m + 8] * d1 * w1);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const tf32x3::FragB bf =
            tf32x3::load_b_cols(bs + ncol + 8 * n, LDB, k0, g, t);
#pragma unroll
        for (int m = 0; m < 2; ++m) tf32x3::mma3(acc[m][n], a[m], bf);
      }
    }
  }
  sgemm::cp_async_wait<0>();
  float* out = dstate + (((size_t)bc * H + h) * P + p0) * N;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = prow + 16 * m + g + 8 * (e >> 1);
        const int col = ncol + 8 * n + 2 * t + (e & 1);
        if (p < ps && col < N) out[(size_t)p * N + col] = acc[m][n][e];
      }
  // an entry the passes gave NaN summed again in IEEE f32, in place, by the
  // thread that stored it, the operand (x dt) decay formed as above: a
  // rolled loop apart from the products, so it adds no register to them
  bool nan = false;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) nan |= acc[m][n][e] != acc[m][n][e];
  if (!nan) return;
#pragma unroll 1
  for (int q = 0; q < 8 * NTW; ++q) {
    const int m = q / (4 * NTW), n = q / 4 % NTW, e = q % 4;
    const int p = prow + 16 * m + g + 8 * (e >> 1);
    const int col = ncol + 8 * n + 2 * t + (e & 1);
    if (p >= ps || col >= N) continue;
    float* o = out + (size_t)p * N + col;
    if (*o == *o) continue;
    float d = 0.f;
#pragma unroll 1
    for (int j = 0; j < Q; ++j)
      d = fmaf(xsrc[(size_t)j * H * P + p] * dts[j] * ws[j],
               bsrc[(size_t)j * G * N + col], d);
    *o = d;
  }
}

// 3. the carry: S_0 = init (or 0), S_{c+1} = exp(cum_last) S_c + dS_c, in
// chunk order; S_c replaces dS_c in the scratch, the last S is the final
// state. A thread owns W consecutive entries of one (b, h) and loads
// kCarryAhead chunks' dS before it stores, so that many loads are in flight
// (the pass moves bytes: the states are read once and written once). A
// non-finite dS_c entry (a non-finite dtx, dt or B in the chunk) raises
// the (b, chunk, h)'s flag and the call's.
__device__ __forceinline__ bool finite(float v) {
  return fabsf(v) <= 3.402823466e38f;
}
__device__ __forceinline__ bool finite(float4 v) {
  return finite(v.x) && finite(v.y) && finite(v.z) && finite(v.w);
}

template <int W>
__global__ void __launch_bounds__(kCarryThreads)
ssd_scan_carry(const float* __restrict__ init, const float* __restrict__ cum,
             float* __restrict__ states, float* __restrict__ final_state,
             int* __restrict__ flag, int B, int H, int P, int N, int Q,
             int nc) {
  using T = typename Vec<W>::T;
  const size_t per_b = (size_t)H * P * N / W;      // T entries a batch row
  const size_t e = (size_t)blockIdx.x * kCarryThreads + threadIdx.x;
  if (e >= (size_t)B * per_b) return;
  const size_t bi = e / per_b, rem = e - bi * per_b;
  const int h = (int)(rem * W / ((size_t)P * N));
  T* st = reinterpret_cast<T*>(states);
  T s = init ? reinterpret_cast<const T*>(init)[e] : zero<T>();
  for (int c0 = 0; c0 < nc; c0 += kCarryAhead) {
    T ds[kCarryAhead];
    float dec[kCarryAhead];
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u) {
      const size_t bc = bi * nc + c0 + u;
      if (c0 + u < nc) {
        ds[u] = st[bc * per_b + rem];
        dec[u] = expf(cum[(bc * H + h) * Q + Q - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u) {
      if (c0 + u < nc) {
        st[(bi * nc + c0 + u) * per_b + rem] = s;
        s = axpy(s, dec[u], ds[u]);
        if (!finite(ds[u])) {
          flag[1 + (bi * nc + c0 + u) * H + h] = 1;
          flag[0] = 1;
        }
      }
    }
  }
  reinterpret_cast<T*>(final_state)[e] = s;
}

// 4. the outputs of one (b, chunk, h, P slice) for kOutRows rows of the
// chunk; warp w owns rows 32 w .. + 31 of them (two m tiles) and all PT
// column tiles of the slice. One ring of two slots runs through both
// terms, kTok deep a stage: first the readout (C_i exp(cum_i)) . S_c over
// the depth N (a C chunk of the block's rows and an S chunk of the slice's
// rows a stage), then the intra-chunk term over the tokens j0 <= the rows
// (a C B^T tile of the block's rows and an x tile a stage, x dt formed as
// its fragments load), so that both operands of every product come from
// shared memory, the next stage's copy in flight while this one's
// products run.
template <int PT>
__global__ void __launch_bounds__(32 * kOutWarps, kOutBlocks)
ssd_scan_out(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ cmat, const float* __restrict__ d_skip,
           const float* __restrict__ cb, const float* __restrict__ cum,
           const float* __restrict__ states, float* __restrict__ y,
           int* __restrict__ flag, int L, int H, int P, int G, int N, int Q,
           int Qp, int ps_width, int slices, int row_tiles, int vec_x,
           int vec_c, int vec_s) {
  constexpr int PW = 8 * PT, LDX = ld_cols(PW), LDK = ld_rows(kTok);
  constexpr int kSlot = out_slot(PT);
  extern __shared__ __align__(16) float smem[];
  const int rt = row_tiles - 1 - (int)(blockIdx.x / slices);   // longest first
  const int slice = blockIdx.x % slices, h = blockIdx.y, bc = blockIdx.z;
  const int nc = L / Q, bi = bc / nc, ci = bc - bi * nc;
  const int p0 = slice * ps_width, ps = min(ps_width, P - p0);
  const int i0 = rt * kOutRows, i_end = min(Q, i0 + kOutRows);
  const int Qt = (i_end + kTok - 1) / kTok * kTok;
  float* cum_s = smem;                  // Qt each
  float* dt_s = cum_s + Qt;
  float* ring = dt_s + Qt;              // kRing slots
  const int g_idx = h / (H / G);
  const size_t tok0 = (size_t)bi * L + (size_t)ci * Q;
  const size_t bch = (size_t)bc * H + h;
  const float* xsrc = x + tok0 * H * P + (size_t)h * P + p0;
  const float* csrc = cmat + tok0 * G * N + (size_t)g_idx * N;
  const float* ssrc = states + (bch * P + p0) * N;
  const float* cbsrc = cb + (size_t)(bc * G + g_idx) * Qp * Qp;
  const int n_read = (N + kTok - 1) / kTok;     // readout stages
  const int stages = n_read + Qt / kTok;
  // stage k: readout depth n0 = kTok k, or intra tokens j0 = kTok (k - n_read)
  auto issue = [&](int k) {
    if (k >= stages) return;
    float* s = ring + (k % kRing) * kSlot;
    if (k < n_read) {
      const int n0 = k * kTok, cols = min(kTok, N - n0);
      load_rows(s, LDK, csrc + n0, (size_t)G * N, i0, kOutRows, Q, cols,
                kTok, vec_c);
      load_rows(s + kOutRows * LDK, LDK, ssrc + n0, N, 0, PW, ps, cols, kTok,
                vec_s);
    } else {
      const int j0 = (k - n_read) * kTok;
      load_rows(s, LDK, cbsrc + j0, Qp, i0, kOutRows, Q, kTok, kTok, true);
      load_rows(s + kOutRows * LDK, LDX, xsrc, (size_t)H * P, j0, kTok, Q, ps,
                PW, vec_x);
    }
  };
  for (int k = 0; k < kRing - 1; ++k) {
    issue(k);
    sgemm::cp_async_commit();           // an empty group keeps the count
  }
  for (int q = threadIdx.x; q < Qt; q += blockDim.x) {
    cum_s[q] = q < i_end ? cum[bch * Q + q] : 0.f;
    dt_s[q] = q < Q ? dt[(tok0 + q) * H + h] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wi0 = i0 + 32 * warp;       // the warp's first row
  const bool active = wi0 < i_end;
  const int wlast = min(wi0 + 31, i_end - 1);
  // rows i0 + 32 w + 16 m + g + 8 r: cumsum and exp(cumsum)
  float ci_r[2][2], dec[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = wi0 + 16 * m + g + 8 * r;
      ci_r[m][r] = i < i_end ? cum_s[i] : 0.f;
      dec[m][r] = i < i_end ? exp_of(ci_r[m][r]) : 0.f;
    }
  float acc[2][PT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int k = 0; k < stages; ++k) {
    sgemm::cp_async_wait<kRing - 2>();  // stage k has landed
    __syncthreads();                    // ... for every thread (and cum, dt);
                                        // the last stage's slot is free
    issue(k + kRing - 1);
    sgemm::cp_async_commit();
    const float* s = ring + (k % kRing) * kSlot;
    const float* aw = s + 32 * warp * LDK;   // the warp's rows of C or C B^T
    const float* bt = s + kOutRows * LDK;    // S chunk or x tile
    if (k < n_read) {
      if (active) {
#pragma unroll
        for (int k0 = 0; k0 < kTok; k0 += 8) {
          tf32x3::FragA a[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* r0 = aw + (16 * m + g) * LDK + k0 + 2 * t;
            const float2 u = *reinterpret_cast<const float2*>(r0);
            const float2 v = *reinterpret_cast<const float2*>(r0 + 8 * LDK);
            a[m] = tf32x3::frag_a(u.x * dec[m][0], v.x * dec[m][1],
                                  u.y * dec[m][0], v.y * dec[m][1]);
          }
#pragma unroll
          for (int n = 0; n < PT; ++n) {
            const tf32x3::FragB bf =
                tf32x3::load_b_rows(bt + 8 * n * LDK, LDK, k0, g, t);
#pragma unroll
            for (int m = 0; m < 2; ++m) tf32x3::mma3(acc[m][n], a[m], bf);
          }
        }
      }
    } else {
      const int j0 = (k - n_read) * kTok;
      if (active && j0 <= wlast) {
#pragma unroll
        for (int k0 = 0; k0 < kTok; k0 += 8) {
          const int j = j0 + k0 + 2 * t;
          const float cj0 = cum_s[j], cj1 = cum_s[j + 1];
          const float dj0 = dt_s[j], dj1 = dt_s[j + 1];
          tf32x3::FragA a[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* r0 = aw + (16 * m + g) * LDK + k0 + 2 * t;
            const float2 cb_r[2] = {*reinterpret_cast<const float2*>(r0),
                                    *reinterpret_cast<const float2*>(
                                        r0 + 8 * LDK)};
            float v[4];   // (g, j), (g + 8, j), (g, j + 1), (g + 8, j + 1)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = wi0 + 16 * m + g + 8 * r;
              v[r] = j <= i ? cb_r[r].x * exp_of(ci_r[m][r] - cj0) : 0.f;
              v[r + 2] =
                  j + 1 <= i ? cb_r[r].y * exp_of(ci_r[m][r] - cj1) : 0.f;
            }
            a[m] = tf32x3::frag_a(v[0], v[1], v[2], v[3]);
          }
#pragma unroll
          for (int n = 0; n < PT; ++n) {   // rows j, j + 1 of dtx, column g
            const float* xb = bt + (k0 + 2 * t) * LDX + 8 * n + g;
            const tf32x3::FragB bf =
                tf32x3::frag_b(xb[0] * dj0, xb[LDX] * dj1);
#pragma unroll
            for (int m = 0; m < 2; ++m) tf32x3::mma3(acc[m][n], a[m], bf);
          }
        }
      }
    }
  }
  sgemm::cp_async_wait<0>();
  if (!active) return;

  // an output the passes gave NaN (it met an inf or NaN operand): the
  // call's last launch (ssd_scan_repair) sums it again in IEEE f32
  bool nan = false;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) nan |= acc[m][n][e] != acc[m][n][e];
  if (nan) {   // the (b, chunk, h)'s flag: blockIdx.z H + blockIdx.y
    flag[1 + (size_t)blockIdx.z * gridDim.y + blockIdx.y] = 1;
    flag[0] = 1;
  }

  const float dskip = d_skip[h];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = wi0 + 16 * m + g + 8 * r;
      if (i >= i_end) continue;
      const size_t base = (tok0 + i) * H * P + (size_t)h * P + p0;
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * n + 2 * t + e;
          if (p < ps) y[base + p] = acc[m][n][2 * r + e] + dskip * x[base + p];
        }
    }
}

// the dynamic shared memory an instance may take, per device: raised only
// when a launch needs more (setting it costs the host about a launch)
template <auto Kernel>
int grant(size_t bytes) {
  static int granted[kDevices] = {};
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices || (int)bytes > granted[dev]) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kDevices) granted[dev] = (int)bytes;
  }
  return 0;
}

template <int NTW>
int launch_state(const float* x, const float* dt, const float* a_log,
                 const float* b, const float2* cbmax, float* cum,
                 float* states, int* flag, int B, int L, int H, int P, int G,
                 int N, int Q, int slices, int ps, int vec_x, int vec_b,
                 cudaStream_t stream) {
  const int pw = ps <= 32 ? 32 : 64;
  const int Qt = (Q + kTok - 1) / kTok * kTok;
  const size_t smem =
      ((size_t)3 * Qt + 32 + kRing * kTok * (ld_cols(pw) + ld_cols(16 * NTW))) *
      sizeof(float);
  int rc = grant<ssd_scan_state<NTW>>(smem);
  if (rc) return rc;
  dim3 grid(slices, H, B * (L / Q));
  ssd_scan_state<NTW><<<grid, 2 * pw, smem, stream>>>(
      x, dt, a_log, b, cbmax, cum, states, flag, L, H, P, G, N, Q, ps, vec_x,
      vec_b);
  return (int)cudaGetLastError();
}

template <int PT>
int launch_out(const float* x, const float* dt, const float* c,
               const float* d_skip, const float* cb, const float* cum,
               const float* states, float* y, int* flag, int B, int L,
               int H, int P, int G, int N, int Q, int Qp, int slices, int ps,
               int vec_x, int vec_c, int vec_s, cudaStream_t stream) {
  const int row_tiles = (Q + kOutRows - 1) / kOutRows;
  // cum and dt of the last row tile's tokens, and the ring
  const int Qt = (Q + kTok - 1) / kTok * kTok;
  const size_t smem = ((size_t)2 * Qt + kRing * out_slot(PT)) * sizeof(float);
  int rc = grant<ssd_scan_out<PT>>(smem);
  if (rc) return rc;
  dim3 grid(row_tiles * slices, H, B * (L / Q));
  ssd_scan_out<PT><<<grid, 32 * kOutWarps, smem, stream>>>(
      x, dt, c, d_skip, cb, cum, states, y, flag, L, H, P, G, N, Q, Qp, ps,
      slices, row_tiles, vec_x, vec_c, vec_s);
  return (int)cudaGetLastError();
}

// 5. the repair: a block for each flagged (b, chunk, h), the grid walking
// them in turn; without the call's flag each block reads one word. For
// column p of the chunk, the rule above needs the last token j with a
// non-finite dtx[j, p] (jx[p]; a non-finite dt[j] makes it so for every
// p) and the last with a non-finite B[j] (jall), found in shared memory
// from the operands. Then each output y[i, p]: NaN where i < jall or i <
// jx[p]; else, where launch 4 gave NaN, NaN if C[i] is non-finite and a
// token follows row i, or else summed again in IEEE f32 from the same
// operand values as launch 4 forms them (the C B^T entries and the states
// already repaired by launches 1 and 2): the readout over N, the tokens j
// <= i of its chunk, plus D x. (A non-finite C[i] gives row i NaN in
// launch 4's passes, so only those outputs need the test.) The tokens j >
// i add 0 there. Last, where the group's C B^T may overflow (launch 1's
// maxima), row i is NaN wherever C[i] . B[j], summed in IEEE f32 for
// each j > i, is not finite.
constexpr int kRepairBlocks = 64, kRepairThreads = 256;

__global__ void __launch_bounds__(kRepairThreads)
ssd_scan_repair(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ bmat,
                const float* __restrict__ cmat,
                const float* __restrict__ d_skip,
                const float* __restrict__ cb, const float* __restrict__ cum,
                const float* __restrict__ states,
                const float2* __restrict__ cbmax, float* __restrict__ y,
                const int* __restrict__ flag, int B, int L, int H, int P,
                int G, int N, int Q, int Qp) {
  if (!flag[0]) return;
  __shared__ int jx[kRepairThreads];    // a strip of columns
  __shared__ int jall;
  const int nc = L / Q, tid = threadIdx.x;
  const float nan = __int_as_float(0x7fffffff);
  for (long long job = blockIdx.x; job < (long long)B * nc * H;
       job += gridDim.x) {
    if (!flag[1 + job]) continue;
    const int h = (int)(job % H), g = h / (H / G);
    const size_t bc = (size_t)(job / H);
    const size_t tok0 = bc / nc * L + bc % nc * Q;
    const float* cum_c = cum + (bc * H + h) * Q;
    if (tid == 0) jall = -1;
    __syncthreads();
    for (int e = tid; e < Q * N; e += blockDim.x) {
      const int j = e / N;
      if (!finite(bmat[(tok0 + j) * G * N + (size_t)g * N + e - j * N]))
        atomicMax(&jall, j);
    }
    for (int p0 = 0; p0 < P; p0 += kRepairThreads) {
      const int pw = min(kRepairThreads, P - p0);
      jx[tid] = -1;
      __syncthreads();
      for (int e = tid; e < Q * pw; e += blockDim.x) {
        const int j = e / pw, p = p0 + e - j * pw;
        if (!finite(x[((tok0 + j) * H + h) * P + p] * dt[(tok0 + j) * H + h]))
          atomicMax(&jx[p - p0], j);
      }
      __syncthreads();
      for (int e = tid; e < Q * pw; e += blockDim.x) {
        const int i = e / pw, p = p0 + e - i * pw;
        const size_t o = ((tok0 + i) * H + h) * P + p;
        if (i < jall || i < jx[p - p0]) {
          y[o] = nan;
          continue;
        }
        if (y[o] == y[o]) continue;
        const float* crow = cmat + (tok0 + i) * G * N + (size_t)g * N;
        bool c_bad = false;
        for (int c = 0; c < N; ++c) c_bad |= !finite(crow[c]);
        if (c_bad && i + 1 < Q) {
          y[o] = nan;
          continue;
        }
        const float di = exp_of(cum_c[i]);
        const float* srow = states + ((bc * H + h) * P + p) * N;
        const float* cbrow = cb + ((bc * G + g) * Qp + i) * (size_t)Qp;
        float d = 0.f;
        for (int c = 0; c < N; ++c) d = fmaf(crow[c] * di, srow[c], d);
        for (int j = 0; j <= i; ++j)
          d = fmaf(cbrow[j] * exp_of(cum_c[i] - cum_c[j]),
                   x[((tok0 + j) * H + h) * P + p] * dt[(tok0 + j) * H + h],
                   d);
        y[o] = d + d_skip[h] * x[o];
      }
      __syncthreads();                  // jx and jall free for the next
    }
    if (!cb_may_overflow(cbmax, bc * G + g, (Q + kCB - 1) / kCB, N)) continue;
    for (int i = tid; i < Q - 1; i += blockDim.x) {
      const float* crow = cmat + (tok0 + i) * G * N + (size_t)g * N;
      bool over = false;
      for (int j = i + 1; j < Q && !over; ++j) {
        const float* brow = bmat + (tok0 + j) * G * N + (size_t)g * N;
        float d = 0.f;
        for (int c = 0; c < N; ++c) d = fmaf(crow[c], brow[c], d);
        over = !finite(d);
      }
      if (over)
        for (int p = 0; p < P; ++p) y[((tok0 + i) * H + h) * P + p] = nan;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Five launches on `stream` (repro_torch/kernels/ssd_scan.py::plan_scan):
// C B^T, the chunk-local states and cumsums, the carry, the outputs, the
// repair of NaN outputs. `scratch` holds scratch_floats floats, at least
// C B^T (B, nc, G, Qp, Qp) with Qp = Q rounded up to 64, the cumsums (B,
// nc, H, Q), the states (B, nc, H, P, N), the diagonal tiles' max |C| and
// max |B| (B, nc, G, Qp / 64, 2), each from a multiple of 4 floats, and
// the flags (1 + B nc H ints: the call's, then one a (b, chunk, h)). P is
// cut into
// `slices` slices of ceil(P / slices) <= 64 rows. Returns the first
// nonzero cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int ssd_scan_f32(const float* x, const float* dt,
                            const float* a_log, const float* b,
                            const float* c, const float* d_skip,
                            const float* init, float* y, float* final_state,
                            float* scratch, long long scratch_floats, int B,
                            int L, int H, int P, int G, int N, int Q,
                            int slices, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0 ||
      slices <= 0 || L % Q != 0 || H % G != 0 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int ps = (P + slices - 1) / slices;
  if (ps > kMaxPS) return (int)cudaErrorInvalidValue;
  const int nc = L / Q, tiles = (Q + kCB - 1) / kCB, Qp = tiles * kCB;
  const long long jobs = (long long)B * nc * H;
  float* cb = scratch;
  float* cum = cb + up4((long long)B * nc * G * Qp * Qp);
  float* states = cum + up4(jobs * Q);
  float* maxima = states + up4(jobs * P * N);
  const long long n_max = up4(2LL * B * nc * G * tiles);
  float2* cbmax = reinterpret_cast<float2*>(maxima);
  int* flag = reinterpret_cast<int*>(maxima + n_max);
  if (maxima + n_max + up4(1 + jobs) > scratch + scratch_floats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every copied row starts 16-byte aligned
  const int vec_bc = N % 4 == 0 && aligned16(b) && aligned16(c);
  const int vec_x = P % 4 == 0 && ps % 4 == 0 && aligned16(x);
  const int vec_s = N % 4 == 0;

  const size_t cb_smem = (size_t)2 * kCB * ld_rows(up8(N)) * sizeof(float);
  int rc = grant<ssd_scan_cb>(cb_smem);
  if (rc) return rc;
  ssd_scan_cb<<<dim3(B * nc * G, tiles * (tiles + 1) / 2), 32 * kCBWarps,
              cb_smem, s>>>(b, c, cb, cbmax, flag, L, G, N, Q, Qp, vec_bc);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  if (N <= 16)
    rc = launch_state<1>(x, dt, a_log, b, cbmax, cum, states, flag, B, L,
                         H, P, G, N, Q, slices, ps, vec_x, vec_bc, s);
  else if (N <= 32)
    rc = launch_state<2>(x, dt, a_log, b, cbmax, cum, states, flag, B, L,
                         H, P, G, N, Q, slices, ps, vec_x, vec_bc, s);
  else if (N <= 64)
    rc = launch_state<4>(x, dt, a_log, b, cbmax, cum, states, flag, B, L,
                         H, P, G, N, Q, slices, ps, vec_x, vec_bc, s);
  else
    rc = launch_state<8>(x, dt, a_log, b, cbmax, cum, states, flag, B, L,
                         H, P, G, N, Q, slices, ps, vec_x, vec_bc, s);
  if (rc) return rc;

  // the carry moves 16 bytes a thread where a (b, h)'s P N entries and
  // the state pointers allow
  const long long entries = (long long)B * H * P * N;
  const bool vec_carry = (P * N) % 4 == 0 && aligned16(final_state) &&
                         (init == nullptr || aligned16(init));
  const int per = vec_carry ? 4 : 1;
  const unsigned carry_blocks =
      (unsigned)((entries / per + kCarryThreads - 1) / kCarryThreads);
  if (vec_carry)
    ssd_scan_carry<4><<<carry_blocks, kCarryThreads, 0, s>>>(
        init, cum, states, final_state, flag, B, H, P, N, Q, nc);
  else
    ssd_scan_carry<1><<<carry_blocks, kCarryThreads, 0, s>>>(
        init, cum, states, final_state, flag, B, H, P, N, Q, nc);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  if (ps <= 16)
    rc = launch_out<2>(x, dt, c, d_skip, cb, cum, states, y, flag, B, L, H,
                       P, G, N, Q, Qp, slices, ps, vec_x, vec_bc, vec_s, s);
  else if (ps <= 32)
    rc = launch_out<4>(x, dt, c, d_skip, cb, cum, states, y, flag, B, L, H,
                       P, G, N, Q, Qp, slices, ps, vec_x, vec_bc, vec_s, s);
  else
    rc = launch_out<8>(x, dt, c, d_skip, cb, cum, states, y, flag, B, L, H,
                       P, G, N, Q, Qp, slices, ps, vec_x, vec_bc, vec_s, s);
  if (rc) return rc;
  ssd_scan_repair<<<kRepairBlocks, kRepairThreads, 0, s>>>(
      x, dt, b, c, d_skip, cb, cum, states, cbmax, y, flag, B, L, H, P, G, N,
      Q, Qp);
  return (int)cudaGetLastError();
}
