// K6: Mamba-2 SSD chunked scan (the dual form), f32.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_pallas and the group
// expansion of repro/kernels/ops.py::ssd_scan. Contract
// (repro/models/layers/ssd.py::ssd_scan_chunked), per batch row b and
// head h, with A = -exp(a_log[h]) and chunks of Q tokens:
//
//     cum_i   = sum_{q <= i} dt_q A                (inclusive, in the chunk)
//     y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i . S                 (S: state entering the chunk)
//             + D x_i
//     S'      = exp(cum_{Q-1}) S + sum_q exp(cum_{Q-1} - cum_q) B_q (dt_q x_q)^T
//
// x (B, L, H, P), dt (B, L, H), b and c (B, L, G, N), a_log and d_skip
// (H,), init (B, H, P, N) or null (a zero state); y (B, L, H, P) and the
// final state (B, H, P, N). All contiguous f32. Head h reads group
// h / (H / G) in place: the (B, L, H, N) expansion the TPU wrapper built
// is never materialised.
//
// Design. The TPU kernel walked a sequential (batch, head-block, chunk)
// grid and kept the state in VMEM. Here one block owns one (b, h) and a
// slice of at most 64 of the P state rows (y[:, p] needs only state[p, :]
// and x[:, p], so P-slices are independent), and walks the chunks in
// order with the (N x slice) state in shared memory. Per chunk:
//   1. dt and A give cum by one thread, sequentially in f32 (the
//      reference's order; every run sums the same way);
//   2. per 64-row tile i of C: the inter-chunk term C_i . S, then for each
//      64-row tile j <= i of B: G = C_i B_j^T, masked and decayed as it
//      leaves the registers (tiles above the diagonal are skipped, and
//      inside the diagonal tile no exp of a j > i difference is taken),
//      then y_i += G (dt x)_j;
//   3. the state update over the chunk's B tiles, S kept in registers.
// C and B tiles are stored depth-major with a padded stride (65), so the
// 16x16 threads' 4x4 (or 8x4) register tiles read shared memory without
// bank conflicts. Every product is an IEEE f32 FMA in a fixed order, with
// no atomics: two launches on the same inputs are bit-equal, and so are
// launches with a different P split.
//
// Bound. Every token needs the recurrence's two state products, the
// update S += B (dt x)^T and the readout C . S: 2 P N multiply-adds per
// (token, head), 8.59 GFLOP for mamba2-1.3b's prefill layer (B 4, L 1024,
// H 64, P 64, N 128), against 148 MB of inputs and outputs (156 MB with an
// initial state), so on an H100 SXM the kernel is bound by f32
// operations: 0.128 ms at the published 67 TFLOP/s. The chunked form's
// intra-chunk Q x Q products are work a smaller chunk avoids, so the
// bound leaves them out. This simple version does 2.5 times that work
// (the causal half of C B^T and of its product with dt x, per head: 21.5
// GFLOP), re-reads its operands from shared memory for every product
// (two loads per four FMAs in the inner loops), and recomputes C B^T for
// every head of a group; wgmma is out for f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16
constexpr int kT = 64;            // token tile
constexpr int kTP = kT + 1;       // padded stride of depth-major tiles
constexpr int kMaxPS = 64;        // state rows (P) owned by one block
constexpr int kSP = kMaxPS + 1;   // padded stride of the state
constexpr int kMaxN = 128;        // state width N
constexpr int kNA = kMaxN / 16;   // state-update register rows per thread

__host__ __device__ constexpr size_t smem_floats(int N, int Q) {
  // cs, bs: N x kTP each; gs: kT x kTP; ds: kT x kMaxPS; st: N x kSP;
  // dts, cum: Q each
  return (size_t)2 * N * kTP + (size_t)kT * kTP + (size_t)kT * kMaxPS +
         (size_t)N * kSP + 2 * (size_t)Q;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log,
                const float* __restrict__ bmat, const float* __restrict__ cmat,
                const float* __restrict__ d_skip,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ final_state, int L, int H, int P, int G,
                int N, int Q, int ps_width) {
  extern __shared__ float smem[];
  float* cs = smem;                     // C tile, cs[n * kTP + i]
  float* bs = cs + N * kTP;             // B tile, bs[n * kTP + j]
  float* gs = bs + N * kTP;             // decayed C B^T, gs[j * kTP + i]
  float* ds = gs + kT * kTP;            // dt x tile, ds[j * kMaxPS + p]
  float* st = ds + kT * kMaxPS;         // state, st[n * kSP + p]
  float* dts = st + N * kSP;            // dt of the chunk
  float* cum = dts + Q;                 // inclusive cumsum of dt A

  const int split = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int p0 = split * ps_width;
  const int ps = min(ps_width, P - p0);
  if (ps <= 0) return;                  // uniform over the block
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float A = -expf(a_log[h]);
  const float dskip = d_skip[h];
  const int nc = L / Q;
  const int ntile = (Q + kT - 1) / kT;
  const size_t state_base = ((size_t)bi * H + h) * P;

  for (int e = tid; e < N * kSP; e += kThreads) st[e] = 0.f;
  __syncthreads();
  if (init) {
    for (int e = tid; e < ps * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      st[n * kSP + p] = init[(state_base + p0 + p) * N + n];
    }
  }

  for (int ch = 0; ch < nc; ++ch) {
    const size_t row0 = (size_t)bi * L + (size_t)ch * Q;   // token row
    __syncthreads();                    // last chunk's readers of cum are done
    for (int q = tid; q < Q; q += kThreads) {
      const float d = dt[(row0 + q) * H + h];
      dts[q] = d;
      cum[q] = d * A;
    }
    __syncthreads();
    if (tid == 0) {
      float run = cum[0];
      for (int q = 1; q < Q; ++q) {
        run += cum[q];
        cum[q] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    for (int it = 0; it < ntile; ++it) {
      const int i0 = it * kT;
      for (int e = tid; e < kT * N; e += kThreads) {
        const int i = e / N, n = e - i * N;
        cs[n * kTP + i] = (i0 + i < Q)
            ? cmat[((row0 + i0 + i) * G + g) * N + n] : 0.f;
      }
      __syncthreads();
      // inter-chunk term: exp(cum_i) C_i . S
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[n * kTP + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) sv[b] = st[n * kSP + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[a], sv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float decay_in = (i < Q) ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] *= decay_in;
      }
      // intra-chunk terms, causal j tiles only
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();                // previous readers of bs, ds, gs
        for (int e = tid; e < kT * N; e += kThreads) {
          const int j = e / N, n = e - j * N;
          bs[n * kTP + j] = (j0 + j < Q)
              ? bmat[((row0 + j0 + j) * G + g) * N + n] : 0.f;
        }
        for (int e = tid; e < kT * kMaxPS; e += kThreads) {
          const int j = e / kMaxPS, p = e - j * kMaxPS;
          ds[e] = (j0 + j < Q && p < ps)
              ? x[((row0 + j0 + j) * H + h) * P + p0 + p] * dts[j0 + j] : 0.f;
        }
        __syncthreads();
        float gv[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) gv[a][b] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[n * kTP + ty + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = bs[n * kTP + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) gv[a][b] = fmaf(cv[a], bv[b], gv[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int il = ty + 16 * a, i = i0 + il;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int jl = tx + 16 * b, j = j0 + jl;
            // mask before exp: cum_i - cum_j > 0 for j > i
            gs[jl * kTP + il] = (j <= i && i < Q)
                ? gv[a][b] * expf(cum[i] - cum[j]) : 0.f;
          }
        }
        __syncthreads();
        const int jn = min(kT, Q - j0);
        for (int j = 0; j < jn; ++j) {
          float gvv[4], dv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gvv[a] = gs[j * kTP + ty + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) dv[b] = ds[j * kMaxPS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(gvv[a], dv[b], acc[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = tx + 16 * b;
          if (p >= ps) continue;
          const size_t idx = ((row0 + i) * H + h) * P + p0 + p;
          y[idx] = acc[a][b] + dskip * x[idx];
        }
      }
      __syncthreads();                  // cs is refilled by the next tile
    }

    // state update: S' = exp(cum_last) S + sum_q B_q (w_q dt_q x_q)^T
    const float decay_all = expf(cum_last);
    float sacc[kNA][4];
#pragma unroll
    for (int a = 0; a < kNA; ++a) {
      const int n = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sacc[a][b] = (n < N) ? st[n * kSP + tx + 16 * b] * decay_all : 0.f;
    }
    for (int qt = 0; qt < ntile; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();                  // previous readers of bs, ds
      for (int e = tid; e < kT * N; e += kThreads) {
        const int q = e / N, n = e - q * N;
        bs[n * kTP + q] = (q0 + q < Q)
            ? bmat[((row0 + q0 + q) * G + g) * N + n] : 0.f;
      }
      for (int e = tid; e < kT * kMaxPS; e += kThreads) {
        const int q = e / kMaxPS, p = e - q * kMaxPS;
        float v = 0.f;
        if (q0 + q < Q && p < ps)
          v = x[((row0 + q0 + q) * H + h) * P + p0 + p] * dts[q0 + q] *
              expf(cum_last - cum[q0 + q]);
        ds[e] = v;
      }
      __syncthreads();
      const int qn = min(kT, Q - q0);
      for (int q = 0; q < qn; ++q) {
        float bv[kNA], dv[4];
#pragma unroll
        for (int a = 0; a < kNA; ++a) {
          const int n = ty + 16 * a;
          bv[a] = (n < N) ? bs[n * kTP + q] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) dv[b] = ds[q * kMaxPS + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < kNA; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) sacc[a][b] = fmaf(bv[a], dv[b], sacc[a][b]);
      }
    }
    __syncthreads();                    // every reader of the old state is done
#pragma unroll
    for (int a = 0; a < kNA; ++a) {
      const int n = ty + 16 * a;
      if (n >= N) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) st[n * kSP + tx + 16 * b] = sacc[a][b];
    }
  }
  __syncthreads();
  for (int e = tid; e < ps * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    final_state[(state_base + p0 + p) * N + n] = st[n * kSP + p];
  }
}

}  // namespace

// One launch on `stream`: grid (splits, H, B), each block a (b, h) and a
// slice of ceil(P / splits) <= 64 state rows. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_scan_f32(const float* x, const float* dt,
                            const float* a_log, const float* b,
                            const float* c, const float* d_skip,
                            const float* init, float* y, float* final_state,
                            int B, int L, int H, int P, int G, int N, int Q,
                            int splits, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0 ||
      splits <= 0 || L % Q != 0 || H % G != 0 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int ps = (P + splits - 1) / splits;
  if (ps > kMaxPS) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(splits, H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, dt, a_log, b, c, d_skip, init, y, final_state, L, H, P, G, N, Q, ps);
  return (int)cudaGetLastError();
}
