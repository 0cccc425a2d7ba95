// K7: online-softmax attention (flash attention), causal and/or sliding
// window, with grouped KV heads; f32 accuracy on the tensor cores (3xTF32).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// and its wrapper repro/kernels/ops.py::flash_attention. Contract: the
// oracle repro/kernels/ref.py::flash_attention_ref,
//
//   q (B, Lq, H, D); k, v (B, Lkv, KVH, D); H = G * KVH, query head h
//   reading KV head h / G; positions start at 0 for both q and k;
//   s = (q . k) * D^-0.5, masked where causal and kv > q, or where
//   window > 0 and kv <= q - window, with the finite fill -1e30;
//   o = softmax(s) v, computed to f32 accuracy.
//
// The reference's ops wrapper pads Lkv to a multiple of its block and then
// tells the Pallas kernel that the padded length is the true one, so
// without the causal mask the padded keys enter the softmax with score 0.
// This kernel masks on the true Lkv: a key at or past Lkv gets
// probability 0, never the fill, so it cannot enter even a row whose keys
// are all masked (the oracle averages such a row over its Lkv keys, and so
// does this kernel).
//
// Bound on the card: operations. Each (query, key) pair in the band costs
// 4 D FLOP (q.k and p v) against 16 D bytes of q, k, v and o per row, and
// a q tile reuses every k and v row 16 w times. The reference contracts at
// Precision.HIGHEST; both products run as 3xTF32 on mma.sync
// (mma_tf32x3.cuh): three TF32 passes of the tensor cores give an f32-
// accurate product at a third of their 495 TFLOP/s, where the CUDA cores'
// IEEE f32 stops at 67.
//
// Design (FlashAttention-2's split of the work). A block owns one (b, h,
// q tile of 16 w rows), w = 1..4 warps, and walks the kv tiles of its band
// itself; each warp owns 16 q rows and keeps their running max, sum and
// 16 x D output accumulator in registers (the mma C fragment: D / 2
// floats a lane, 128 at D = 256). Per kv tile of BKV keys:
//  - S = Q K^T: the warp's Q rows (shared memory, split to TF32 halves as
//    they are read) against the K tile, 3xTF32, D zero-padded in shared
//    memory to the instance's width 8 DT, so that every loop has a fixed
//    trip count and no branch (a branch inside an unrolled loop cuts it
//    into blocks whose loads and products ptxas cannot interleave);
//    where a tile has fewer than 8 key groups, the depth steps go
//    round-robin into partial sums, so a warp always has at least 8
//    accumulator chains in flight;
//  - masks and the online softmax on the C fragment: a lane holds two
//    columns of rows g and g + 8, so a row's max is a shuffle over the 4
//    lanes of a quad; the running sum stays a per-lane partial (the same
//    rescale applies to all of a row's lanes) and is summed over the quad
//    once, at the end;
//  - O += P V, 3xTF32: with mma_tf32x3.cuh's depth map the C fragment of
//    S is the A fragment of P, so P is split once and never leaves the
//    registers; V's B fragment is read from rows 2t, 2t + 1 of the tile.
// K and V tiles alternate through a ring of two shared-memory slots (K in
// one, V in the other) filled by cp.async: while one tile's products run,
// the next operand's copy is in flight (the V tile during S, the next K
// tile during P V). Q's
// tile and the ring's slots are padded so that every fragment load is
// conflict-free (Q and K rows = 8 mod 32 floats, V rows = 4 mod 16).
//
// The kernel is bound by latency more than by issue, so warps resident
// an SM move it most: each instance caps its registers for a
// number of resident blocks (min_blocks), the kv tile shrinks as D grows
// (64 keys up to D 64, 32 up to 192, 16 at 256) so that shared memory
// holds as many blocks as the registers (two at D = 256), and the host
// planner (flash_attention.py::plan_attention) takes four warps a block
// where the grid stays full. A warp whose rows lie past Lq, or
// whose band misses a kv tile, skips that tile's products (it adds
// exactly nothing there: probabilities exp(-1e30 - m) = 0, or are wiped
// by the rescale exp(-1e30 - m) = 0 once a row meets its first key); keys
// past Lkv in the last tile read zero rows and get probability 0. The
// finite fill (not -INFINITY) means exp never sees inf - inf. Every sum
// runs in a fixed order, no atomics: a repeat gives the same bits, and
// so does any other plan (a warp's rows, band and kv tiles do not depend
// on w or the ring). The q tiles run longest first across the whole
// grid, so causal blocks finish together.
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"
#include "sgemm_f32.cuh"   // the cp.async helpers

namespace {

constexpr float kFill = -1e30f;      // the reference's NEG_INF
constexpr int kMaxD = 256;
constexpr int kMaxWarps = 4;
constexpr int kStages = 2;           // ring slots: K, V
constexpr int kDevices = 16;         // devices whose granted smem is kept

// row strides (floats) of the padded tiles: Q and K rows = 8 (mod 32), for
// conflict-free 8-byte A / B^T loads; V rows = 4 (mod 16), for 4-byte B
// loads. dp is the instance's width, a multiple of 8.
__host__ __device__ constexpr int ld_qk(int dp) {
  return dp + (40 - dp % 32) % 32;
}
__host__ __device__ constexpr int ld_v(int dp) { return dp + (dp % 16 ? 12 : 4); }
__host__ __device__ constexpr int slot_floats(int dp, int bkv) {
  return bkv * (ld_qk(dp) > ld_v(dp) ? ld_qk(dp) : ld_v(dp));
}
__host__ __device__ constexpr size_t smem_bytes(int dp, int bkv,
                                                int warps) {
  return ((size_t)16 * warps * ld_qk(dp) +
          (size_t)kStages * slot_floats(dp, bkv)) * sizeof(float);
}

// keys [lo, hi] that some row of [qa, qb] can see; every key where a row
// of it sees none (the oracle's softmax over an all-fill row averages all
// Lkv keys)
__device__ __forceinline__ void band(int qa, int qb, int Lkv, int causal,
                                     int window, int& lo, int& hi) {
  lo = 0;
  hi = Lkv - 1;
  if (causal) hi = min(hi, qb);
  if (window > 0) lo = max(0, qa - window + 1);
  if (window > 0 && qb - window + 1 > Lkv - 1) {
    lo = 0;
    hi = Lkv - 1;
  }
}

// rows [r0, r0 + rows) of a (.., D)-strided operand into a padded tile
// (row stride ld), zero past `limit` rows and in the columns D .. dp - 1
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, size_t stride,
                                          int r0, int rows, int limit, int D,
                                          int dp, bool vec) {
  if (vec) {                       // D % 4 == 0: a 16-byte copy is all in or out
    const int per_row = dp / 4;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * 4;
      const bool in = r0 + r < limit && c < D;
      sgemm::cp_async16(dst + r * ld + c,
                        in ? src + (size_t)(r0 + r) * stride + c : src,
                        in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * dp; e += blockDim.x) {
      const int r = e / dp, c = e - r * dp;
      const bool in = r0 + r < limit && c < D;
      sgemm::cp_async4(dst + r * ld + c,
                       in ? src + (size_t)(r0 + r) * stride + c : src,
                       in ? 4 : 0);
    }
  }
}

// Blocks of four warps an SM that the registers allow, by width: the
// kernel is bound by latency more than by issue, so it asks ptxas for the
// register count that keeps this many blocks resident (128, 170 and 255
// registers a thread)
template <int DT>
constexpr int min_blocks() {
  return DT <= 8 ? 4 : DT <= 16 ? 3 : 2;
}

// DT: 8-column groups of the padded head dim (D <= 8 DT; the tiles are
// 8 DT wide, zero past D, so every loop below has a fixed trip count and
// no branch); BKV: keys a kv tile
template <int DT, int BKV>
__global__ void __launch_bounds__(32 * kMaxWarps, min_blocks<DT>())
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int B, int Lq, int Lkv, int H, int KVH, int D,
                       int causal, int window, float scale, int q_tiles,
                       int vec) {
  constexpr int NT = BKV / 8;          // 8-key column groups a tile
  constexpr int DP = 8 * DT;
  constexpr int LDQ = ld_qk(DP), LDV = ld_v(DP);
  constexpr int kSlot = slot_floats(DP, BKV);
  // S's partial sums over the depth: at least 8 independent accumulator
  // chains a warp, however few key groups a tile has
  constexpr int SP = NT >= 8 ? 1 : 8 / NT;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5, QT = 16 * warps;
  float* qs = smem;                    // qs[r * LDQ + d]
  float* ring = smem + QT * LDQ;       // K (row stride LDQ) or V (LDV)

  // longest q tiles first across the grid
  const int bh = B * H;
  const int qt = q_tiles - 1 - (int)(blockIdx.x / bh);
  const int rem = (int)(blockIdx.x % bh);
  const int h = rem % H, b = rem / H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const float* qb = q + (size_t)b * Lq * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * Lkv * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Lkv * kv_row + (size_t)kvh * D;

  int lo, hi;                          // the block's keys
  band(q0, min(q0 + QT, Lq) - 1, Lkv, causal, window, lo, hi);
  const int wq0 = q0 + 16 * warp;      // the warp's rows and keys
  const bool active = wq0 < Lq;
  int wlo = 0, whi = -1;
  if (active) band(wq0, min(wq0 + 16, Lq) - 1, Lkv, causal, window, wlo, whi);
  const int t_lo = lo / BKV;
  const int loads = 2 * (hi / BKV - t_lo + 1);   // K, V, K, V, ...

  // load j: tile t_lo + j / 2, K for even j into slot 0, V for odd into 1
  auto issue = [&](int j) {
    const bool is_v = j & 1;
    load_rows(ring + (j & 1) * kSlot, is_v ? LDV : LDQ, is_v ? vb : kb,
              kv_row, (t_lo + (j >> 1)) * BKV, BKV, Lkv, D, DP, vec);
  };
  load_rows(qs, LDQ, qb, q_row, q0, QT, Lq, D, DP, vec);
  issue(0);
  sgemm::cp_async_commit();

  float acc[DT][4], s[NT][4];
  float m_r[2] = {kFill, kFill}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  const float* qw = qs + 16 * warp * LDQ;

  for (int j = 0; j < loads; ++j) {
    sgemm::cp_async_wait<0>();         // load j has landed
    __syncthreads();                   // ... for every thread; slot of j - 1 free
    if (j + 1 < loads) {
      issue(j + 1);
      sgemm::cp_async_commit();
    }
    const int c0 = (t_lo + (j >> 1)) * BKV;
    if (!active || c0 > whi || c0 + BKV - 1 < wlo) continue;
    const float* cur = ring + (j & 1) * kSlot;
    if (!(j & 1)) {
      // S = Q K^T over the tile's keys, 3xTF32; depth step ks adds into
      // partial sum ks % SP, the partials summed in order after the loop.
      // Keys at or past Lkv read zero rows: their scores are dropped below.
      float sp[SP][NT][4];
#pragma unroll
      for (int p = 0; p < SP; ++p)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[p][n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        const tf32x3::FragA a = tf32x3::load_a_rows(qw, LDQ, 8 * ks, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const tf32x3::FragB kf =
              tf32x3::load_b_rows(cur + 8 * n * LDQ, LDQ, 8 * ks, g, t);
          tf32x3::mma3(sp[ks % SP][n], a, kf);
        }
      }
      // mask, scale, online softmax; element e of group n: row g + 8 (e / 2),
      // key c0 + 8 n + 2 t + e % 2
      float mx[2] = {kFill, kFill};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sp[0][n][e];
#pragma unroll
          for (int p = 1; p < SP; ++p) x += sp[p][n][e];
          const int kp = c0 + 8 * n + 2 * t + (e & 1);
          const int qp = wq0 + g + 8 * (e >> 1);
          bool ok = true;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          s[n][e] = ok ? x * scale : kFill;
          if (kp < Lkv) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = c0 + 8 * n + 2 * t + (e & 1);
          const float p = kp < Lkv ? expf(s[n][e] - m_r[e >> 1]) : 0.f;
          s[n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
    } else {
      // O += P V, 3xTF32; P's A fragment is S's C fragment (c0, c2, c1, c3).
      // Keys past Lkv have P = 0 and zero V rows; columns past D are zero.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const tf32x3::FragA pa =
            tf32x3::frag_a(s[n][0], s[n][2], s[n][1], s[n][3]);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const tf32x3::FragB vf =
              tf32x3::load_b_cols(cur + 8 * d, LDV, 8 * n, g, t);
          tf32x3::mma3(acc[d], pa, vf);
        }
      }
    }
  }
  sgemm::cp_async_wait<0>();           // no copy outlives the block

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    if (row >= Lq) continue;
    const float denom = fmaxf(l_r[r], 1e-30f);
    float* orow = o + ((size_t)b * Lq + row) * q_row + (size_t)h * D;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = 8 * d + 2 * t;
      if (col < D) orow[col] = acc[d][2 * r] / denom;
      if (col + 1 < D) orow[col + 1] = acc[d][2 * r + 1] / denom;
    }
  }
}

template <int DT, int BKV>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Lq, int Lkv, int H, int KVH, int D, int causal, int window,
           float scale, int warps, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes(8 * DT, BKV, warps);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // the shared memory this instance may take, per device: raised only when
  // a launch needs more (setting it costs the host about a launch)
  static int granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices || (int)smem > granted[dev]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<DT, BKV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kDevices) granted[dev] = (int)smem;
  }
  const int q_tiles = (Lq + 16 * warps - 1) / (16 * warps);
  const long long blocks = (long long)q_tiles * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<DT, BKV><<<(unsigned)blocks, 32 * warps, smem,
                                    stream>>>(
      q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, q_tiles,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`, grid (q tiles x H x B), `warps` warps a block.
// q, k, v, o contiguous in the reference's (B, L, heads, D) layout. The
// plan (flash_attention.py::plan_attention): `warps` (1..4, a q tile of
// 16 warps rows), the kv tile `kv_tile`, which must be the one built for
// D's width (flash_attention.py::INSTANCES). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int Lq,
                                   int Lkv, int H, int KVH, int D, int causal,
                                   int window, float scale, int warps,
                                   int kv_tile, void* stream) {
  if (B < 0 || Lq < 0 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 ||
      D > kMaxD || Lkv < 1 || window < 0 || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every row is 16-byte aligned
  const int vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(q) |
                                 reinterpret_cast<uintptr_t>(k) |
                                 reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int dt = (D + 7) / 8;
#define K7_LAUNCH(DT, BKV)                                                 \
  return kv_tile == BKV                                                    \
             ? launch<DT, BKV>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal,  \
                               window, scale, warps, vec, s)               \
             : (int)cudaErrorInvalidValue
  if (dt <= 2) K7_LAUNCH(2, 64);
  if (dt <= 4) K7_LAUNCH(4, 64);
  if (dt <= 8) K7_LAUNCH(8, 64);
  if (dt <= 10) K7_LAUNCH(10, 32);
  if (dt <= 16) K7_LAUNCH(16, 32);
  if (dt <= 24) K7_LAUNCH(24, 32);
  K7_LAUNCH(32, 16);
#undef K7_LAUNCH
}
