// K7: online-softmax attention (flash attention), causal and/or sliding
// window, with grouped KV heads; f32.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// and its wrapper repro/kernels/ops.py::flash_attention. Contract: the
// oracle repro/kernels/ref.py::flash_attention_ref,
//
//   q (B, Lq, H, D); k, v (B, Lkv, KVH, D); H = G * KVH, query head h
//   reading KV head h / G; positions start at 0 for both q and k;
//   s = (q . k) * D^-0.5, masked where causal and kv > q, or where
//   window > 0 and kv <= q - window, with the finite fill -1e30;
//   o = softmax(s) v, computed in f32.
//
// The reference's ops wrapper pads Lkv to a multiple of its block and then
// tells the Pallas kernel that the padded length is the true one, so
// without the causal mask the padded keys enter the softmax with score 0.
// This kernel masks on the true Lkv: a key at or past Lkv gets
// probability 0, never the fill, so it cannot enter even a row whose keys
// are all masked (the oracle averages such a row over its Lkv keys, and so
// does this kernel).
//
// Bound on the card: f32 arithmetic. Each (query, key) pair in the band
// costs 4*D FLOP (q.k and p*v) against 16*D bytes of q, k, v and o per
// row, and a q tile reuses every k and v row 64 times; the products are
// IEEE f32 FMAs on the CUDA cores (the reference contracts at
// Precision.HIGHEST), so no TF32 and no tensor cores.
//
// Design. The Pallas grid walked kv blocks on a sequential axis with the
// running max, denominator and accumulator in VMEM scratch, and folded the
// G query heads of a KV head into its rows. Here one block owns one
// (b, h, 64-row q tile) and walks the kv tiles itself, keeping all three
// in registers: a 16 x 16 thread grid, each thread four q rows
// (ty + 16 i) and, of the 64 x 64 score tile, the four columns tx + 16 j,
// and of the accumulator the columns tx + 16 j up to D. The q tile, the kv
// tile (k transposed) and the probabilities sit in shared memory, which
// is dynamic: 214 KB at D = 256, above the 48 KB static limit, so the
// launcher raises the block's limit and refuses a D it cannot hold.
// Row maxima and sums are reduced across the 16 threads of a row by a
// fixed xor-shuffle tree, and the kv tiles are visited in order: no
// atomics, every launch gives the same bits. Only kv tiles that meet the
// causal/window band of some row of the q tile are visited (the rest add
// exactly nothing: probabilities exp(-1e30 - m) = 0, or are wiped by the
// rescale exp(-1e30 - m) = 0 once a row meets its first key). Keeping the
// finite fill (not -INFINITY) means exp never sees inf - inf. The q tiles
// run longest first, so causal blocks finish together.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // q rows per block
constexpr int kBK = 64;              // keys per kv tile
constexpr int kKS = kBK + 1;         // padded stride of the k^T and p tiles
constexpr int kThreads = 256;        // 16 x 16
constexpr float kFill = -1e30f;      // the reference's NEG_INF
constexpr int kMaxD = 256;

__host__ __device__ constexpr size_t smem_floats(int D) {
  // q tile kBQ x (D + 1), k^T tile D x kKS, v tile kBK x D, p tile kBQ x kKS
  return (size_t)kBQ * (D + 1) + (size_t)D * kKS + (size_t)kBK * D +
         (size_t)kBQ * kKS;
}

// DPT: accumulator columns per thread, D <= 16 * DPT
template <int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Lq, int Lkv, int H, int KVH, int D, int causal,
                       int window, float scale) {
  extern __shared__ float smem[];
  const int DS = D + 1;
  float* qs = smem;                     // qs[r * DS + d]
  float* kt = qs + kBQ * DS;            // kt[d * kKS + c]
  float* vs = kt + D * kKS;             // vs[c * D + d]
  float* ps = vs + kBK * D;             // ps[r * kKS + c]

  const int qt = gridDim.x - 1 - blockIdx.x;      // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const float* qb = q + (size_t)b * Lq * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * Lkv * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Lkv * kv_row + (size_t)kvh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, dd = e - r * D;
    qs[r * DS + dd] = (q0 + r < Lq) ? qb[(size_t)(q0 + r) * q_row + dd] : 0.f;
  }

  // the keys some row of this tile can see: rows q0..q_last see
  // [max(0, q - window + 1), causal ? q : Lkv - 1]
  const int q_last = min(q0 + kBQ, Lq) - 1;
  int lo = 0, hi = Lkv - 1;
  if (causal) hi = min(hi, q_last);
  if (window > 0) lo = max(0, q0 - window + 1);
  // a row past Lkv - 1 + window sees no key: the oracle's softmax over an
  // all-fill row averages every key, so visit them all
  if (window > 0 && q_last - window + 1 > Lkv - 1) {
    lo = 0;
    hi = Lkv - 1;
  }

  float m_i[4], l_i[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kFill;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int t = lo / kBK; t <= hi / kBK; ++t) {
    const int c0 = t * kBK;
    __syncthreads();                  // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, dd = e - c * D;
      const bool in = c0 + c < Lkv;
      kt[dd * kKS + c] = in ? kb[(size_t)(c0 + c) * kv_row + dd] : 0.f;
      vs[c * D + dd] = in ? vb[(size_t)(c0 + c) * kv_row + dd] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[dd * kKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kFill;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = c0 + tx + 16 * j;
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kFill;
        if (kp < Lkv) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = c0 + tx + 16 * j;
        const float p = (kp < Lkv) ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kKS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                  // the p tile is complete

    const int cn = min(kBK, Lkv - c0);
    for (int c = 0; c < cn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kKS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int col = tx + 16 * j;
        const float vv = (col < D) ? vs[c * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    float* orow = o + ((size_t)b * Lq + row) * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int col = tx + 16 * j;
      if (col < D) orow[col] = acc[i][j] / denom;
    }
  }
}

template <int DPT>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Lq, int Lkv, int H, int KVH, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<DPT><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Lq, Lkv, H, KVH, D, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`: grid (q tiles, H, B). q, k, v, o contiguous in
// the reference's (B, L, heads, D) layout. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take (D > 256,
// Lkv < 1, H not a multiple of KVH, a grid too large).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int Lq,
                                   int Lkv, int H, int KVH, int D, int causal,
                                   int window, float scale, void* stream) {
  if (B < 0 || Lq < 0 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 ||
      D > kMaxD || Lkv < 1 || window < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dpt = (D + 15) / 16;
  if (dpt <= 1)
    return launch<1>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, s);
  if (dpt <= 2)
    return launch<2>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, s);
  if (dpt <= 4)
    return launch<4>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, s);
  if (dpt <= 5)
    return launch<5>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, s);
  if (dpt <= 8)
    return launch<8>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, s);
  if (dpt <= 12)
    return launch<12>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, s);
  return launch<16>(q, k, v, o, B, Lq, Lkv, H, KVH, D, causal, window, scale, s);
}
