// 3xTF32: an f32-accurate matrix product on Hopper's tensor cores, shared
// by K5 (lora_apply.cu, the base product x @ W above 32 rows) and K7
// (flash_attention.cu, both of its products).
//
// The reference contracts at Precision.HIGHEST, f32 accuracy. A TF32
// product keeps 11 significant bits of each operand, so each f32 operand
// is split in two TF32 values,
//
//     hi = rna_tf32(a),   lo = rna_tf32(a - hi),
//
// and a . b is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b, three
// mma.sync.m16n8k8 TF32 passes into one f32 accumulator, the small terms
// first. a - hi is exact in f32, hi + lo is within 2^-22 |a| of a, and a
// TF32 x TF32 product is exact in f32; the dropped lo_a lo_b and the two
// representation errors cost a few 2^-22 of |a b|, far below the
// rounding of a K-deep f32 sum (K 2^-24), so the kernels hold the plain
// f32 tolerances unchanged. Plain TF32 (one pass) would keep three
// digits and is not used.
//
// rna_tf32 rounds to the nearest TF32 value, ties away from zero. hi takes
// it on the int32 view: (bits + 0x1000) & ~0x1fff, the same as
// cvt.rna.tf32.f32 on every finite value and infinity (the largest finite
// values round to infinity, as cvt.rna does), in two integer instructions
// on full-rate pipes. lo takes cvt.rna.tf32.f32 itself, one instruction,
// which keeps a NaN a NaN; the integer add would carry the card's NaN
// (0x7fffffff) into the sign and give -0. a - hi is NaN exactly where a is
// NaN or infinite, so such an operand's lo is NaN, and the passes that
// read lo carry it: a product with an infinite or NaN operand gives NaN,
// where an IEEE product may give +-inf (a NaN's hi may be anything).
//
// So every kernel on this route repairs its NaN outputs: an output (or a
// softmax row, K7) that comes out NaN is summed again from the same
// operand values in IEEE f32 FMAs, which give the f32 product's +-inf or
// NaN, and a finite output is left as it is. Only an output that met a
// non-finite operand can be NaN, so on finite inputs the repair costs one
// test an output and changes no bit. (An IEEE split in the passes, hi = +-1
// and lo = +-inf for an infinity, took three more instructions a split
// element: 14-22% of K5's, K6's and K7's device time.) The CPU emulation
// is repro_torch.kernels.tf32x3.matmul.
//
// mma.sync and not wgmma: wgmma takes TF32 operands only K-major in shared
// memory, and K5's W (K, N) and K7's V (Lkv, D) are N-major; mma.sync's
// fragments are loaded by hand from either layout.
//
// Fragments of mma.m16n8k8.row.col.f32.tf32.tf32.f32 for lane = 4 g + t
// (g = lane / 4, t = lane % 4). The k index of a step is free to map to
// any 8 depths, as long as A and B agree: here k-index t holds depth 2t
// and k-index t + 4 holds depth 2t + 1, so that
//   A (16 x 8): a0 = A[g][2t], a1 = A[g + 8][2t], a2 = A[g][2t + 1],
//               a3 = A[g + 8][2t + 1]  (a row-major A gives a0/a2 and
//               a1/a3 as two 8-byte loads);
//   B (8 x 8):  b0 = B[2t][g], b1 = B[2t + 1][g];
//   C (16 x 8): c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t],
//               c3 = C[g + 8][2t + 1].
// With this map the C fragment of one product is, as it stands, the A
// fragment of the next one over the same 8 columns (a = c0, c2, c1, c3):
// K7's probabilities go from S = Q K^T into P V with no shuffle.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// an operand in two TF32 halves, as mma takes them (b32 registers)
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split(float a) {
  const uint32_t hi = rna(__float_as_uint(a));
  uint32_t lo;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
  return {hi, lo};
}

// d += a b, one TF32 pass
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the A fragment of a step, split
struct FragA {
  Split v[4];
};
// the B fragment of a step, split
struct FragB {
  Split v[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  return {{split(a0), split(a1), split(a2), split(a3)}};
}
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  return {{split(b0), split(b1)}};
}

// d += a b to f32 accuracy: lo.hi, hi.lo, then hi.hi into one accumulator
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, b.v[0].hi, b.v[1].hi);
  mma(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].lo, b.v[1].lo);
  mma(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].hi, b.v[1].hi);
}

// A fragment from a row-major tile in shared memory: rows g and g + 8 of
// `a` (row stride lda floats), depths k0 + 2t, k0 + 2t + 1, as two 8-byte
// loads. lda = 8 (mod 32) keeps each half-warp's loads on distinct banks.
__device__ __forceinline__ FragA load_a_rows(const float* a, int lda, int k0,
                                             int g, int t) {
  const float2 u = *reinterpret_cast<const float2*>(a + g * lda + k0 + 2 * t);
  const float2 v =
      *reinterpret_cast<const float2*>(a + (g + 8) * lda + k0 + 2 * t);
  return frag_a(u.x, v.x, u.y, v.y);
}

// B fragment from B^T stored row-major (row n, depth k; K7's K tile):
// row g, depths k0 + 2t and k0 + 2t + 1, one 8-byte load. ldb = 8 (mod 32).
__device__ __forceinline__ FragB load_b_rows(const float* bt, int ldb, int k0,
                                             int g, int t) {
  const float2 u =
      *reinterpret_cast<const float2*>(bt + g * ldb + k0 + 2 * t);
  return frag_b(u.x, u.y);
}

// B fragment from B stored row-major (row k, column n; K5's W and K7's V):
// rows k0 + 2t and k0 + 2t + 1, column g. ldb = 4 (mod 16) keeps the warp's
// loads on distinct banks.
__device__ __forceinline__ FragB load_b_cols(const float* b, int ldb, int k0,
                                             int g, int t) {
  const float* p = b + (k0 + 2 * t) * ldb + g;
  return frag_b(p[0], p[ldb]);
}

}  // namespace tf32x3
