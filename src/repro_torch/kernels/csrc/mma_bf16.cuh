// bf16 products on Hopper's tensor cores with mma.sync, for K4's bf16
// instances above 32 rows (lora_apply.cu, lora_mma_bf16_kernel).
//
// The reference (src/repro/kernels/lora_apply.py::_batched_kernel) upcasts
// each bf16 tile to f32 and contracts it at Precision.HIGHEST. A bf16 x
// bf16 product is exact in f32 (8 + 8 significant bits), and
// mma.sync.m16n8k16 with f32 accumulators adds those exact products into
// f32 sums: the reference's products, summed in another order (the tensor
// core aligns the 16 products of a step before it adds them, which may
// drop bits below the f32 sum's last place; y is rounded to bf16 once, 2^16
// times coarser). So K4's card check, one bf16 ulp of each row's largest
// |value|, holds unchanged.
//
// Fragments of mma.m16n8k16.row.col.f32.bf16.bf16.f32 for lane = 4 g + t
// (g = lane / 4, t = lane % 4), two bf16 values a 32-bit register, the
// lower index in the low half:
//   A (16 x 16, row-major): a0 = A[g][2t..], a1 = A[g + 8][2t..],
//                           a2 = A[g][2t + 8..], a3 = A[g + 8][2t + 8..];
//   B (16 x 8):             b0 = B[2t..][g], b1 = B[2t + 8..][g];
//   C (16 x 8, f32):        c0, c1 = C[g][2t], C[g][2t + 1];
//                           c2, c3 = C[g + 8][2t], C[g + 8][2t + 1].
// ldmatrix.x4 loads four 8 x 8 b16 matrices from shared memory, lanes 8i
// .. 8i + 7 giving the 16-byte rows of matrix i, and hands lane l the
// pair (row l / 4, columns 2 (l % 4), + 1) of each: A's fragment as it
// stands. W is k-major (K, N) in memory and in the slab (row k, columns
// n), so its side takes ldmatrix.trans, which hands lane l the pair (rows
// 2 (l % 4), + 1; column l / 4): B's fragment. Slab rows are padded so
// that the 8 rows of one matrix fall on 8 distinct 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d += a b: one 16 x 8 x 16 step, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A's fragment of the 16 x 16 block at depth k0 of a row-major tile
// (`ld` elements a row, a multiple of 8): lanes 0-15 point at rows 0-15
// at k0 (matrices 0 and 1: a0, a1), lanes 16-31 at the same rows at k0 +
// 8 (matrices 2 and 3: a2, a3).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int k0, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + k0 + (lane >> 4) * 8);
}

// B's fragments of two neighbouring n8 tiles from a k-major tile (row k,
// `ld` elements a row, a multiple of 8): the 16 x 16 block at depth k0,
// column n0. b[0], b[1] for columns n0 .. n0 + 7, b[2], b[3] for n0 + 8 ..
// n0 + 15: lanes 0-15 point at rows k0 .. k0 + 15 at n0, lanes 16-31 at
// the same rows at n0 + 8.
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int ld, int k0, int n0,
                                            int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

}  // namespace mma_bf16
