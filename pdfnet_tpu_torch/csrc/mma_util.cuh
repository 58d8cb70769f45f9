// Tensor-core building blocks shared by trunk_block.cu and sa_mlp.cu
// (sm_90a): cp.async, ldmatrix and mma.sync.m16n8k16 with bf16 operands
// and float32 accumulators.
//
// Fragment layout of one m16n8k16 product, lane l = 4 * g + q:
//   A (16 x 16, row-major): a[0] rows g, k 2q..2q+1; a[1] rows g + 8, same k;
//     a[2], a[3] the same rows at k + 8.  ldmatrix_x4 with lane l pointing
//     at row (l % 16), column (l / 16) * 8 of the tile loads exactly this.
//   B (16 x 8): b[0] k 2q..2q+1 of column g, b[1] k + 8.  ldmatrix_x4_trans
//     on a row-major (k, n) tile, lane l pointing at k row
//     (l % 8) + ((l / 8) % 2) * 8, column (l / 16) * 8, loads b[0], b[1] of
//     columns 0..7 and then of columns 8..15.
//   C/D (16 x 8, float32): d[0], d[1] row g, columns 2q, 2q + 1; d[2], d[3]
//     row g + 8.  Two neighbouring n8 tiles of D, packed to bf16 pairs, are
//     the A fragment of the next product's k16 slice (pack_a).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16 bf16) @ b (16 x 8 bf16), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half (the lower k or
// column index, as the fragments and memory order want it).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The lane's offset into a row-major (k, n) tile of stride ld (elements)
// for ldmatrix_x4_trans at (k0, n0) = (0, 0).
__device__ __forceinline__ int b_lane_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

}  // namespace mma
