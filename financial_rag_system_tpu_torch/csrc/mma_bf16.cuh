// Tensor-core helpers shared by every kernel of the port (topk_common.cuh,
// pair_attention.cu, fused_bert.cu, flash_attention.cu): mma.sync
// m16n8k16 with bf16 operands and f32 sums, the 32-bit shared-memory
// loads, ldmatrix (plain and transposing) and bf16 packing its fragments
// are made of, and the quad reductions over an accumulator's rows.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// the max and the sum over the four lanes of a quad (lanes 4g .. 4g + 3),
// which hold one row of an m16n8 accumulator between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two neighbouring bf16 values as one 32-bit fragment register
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// round two f32 values to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the addresses of matrix i's rows (16 B each), and r[i] receives
// its elements (2t, g) and (2t + 1, g), the B fragment of a row-major tile
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// addresses of matrix i's rows (16 B each), and r[i] receives its elements
// (g, 2t) and (g, 2t + 1); with matrices (rows 0-7, cols 0-7), (rows 8-15,
// cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15) of a row-major
// 16x16 tile, r is that tile's A fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// two 8x8 bf16 matrices, as ldsm_x4 (lanes 0-15 give the addresses): of an
// (8 keys x 16 values) row-major tile, the B fragment of its transpose
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
