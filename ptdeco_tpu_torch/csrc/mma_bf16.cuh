// Shared device helpers for the port's hand-written Hopper kernels: the
// warp-level bf16 tensor-core product (mma.sync m16n8k16, f32 accumulate)
// and the packing of two bf16 values into one 32-bit fragment register.
//
// Fragment layout of mma.sync.m16n8k16.row.col (per lane, g = lane / 4,
// t = lane % 4), the contract every kernel here relies on:
//   A (16x16, row):  a0 = (g,   2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                    a2 = (g,   2t+8..+9)   a3 = (g+8, 2t+8..+9)
//   B (16x8,  col):  b0 = (k = 2t..2t+1, n = g)   b1 = (k = 2t+8..+9, n = g)
//   C (16x8, f32):   c0, c1 = (g, 2t..2t+1)      c2, c3 = (g+8, 2t..2t+1)
// The lower 16 bits of a packed register hold the lower-indexed element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptdeco {

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Round two f32 values to bf16 (round to nearest even) and pack them.
__device__ __forceinline__ uint32_t pack_f32_as_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Two consecutive bf16 elements (row, col) and (row, col + 1) of a row-major
// (rows x cols) matrix with leading dimension ld, zero outside the matrix.
// col must be even; the 32-bit load is taken only where it is aligned.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              int row, int col, int rows,
                                              int cols, int ld) {
  if (row >= rows || col >= cols) return 0u;
  const __nv_bfloat16* p = base + static_cast<size_t>(row) * ld + col;
  if (col + 1 < cols && (ld & 1) == 0) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  return pack_bf16(p[0], col + 1 < cols ? p[1] : zero);
}

}  // namespace ptdeco
