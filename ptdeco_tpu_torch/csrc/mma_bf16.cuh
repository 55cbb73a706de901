// Shared device helpers for the port's hand-written Hopper kernels: the
// warp-level bf16 tensor-core product (mma.sync m16n8k16, f32 accumulate),
// the packing of two bf16 values into one 32-bit fragment register, the
// ldmatrix fragment loads and the zero-filling cp.async copies.
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

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register q receives matrix q in the mma
// fragment layout (row = lane / 4, two columns from 2 * (lane % 4)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same with each matrix transposed: lane (g, t) receives elements
// (2t, g) and (2t + 1, g) of the matrix as it lies in memory.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Asynchronous 16- or 4-byte copy global -> shared; when `valid` is false
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

// Offset of element (r, c) of a tile of 64-column (128-byte) rows with the
// 128-byte swizzle that TMA writes: chunk c / 8 of row r lands at chunk
// (c / 8) ^ (r % 8), so ldmatrix's 8 rows of one chunk hit 8 banks.
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// Copy rows [row0, row0 + Rows) x columns [col0, col0 + 64) of a row-major
// (row_lim x col_lim) bf16 matrix with leading dimension ld into a swz64
// tile, zero outside the matrix: the cp.async path for a matrix that TMA
// cannot address.  `vec` is the copy width in elements: 8 (16-byte
// cp.async; ld and col_lim multiples of 8, base 16-byte aligned), 2
// (4-byte cp.async; ld and col_lim even) or 1 (plain loads and stores,
// visible after the next barrier).  Only the first `rows` rows are
// written.  The Threads threads that call it pass their index tid.
template <int Rows, int Threads>
__device__ __forceinline__ void load_block(int tid, __nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int ld, int row0,
                                           int row_lim, int col0, int col_lim, int vec,
                                           int rows = Rows) {
  rows = rows < Rows ? rows : Rows;
  if (vec == 8) {
    // each thread copies the chunk at column cc of rows cr, cr + kStride, ...
    constexpr int kStride = Threads / 8;
    constexpr int kPer = (Rows + kStride - 1) / kStride;
    const int cr = tid / 8, cc = (tid % 8) * 8;
    const bool col_ok = col0 + cc < col_lim;
    const __nv_bfloat16* p = src + static_cast<size_t>(row0 + cr) * ld + col0 + cc;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = cr + i * kStride;
      if (r >= rows) break;
      const bool ok = col_ok && row0 + r < row_lim;
      cp_async16_zfill(dst + swz64(r, cc), ok ? p + static_cast<size_t>(i) * kStride * ld : src,
                       ok);
    }
  } else if (vec == 2) {
    for (int e = tid; e < rows * 32; e += Threads) {
      const int r = e / 32, c = (e % 32) * 2;
      const bool ok = row0 + r < row_lim && col0 + c < col_lim;
      const __nv_bfloat16* p = ok ? src + static_cast<size_t>(row0 + r) * ld + col0 + c : src;
      cp_async4_zfill(dst + swz64(r, c), p, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < rows * 64; e += Threads) {
      const int r = e / 64, c = e % 64;
      const bool ok = row0 + r < row_lim && col0 + c < col_lim;
      dst[swz64(r, c)] = ok ? src[static_cast<size_t>(row0 + r) * ld + col0 + c] : zero;
    }
  }
}

}  // namespace ptdeco
