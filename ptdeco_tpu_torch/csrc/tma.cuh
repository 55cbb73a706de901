// Tensor Memory Accelerator (TMA) helpers shared by the port's Hopper
// kernels: the host side encodes a 2D tensor map of a row-major bf16, f32
// or int8 matrix, or a 4D one of (batch, heads, seq, head_dim) attention
// tensors with the caller's strides; the device side copies one box into
// shared memory, swizzled, or a contiguous run of bytes (a bulk copy), and
// counts its bytes on an mbarrier.
//
// The 128-byte swizzle: a box row of 64 bf16 (128 bytes) holds 8 chunks of
// 16 bytes, and chunk c of row r lands at chunk c ^ (r % 8); a box's
// destination must be 1 KB aligned.  Elements outside the matrix arrive as
// zeros.  The matrix's row pitch must be a multiple of 16 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptdeco {

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that a kernel library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major (rows x cols) bf16 matrix read in boxes of
// box_rows x 64 columns, 128-byte swizzled.  Returns a CUDA error code.
inline int encode_rows(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map of a row-major (rows x cols) f32 matrix read in boxes of
// box_rows x 32 columns (128-byte rows), 128-byte swizzled as above: chunk
// c (4 floats) of box row r lands at chunk c ^ (r % 8).  cols must be a
// multiple of 4.  Returns a CUDA error code.
inline int encode_f32_rows(CUtensorMap* map, const void* base, int rows, int cols,
                           int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map of a row-major (rows x cols) int8 matrix read in boxes of
// box_rows x 64 bytes, 64-byte swizzled: 16-byte chunk c of box row r lands
// at chunk c ^ ((r >> 1) & 3), and a box's destination must be 512-byte
// aligned.  cols must be a multiple of 16.  Returns a CUDA error code.
inline int encode_int8_rows(CUtensorMap* map, const void* base, int rows, int cols,
                            int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map of a (batch, heads, seq, d) bf16 tensor with element strides
// stride_b, stride_h, stride_s (d contiguous) read in boxes of box_rows
// positions x 64 of d for one (batch, head), 128-byte swizzled.  Each head
// is its own row range: a box that runs past seq is zero-filled, never read
// from the next head.  The strides must be multiples of 8 elements.
inline int encode_heads(CUtensorMap* map, const void* base, int batch, int heads, int seq, int d,
                        long long stride_b, long long stride_h, long long stride_s,
                        int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride_s) * 2,
                                 static_cast<cuuint64_t>(stride_h) * 2,
                                 static_cast<cuuint64_t>(stride_b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the box at (column c0, row r0) of `map` into dst; completion on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int r0,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(r0), "r"(smem_addr(bar))
      : "memory");
}

// A tensor map read from device memory (not a __grid_constant__
// parameter) that a host copy wrote: make the copy visible to the
// tensor-map proxy that TMA reads it through, before the map's first use.
// The map must be 64-byte aligned.
__device__ __forceinline__ void tensor_map_acquire(const CUtensorMap* map) {
#if (__CUDACC_VER_MAJOR__ > 12) || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 3)
  asm volatile("fence.proxy.tensormap::generic.acquire.sys [%0], 128;\n" ::"l"(map) : "memory");
#endif
}

// the box at (c0, c1, c2, c3) of a 4D `map` into dst; completion on `bar`
__device__ __forceinline__ void tma_box4(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global src into dst; completion on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `count` arrivals expected (the producer's one, or a consumer warp's
// each); call fence_barrier_init() and a barrier after
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}

// one plain arrival (no bytes announced)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival, announcing `bytes` of copies still to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the completion of phase `parity` (0, 1, 0, ... use by use)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

}  // namespace ptdeco
