// Grouped matmul over weight-only int8 experts:
//   out[i] = (lhs[i] @ Wq[e_i]^T) * scale[e_i],  e_i = row i's expert,
// int8 weights converted to bf16 on chip (exact), bf16 activations, f32
// accumulate, the per-output-channel scale applied once in the f32 epilogue,
// the output rounded to bf16.
//
// Replaces: ptdeco_tpu/ops/gmm_int8.py:_kernel (pallas_call in
// _gmm_int8_padded, :173), which MoEMLP._grouped_int8
// (ptdeco_tpu/models/transformer.py:5295) runs on steps that route <= 512
// rows over quantized experts: the decode steps of serving.generate.
//
// Layout: lhs (M, K) holds the routed rows sorted by expert; group_sizes
// (E,) int32 on the card says how many rows each expert owns, in order, as
// for the bf16 grouped kernel (grouped_matmul.cu).  Each expert's int8 grid
// (N, K) and f32 scale (N,) are read through device arrays of pointers, in
// torch.nn.Linear's (out, in) layout.
//
// What bounds it on an H100: bytes.  At decode (8-16 rows) each routed
// expert's grid is read for a handful of rows: K*N int8 bytes per expert,
// 58.7 MB at K 4096 x N 14336, over 3.35 TB/s; the flops are ~16 per byte.
// At 512 rows (~64 a group) it is still under the bf16 ridge.
//
// Design, against the TPU kernel's habits:
//   * the TPU kernel takes rows scattered so that each group starts on an
//     m-tile (gmm_int8.py:pad_groups_for_tiles), a padded copy of the
//     activations and a gather of the output; here each block finds its
//     expert and rows from group_sizes (gmm_tile.cuh:group_slot, the bf16
//     kernel's walk) and masks its group's ragged edge, so the sorted rows
//     are read as they are;
//   * the TPU's m-tile is 128/256 rows (transformer.py:5318), so 8 decode
//     rows pad to a whole tile; here BM is 16 at decode and 64 above
//     (ops/gmm.py:block_rows), the smallest mma.sync tiles;
//   * the TPU's static tile count ceil(m / bm) + E leaves trailing empty
//     tiles clamped to the last expert (gmm_int8.py:94-99), which read its
//     weights again; here a slot past the last group returns at once, so a
//     routed expert's grid is read once per m-tile of its group and an
//     unrouted expert's not at all, with no host sync;
//   * the grid streams through the same 4-stage cp.async ring as the bf16
//     kernel (gmm_tile.cuh), staged as int8 (half the bytes of bf16) and
//     converted when the fragments are formed.
// Activations are not quantized: int8 tensor-core math would compute
// another function.
// Not yet done (later work): wgmma/TMA, splitting K when few experts are
// routed, and a faster int8 -> bf16 conversion.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptdeco::gmm::Tile;

using Decode = Tile<int8_t, 16, 128, 64, 1, 4, 4>;
using Batch = Tile<int8_t, 64, 128, 64, 2, 2, 4>;

template <class T>
__global__ void __launch_bounds__(T::kThreads)
    gmm_int8_kernel(const bf16* __restrict__ lhs,
                    const int8_t* const* __restrict__ weights,
                    const float* const* __restrict__ scales,
                    const int* __restrict__ group_sizes, int n_experts,
                    bf16* __restrict__ out, int m, int k, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int e, r0, r1;
  if (!ptdeco::gmm::group_slot<T::BM>(static_cast<int>(blockIdx.x), group_sizes, n_experts,
                                      m, e, r0, r1)) {
    return;
  }
  const int n0 = static_cast<int>(blockIdx.y) * T::BN;
  float acc[T::MT][T::NT][4] = {};
  ptdeco::gmm::tile_product<T>(acc, smem, lhs + static_cast<size_t>(r0) * k, r1 - r0,
                               weights[e] + static_cast<size_t>(n0) * k, n - n0, k);
  ptdeco::gmm::store_tile<T>(acc, out + static_cast<size_t>(r0) * n, r1 - r0, n0, n,
                             scales[e]);
}

template <class T>
int launch(const void* lhs, const void* weights, const void* scales,
           const void* group_sizes, int n_experts, void* out, int m, int k, int n,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gmm_int8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + T::BM - 1) / T::BM + n_experts, (n + T::BN - 1) / T::BN);
  gmm_int8_kernel<T><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(lhs), static_cast<const int8_t* const*>(weights),
      static_cast<const float* const*>(scales), static_cast<const int*>(group_sizes),
      n_experts, static_cast<bf16*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lhs: (m, k) bf16; weights / scales: device arrays of n_experts pointers
// to (n, k) int8 grids and (n,) f32 scales; group_sizes: (n_experts,) int32
// on the device; out: (m, n) bf16.  All contiguous, 16-byte aligned.  bm
// (16 or 64) picks the tile.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (cudaErrorInvalidValue for another bm).
extern "C" int ptdeco_gmm_int8(const void* lhs, const void* weights, const void* scales,
                               const void* group_sizes, int n_experts, void* out, int m,
                               int k, int n, int bm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16:
      return launch<Decode>(lhs, weights, scales, group_sizes, n_experts, out, m, k, n, s);
    case 64:
      return launch<Batch>(lhs, weights, scales, group_sizes, n_experts, out, m, k, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
