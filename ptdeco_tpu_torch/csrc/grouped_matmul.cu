// Grouped expert matmul: out[rows of group e] = lhs[rows of group e] @ W_e^T,
// bf16 in, f32 accumulate, bf16 out.
//
// Replaces: the library megablox `gmm` Pallas kernel called by
// ptdeco_tpu/models/transformer.py:MoEMLP._grouped (import :5252, call
// :5269) on every prefill and decode step of a bf16 MoE model (and on the
// prefill of an int8 one, after dequantization).
//
// Layout: lhs (M, K) holds the routed (token, slot) rows sorted by expert;
// group_sizes (E,) int32 on the card says how many rows each expert owns, in
// order.  The E expert weights are read through a device array of E
// pointers, each (N, K) row-major: torch.nn.Linear's own layout, one tensor
// per expert module.  The JAX package stacks every expert into a transient
// (E, K, N) copy on each call (transformer.py:5221-5235), 2.8 GB a layer a
// call at Mixtral-8x7B width; the pointer table reads the modules' weights
// where they lie and copies nothing.
//
// What bounds it on an H100:
//   * prefill (M = 4096 rows over 8 experts, K 4096 -> N 14336): 2*M*K*N =
//     481 GFLOP against 1.09 GB of weights and activations, ~440 flops a
//     byte, above the bf16 ridge (~295): tensor-core operations;
//   * decode (M = 8..16 rows): each routed expert's weight is read once for a
//     handful of rows: bytes, the routed experts' weights over 3.35 TB/s.
//
// Design:
//   * no row padding: the TPU kernel needs m % 512 == 0 and pads rows onto
//     the last expert (transformer.py:5207-5220); here each block finds its
//     (expert, row range) from group_sizes by a prefix walk (E steps, no host
//     sync, gmm_tile.cuh:group_slot) and masks the ragged edge of its group
//     itself;
//   * the grid is (ceil(M / BM) + E m-tile slots) x (ceil(N / BN) column
//     tiles), enough for any split of M rows into E groups; a slot past the
//     last group's last tile returns at once, so an expert that no row is
//     routed to is never read;
//   * BM is chosen per call from the mean group size (16 at decode, 64 or
//     128 at prefill; ops/gmm.py:block_rows): a decode tile holds one group's few rows and streams
//     its expert's columns once; a prefill tile reuses each staged weight
//     tile across 128 rows;
//   * the block's tile product is gmm_tile.cuh: a 4-stage cp.async ring,
//     mma.sync m16n8k16 with 64-bit fragment loads.
// Not yet done (later work): wgmma/TMA, a persistent tile scheduler, and
// splitting K at decode when few experts are routed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptdeco::gmm::Tile;

using Decode = Tile<bf16, 16, 128, 64, 1, 4, 4>;
using Medium = Tile<bf16, 64, 128, 32, 2, 2, 4>;
using Prefill = Tile<bf16, 128, 128, 32, 2, 4, 4>;

template <class T>
__global__ void __launch_bounds__(T::kThreads)
    grouped_matmul_kernel(const bf16* __restrict__ lhs,
                          const bf16* const* __restrict__ weights,
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
                             nullptr);
}

template <class T>
int launch(const void* lhs, const void* weights, const void* group_sizes,
           int n_experts, void* out, int m, int k, int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(grouped_matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + T::BM - 1) / T::BM + n_experts, (n + T::BN - 1) / T::BN);
  grouped_matmul_kernel<T><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16* const*>(weights),
      static_cast<const int*>(group_sizes), n_experts, static_cast<bf16*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lhs: (m, k) bf16; weights: device array of n_experts pointers, each to an
// (n, k) bf16 matrix; group_sizes: (n_experts,) int32 on the device; out:
// (m, n) bf16.  All contiguous, 16-byte aligned.  bm (16, 64 or 128) picks
// the tile.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for another bm).
extern "C" int ptdeco_grouped_matmul(const void* lhs, const void* weights,
                                     const void* group_sizes, int n_experts,
                                     void* out, int m, int k, int n, int bm,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16:
      return launch<Decode>(lhs, weights, group_sizes, n_experts, out, m, k, n, s);
    case 64:
      return launch<Medium>(lhs, weights, group_sizes, n_experts, out, m, k, n, s);
    case 128:
      return launch<Prefill>(lhs, weights, group_sizes, n_experts, out, m, k, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
