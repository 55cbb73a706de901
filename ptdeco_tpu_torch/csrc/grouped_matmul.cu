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
//     tile across 64 or 128 rows;
//   * two routes, chosen by shape in the wrapper (ops/gmm.py:kernel_route),
//     never after a failure:
//     - "wgmma" (BM 64 and 128, both row pitches multiples of 16 bytes, at
//       most kMaxExperts experts): a warp-specialised TMA + wgmma tile of
//       BM x 256.  A producer warpgroup (registers handed over with
//       setmaxnreg) has one thread keep a 4-stage ring of BK = 64 (one
//       128-byte swizzle atom) full with TMA boxes of lhs and of the
//       expert's weight, through one tensor map over lhs (M, K), a
//       __grid_constant__ parameter, and one per expert weight (N, K), read
//       from a 64-byte aligned table in device memory (a kernel's
//       parameters hold at most 16 maps; the table holds any number, and
//       the wrapper encodes it once for a set of weights and keeps it,
//       ops/gmm.py); both are K-major, wgmma's natural A and B.  Two consumer
//       warpgroups run wgmma m64n256k16 (BM 128: 64 rows each) or m64n128k16
//       (BM 64: 128 columns each) with one group of products in flight, and
//       release a stage as soon as the products that read it are done.  A
//       lhs box may run past the group into the next expert's rows (they
//       are multiplied, never stored) or past M (zeros).  The epilogue
//       stages the bf16 tile in the freed ring and writes rows [r0, r1) and
//       columns < N only, as 16-byte row stores: a TMA store of a box that
//       crosses r1 would overwrite the next expert's rows;
//     - "mma_sync" (the 16-row decode tile, which is already near its byte
//       bound, and every shape the wgmma route does not take): gmm_tile.cuh,
//       a 4-stage cp.async ring, mma.sync m16n8k16 with 64-bit fragment
//       loads;
//   * the slot index is the fast grid dimension, so the CTAs in flight run
//     every m-tile of every expert for a few n-tiles together: each
//     expert's weight columns are read from device memory about once while
//     its rows stay in L2.
// Measured and not kept (PERF.md): a persistent grid of one CTA an
// SM, storing from the accumulators (slower: 4-byte stores) or staging
// beside a 3-stage ring (no faster); 128 x 128 tiles (slower); two CTAs
// an SM (does not fit: wgmma needs more than the 85 registers a thread);
// a cluster of two m-tiles sharing an expert's weight tile by TMA
// multicast (slower).
// Not yet done (later work): splitting K at decode when few experts are
// routed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "gmm_tile.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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


// ---- the wgmma route -------------------------------------------------------

// the weights' tensor maps lie in a device table (ops/gmm.py:MAX_TMA_EXPERTS)
constexpr int kMaxExperts = 256;
constexpr int kWgThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;

// BM x BN output tile, BK = 64, a STAGES-deep ring, one CTA an SM.  BM 128:
// warpgroup w takes rows 64 w .. and all BN columns; BM 64: the 64 rows and
// columns (BN / 2) w ..
template <int BM_, int BN_, int STAGES_>
struct WgTile {
  static constexpr int BM = BM_, BN = BN_, BK = 64, STAGES = STAGES_;
  static constexpr int kA = BM * BK;            // elements of a stage's lhs box
  static constexpr int kB = BN * BK;            // elements of a stage's weight box
  static constexpr int kStage = kA + kB;
  static constexpr int kRingBytes = STAGES * kStage * 2;
  static constexpr int WN = BM == 128 ? BN : BN / 2;  // columns a warpgroup
  static constexpr int kAcc = WN / 2;            // f32 accumulators a thread
  static constexpr int kOutLd = WN + 8;          // staged bf16 row (+16 bytes: no bank conflicts)
  static constexpr int kOutBytes = 2 * 64 * kOutLd * 2;
  static_assert(BM == 64 || BM == 128, "m-tile");
  static_assert(WN == 128 || WN == 256, "a warpgroup's columns");
  static_assert(kOutBytes <= kRingBytes, "the staged tile reuses the ring");
  // + one full and one empty mbarrier a stage, + 1 KB to align the ring
  static constexpr int kSmemBytes = kRingBytes + 2 * STAGES * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of a CTA");
};

// the tiles the wrapper's m-tiles take (ops/gmm.py:block_rows); the prefill
// tile chosen by measurement (tools/tile_sweep.py; PERF.md)
using WgPrefill = WgTile<128, 256, 4>;
using WgMedium = WgTile<64, 256, 4>;

__device__ __forceinline__ void consumer_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <class T>
__global__ void __launch_bounds__(kWgThreads, 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                         const CUtensorMap* __restrict__ weight_maps,
                         const int* __restrict__ group_sizes, int n_experts,
                         bf16* __restrict__ out, int m, int k, int n) {
  int e, r0, r1;
  if (!ptdeco::gmm::group_slot<T::BM>(static_cast<int>(blockIdx.x), group_sizes, n_experts, m,
                                      e, r0, r1)) {
    return;
  }
  const int n0 = static_cast<int>(blockIdx.y) * T::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (ptdeco::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [STAGES][lhs box, weight box]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kRingBytes);
  uint64_t* empty = full + T::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      ptdeco::mbar_init(&full[i], 1);
      ptdeco::mbar_init(&empty[i], kConsumerWarps);
    }
    ptdeco::fence_barrier_init();
  }
  __syncthreads();
  const int n_k = (k + T::BK - 1) / T::BK;

  if (warp < 4) {
    // producer: one thread keeps the ring full; no barrier follows that
    // would need the others
    ptdeco::wgmma::regs_dec<40>();
    if (warp == 0 && lane == 0) {
      const CUtensorMap* wmap = weight_maps + e;
      ptdeco::tensor_map_acquire(wmap);
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % T::STAGES, ph = (kt / T::STAGES) & 1;
        bf16* a = ring + st * T::kStage;
        ptdeco::mbar_wait(&empty[st], ph ^ 1);
        ptdeco::mbar_expect(&full[st], T::kStage * 2);
        ptdeco::tma_box(a, &lhs_map, kt * T::BK, r0, &full[st]);
        ptdeco::tma_box(a + T::kA, wmap, kt * T::BK, n0, &full[st]);
      }
    }
    return;
  }

  ptdeco::wgmma::regs_inc<232>();
  const int wg = (warp >> 2) - 1;
  float acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
  // this warpgroup's operands within a stage: 64 lhs rows and WN weight rows
  const int a_off = T::BM == 128 ? wg * 64 * T::BK : 0;
  const int b_off = T::kA + (T::BM == 128 ? 0 : wg * T::WN * T::BK);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % T::STAGES, ph = (kt / T::STAGES) & 1;
    const bf16* a = ring + st * T::kStage;
    ptdeco::mbar_wait(&full[st], ph);
    ptdeco::wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) {
      const uint64_t da = ptdeco::wgmma::desc(a + a_off + kk * 16, 16, 1024);
      const uint64_t db = ptdeco::wgmma::desc(a + b_off + kk * 16, 16, 1024);
      if constexpr (T::WN == 256) {
        ptdeco::wgmma::ss_m64n256k16<0, 0>(acc, da, db, 1);
      } else {
        ptdeco::wgmma::ss_m64n128k16<0, 0>(acc, da, db, 1);
      }
    }
    ptdeco::wgmma::commit();
    // the previous step's products are done: release their stage
    ptdeco::wgmma::wait<1>();
    if (kt > 0 && lane == 0) ptdeco::mbar_arrive(&empty[(kt - 1) % T::STAGES]);
  }
  ptdeco::wgmma::wait<0>();
  ptdeco::wgmma::fence_acc<T::kAcc>(acc);

  // both warpgroups are done reading the ring: stage the tile there, this
  // warpgroup's 64 x WN part at 64 wg rows, then write it row by row
  consumer_sync(1, 256);
  bf16* st = reinterpret_cast<bf16*>(smem) + wg * 64 * T::kOutLd;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int srow = (warp & 3) * 16 + g8;
#pragma unroll
  for (int q = 0; q < T::WN / 8; ++q) {
    const int c = q * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(&st[srow * T::kOutLd + c]) =
        ptdeco::pack_f32_as_bf16(acc[4 * q], acc[4 * q + 1]);
    *reinterpret_cast<uint32_t*>(&st[(srow + 8) * T::kOutLd + c]) =
        ptdeco::pack_f32_as_bf16(acc[4 * q + 2], acc[4 * q + 3]);
  }
  consumer_sync(2 + wg, 128);
  const int row0 = r0 + (T::BM == 128 ? wg * 64 : 0);
  const int col0 = n0 + (T::BM == 128 ? 0 : wg * T::WN);
  const int row_end = r1;  // the group's last row + 1: never store past it
  constexpr int kChunks = T::WN / 8;  // 16-byte chunks of a staged row
  for (int i = tid & 127; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < row_end && gc < n)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(gr) * n + gc) =
          *reinterpret_cast<const uint4*>(&st[r * T::kOutLd + c]);
  }
}

template <class T>
int launch_wgmma(const void* lhs, const void* weight_maps, const void* group_sizes,
                 int n_experts, void* out, int m, int k, int n, cudaStream_t stream) {
  static unsigned opted_in = 0;  // once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(opted_in & (1u << dev))) {
    err = cudaFuncSetAttribute(grouped_wgmma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) opted_in |= 1u << dev;
  }
  CUtensorMap lhs_map;
  const int rc = ptdeco::encode_rows(&lhs_map, lhs, m, k, T::BM);
  if (rc != 0) return rc;
  const dim3 grid((m + T::BM - 1) / T::BM + n_experts, (n + T::BN - 1) / T::BN);
  grouped_wgmma_kernel<T><<<grid, kWgThreads, T::kSmemBytes, stream>>>(
      lhs_map, static_cast<const CUtensorMap*>(weight_maps),
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

// The wgmma route's weight maps for m-tile bm: into `maps`, a HOST buffer
// of n_experts CUtensorMaps (128 bytes each), the map of each (n, k) bf16
// matrix at weight_ptrs[i] (a host array of device pointers), read in boxes
// of the tile's BN rows x 64.  The caller copies the buffer to a 64-byte
// aligned device table for ptdeco_grouped_matmul_wgmma at the same bm, once
// for a set of weights.  Returns a CUDA error code.
extern "C" int ptdeco_grouped_wgmma_encode_weights(const unsigned long long* weight_ptrs,
                                                   int n_experts, int n, int k, int bm,
                                                   void* maps) {
  const int box_rows = bm == 64 ? WgMedium::BN : bm == 128 ? WgPrefill::BN : 0;
  if (n_experts < 1 || n_experts > kMaxExperts || k % 8 != 0 || n % 8 != 0 || box_rows == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_experts; ++i) {
    CUtensorMap map;  // aligned here, then copied into the caller's buffer
    const int rc = ptdeco::encode_rows(&map, reinterpret_cast<const void*>(weight_ptrs[i]), n, k,
                                       box_rows);
    if (rc != 0) return rc;
    memcpy(static_cast<unsigned char*>(maps) + sizeof(CUtensorMap) * i, &map, sizeof(map));
  }
  return 0;
}

// The wgmma route.  lhs: (m, k) bf16; weight_maps: a DEVICE table of
// n_experts tensor maps, 64-byte aligned, from
// ptdeco_grouped_wgmma_encode_weights at these n, k and bm; group_sizes:
// (n_experts,) int32 on the device; out: (m, n) bf16.  All contiguous,
// 16-byte aligned, k and n multiples of 8, 1 <= n_experts <= kMaxExperts,
// bm 64 or 128.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for what the route does not
// take).
extern "C" int ptdeco_grouped_matmul_wgmma(const void* lhs, const void* weight_maps,
                                           const void* group_sizes, int n_experts, void* out,
                                           int m, int k, int n, int bm, void* stream) {
  if (n_experts < 1 || n_experts > kMaxExperts || k % 8 != 0 || n % 8 != 0 ||
      reinterpret_cast<uintptr_t>(weight_maps) % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 64:
      return launch_wgmma<WgMedium>(lhs, weight_maps, group_sizes, n_experts, out, m, k, n, s);
    case 128:
      return launch_wgmma<WgPrefill>(lhs, weight_maps, group_sizes, n_experts, out, m, k, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of one wgmma-route CTA at m-tile bm (0 for another)
extern "C" int ptdeco_grouped_wgmma_smem_bytes(int bm) {
  return bm == 64 ? WgMedium::kSmemBytes : bm == 128 ? WgPrefill::kSmemBytes : 0;
}

// the most experts the wgmma route takes
extern "C" int ptdeco_grouped_wgmma_max_experts() { return kMaxExperts; }
