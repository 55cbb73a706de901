// Grouped matmul over weight-only int8 experts:
//   out[i] = bf16((lhs[i] @ Wq[e_i]^T) * scale[e_i]),  e_i = row i's expert,
// int8 weights converted exactly to bf16 on chip, bf16 activations, f32
// accumulation, the per-output-channel scale applied once in the f32
// epilogue and the output rounded once.
//
// Replaces: ptdeco_tpu/ops/gmm_int8.py:_kernel (pallas_call in
// _gmm_int8_padded, :173), which MoEMLP._grouped_int8
// (ptdeco_tpu/models/transformer.py:5295) runs on the steps of a quantized
// MoE model.
//
// Layout: lhs (M, K) holds the routed rows sorted by expert; group_sizes
// (E,) int32 on the card says how many rows each expert owns, in order, as
// for the bf16 grouped kernel (grouped_matmul.cu).  Each expert's int8 grid
// (N, K) and f32 scale (N,) are read where they lie, in torch.nn.Linear's
// (out, in) layout: through device arrays of pointers, or for TMA through
// one tensor map per expert.  A CTA finds its expert and rows by a walk
// over group_sizes on the card (gmm_tile.cuh:group_slot, the bf16 kernel's):
// no host sync, no padded copy, and an expert no row is routed to is never
// read.
//
// What bounds it on an H100, and the design: two routes, chosen by shape
// in the wrapper (ops/gmm_int8.py:kernel_route), never after a failure.
//
//   * "decode" (a few rows a group: the decode steps' 8-16 rows over 8
//     experts; also every shape the batch route does not take).  Bound by
//     weight bytes: each routed expert's grid is read once for 1-2 rows
//     (58.7 MB an expert at K 4096 x N 14336, over 3.35 TB/s).  So:
//     - operands swapped: the expert's weight rows (output channels) are
//       the M side of mma.sync m16n8k16 (32 a warp, 2 m-tiles) and the
//       slot's <= 16 group rows its N side (one or two n8 tiles), so no MMA
//       work is spent on padded rows;
//     - split K: a unit is (16-row slot, column tile, k-split); the
//       k-splits of a unit are one thread-block cluster, and the split
//       count is chosen on the host from m, E, N, K and the SM count alone
//       (ops/gmm_int8.py:decode_split) so that the units cover the card
//       even when few experts are routed or N is narrow (the down
//       projection).  A slot past the last group returns at once;
//     - the split-K partials are reduced deterministically: each CTA leaves
//       its f32 partial in its own shared memory, and after a cluster
//       barrier each CTA sums a share of the outputs over the cluster's
//       partials in rank order (distributed shared memory), scales and
//       stores them: the same inputs give the same bits on every run, with
//       no atomics;
//     - weights stream by cp.async.bulk, one copy a weight row a stage (so
//       a pointer table serves any number of experts), into a ring of
//       COLS x BK-byte stages completed on mbarriers, with the slot's rows
//       of lhs beside them; rows are padded 16 bytes so that the fragment
//       loads are free of bank conflicts.  The copies' count, not the
//       bytes in flight, is what the sweep found to matter (PERF.md): the
//       ring is two stages, two CTAs an SM.  A row pitch that is not a
//       multiple of 16 bytes takes plain loads instead (no model here has
//       one);
//     - int8 -> bf16 is exact and cheap: each byte is put into the mantissa
//       of 2^23 with prmt (after flipping its sign bit), 2^23 + 128 is
//       subtracted in f32, and the upper halves of two such floats are one
//       bf16 pair (a prmt); no I2F.  Each weight byte is converted once a
//       CTA: lane (g, t) loads 16 bytes of rows g and g + 8 and uses them in
//       four MMA k-steps, the lhs rows permuted alike along k (the product
//       sums over k, so it is unchanged).
//   * "batch" (more than 16 rows a mean group: 256-512 rows over 8
//     experts, the prefill's 4096).  Bound by tensor-core operations at
//     4096 rows (481 GFLOP against 0.97 GB), by bytes at 512.  A
//     warp-specialised TMA + wgmma tile with the weights as A from
//     registers: a producer warp TMA-loads, into a ring of stages, a box of
//     128 weight rows x 64 int8 (64-byte swizzle) and a box of the group's
//     BN rows (128 or 256) x 64 bf16 of lhs (128-byte swizzle).  Two
//     consumer warpgroups each convert their 64 weight rows of the box into
//     wgmma's register A fragments (two 32-bit loads a row and k-step, free
//     of bank conflicts under the swizzle) and issue wgmma m64nBNk16 with
//     the lhs box as a K-major B; one warpgroup converts while the other's
//     products run (an A register written while a product of its own
//     warpgroup is in flight would make ptxas serialize them).  A group's
//     weights are read once per BN-row chunk of the group, not once per
//     64-row m-tile.  The transposed accumulator tile is scaled, staged in
//     the freed ring and written row by row, 16 bytes a store, rows
//     [r0, r1) only: a lhs box may run into the next expert's rows, which
//     are multiplied but never stored.  The lhs map is a kernel parameter;
//     the experts' maps lie in a 64-byte aligned table in device memory,
//     which the wrapper encodes once for a set of grids and keeps
//     (ops/gmm_int8.py), so the route takes up to kMaxExperts experts (a
//     kernel's parameters would hold 16 maps).  K must be a multiple of 16
//     and N of 8 (TMA's and the 16-byte stores' rules); other shapes take
//     the decode route.
// Activations are not quantized: int8 tensor-core math would compute
// another function.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "gmm_tile.cuh"
#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// Four int8 values (byte i of v is element i) as two packed bf16 pairs,
// lo = (e0, e1), hi = (e2, e3); exact, since every int8 value is a bf16
// value.  x + 128 (the sign bit flipped) in the low mantissa byte of 2^23
// is the float 2^23 + 128 + x; subtracting 2^23 + 128 leaves x exactly, and
// a float that is a bf16 value is its upper 16 bits.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  constexpr uint32_t kTwo23 = 0x4B000000u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, kTwo23, 0x7440)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, kTwo23, 0x7441)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, kTwo23, 0x7442)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, kTwo23, 0x7443)) - kBias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---- the decode route ------------------------------------------------------

constexpr int kDecRows = 16;      // group rows a slot takes: two n8 MMA tiles
constexpr int kDecThreads = 256;  // 8 warps
constexpr int kLhsThread = 128;   // the thread that copies a slot's first lhs row
constexpr int kMaxSplit = 8;      // CTAs of a cluster (the portable most)

// COLS weight rows (output channels) a CTA, BK bytes of k a stage, STAGES
// stages in the ring.  The 8 warps are COLS / 32 column groups of 32 times
// kWarpsK parts of each stage's k, whole 128-byte units each.
template <int COLS_, int BK_, int STAGES_>
struct DecTile {
  static constexpr int COLS = COLS_, BK = BK_, STAGES = STAGES_;
  static constexpr int kWarpsN = COLS / 32, kWarpsK = 8 / kWarpsN;
  static constexpr int kPart = BK / kWarpsK;  // bytes of a stage's k a warp takes
  static constexpr int kWLd = BK + 16;        // bytes a staged weight row (16 (mod 128))
  static constexpr int kALd = 2 * BK + 32;    // bytes a staged lhs row
  static constexpr int kWBytes = COLS * kWLd;
  static constexpr int kStage = kWBytes + kDecRows * kALd;
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kPartLd = COLS + 4;  // f32 a partial row: stores free of conflicts
  static constexpr int kPartBytes = kWarpsK * kDecRows * kPartLd * 4;
  static constexpr int kBarOffset = kRing > kPartBytes ? kRing : kPartBytes;
  static constexpr int kSmemBytes = kBarOffset + STAGES * 8;
  static_assert(COLS == 64 || COLS == 128, "columns");
  static_assert(kPart % 128 == 0, "k step");
  static_assert(kSmemBytes <= 232448, "shared memory of a CTA");
};

// 512-byte copies at two CTAs an SM: the copies' count, more than the
// bytes in flight, set the pace (tools/int8_sweep.py, PERF.md)
using DecodeTile = DecTile<64, 512, 2>;

template <class T>
__global__ void __launch_bounds__(kDecThreads, 2)
    decode_kernel(const bf16* __restrict__ lhs, const int8_t* const* __restrict__ weights,
                  const float* const* __restrict__ scales, const int* __restrict__ group_sizes,
                  int n_experts, bf16* __restrict__ out, int m, int k, int n,
                  int steps_per_split, int bulk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  int e, r0, r1;
  // the k-splits of one unit are one cluster: they all return here or none
  if (!ptdeco::gmm::group_slot<kDecRows>(static_cast<int>(blockIdx.x) / ks, group_sizes,
                                         n_experts, m, e, r0, r1)) {
    return;
  }
  const int rows = r1 - r0;
  const int n0 = static_cast<int>(blockIdx.y) * T::COLS;
  const int cols = min(T::COLS, n - n0);
  const int kbeg = split * steps_per_split * T::BK;
  const int kend = min(k, kbeg + steps_per_split * T::BK);
  const int n_k = kend > kbeg ? (kend - kbeg + T::BK - 1) / T::BK : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % T::kWarpsN, kq = warp / T::kWarpsN;  // columns 32 rg .., k part kq
  const int8_t* w = weights[e] + static_cast<size_t>(n0) * k;
  const bf16* x = lhs + static_cast<size_t>(r0) * k;

  if (bulk) {
    if (tid == 0) {
      for (int s = 0; s < T::STAGES; ++s) ptdeco::mbar_init(&full[s], 1);
      ptdeco::fence_barrier_init();
    }
    __syncthreads();
  }
  auto span = [&](int kt) { return min(T::BK, kend - kbeg - kt * T::BK); };
  // one thread announces a stage's bytes; each of its rows is one copy,
  // issued by its own thread (weight row tid, lhs row tid - kLhsThread)
  auto expect = [&](int kt) {
    ptdeco::mbar_expect(&full[kt % T::STAGES], span(kt) * (cols + 2 * rows));
  };
  auto issue = [&](int kt) {
    const int k0 = kbeg + kt * T::BK, sp = span(kt);
    unsigned char* st = smem + (kt % T::STAGES) * T::kStage;
    uint64_t* bar = &full[kt % T::STAGES];
    if (tid < cols) {
      ptdeco::bulk_copy(st + tid * T::kWLd, w + static_cast<size_t>(tid) * k + k0, sp, bar);
    } else if (tid >= kLhsThread && tid - kLhsThread < rows) {
      const int r = tid - kLhsThread;
      ptdeco::bulk_copy(st + T::kWBytes + r * T::kALd, x + static_cast<size_t>(r) * k + k0,
                        2 * sp, bar);
    }
  };
  // a row pitch TMA cannot address: the stage loaded by every thread,
  // zero past the rows and k
  auto fill = [&](int kt) {
    const int k0 = kbeg + kt * T::BK, sp = span(kt);
    unsigned char* st = smem + (kt % T::STAGES) * T::kStage;
    for (int i = tid; i < T::COLS * T::BK; i += kDecThreads) {
      const int r = i / T::BK, c = i % T::BK;
      st[r * T::kWLd + c] =
          r < cols && c < sp ? static_cast<unsigned char>(w[static_cast<size_t>(r) * k + k0 + c])
                             : 0;
    }
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < kDecRows * T::BK; i += kDecThreads) {
      const int r = i / T::BK, c = i % T::BK;
      reinterpret_cast<bf16*>(st + T::kWBytes + r * T::kALd)[c] =
          r < rows && c < sp ? x[static_cast<size_t>(r) * k + k0 + c] : zero;
    }
  };

  if (bulk) {
    const int pre = min(T::STAGES, n_k);
    if (tid == 0)
      for (int s = 0; s < pre; ++s) expect(s);
    __syncthreads();
    for (int s = 0; s < pre; ++s) issue(s);
  }

  float acc[2][2][4] = {};
  const bool two = rows > 8;  // the second n8 tile holds rows 8 .. 15
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % T::STAGES;
    if (bulk) {
      ptdeco::mbar_wait(&full[st], (kt / T::STAGES) & 1);
    } else {
      fill(kt);
      __syncthreads();
    }
    const unsigned char* sw = smem + st * T::kStage;
    const unsigned char* sa = sw + T::kWBytes;
    const int sp = span(kt);
#pragma unroll
    for (int u = 0; u < T::kPart / 128; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // this lane's 16 k of the stage: chunk 2t + h of 128-byte unit u of
        // part kq; MMA step j takes its bytes 4j .. 4j + 3
        const int kc = kq * T::kPart + u * 128 + 16 * (2 * t + h);
        // past the stage's span the bytes are stale: zero the lhs side (a
        // stale int8 is finite, so its products are zero)
        const bool live = kc < sp;
        uint32_t b[2][8];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt == 1 && !two) break;
          const unsigned char* p = sa + (nt * 8 + g) * T::kALd + 2 * kc;
          const uint4 v0 = lds128(p), v1 = lds128(p + 16);
          b[nt][0] = live ? v0.x : 0u;
          b[nt][1] = live ? v0.y : 0u;
          b[nt][2] = live ? v0.z : 0u;
          b[nt][3] = live ? v0.w : 0u;
          b[nt][4] = live ? v1.x : 0u;
          b[nt][5] = live ? v1.y : 0u;
          b[nt][6] = live ? v1.z : 0u;
          b[nt][7] = live ? v1.w : 0u;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int row = rg * 32 + mt * 16 + g;
          const uint4 lo = lds128(sw + row * T::kWLd + kc);
          const uint4 hi = lds128(sw + (row + 8) * T::kWLd + kc);
          const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
          const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t a[4];
            int8x4_to_bf16(wl[j], a[0], a[2]);
            int8x4_to_bf16(wh[j], a[1], a[3]);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              if (nt == 1 && !two) break;
              const uint32_t bb[2] = {b[nt][2 * j], b[nt][2 * j + 1]};
              ptdeco::mma_16816(acc[mt][nt], a, bb);
            }
          }
        }
      }
    }
    const int next = kt + T::STAGES;
    if (bulk && next < n_k && tid == 0) expect(next);
    __syncthreads();  // every warp is done with this stage
    if (bulk && next < n_k) issue(next);
  }

  // each warp's f32 partial (columns x rows) into the freed ring, as
  // part[kq][group row][column]; then the cluster's partials are summed
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = nt * 8 + 2 * t + (c & 1);
        const int j = rg * 32 + mt * 16 + g + 8 * (c >> 1);
        part[(kq * kDecRows + i) * T::kPartLd + j] = acc[mt][nt][c];
      }
  cluster.sync();
  // CTA `split` takes every ks-th block of output pairs; each pair is the
  // sum, in rank order, of the cluster's ks x kWarpsK partials
  const float* sc = scales[e] + n0;
  for (int p = split * kDecThreads + tid; p < rows * (T::COLS / 2); p += ks * kDecThreads) {
    const int i = p / (T::COLS / 2), j = 2 * (p % (T::COLS / 2));
    if (j >= cols) continue;
    float v0 = 0.f, v1 = 0.f;
    for (int s = 0; s < ks; ++s) {
#pragma unroll
      for (int q = 0; q < T::kWarpsK; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(part + (q * kDecRows + i) * T::kPartLd + j, s));
        v0 += v.x;
        v1 += v.y;
      }
    }
    const float s0 = sc[j], s1 = j + 1 < cols ? sc[j + 1] : 0.f;
    bf16* o = out + static_cast<size_t>(r0 + i) * n + n0 + j;
    if (j + 1 < cols && (n & 1) == 0) {
      *reinterpret_cast<uint32_t*>(o) = ptdeco::pack_f32_as_bf16(v0 * s0, v1 * s1);
    } else {
      o[0] = __float2bfloat16_rn(v0 * s0);
      if (j + 1 < cols) o[1] = __float2bfloat16_rn(v1 * s1);
    }
  }
  cluster.sync();  // no CTA leaves while another may read its partial
}

template <class T>
int launch_decode(const void* lhs, const void* weights, const void* scales,
                  const void* group_sizes, int n_experts, void* out, int m, int k, int n,
                  int ks, int steps_per_split, cudaStream_t stream) {
  static unsigned opted_in = 0;  // once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(opted_in & (1u << dev))) {
    err = cudaFuncSetAttribute(decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) opted_in |= 1u << dev;
  }
  // bulk copies need 16-byte aligned rows of both matrices
  const int bulk = k % 16 == 0 && reinterpret_cast<uintptr_t>(lhs) % 16 == 0;
  const int slots = (m + kDecRows - 1) / kDecRows + n_experts;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks * slots, (n + T::COLS - 1) / T::COLS, 1);
  cfg.blockDim = dim3(kDecThreads, 1, 1);
  cfg.dynamicSmemBytes = T::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T>, static_cast<const bf16*>(lhs),
                           static_cast<const int8_t* const*>(weights),
                           static_cast<const float* const*>(scales),
                           static_cast<const int*>(group_sizes), n_experts,
                           static_cast<bf16*>(out), m, k, n, steps_per_split, bulk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- the batch route -------------------------------------------------------

constexpr int kBatCols = 128;     // weight rows a CTA takes: 64 a consumer warpgroup
constexpr int kBatK = 64;         // k a stage: one swizzle atom of the lhs box
constexpr int kBatThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
// the grids' tensor maps (boxes of kBatCols rows x 64 bytes) lie in a
// device table (ops/gmm.py:MAX_TMA_EXPERTS)
constexpr int kMaxExperts = 256;

// BN group rows a tile (the wgmma's N: 128 or 256; 64 rows re-read a
// 64-row group's weights for its neighbours too often), STAGES stages
template <int BN_, int STAGES_>
struct BatTile {
  static constexpr int BN = BN_, STAGES = STAGES_;
  static constexpr int kABytes = BN * kBatK * 2;    // a stage's lhs box (1 KB multiple)
  static constexpr int kWBytes = kBatCols * kBatK;  // a stage's weight box
  static constexpr int kStage = kABytes + kWBytes;
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kAcc = BN / 2;          // f32 accumulators a consumer thread
  static constexpr int kOutLd = kBatCols + 8;  // staged bf16 row: stores free of conflicts
  static_assert(BN == 128 || BN == 256, "tile rows");
  static_assert(BN * kOutLd * 2 <= kRing, "the staged tile reuses the ring");
  // + one full and one empty mbarrier a stage, + 1 KB to align the ring
  static constexpr int kSmemBytes = kRing + 2 * STAGES * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of a CTA");
};

using Bat256 = BatTile<256, 5>;
using Bat128 = BatTile<128, 8>;

__device__ __forceinline__ void consumer_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int BN>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t* a, uint64_t db) {
  if constexpr (BN == 256) {
    ptdeco::wgmma::rs_m64n256k16<0>(acc, a, db, 1);
  } else {
    ptdeco::wgmma::rs_m64n128k16<0>(acc, a, db, 1);
  }
}

// Where lane (g, t) of a consumer warp finds its A fragments in a stage's
// weight box: k-step kk needs bytes 2t, 2t + 1 (+ 8) of the row's 16-byte
// chunk kk, in words t / 2 and 2 + t / 2 of the chunk, which the 64-byte
// swizzle puts at chunk kk ^ ((row >> 1) & 3); rows ra and ra + 8
struct Frag {
  int a_off, b_off, sa, sb;
  uint32_t sel;  // the pair 2t, 2t + 1 of each word
  __device__ __forceinline__ Frag(int ra, int t)
      : a_off(ra * kBatK + 4 * (t >> 1)),
        b_off((ra + 8) * kBatK + 4 * (t >> 1)),
        sa((ra >> 1) & 3),
        sb(((ra + 8) >> 1) & 3),
        sel((t & 1) ? 0x7632u : 0x5410u) {}
};

// The four k-steps' A fragments (rows ra, ra + 8) of a weight box, as
// bf16 in mma.sync's A layout: a[4 kk + 0, 2] row ra, a[4 kk + 1, 3] row
// ra + 8
__device__ __forceinline__ void batch_frags(const unsigned char* wbox, const Frag& f,
                                            uint32_t (&a)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned char* pa = wbox + f.a_off + ((kk ^ f.sa) << 4);
    const unsigned char* pb = wbox + f.b_off + ((kk ^ f.sb) << 4);
    const uint32_t va = __byte_perm(lds32(pa), lds32(pa + 8), f.sel);
    const uint32_t vb = __byte_perm(lds32(pb), lds32(pb + 8), f.sel);
    int8x4_to_bf16(va, a[4 * kk], a[4 * kk + 2]);
    int8x4_to_bf16(vb, a[4 * kk + 1], a[4 * kk + 3]);
  }
}

// One k-step of a consumer warpgroup: its A fragments, its four products,
// then a wait for them, which frees the stage.  No A register is written
// while a product of this warpgroup is in flight (ptxas would serialize
// every wgmma); the other warpgroup's products run meanwhile.
template <class T>
__device__ __forceinline__ void batch_step(float (&acc)[T::kAcc], const unsigned char* smem,
                                           uint64_t* full, uint64_t* empty, int kt,
                                           const Frag& f, int lane, uint32_t (&a)[16]) {
  const int st = kt % T::STAGES;
  const unsigned char* s = smem + st * T::kStage;
  ptdeco::mbar_wait(&full[st], (kt / T::STAGES) & 1);
  batch_frags(s + T::kABytes, f, a);
  ptdeco::wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rs_product<T::BN>(acc, a + 4 * kk, ptdeco::wgmma::desc(s + kk * 32, 16, 1024));
  ptdeco::wgmma::commit();
  ptdeco::wgmma::wait<0>();
  ptdeco::wgmma::fence_frag<16>(a);
  if (lane == 0) ptdeco::mbar_arrive(&empty[st]);
}

template <class T>
__global__ void __launch_bounds__(kBatThreads, 1)
    batch_kernel(const __grid_constant__ CUtensorMap lhs_map,
                 const CUtensorMap* __restrict__ weight_maps, const float* const* __restrict__ scales,
                 const int* __restrict__ group_sizes, int n_experts, bf16* __restrict__ out,
                 int m, int k, int n) {
  int e, r0, r1;
  if (!ptdeco::gmm::group_slot<T::BN>(static_cast<int>(blockIdx.x), group_sizes, n_experts, m,
                                      e, r0, r1)) {
    return;
  }
  const int n0 = static_cast<int>(blockIdx.y) * kBatCols;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (ptdeco::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kRing);
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
  const int n_k = (k + kBatK - 1) / kBatK;

  if (warp < 4) {
    // producer: one thread keeps the ring full; stage = [lhs box][weight box]
    ptdeco::wgmma::regs_dec<40>();
    if (warp == 0 && lane == 0) {
      const CUtensorMap* wmap = weight_maps + e;
      ptdeco::tensor_map_acquire(wmap);
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % T::STAGES, ph = (kt / T::STAGES) & 1;
        unsigned char* s = smem + st * T::kStage;
        ptdeco::mbar_wait(&empty[st], ph ^ 1);
        ptdeco::mbar_expect(&full[st], T::kStage);
        ptdeco::tma_box(s, &lhs_map, kt * kBatK, r0, &full[st]);
        ptdeco::tma_box(s + T::kABytes, wmap, kt * kBatK, n0, &full[st]);
      }
    }
    return;
  }

  ptdeco::wgmma::regs_inc<232>();
  const int wg = (warp >> 2) - 1, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
  // this lane's weight rows of the box: 64 wg + 16 wi + g and + 8
  const int ra = 64 * wg + 16 * wi + g, rb = ra + 8;
  const Frag frag(ra, t);
  uint32_t a[16];
  for (int kt = 0; kt < n_k; ++kt) batch_step<T>(acc, smem, full, empty, kt, frag, lane, a);
  ptdeco::wgmma::fence_acc<T::kAcc>(acc);

  // both warpgroups are done reading the ring: stage the scaled tile there
  // transposed, st[group row][weight row], then write it row by row
  consumer_sync(1, 256);
  bf16* st = reinterpret_cast<bf16*>(smem);
  const float* sc = scales[e];
  const float s_a = n0 + ra < n ? sc[n0 + ra] : 0.f;
  const float s_b = n0 + rb < n ? sc[n0 + rb] : 0.f;
#pragma unroll
  for (int q = 0; q < T::BN / 8; ++q) {
    const int c = q * 8 + 2 * t;
    st[c * T::kOutLd + ra] = __float2bfloat16_rn(acc[4 * q] * s_a);
    st[(c + 1) * T::kOutLd + ra] = __float2bfloat16_rn(acc[4 * q + 1] * s_a);
    st[c * T::kOutLd + rb] = __float2bfloat16_rn(acc[4 * q + 2] * s_b);
    st[(c + 1) * T::kOutLd + rb] = __float2bfloat16_rn(acc[4 * q + 3] * s_b);
  }
  consumer_sync(1, 256);
  const int store_rows = r1 - r0;  // the group's rows only: never the next expert's
  constexpr int kChunks = kBatCols / 8;  // 16-byte chunks of a staged row
  for (int i = tid - 128; i < store_rows * kChunks; i += 256) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (n0 + c < n)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * n + n0 + c) =
          *reinterpret_cast<const uint4*>(&st[r * T::kOutLd + c]);
  }
}

template <class T>
int launch_batch(const void* lhs, const void* weight_maps, const void* scales,
                 const void* group_sizes, int n_experts, void* out, int m, int k, int n,
                 cudaStream_t stream) {
  static unsigned opted_in = 0;  // once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(opted_in & (1u << dev))) {
    err = cudaFuncSetAttribute(batch_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) opted_in |= 1u << dev;
  }
  CUtensorMap lhs_map;
  const int rc = ptdeco::encode_rows(&lhs_map, lhs, m, k, T::BN);
  if (rc != 0) return rc;
  const dim3 grid((m + T::BN - 1) / T::BN + n_experts, (n + kBatCols - 1) / kBatCols);
  batch_kernel<T><<<grid, kBatThreads, T::kSmemBytes, stream>>>(
      lhs_map, static_cast<const CUtensorMap*>(weight_maps),
      static_cast<const float* const*>(scales), static_cast<const int*>(group_sizes),
      n_experts, static_cast<bf16*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The decode route.  lhs: (m, k) bf16; weights / scales: device arrays of
// n_experts pointers to (n, k) int8 grids and (n,) f32 scales;
// group_sizes: (n_experts,) int32 on the device; out: (m, n) bf16.  All
// contiguous, 16-byte aligned.  ks (1 to 8) CTAs split k, each
// steps_per_split stages of bk bytes (ks * steps_per_split * bk >= k), a
// CTA taking `cols` weight rows: cols and bk must be the tile's (64, 512),
// so that the caller's split is the kernel's.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (cudaErrorInvalidValue
// for what the route does not take).
extern "C" int ptdeco_gmm_int8_decode(const void* lhs, const void* weights, const void* scales,
                                      const void* group_sizes, int n_experts, void* out, int m,
                                      int k, int n, int ks, int steps_per_split, int cols,
                                      int bk, void* stream) {
  if (n_experts < 1 || ks < 1 || ks > kMaxSplit || steps_per_split < 0 ||
      cols != DecodeTile::COLS || bk != DecodeTile::BK ||
      static_cast<long long>(ks) * steps_per_split * bk < k)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_decode<DecodeTile>(lhs, weights, scales, group_sizes, n_experts, out, m, k, n,
                                   ks, steps_per_split, static_cast<cudaStream_t>(stream));
}

// The batch route's grid maps: into `maps`, a HOST buffer of n_experts
// CUtensorMaps (128 bytes each), the map of each (n, k) int8 grid at
// weight_ptrs[i] (a host array of device pointers), read in boxes of
// kBatCols rows x 64 bytes; a null pointer (an expert with no grid, which
// must have no rows) leaves its map zero.  The caller copies the buffer to
// a 64-byte aligned device table for ptdeco_gmm_int8_batch, once for a set
// of grids.  Returns a CUDA error code.
extern "C" int ptdeco_gmm_int8_encode_weights(const unsigned long long* weight_ptrs,
                                              int n_experts, int n, int k, void* maps) {
  if (n_experts < 1 || n_experts > kMaxExperts || k < 16 || k % 16 != 0 || n % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_experts; ++i) {
    CUtensorMap map = {};  // aligned here, then copied into the caller's buffer
    if (weight_ptrs[i] != 0) {
      const int rc = ptdeco::encode_int8_rows(
          &map, reinterpret_cast<const void*>(weight_ptrs[i]), n, k, kBatCols);
      if (rc != 0) return rc;
    }
    memcpy(static_cast<unsigned char*>(maps) + sizeof(CUtensorMap) * i, &map, sizeof(map));
  }
  return 0;
}

// The batch route.  lhs: (m, k) bf16; weight_maps: a DEVICE table of
// n_experts tensor maps, 64-byte aligned, from
// ptdeco_gmm_int8_encode_weights at these n and k; scales: a device array
// of n_experts pointers to (n,) f32 scales; group_sizes: (n_experts,)
// int32 on the device; out: (m, n) bf16.  All contiguous, 16-byte aligned,
// k a multiple of 16, n of 8, 1 <= n_experts <= kMaxExperts, bn (the
// tile's group rows) 128 or 256.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (cudaErrorInvalidValue for what the route
// does not take).
extern "C" int ptdeco_gmm_int8_batch(const void* lhs, const void* weight_maps,
                                     const void* scales, const void* group_sizes, int n_experts,
                                     void* out, int m, int k, int n, int bn, void* stream) {
  if (n_experts < 1 || n_experts > kMaxExperts || k < 16 || k % 16 != 0 || n % 8 != 0 ||
      reinterpret_cast<uintptr_t>(weight_maps) % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128:
      return launch_batch<Bat128>(lhs, weight_maps, scales, group_sizes, n_experts, out, m, k,
                                  n, s);
    case 256:
      return launch_batch<Bat256>(lhs, weight_maps, scales, group_sizes, n_experts, out, m, k,
                                  n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the most experts the batch route takes
extern "C" int ptdeco_gmm_int8_batch_max_experts() { return kMaxExperts; }
