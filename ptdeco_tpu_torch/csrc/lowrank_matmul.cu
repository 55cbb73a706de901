// Fused low-rank forward y = (x @ W1^T) @ W2^T + b of a decomposed site.
//
// Replaces: ptdeco_tpu/ops/lowrank_pallas.py:_kernel (via _lowrank_padded),
// the serving-path kernel that keeps the rank-r hidden on chip.
//
// Layout: W1 is the first factor's weight (r, d_in) and W2 the second's
// (d_out, r), as torch.nn.Linear stores them, so both products read their
// operands along the contraction axis.
//
// What bounds it on an H100: bytes.  The work is 2*n*r*(d_in + d_out)
// flops against (n*d_in + r*d_in + r*d_out + n*d_out)*2 bytes; at
// n = 1024, d_in = 2048, r = 256, d_out = 5632 that is ~4 GFLOP over
// ~19 MB, about 210 flops per byte, under the card's bf16 ridge of ~295,
// and at the served rank 32 about 30.  So the kernel has to fill the card
// with blocks that stream x, W1 and W2 at full width and write y once;
// the hidden never goes to device memory, which is the point of fusing.
// The products are small (a decode step is 4 rows), so what limits it in
// practice is latency: few, short steps between barriers.
//
// Design:
//   * grid = (cluster x column groups, row tiles); a thread-block cluster
//     of C <= 8 CTAs shares one row tile of BM rows (8, 16, 32 or 64) and
//     one column group; the wrapper picks the shape
//     (ops/lowrank.py:launch_shape) so that the grid runs in one wave at
//     two CTAs an SM;
//   * tiles of 64 contraction columns (128-byte rows, 128-byte swizzle)
//     arrive by TMA, one thread issuing a stage's boxes and an mbarrier
//     counting their bytes, zero-filled past every ragged edge; where a
//     row pitch is not a multiple of 16 bytes (TMA cannot address it) they
//     arrive by cp.async (4-byte or scalar copies) into the same layout;
//   * phase 1: each CTA of the cluster takes 1/C of the contraction over
//     d_in and computes an f32 partial of the hidden, 128 hidden columns
//     (a chunk) at a time, x and W1 tiles streaming through a 3-stage
//     ring, ldmatrix fragments, mma.sync m16n8k16 in 8 warps (a BM = 8
//     tile repeats its rows in the upper half of the 16-row fragment);
//   * the exchange, through distributed shared memory: CTA q sums rows
//     q * BM / C .. of all C partials in rank order and rounds them once
//     to bf16 (x's dtype, as the TPU kernel and lowrank_xla do), then every
//     CTA gathers the other rows, so all hold one bit-identical hidden in
//     shared memory;
//   * phase 2: each warp takes 16-column units of its CTA's share of the
//     output (cols_per_cta columns) and streams their W2 rows through its
//     own 3-stage ring (its lane 0 issuing the boxes), with no block-wide
//     barrier; the hidden's zero columns past r are skipped;
//   * epilogue: bias added in f32, one rounding to bf16, the unit staged in
//     shared memory and written as 16-byte row stores;
//   * r is any value >= 1, padded to a multiple of 64 in shared memory.
//     The hidden takes BM * (r_pad + 8) * 2 bytes; the wrapper halves the
//     row tile for a large r and raises above the rank that fits at
//     BM = 8 (10944), it never falls back.
// Not yet done (later work): wgmma for the 64-row tiles; a persistent grid.
//
// f32 (lowrank_f32_kernel, ptdeco_lowrank_matmul_f32): the same Pallas
// kernel on f32 operands, an f32 model's fused pairs (bench.py's MLP, the
// ConvNeXt and Swin walks); the hidden stays f32, as lowrank_xla keeps it
// for an f32 x.  What bounds it: bytes at a small rank (n 256, 2048 -> 32
// -> 2048 moves 4.5 MB, 1.4 us at 3.35 TB/s), operations at a large one.
// Exact f32 on the CUDA cores peaks at 67 TFLOP/s; the tensor cores take
// no f32 operand, but give 495 TFLOP/s in TF32, so the products are 3xTF32:
// each operand a = hi + lo (hi rounded to TF32 as cvt.rna does, lo the
// rest, truncated to TF32 by the tensor cores; split in registers after
// the fragment load, so shared memory holds each operand once) and
// a * b ~ hi*hi + hi*lo + lo*hi, mma.sync m16n8k8, each product within
// about 2^-20 of |a b| (one-pass TF32 is ~2^-11).  The tensor cores
// truncate as they add, so their accumulator is drained into an f32 sum
// rounded to nearest after every 32-deep step.  Design, as the bf16 path:
//   * grid = (row tiles, cluster x column groups); a cluster of C <= 8
//     CTAs (along y) shares one row tile of BM = 16, 32 or 64 rows and
//     splits the d_in contraction; ops/lowrank.py:launch_shape_f32 picks
//     the shape so that the grid fills the card's 132 SMs in about one
//     wave, column groups only where SMs would be idle;
//   * phase 1: tiles of 32 contraction columns (128-byte rows, 128-byte
//     swizzle) by TMA, or by cp.async where a row pitch is not a multiple
//     of 16 bytes, through a 3-stage ring; each CTA computes the f32
//     partial of its share, 128 hidden columns (a chunk) at a time, its 8
//     warps split as 16 hidden columns x 16-row tiles x k slices (a narrow
//     rank splits k too, so every warp works);
//   * the exchange, through distributed shared memory: CTA q sums rows
//     q * BM / C .. of all partials in rank order (no atomics: the same
//     bits every run), then every CTA gathers the other rows, so all hold
//     one bit-identical f32 hidden: phase 1 runs once a row tile and W1 is
//     streamed once a row tile, split across the cluster;
//   * phase 2: each warp takes 16-column units of its CTA's share of the
//     output and streams their W2 rows through its own 3-stage ring; the
//     bias is added in f32 and the tile stored from the fragments;
//   * the hidden takes BM * (r padded to 32, + 4) * 4 bytes, so ranks up
//     to 2592 at BM = 16 (ops.lowrank.MAX_RANK_F32).
// Not yet done for f32 (PERF.md, ROADMAP Queue 2 item 1): it still loses to
// cuBLAS at wide ranks with many row tiles, where every row tile streams
// the weights again through L2 (a cluster over row tiles could multicast
// them) and each warp splits its fragments again (wgmma would take
// operand tiles split once in shared memory).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // 8 warps
constexpr int kNT = 128;           // hidden columns per chunk, output columns per tile
constexpr int kBK = 64;            // contraction per pipeline step: one 128-byte row
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int rank_pad(int r) { return (r + kBK - 1) / kBK * kBK; }

// row of the f32 partial: one hidden chunk (at most kNT columns) + 4
__host__ __device__ constexpr int part_ld(int r) {
  return (rank_pad(r) < kNT ? rank_pad(r) : kNT) + 4;
}

// phase 2 reuses the ring: each warp's own ring of kStages 16-row W2
// tiles, then each warp's bf16 output staging of bm x 16 (+ 8)
constexpr int kUnit = 16;  // output columns a warp takes at a time
constexpr int kWarpRing = kStages * kUnit * kBK;
constexpr int kBarriers = kStages + 8 * kStages;  // phase 1's, then each warp's
__host__ __device__ constexpr int ring_elems(int bm) { return kStages * (bm + kNT) * kBK; }

__host__ __device__ constexpr size_t smem_bytes(int bm, int r) {
  return static_cast<size_t>(ring_elems(bm)) * 2 +
         static_cast<size_t>(bm) * (rank_pad(r) + 8) * 2 +
         static_cast<size_t>(bm) * part_ld(r) * 4 + kBarriers * 8;
}

// kTma: tiles by TMA from the three tensor maps (every row pitch a
// multiple of 16 bytes), else by cp.async; both write the swz64 layout
template <int BM, bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
    lowrank_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w1_map,
                   const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ bias, bf16* __restrict__ out, int n, int d_in, int r,
                   int d_out, int cols_per_cta, int vec_in, int vec_r, int vec_out) {
  // phase 1: 8 warps as WM x WN over a BM x kNT tile of the hidden
  constexpr int WM = BM >= 16 ? BM / 16 : 1;
  constexpr int WN = 8 / WM;
  constexpr int WCOLS = kNT / WN;
  constexpr int NTILES = WCOLS / 8;
  constexpr int RM = BM < 16 ? BM : 16;  // distinct rows in a 16-row fragment
  // phase 2: each warp all BM rows x kUnit columns, as MT 16-row tiles
  constexpr int MT = BM >= 16 ? BM / 16 : 1;
  constexpr int SLD = kUnit + 8;  // row of a warp's output staging
  static_assert(8 * (kWarpRing + BM * SLD) <= ring_elems(BM), "phase 2 fits the ring");

  // tiles start on 1 KB boundaries, as the swizzle of TMA needs
  extern __shared__ __align__(1024) unsigned char smem[];
  const int r_pad = rank_pad(r), hld = r_pad + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem);              // [kStages][BM + kNT][kBK]
  bf16* hid = ring + ring_elems(BM);                       // [BM][hld]
  const int pld = part_ld(r);
  float* part = reinterpret_cast<float*>(hid + BM * hld);  // [BM][pld]
  uint64_t* bars = reinterpret_cast<uint64_t*>(part + BM * pld);  // [kBarriers]

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * BM;
  const int col_begin = blockIdx.x * cols_per_cta;
  const int col_end = min(d_out, col_begin + cols_per_cta);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;

  if (kTma) {
    if (tid == 0) {
      for (int i = 0; i < kBarriers; ++i) ptdeco::mbar_init(&bars[i]);
      ptdeco::fence_barrier_init();
    }
    __syncthreads();
  }

  // ---- phase 1: the hidden, 128 columns (a chunk) at a time ----------
  // this CTA's share of the contraction: k steps [my_k0, my_k0 + my_ks)
  const int k_steps = max(1, (d_in + kBK - 1) / kBK);
  const int my_k0 = crank * k_steps / csize;
  const int my_ks = (crank + 1) * k_steps / csize - my_k0;
  const int chunks = (r_pad + kNT - 1) / kNT;
  const int p1 = chunks * my_ks;
  // hidden columns of chunk c: a multiple of 64, so each warp's columns
  // lie all inside or all outside it
  auto chunk_width = [&](int c) { return min(kNT, r_pad - c * kNT); };
  const int wm = warp / WN, wn = warp % WN;

  auto load_step = [&](int chunk, int kb, int stage) {
    bf16* a = ring + stage * (BM + kNT) * kBK;
    const int k = (my_k0 + kb) * kBK, w = chunk_width(chunk);
    if (kTma) {
      if (tid == 0) {
        ptdeco::mbar_expect(&bars[stage], (BM + w) * kBK * 2);
        ptdeco::tma_box(a, &x_map, k, row0, &bars[stage]);
        for (int h = 0; h < w; h += 64)
          ptdeco::tma_box(a + (BM + h) * kBK, &w1_map, k, chunk * kNT + h, &bars[stage]);
      }
    } else {
      ptdeco::load_block<BM, kThreads>(tid, a, x, d_in, row0, n, k, d_in, vec_in);
      ptdeco::load_block<kNT, kThreads>(tid, a + BM * kBK, w1, d_in, chunk * kNT, r, k, d_in,
                                        vec_in, w);
    }
  };

  float acc[NTILES][4];
#pragma unroll
  for (int j = 0; j < NTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // the cluster's f32 partials of hidden chunk `chunk` -> the bf16 hidden
  // in every CTA, bit-identical (each row is summed and rounded by one CTA)
  auto exchange = [&](int chunk) {
    const int w = chunk_width(chunk);
    if (wn * WCOLS < w) {
#pragma unroll
      for (int j = 0; j < NTILES; ++j) {
        const int c = wn * WCOLS + j * 8 + 2 * t4, m = wm * 16 + g8;
        *reinterpret_cast<float2*>(&part[m * pld + c]) = make_float2(acc[j][0], acc[j][1]);
        if (BM >= 16)
          *reinterpret_cast<float2*>(&part[(m + 8) * pld + c]) =
              make_float2(acc[j][2], acc[j][3]);
      }
    }
    cluster.sync();
    // reduce-scatter: this CTA sums its BM / C rows of all C partials, in
    // rank order, and rounds them once into its hidden
    const int own = BM / csize, w4 = w / 4;
    for (int e = tid; e < own * w4; e += kThreads) {
      const int m = crank * own + e / w4, c = (e % w4) * 4;
      float4 v[kMaxCluster];  // all remote loads in flight before the sum
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < csize)
          v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) +
                                                  m * pld + c);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < csize) {
          sum.x += v[q].x;
          sum.y += v[q].y;
          sum.z += v[q].z;
          sum.w += v[q].w;
        }
      *reinterpret_cast<uint2*>(&hid[m * hld + chunk * kNT + c]) = make_uint2(
          ptdeco::pack_f32_as_bf16(sum.x, sum.y), ptdeco::pack_f32_as_bf16(sum.z, sum.w));
    }
    cluster.sync();  // partials read; every CTA's rows rounded
    // all-gather: the other CTAs' rows of this chunk, 16 bytes at a time
    const int w8 = w / 8;
    for (int e = tid; e < BM * w8; e += kThreads) {
      const int m = e / w8, q = m / own;
      if (q == crank) continue;
      const int off = m * hld + chunk * kNT + (e % w8) * 8;
      *reinterpret_cast<uint4*>(&hid[off]) =
          *reinterpret_cast<const uint4*>(cluster.map_shared_rank(hid, q) + off);
    }
  };

  {
    int l_chunk = 0, l_kb = 0, l_n = 0;  // the next step to load, counted
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (l_n < p1) {
        load_step(l_chunk, l_kb, l_n % kStages);
        if (++l_kb == my_ks) l_kb = 0, ++l_chunk;
        ++l_n;
      }
      if (!kTma) ptdeco::async_commit();
    }
    int chunk = 0, kb = 0;
    for (int s = 0; s < p1; ++s) {
      if (kTma)
        ptdeco::mbar_wait(&bars[s % kStages], (s / kStages) & 1);
      else
        ptdeco::async_wait<kStages - 2>();
      __syncthreads();  // step s landed; every warp is done with the stage loaded next
      if (l_n < p1) {
        load_step(l_chunk, l_kb, l_n % kStages);
        if (++l_kb == my_ks) l_kb = 0, ++l_chunk;
        ++l_n;
      }
      if (!kTma) ptdeco::async_commit();
      const bf16* a = ring + (s % kStages) * (BM + kNT) * kBK;
      if (wn * WCOLS < chunk_width(chunk)) {
        // acc += x tile (BM x 64) @ W1 tile^T (kNT x 64)
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t af[4];
          const int ra = wm * 16 + ((lane & 15) & (RM - 1));
          ptdeco::ldmatrix_x4(af, a + ptdeco::swz64(ra, kk + (lane >> 4) * 8));
#pragma unroll
          for (int p = 0; p < NTILES / 2; ++p) {
            uint32_t bq[4];
            const int rb = BM + wn * WCOLS + p * 16 + (lane & 7) + (lane >> 4) * 8;
            ptdeco::ldmatrix_x4(bq, a + ptdeco::swz64(rb, kk + ((lane >> 3) & 1) * 8));
            ptdeco::mma_16816(acc[2 * p], af, bq);
            ptdeco::mma_16816(acc[2 * p + 1], af, bq + 2);
          }
        }
      }
      if (++kb == my_ks) {
        exchange(chunk);
#pragma unroll
        for (int j = 0; j < NTILES; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        kb = 0;
        ++chunk;
      }
    }
    if (!kTma) ptdeco::async_wait<0>();
    __syncthreads();  // the gathered hidden is visible; the ring is free
  }

  // ---- phase 2: y = hidden @ W2^T + b, warp by warp -------------------
  // warp w takes the 16-column units w, w + 8, ... of this CTA's columns
  // and streams their W2 rows through its own ring: no block barrier
  bf16* wring = ring + warp * kWarpRing;                          // [kStages][16][kBK]
  bf16* wst = ring + 8 * kWarpRing + warp * BM * SLD;             // [BM][SLD]
  uint64_t* wbars = bars + kStages + warp * kStages;              // [kStages]
  const int ks2 = r_pad / kBK, r16 = (r + 15) / 16 * 16;
  const int units = (max(0, col_end - col_begin) + kUnit - 1) / kUnit;
  const int wsteps = units > warp ? (units - warp + 7) / 8 * ks2 : 0;

  float o[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;

  auto wload = [&](int unit, int kb, int stage) {
    bf16* dst = wring + stage * kUnit * kBK;
    if (kTma) {
      if (lane == 0) {
        ptdeco::mbar_expect(&wbars[stage], kUnit * kBK * 2);
        ptdeco::tma_box(dst, &w2_map, kb * kBK, col_begin + unit * kUnit, &wbars[stage]);
      }
    } else {
      ptdeco::load_block<kUnit, 32>(lane, dst, w2, r, col_begin + unit * kUnit, col_end,
                                    kb * kBK, r, vec_r);
    }
  };

  // write unit `unit`: bias in f32, one rounding, 16-byte row stores
  auto store_unit = [&](int unit) {
    const int c0 = col_begin + unit * kUnit;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = j * 8 + 2 * t4;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (c0 + c < col_end) b0 = __bfloat162float(bias[c0 + c]);
        if (c0 + c + 1 < col_end) b1 = __bfloat162float(bias[c0 + c + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 16 + g8;
        *reinterpret_cast<uint32_t*>(&wst[m * SLD + c]) =
            ptdeco::pack_f32_as_bf16(o[mt][j][0] + b0, o[mt][j][1] + b1);
        if (BM >= 16)
          *reinterpret_cast<uint32_t*>(&wst[(m + 8) * SLD + c]) =
              ptdeco::pack_f32_as_bf16(o[mt][j][2] + b0, o[mt][j][3] + b1);
      }
    }
    __syncwarp();
    const int width = min(kUnit, col_end - c0);
    if (vec_out) {
#pragma unroll
      for (int i = 0; i < (BM * 2 + 31) / 32; ++i) {
        const int e = lane + 32 * i, m = e >> 1, c = (e & 1) * 8;
        if (e < BM * 2 && row0 + m < n && c < width)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + m) * d_out + c0 + c) =
              *reinterpret_cast<const uint4*>(&wst[m * SLD + c]);
      }
    } else {
      for (int e = lane; e < BM * width; e += 32) {
        const int m = e / width, c = e % width;
        if (row0 + m < n) out[static_cast<size_t>(row0 + m) * d_out + c0 + c] = wst[m * SLD + c];
      }
    }
    __syncwarp();
  };

  int l_unit = warp, l_kb = 0, l_n = 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (l_n < wsteps) {
      wload(l_unit, l_kb, l_n % kStages);
      if (++l_kb == ks2) l_kb = 0, l_unit += 8;
      ++l_n;
    }
    if (!kTma) ptdeco::async_commit();
  }
  int unit = warp, kb = 0;
  for (int t = 0; t < wsteps; ++t) {
    if (kTma)
      ptdeco::mbar_wait(&wbars[t % kStages], (t / kStages) & 1);
    else
      ptdeco::async_wait<kStages - 2>();
    __syncwarp();  // step t landed for every lane; step t - 1's stage is free
    if (l_n < wsteps) {
      wload(l_unit, l_kb, l_n % kStages);
      if (++l_kb == ks2) l_kb = 0, l_unit += 8;
      ++l_n;
    }
    if (!kTma) ptdeco::async_commit();
    const bf16* b = wring + (t % kStages) * kUnit * kBK;
    const int kmax = r16 - kb * kBK;  // the hidden's zero columns past r are skipped
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      if (kk >= kmax) break;
      uint32_t bq[4];
      const int rb = (lane & 7) + (lane >> 4) * 8;
      ptdeco::ldmatrix_x4(bq, b + ptdeco::swz64(rb, kk + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ptdeco::ldmatrix_x4(af, hid + (mt * 16 + ((lane & 15) & (RM - 1))) * hld + kb * kBK +
                                    kk + (lane >> 4) * 8);
        ptdeco::mma_16816(o[mt][0], af, bq);
        ptdeco::mma_16816(o[mt][1], af, bq + 2);
      }
    }
    if (++kb == ks2) {
      store_unit(unit);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
      kb = 0;
      unit += 8;
    }
  }
  if (!kTma) ptdeco::async_wait<0>();
  cluster.sync();  // no CTA leaves while another may read its hidden
}

// Opt the kernel in to the block maximum of shared memory, once per device,
// so that a launch (or a CUDA graph capture) makes no attribute call.
template <int BM, bool kTma>
cudaError_t opt_in() {
  static unsigned opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (opted_in & (1u << dev)))) return err;
  err = cudaFuncSetAttribute(lowrank_kernel<BM, kTma>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < 32) opted_in |= 1u << dev;
  return err;
}

cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, cudaStream_t stream, dim3 cluster,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster.x;
  attr->val.clusterDim.y = cluster.y;
  attr->val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BM>
int launch(const bf16* x, const bf16* w1, const bf16* w2, const bf16* bias, bf16* out,
           int n, int d_in, int r, int d_out, int cluster, int groups, int cols_per_cta,
           int vec_in, int vec_r, int vec_out, cudaStream_t stream) {
  // TMA takes every matrix whose row pitch is a multiple of 16 bytes
  const bool tma = vec_in == 8 && vec_r == 8 && d_in > 0;
  cudaError_t err = tma ? opt_in<BM, true>() : opt_in<BM, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap x_map = {}, w1_map = {}, w2_map = {};
  if (tma) {
    int rc = ptdeco::encode_rows(&x_map, x, n, d_in, BM);
    if (rc == 0) rc = ptdeco::encode_rows(&w1_map, w1, r, d_in, 64);
    if (rc == 0) rc = ptdeco::encode_rows(&w2_map, w2, d_out, r, kUnit);
    if (rc != 0) return rc;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cluster * groups, (n + BM - 1) / BM, 1),
                                                smem_bytes(BM, r), stream, dim3(cluster, 1, 1),
                                                &attr);
  err = cudaLaunchKernelEx(&cfg, tma ? lowrank_kernel<BM, true> : lowrank_kernel<BM, false>,
                           x_map, w1_map, w2_map, x, w1, w2, bias, out, n, d_in, r, d_out,
                           cols_per_cta, vec_in, vec_r, vec_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` CTAs of `BM` rows at rank r that fit on the card
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
template <int BM>
int max_clusters(int r, int cluster) {
  cudaError_t err = opt_in<BM, true>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(cluster, 1, 1), smem_bytes(BM, r), nullptr, dim3(cluster, 1, 1), &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, lowrank_kernel<BM, true>, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}

// Copy width in elements for a row-major bf16 matrix of row pitch ld.
int copy_width(const void* p, int ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (ld % 8 == 0 && a % 16 == 0) return 8;
  if (ld % 2 == 0 && a % 4 == 0) return 2;
  return 1;
}

// ---- the f32 path (see the note at the top) -------------------------------
constexpr int kFK = 32;              // contraction per step: one 128-byte row of f32
constexpr int kFNT = 128;            // hidden columns per chunk (phase 1)
constexpr int kFUnit = 16;           // output columns a warp takes at a time (phase 2)
constexpr int kFPartLd = kFNT + 16;  // a row of the partials: WK slices of w + 4 floats

__host__ __device__ constexpr int f32_rank_pad(int r) { return (r + kFK - 1) / kFK * kFK; }

// W1 rows a phase-1 stage holds: one hidden chunk
__host__ __device__ constexpr int f32_w1_rows(int r) {
  return f32_rank_pad(r) < kFNT ? f32_rank_pad(r) : kFNT;
}

// 32-float rows of one ring stage: phase 1's x and W1 tiles, or phase 2's
// eight warps' 16-row W2 tiles
__host__ __device__ constexpr int f32_stage_rows(int bm, int r) {
  return bm + f32_w1_rows(r) > 8 * kFUnit ? bm + f32_w1_rows(r) : 8 * kFUnit;
}

// the ring, the f32 hidden (bm x (r padded to 32, + 4)), the partials
// (bm x kFPartLd) and the mbarriers
__host__ __device__ constexpr size_t f32_smem_bytes(int bm, int r) {
  return (static_cast<size_t>(kStages) * f32_stage_rows(bm, r) * kFK +
          static_cast<size_t>(bm) * (f32_rank_pad(r) + 4) + static_cast<size_t>(bm) * kFPartLd) *
             4 +
         kBarriers * 8;
}

// Offset of f32 element (r, c) of a tile of 32-float (128-byte) rows with
// TMA's 128-byte swizzle: chunk c / 4 of row r lands at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// Rows [row0, row0 + rows) x columns [col0, col0 + 32) of a row-major f32
// matrix of row pitch ld (row_lim rows, col_lim columns) into a swz32 tile,
// zero outside the matrix: the cp.async path for a matrix TMA cannot
// address.  vec4: 16-byte copies (ld and col_lim multiples of 4, base
// 16-byte aligned), else 4-byte ones.
template <int Threads>
__device__ __forceinline__ void f32_load_block(int tid, float* dst, const float* src, int ld,
                                               int row0, int row_lim, int col0, int col_lim,
                                               int vec4, int rows) {
  if (vec4) {
    for (int e = tid; e < rows * 8; e += Threads) {
      const int i = e >> 3, c = (e & 7) * 4;
      const bool ok = row0 + i < row_lim && col0 + c < col_lim;
      ptdeco::cp_async16_zfill(dst + swz32(i, c),
                               ok ? src + static_cast<size_t>(row0 + i) * ld + col0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < rows * 32; e += Threads) {
      const int i = e >> 5, c = e & 31;
      const bool ok = row0 + i < row_lim && col0 + c < col_lim;
      ptdeco::cp_async4_zfill(dst + swz32(i, c),
                              ok ? src + static_cast<size_t>(row0 + i) * ld + col0 + c : src, ok);
    }
  }
}

// f32 a -> (hi, lo) with a = hi + lo exactly: hi is a rounded to TF32 to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds every finite
// value, but by two integer operations (half a TF32 ulp added to the
// magnitude's bits, the 13 dropped bits cleared): cvt is a conversion, at
// a quarter of the integer rate.  lo = a - hi goes to the tensor cores as
// it is; they read a TF32 operand's top 19 bits, so lo is truncated there
// (within 2^-10 of |lo| <= 2^-11 |a|), and a NaN in a stays a NaN in lo.
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& hi, uint32_t& lo) {
  hi = (a + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(a) - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&a)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(a[i], hi[i], lo[i]);
}

// c += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g);
// c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32 for one 16-row tile and two 8-column tiles: the
// small products first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[2][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[4],
                                           const uint32_t (&bl)[4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mma_tf32(c[j], al, bh + 2 * j);
    mma_tf32(c[j], ah, bl + 2 * j);
    mma_tf32(c[j], ah, bh + 2 * j);
  }
}

// tot += acc; acc = 0: the tensor cores' accumulator is drained into an
// f32 sum rounded to nearest after every 32-wide step, so their
// truncation as they add stays inside one step
template <int M>
__device__ __forceinline__ void drain(float (&tot)[M][2][4], float (&acc)[M][2][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[m][j][e] += acc[m][j][e];
        acc[m][j][e] = 0.f;
      }
}

template <int M>
__device__ __forceinline__ void zero(float (&a)[M][2][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[m][j][e] = 0.f;
}

template <int BM, bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
    lowrank_f32_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w1_map,
                       const __grid_constant__ CUtensorMap w2_map, const float* __restrict__ x,
                       const float* __restrict__ w1, const float* __restrict__ w2,
                       const float* __restrict__ bias, float* __restrict__ out, int n, int d_in,
                       int r, int d_out, int cols_per_cta, int vec_in, int vec_r, int vec_out) {
  constexpr int MT = BM / 16;  // 16-row tiles in the row tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const int r_pad = f32_rank_pad(r), hld = r_pad + 4;
  const int w1_rows = f32_w1_rows(r), stage = f32_stage_rows(BM, r) * kFK;
  float* ring = reinterpret_cast<float*>(smem);  // [kStages][stage rows][kFK]
  float* hid = ring + kStages * stage;           // [BM][hld]
  float* part = hid + BM * hld;                  // [WK][BM][w + 4]
  uint64_t* bars = reinterpret_cast<uint64_t*>(part + BM * kFPartLd);  // [kBarriers]

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.x * BM;
  const int col_begin = blockIdx.y * cols_per_cta;
  const int col_end = min(d_out, col_begin + cols_per_cta);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;

  if (kTma) {
    if (tid == 0) {
      for (int i = 0; i < kBarriers; ++i) ptdeco::mbar_init(&bars[i]);
      ptdeco::fence_barrier_init();
    }
    __syncthreads();
  }

  // ---- phase 1: this CTA's partial of the hidden, a chunk at a time -----
  // its share of the contraction: k steps [my_k0, my_k0 + my_ks)
  const int k_steps = max(1, (d_in + kFK - 1) / kFK);
  const int my_k0 = crank * k_steps / csize;
  const int my_ks = (crank + 1) * k_steps / csize - my_k0;
  const int chunks = (r_pad + kFNT - 1) / kFNT;
  const int p1 = chunks * my_ks;

  auto load_step = [&](int chunk, int kb, int st) {
    float* a = ring + st * stage;
    const int k = (my_k0 + kb) * kFK;
    if (kTma) {
      if (tid == 0) {
        ptdeco::mbar_expect(&bars[st], (BM + w1_rows) * kFK * 4);
        ptdeco::tma_box(a, &x_map, k, row0, &bars[st]);
        ptdeco::tma_box(a + BM * kFK, &w1_map, k, chunk * kFNT, &bars[st]);
      }
    } else {
      f32_load_block<kThreads>(tid, a, x, d_in, row0, n, k, d_in, vec_in, BM);
      f32_load_block<kThreads>(tid, a + BM * kFK, w1, d_in, chunk * kFNT, r, k, d_in, vec_in,
                               w1_rows);
    }
  };

  // Warps of a chunk w columns wide: WN of 16 hidden columns, by WM of
  // 16 * mts rows, by WK that split each step's four 8-deep k slices
  int WN = 0, WM = 0, WK = 0, mts = 0, wn = 0, wm = 0, wk = 0;
  auto layout = [&](int w) {
    WN = w / 16;
    WM = min(MT, 8 / WN);
    WK = 8 / (WN * WM);
    mts = MT / WM;
    wn = warp % WN;
    wm = (warp / WN) % WM;
    wk = warp / (WN * WM);
  };
  auto chunk_width = [&](int c) { return min(kFNT, r_pad - c * kFNT); };

  float acc[MT][2][4], tot[MT][2][4];
  zero(acc);
  zero(tot);

  // the cluster's partials of hidden chunk `chunk` -> the f32 hidden in
  // every CTA, bit-identical (each row is summed by one CTA, in rank order)
  auto exchange = [&](int chunk) {
    const int w = chunk_width(chunk), pld = w + 4;
    if (wk < WK) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= mts) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = wn * 16 + j * 8 + 2 * t4, m = (wm * mts + mt) * 16 + g8;
          float* p = part + wk * BM * pld;
          *reinterpret_cast<float2*>(&p[m * pld + c]) = make_float2(tot[mt][j][0], tot[mt][j][1]);
          *reinterpret_cast<float2*>(&p[(m + 8) * pld + c]) =
              make_float2(tot[mt][j][2], tot[mt][j][3]);
        }
      }
    }
    cluster.sync();
    // reduce-scatter: this CTA sums its BM / C rows of all C x WK partials
    const int own = BM / csize, w4 = w / 4;
    for (int e = tid; e < own * w4; e += kThreads) {
      const int m = crank * own + e / w4, c = (e % w4) * 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < WK; ++s) {
        float4 v[kMaxCluster];  // all remote loads in flight before the sum
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < csize)
            v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) +
                                                    (s * BM + m) * pld + c);
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < csize) {
            sum.x += v[q].x;
            sum.y += v[q].y;
            sum.z += v[q].z;
            sum.w += v[q].w;
          }
      }
      *reinterpret_cast<float4*>(&hid[m * hld + chunk * kFNT + c]) = sum;
    }
    cluster.sync();  // partials read; every CTA's rows summed
    // all-gather: the other CTAs' rows of this chunk, 16 bytes at a time
    for (int e = tid; e < BM * w4; e += kThreads) {
      const int m = e / w4, q = m / own;
      if (q == crank) continue;
      const int off = m * hld + chunk * kFNT + (e % w4) * 4;
      *reinterpret_cast<float4*>(&hid[off]) =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(hid, q) + off);
    }
    zero(tot);
  };

  {
    int l_chunk = 0, l_kb = 0, l_n = 0;  // the next step to load, counted
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (l_n < p1) {
        load_step(l_chunk, l_kb, l_n % kStages);
        if (++l_kb == my_ks) l_kb = 0, ++l_chunk;
        ++l_n;
      }
      if (!kTma) ptdeco::async_commit();
    }
    int chunk = 0, kb = 0;
    layout(chunk_width(0));
    for (int s = 0; s < p1; ++s) {
      if (kTma)
        ptdeco::mbar_wait(&bars[s % kStages], (s / kStages) & 1);
      else
        ptdeco::async_wait<kStages - 2>();
      __syncthreads();  // step s landed; every warp is done with the stage loaded next
      if (l_n < p1) {
        load_step(l_chunk, l_kb, l_n % kStages);
        if (++l_kb == my_ks) l_kb = 0, ++l_chunk;
        ++l_n;
      }
      if (!kTma) ptdeco::async_commit();
      const float* a = ring + (s % kStages) * stage;
      if (wk < WK) {
        for (int kk = wk; kk < kFK / 8; kk += WK) {
          // B: the warp's 16 hidden columns (W1 rows) x 8 of k, two 8-column tiles
          uint32_t bq[4], bh[4], bl[4];
          ptdeco::ldmatrix_x4(
              bq, a + swz32(BM + wn * 16 + (lane & 7) + (lane >> 4) * 8,
                            kk * 8 + ((lane >> 3) & 1) * 4));
          split_tf32(bq, bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt >= mts) break;
            uint32_t af[4], ah[4], al[4];
            ptdeco::ldmatrix_x4(
                af, a + swz32((wm * mts + mt) * 16 + (lane & 15), kk * 8 + (lane >> 4) * 4));
            split_tf32(af, ah, al);
            mma_3xtf32(acc[mt], ah, al, bh, bl);
          }
        }
      }
      drain(tot, acc);
      if (++kb == my_ks) {
        exchange(chunk);
        kb = 0;
        if (++chunk < chunks) layout(chunk_width(chunk));
      }
    }
    if (!kTma) ptdeco::async_wait<0>();
    __syncthreads();  // the gathered hidden is visible; the ring is free
  }

  // ---- phase 2: y = hidden @ W2^T + b, warp by warp -------------------
  // warp w takes the 16-column units w, w + 8, ... of this CTA's columns
  // and streams their W2 rows through its own ring: no block barrier
  float* wring = ring + warp * kStages * kFUnit * kFK;  // [kStages][16][kFK]
  uint64_t* wbars = bars + kStages + warp * kStages;     // [kStages]
  const int ks2 = r_pad / kFK, k8s = (r + 7) / 8;
  const int units = (max(0, col_end - col_begin) + kFUnit - 1) / kFUnit;
  const int wsteps = units > warp ? (units - warp + 7) / 8 * ks2 : 0;

  float o[MT][2][4], ot[MT][2][4];
  zero(o);
  zero(ot);

  auto wload = [&](int unit, int kb, int st) {
    float* dst = wring + st * kFUnit * kFK;
    if (kTma) {
      if (lane == 0) {
        ptdeco::mbar_expect(&wbars[st], kFUnit * kFK * 4);
        ptdeco::tma_box(dst, &w2_map, kb * kFK, col_begin + unit * kFUnit, &wbars[st]);
      }
    } else {
      f32_load_block<32>(lane, dst, w2, r, col_begin + unit * kFUnit, col_end, kb * kFK, r, vec_r,
                         kFUnit);
    }
  };

  // write unit `unit`: bias added in f32, 8-byte stores where d_out is even
  auto store_unit = [&](int unit) {
    const int c0 = col_begin + unit * kFUnit;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + j * 8 + 2 * t4;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (c < col_end) b0 = bias[c];
        if (c + 1 < col_end) b1 = bias[c + 1];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + mt * 16 + g8 + 8 * h;
          if (m >= n) continue;
          const float v0 = ot[mt][j][2 * h] + b0, v1 = ot[mt][j][2 * h + 1] + b1;
          float* p = out + static_cast<size_t>(m) * d_out + c;
          if (vec_out && c + 1 < col_end) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (c < col_end) p[0] = v0;
            if (c + 1 < col_end) p[1] = v1;
          }
        }
    }
  };

  int l_unit = warp, l_kb = 0, l_n = 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (l_n < wsteps) {
      wload(l_unit, l_kb, l_n % kStages);
      if (++l_kb == ks2) l_kb = 0, l_unit += 8;
      ++l_n;
    }
    if (!kTma) ptdeco::async_commit();
  }
  int unit = warp, kb = 0;
  for (int t = 0; t < wsteps; ++t) {
    if (kTma)
      ptdeco::mbar_wait(&wbars[t % kStages], (t / kStages) & 1);
    else
      ptdeco::async_wait<kStages - 2>();
    __syncwarp();  // step t landed for every lane; step t - 1's stage is free
    if (l_n < wsteps) {
      wload(l_unit, l_kb, l_n % kStages);
      if (++l_kb == ks2) l_kb = 0, l_unit += 8;
      ++l_n;
    }
    if (!kTma) ptdeco::async_commit();
    const float* b = wring + (t % kStages) * kFUnit * kFK;
#pragma unroll
    for (int kk = 0; kk < kFK / 8; ++kk) {
      if (kb * (kFK / 8) + kk >= k8s) break;  // the hidden's zero columns past r
      uint32_t bq[4], bh[4], bl[4];
      ptdeco::ldmatrix_x4(bq, b + swz32((lane & 7) + (lane >> 4) * 8,
                                        kk * 8 + ((lane >> 3) & 1) * 4));
      split_tf32(bq, bh, bl);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4], ah[4], al[4];
        ptdeco::ldmatrix_x4(af, hid + (mt * 16 + (lane & 15)) * hld + kb * kFK + kk * 8 +
                                    (lane >> 4) * 4);
        split_tf32(af, ah, al);
        mma_3xtf32(o[mt], ah, al, bh, bl);
      }
    }
    drain(ot, o);
    if (++kb == ks2) {
      store_unit(unit);
      zero(ot);
      kb = 0;
      unit += 8;
    }
  }
  if (!kTma) ptdeco::async_wait<0>();
  cluster.sync();  // no CTA leaves while another may read its hidden
}

template <int BM, bool kTma>
cudaError_t f32_opt_in() {
  static unsigned opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (opted_in & (1u << dev)))) return err;
  err = cudaFuncSetAttribute(lowrank_f32_kernel<BM, kTma>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < 32) opted_in |= 1u << dev;
  return err;
}

template <int BM>
int launch_f32(const float* x, const float* w1, const float* w2, const float* bias, float* out,
               int n, int d_in, int r, int d_out, int cluster, int groups, int cols_per_cta,
               cudaStream_t stream) {
  const auto aligned16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_in = d_in % 4 == 0 && aligned16(x) && aligned16(w1);
  const int vec_r = r % 4 == 0 && aligned16(w2);
  const int vec_out = d_out % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  // TMA takes every matrix whose row pitch is a multiple of 16 bytes
  const bool tma = vec_in && vec_r && d_in > 0;
  cudaError_t err = tma ? f32_opt_in<BM, true>() : f32_opt_in<BM, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap x_map = {}, w1_map = {}, w2_map = {};
  if (tma) {
    int rc = ptdeco::encode_f32_rows(&x_map, x, n, d_in, BM);
    if (rc == 0) rc = ptdeco::encode_f32_rows(&w1_map, w1, r, d_in, f32_w1_rows(r));
    if (rc == 0) rc = ptdeco::encode_f32_rows(&w2_map, w2, d_out, r, kFUnit);
    if (rc != 0) return rc;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3((n + BM - 1) / BM, cluster * groups, 1), f32_smem_bytes(BM, r), stream,
                     dim3(1, cluster, 1), &attr);
  err = cudaLaunchKernelEx(&cfg, tma ? lowrank_f32_kernel<BM, true> : lowrank_f32_kernel<BM, false>,
                           x_map, w1_map, w2_map, x, w1, w2, bias, out, n, d_in, r, d_out,
                           cols_per_cta, vec_in, vec_r, vec_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int max_clusters_f32(int r, int cluster) {
  cudaError_t err = f32_opt_in<BM, true>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(1, cluster, 1), f32_smem_bytes(BM, r),
                                                nullptr, dim3(1, cluster, 1), &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, lowrank_f32_kernel<BM, true>, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}

}  // namespace

// Bytes of dynamic shared memory one block of the f32 path needs at rank r
// and `bm` rows (the wrapper's smem_bytes_f32 computes the same).
extern "C" int ptdeco_lowrank_f32_smem_bytes(int r, int bm) {
  return static_cast<int>(f32_smem_bytes(bm, r));
}

extern "C" int ptdeco_lowrank_f32_max_clusters(int r, int bm, int cluster) {
  switch (bm) {
    case 16: return max_clusters_f32<16>(r, cluster);
    case 32: return max_clusters_f32<32>(r, cluster);
    case 64: return max_clusters_f32<64>(r, cluster);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 path: x (n, d_in), w1 (r, d_in), w2 (d_out, r), bias (d_out,) or
// null, out (n, d_out), all contiguous f32.  Launch shape from the wrapper
// (ops/lowrank.py:launch_shape_f32): bm rows a tile (16, 32 or 64),
// clusters of `cluster` CTAs (1, 2, 4 or 8, at most the 32-wide steps of
// d_in), `groups` column groups and cols_per_cta output columns a CTA (a
// multiple of 16).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take).
extern "C" int ptdeco_lowrank_matmul_f32(const void* x, const void* w1, const void* w2,
                                         const void* bias, void* out, int n, int d_in, int r,
                                         int d_out, int bm, int cluster, int groups,
                                         int cols_per_cta, void* stream) {
  const int k_steps = d_in > 0 ? (d_in + kFK - 1) / kFK : 1;
  if (n < 1 || d_in < 0 || r < 1 || d_out < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || cluster > k_steps || groups < 1 ||
      static_cast<long long>(cluster) * groups > 65535 || cols_per_cta < kFUnit ||
      cols_per_cta % kFUnit != 0 ||
      static_cast<long long>(cols_per_cta) * cluster * groups < d_out ||
      (bm != 16 && bm != 32 && bm != 64) || f32_smem_bytes(bm, r) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16:
      return launch_f32<16>(xf, w1f, w2f, bf, of, n, d_in, r, d_out, cluster, groups,
                            cols_per_cta, s);
    case 32:
      return launch_f32<32>(xf, w1f, w2f, bf, of, n, d_in, r, d_out, cluster, groups,
                            cols_per_cta, s);
    default:
      return launch_f32<64>(xf, w1f, w2f, bf, of, n, d_in, r, d_out, cluster, groups,
                            cols_per_cta, s);
  }
}

// Bytes of dynamic shared memory one block of `bm` rows needs at rank r
// (the wrapper's launch_shape computes the same).
extern "C" int ptdeco_lowrank_smem_bytes(int r, int bm) {
  return static_cast<int>(smem_bytes(bm, r));
}

extern "C" int ptdeco_lowrank_max_clusters(int r, int bm, int cluster) {
  switch (bm) {
    case 8: return max_clusters<8>(r, cluster);
    case 16: return max_clusters<16>(r, cluster);
    case 32: return max_clusters<32>(r, cluster);
    case 64: return max_clusters<64>(r, cluster);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (n, d_in), w1: (r, d_in), w2: (d_out, r), bias: (d_out,) or null,
// out: (n, d_out); all contiguous bf16.  Launch shape from the wrapper:
// bm rows a tile (8, 16, 32 or 64), clusters of `cluster` CTAs (1 to 8,
// at most the 64-wide steps of d_in), `groups` column groups and
// cols_per_cta output columns a CTA (a multiple of 8).  Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int ptdeco_lowrank_matmul(const void* x, const void* w1, const void* w2,
                                     const void* bias, void* out, int n, int d_in, int r,
                                     int d_out, int bm, int cluster, int groups,
                                     int cols_per_cta, void* stream) {
  const int k_steps = d_in > 0 ? (d_in + kBK - 1) / kBK : 1;
  if (n < 1 || d_in < 0 || r < 1 || d_out < 1 || cluster < 1 || cluster > kMaxCluster ||
      cluster > k_steps || groups < 1 || cols_per_cta < 8 || cols_per_cta % 8 != 0 ||
      static_cast<long long>(cols_per_cta) * cluster * groups < d_out ||
      (n + bm - 1) / bm > 65535 || smem_bytes(bm, r) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_in = min(copy_width(x, d_in), copy_width(w1, d_in));
  const int vec_r = copy_width(w2, r);
  const int vec_out = d_out % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 8:
      return launch<8>(xb, w1b, w2b, bb, ob, n, d_in, r, d_out, cluster, groups, cols_per_cta,
                       vec_in, vec_r, vec_out, s);
    case 16:
      return launch<16>(xb, w1b, w2b, bb, ob, n, d_in, r, d_out, cluster, groups, cols_per_cta,
                        vec_in, vec_r, vec_out, s);
    case 32:
      return launch<32>(xb, w1b, w2b, bb, ob, n, d_in, r, d_out, cluster, groups, cols_per_cta,
                        vec_in, vec_r, vec_out, s);
    case 64:
      return launch<64>(xb, w1b, w2b, bb, ob, n, d_in, r, d_out, cluster, groups, cols_per_cta,
                        vec_in, vec_r, vec_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
