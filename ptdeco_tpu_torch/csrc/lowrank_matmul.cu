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
// f32 (the Pallas kernel takes it too; an f32 model's fused pairs): exact
// f32 products on the CUDA cores, since the tensor cores take no f32
// operands (TF32 rounds them).  A CTA computes its 16-row tile's f32
// hidden into shared memory, then its column group's outputs from it,
// operand tiles streaming through a 3-stage cp.async ring
// (ptdeco_lowrank_matmul_f32).  The hidden takes 16 * (r padded to 64,
// + 4) * 4 bytes beside the 65 KB ring, so ranks up to 2560.
// Not yet done (later work): wgmma for the 64-row tiles; a persistent
// grid; register tiling for the f32 path.
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

cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, cudaStream_t stream, int cluster,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
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
                                                smem_bytes(BM, r), stream, cluster, &attr);
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
      cluster_config(dim3(cluster, 1, 1), smem_bytes(BM, r), nullptr, cluster, &attr);
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

// f32 path.  A CTA of 256 threads takes a tile of kF32Rows rows: it
// computes their f32 hidden into shared memory, kF32Cols hidden columns a
// pass over d_in, then its share of the output columns from that hidden,
// kF32Cols a pass over r.  Each thread owns one column and 4 rows of a
// pass.  Operand tiles of kF32K contraction columns stream through a
// kF32Stages-deep cp.async ring (16-byte copies where a row pitch allows,
// zero-filled past every edge); a thread reads its column's operand as a
// float4 along the contraction (rows of kF32Ld floats keep 8 lanes on 32
// distinct banks) and its rows' as broadcast float4s: 16 FMAs a 5 shared
// loads.
constexpr int kF32Rows = 16;
constexpr int kF32Cols = 64;
constexpr int kF32K = 64;
constexpr int kF32Ld = kF32K + 4;
constexpr int kF32Stages = 3;
constexpr int kF32StageElems = (kF32Rows + kF32Cols) * kF32Ld;

__host__ __device__ constexpr int f32_rank_pad(int r) {
  return (r + kF32Cols - 1) / kF32Cols * kF32Cols;
}

// the ring, then the hidden: kF32Rows rows of (r padded to 64) + 4 floats
__host__ __device__ constexpr size_t f32_smem_bytes(int r) {
  return (static_cast<size_t>(kF32Stages) * kF32StageElems +
          static_cast<size_t>(kF32Rows) * (f32_rank_pad(r) + 4)) * 4;
}

// rows [row0, row0 + rows) x columns [k0, k0 + kF32K) of a row-major f32
// matrix of row pitch ld (columns < ld exist, rows < row_lim) into a tile
// of row pitch kF32Ld, zero outside the matrix
template <int Rows>
__device__ __forceinline__ void f32_load_tile(float* dst, const float* src, int ld, int row0,
                                              int row_lim, int k0, bool vec) {
  if (vec) {  // ld % 4 == 0: a 4-float chunk lies wholly inside or outside
    for (int e = threadIdx.x; e < Rows * kF32K / 4; e += kThreads) {
      const int i = e / (kF32K / 4), k = e % (kF32K / 4) * 4;
      const bool ok = row0 + i < row_lim && k0 + k < ld;
      ptdeco::cp_async16_zfill(dst + i * kF32Ld + k,
                               ok ? src + static_cast<size_t>(row0 + i) * ld + k0 + k : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < Rows * kF32K; e += kThreads) {
      const int i = e / kF32K, k = e % kF32K;
      const bool ok = row0 + i < row_lim && k0 + k < ld;
      ptdeco::cp_async4_zfill(dst + i * kF32Ld + k,
                              ok ? src + static_cast<size_t>(row0 + i) * ld + k0 + k : src, ok);
    }
  }
}

// acc[q] += sum over the tile's kF32K columns of a[(i0 + q) * lda + k] * w[c * kF32Ld + k]
__device__ __forceinline__ void f32_tile_fma(float acc[4], const float* a, int lda,
                                             const float* w, int i0, int c) {
#pragma unroll 4
  for (int k = 0; k < kF32K; k += 4) {
    const float4 b = *reinterpret_cast<const float4*>(w + c * kF32Ld + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(a + (i0 + q) * lda + k);
      acc[q] = fmaf(v.x, b.x, acc[q]);
      acc[q] = fmaf(v.y, b.y, acc[q]);
      acc[q] = fmaf(v.z, b.z, acc[q]);
      acc[q] = fmaf(v.w, b.w, acc[q]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) lowrank_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ bias, float* __restrict__ out, int n, int d_in, int r, int d_out,
    int cols_per_cta, int vec_in, int vec_r) {
  extern __shared__ __align__(16) float f32_smem[];
  const int rp = f32_rank_pad(r), hld = rp + 4;
  float* ring = f32_smem;                           // kF32Stages x (x tile, W tile)
  float* h = f32_smem + kF32Stages * kF32StageElems;  // kF32Rows x hld, zero in [r, rp)
  const int row0 = blockIdx.x * kF32Rows;
  const int col_begin = blockIdx.y * cols_per_cta;
  const int col_end = min(d_out, col_begin + cols_per_cta);
  const int t = threadIdx.x;
  const int c = t % kF32Cols;
  const int i0 = t / kF32Cols * 4;
  static_assert(kThreads == kF32Cols * kF32Rows / 4, "a thread owns 4 rows of one column");

  // phase 1: h = x @ W1^T for the tile's rows, one 64-column pass at a time
  const int nk1 = (d_in + kF32K - 1) / kF32K;
  for (int j0 = 0; j0 < rp; j0 += kF32Cols) {
    for (int s = 0; s < kF32Stages - 1; ++s) {
      if (s < nk1) {
        float* st = ring + s * kF32StageElems;
        f32_load_tile<kF32Rows>(st, x, d_in, row0, n, s * kF32K, vec_in);
        f32_load_tile<kF32Cols>(st + kF32Rows * kF32Ld, w1, d_in, j0, r, s * kF32K, vec_in);
      }
      ptdeco::async_commit();
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < nk1; ++ks) {
      const int next = ks + kF32Stages - 1;
      if (next < nk1) {
        float* st = ring + next % kF32Stages * kF32StageElems;
        f32_load_tile<kF32Rows>(st, x, d_in, row0, n, next * kF32K, vec_in);
        f32_load_tile<kF32Cols>(st + kF32Rows * kF32Ld, w1, d_in, j0, r, next * kF32K, vec_in);
      }
      ptdeco::async_commit();
      ptdeco::async_wait<kF32Stages - 1>();
      __syncthreads();
      const float* st = ring + ks % kF32Stages * kF32StageElems;
      f32_tile_fma(acc, st, kF32Ld, st + kF32Rows * kF32Ld, i0, c);
      __syncthreads();
    }
    ptdeco::async_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) h[(i0 + q) * hld + j0 + c] = acc[q];
  }
  __syncthreads();

  // phase 2: y = h @ W2^T + b for the CTA's columns, 64 at a time
  const int nk2 = (r + kF32K - 1) / kF32K;
  for (int c0 = col_begin; c0 < col_end; c0 += kF32Cols) {
    for (int s = 0; s < kF32Stages - 1; ++s) {
      if (s < nk2)
        f32_load_tile<kF32Cols>(ring + s * kF32StageElems + kF32Rows * kF32Ld, w2, r, c0, col_end,
                                s * kF32K, vec_r);
      ptdeco::async_commit();
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < nk2; ++ks) {
      const int next = ks + kF32Stages - 1;
      if (next < nk2)
        f32_load_tile<kF32Cols>(ring + next % kF32Stages * kF32StageElems + kF32Rows * kF32Ld, w2,
                                r, c0, col_end, next * kF32K, vec_r);
      ptdeco::async_commit();
      ptdeco::async_wait<kF32Stages - 1>();
      __syncthreads();
      f32_tile_fma(acc, h + ks * kF32K, hld,
                   ring + ks % kF32Stages * kF32StageElems + kF32Rows * kF32Ld, i0, c);
      __syncthreads();
    }
    ptdeco::async_wait<0>();
    const int col = c0 + c;
    if (col < col_end) {
      const float b = bias != nullptr ? bias[col] : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (row0 + i0 + q < n) out[static_cast<size_t>(row0 + i0 + q) * d_out + col] = acc[q] + b;
    }
  }
}

cudaError_t f32_opt_in() {
  static unsigned opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (opted_in & (1u << dev)))) return err;
  err = cudaFuncSetAttribute(lowrank_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < 32) opted_in |= 1u << dev;
  return err;
}

}  // namespace

extern "C" int ptdeco_lowrank_f32_smem_bytes(int r) {
  return static_cast<int>(f32_smem_bytes(r));
}

// The f32 path: x (n, d_in), w1 (r, d_in), w2 (d_out, r), bias (d_out,) or
// null, out (n, d_out), all contiguous f32.  Grid: (n + 15) / 16 row tiles
// by `groups` column groups of cols_per_cta columns (a multiple of 64).
// Launches on `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int ptdeco_lowrank_matmul_f32(const void* x, const void* w1, const void* w2,
                                         const void* bias, void* out, int n, int d_in, int r,
                                         int d_out, int groups, int cols_per_cta, void* stream) {
  if (n < 1 || d_in < 0 || r < 1 || d_out < 1 || groups < 1 || groups > 65535 ||
      cols_per_cta < kF32Cols || cols_per_cta % kF32Cols != 0 ||
      static_cast<long long>(cols_per_cta) * groups < d_out || f32_smem_bytes(r) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = f32_opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_in = d_in % 4 == 0 && aligned16(x) && aligned16(w1);
  const int vec_r = r % 4 == 0 && aligned16(w2);
  const dim3 grid((n + kF32Rows - 1) / kF32Rows, groups, 1);
  lowrank_f32_kernel<<<grid, kThreads, f32_smem_bytes(r), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(bias), static_cast<float*>(out), n, d_in, r, d_out,
      cols_per_cta, vec_in, vec_r);
  return static_cast<int>(cudaGetLastError());
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
