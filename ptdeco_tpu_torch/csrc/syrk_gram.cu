// Symmetric Gram G = Y^T Y (SYRK) of calibration activations, f32 result.
//
// Replaces: ptdeco_tpu/ops/gram_pallas.py:_syrk_kernel (via _syrk_padded),
// the lower-triangle Pallas kernel of the calibration Gram.
//
// What bounds it on an H100: bytes, closely followed by operations.  For Y
// of shape (N, d) the lower triangle costs N*d*d flops (half of the full
// 2*N*d*d product) against N*d*2 bytes read and d*d*4 bytes written; at
// N = 1024, d = 5632 that is ~32 GFLOP over ~139 MB, about 235 flops per
// byte, just under the card's bf16 ridge of ~295.  Writing the f32 Gram
// dominates the bytes, so every tile is written once per side, in full
// coalesced rows, and the math has to keep pace with those stores.
//
// Design (bf16, the engine's path):
//   * one block per lower-triangle 128x128 output tile (i >= j); the block
//     derives (i, j) from blockIdx.x itself (the TPU kernel streamed the
//     pairs in by scalar prefetch);
//   * the block walks N in 32-row steps through a 6-stage ring in shared
//     memory, loads running 4 steps ahead; each stage holds the two 32x128
//     column panels of Y (one on a diagonal tile) as TMA boxes of 32 rows x
//     64 columns, read along Y's rows as they lie and written by the TMA
//     unit in wgmma's MN-major layout with the 128-byte swizzle, so nothing
//     is transposed: Y^T is the A operand and Y the B operand, both
//     MN-major; one thread issues a stage's boxes, an mbarrier a stage
//     counts their bytes; the TMA unit zero-fills past ragged N and d.  A d
//     that is not a multiple of 8 (no TMA: its row pitch is not 16 bytes)
//     takes 4-byte or scalar cp.async copies into the same layout;
//   * two warpgroups, each a 64x128 half of the tile with wgmma
//     m64n128k16 (f32 accumulators in registers); 96 KB of shared memory,
//     two blocks an SM;
//   * the epilogue stages the f32 tile in the freed ring, row-major for
//     tile (i, j) and transposed for its mirror (j, i), and writes each as
//     16-byte row stores (a diagonal tile once), replacing the TPU version's
//     separate mirror pass (gram_pallas.py:102-105);
//   * nothing is padded in device memory;
//   * the tensor cores truncate as they add into an f32 accumulator, so a
//     long sum drifts (2e-4 of the diagonal at 50k rows, 1e-3 at 200k): a
//     block adds its accumulators into an f32 running tile in device memory
//     every kChunkRows rows (each thread its own elements, rounded f32
//     adds) and restarts them, as the TPU kernel adds each step's product
//     into its f32 accumulator;
//   * a Gram of few tiles over many rows (a conv site: d 256-2048, N up to
//     200k) splits N over blocks, `rows_per_split` rows each, so the grid
//     fills the card: each split's tile goes to a workspace slot and a
//     second kernel sums the slots in split order (the same bits every run)
//     and writes the tile and its mirror.
// What held the first wgmma version back: its 16-byte cp.async copies
// could not stream the panels from L2 fast enough (without the loads it
// ran in half the time); TMA moves the same bytes with one instruction a
// box.
// f32 input (not on the engine's path; should_use_syrk takes bf16 only):
// the first design's tiling on the CUDA cores in exact f32, transposing
// through shared memory, with 4-byte mirror stores.
// Not yet done (later work): TMA multicast across a cluster of tiles that
// share a panel, a producer warp, a persistent walk over the triangle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 128;      // output tile edge
constexpr int kStep = 32;       // rows of Y per k-step (f32 path)
constexpr int kThreads = 256;

__device__ __forceinline__ void triangle_tile(int t, int* ti, int* tj) {
  int i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  *ti = i;
  *tj = t - i * (i + 1) / 2;
}

__device__ __forceinline__ void store_sym(float* g, int d, int r, int c,
                                          float v, bool mirror) {
  if (r < d && c < d) {
    g[static_cast<size_t>(r) * d + c] = v;
    if (mirror) g[static_cast<size_t>(c) * d + r] = v;
  }
}

// bf16 path: row-major panels through a TMA ring into wgmma's
// MN-major layout (128-byte swizzle), two consumer warpgroups, an epilogue staged
// through shared memory.
constexpr int kBK = 32;                  // rows of Y per pipeline step
constexpr int kStages = 6;               // ring depth; loads run kStages - 2 steps ahead
constexpr int kPanel = kBK * kTile;      // elements of one 32 x 128 panel
constexpr int kKGroup = 8 * 64;          // elements of 8 k-rows of a 64-wide atom (SBO)
constexpr int kAtom = kBK / 8 * kKGroup;  // elements of one 32 x 64 atom column (LBO)
constexpr int kOutLd = kTile + 4;        // f32 staging row
constexpr int kRingBytes = kStages * 2 * kPanel * 2;
constexpr int kBf16Smem = kRingBytes + kStages * 8;  // + one mbarrier a stage
constexpr int kBoxBytes = kBK * 64 * 2;              // one TMA box: 32 rows x 64 columns
constexpr int kChunkSteps = 128;  // steps (kChunkRows = 4096 rows) between f32 promotions
constexpr int kTileElems = kTile * kTile;
static_assert(kTile * kOutLd * 4 <= kRingBytes, "the staged tile reuses the ring");

// Offset of element (k, m) of a 32 x 128 panel in wgmma's MN-major layout
// with the 128-byte swizzle: 64 consecutive m (128 bytes) make a row, 8
// k-rows a 1 KB swizzle atom in which the 16-byte chunk index is XORed
// with the row; the 4 atoms along k lie 1 KB apart (SBO), the two halves
// of m 4 KB apart (LBO).
__device__ __forceinline__ int panel_offset(int k, int m) {
  return (m >> 6) * kAtom + (k >> 3) * kKGroup + (k & 7) * 64 + ((((m >> 3) & 7) ^ (k & 7)) << 3) +
         (m & 7);
}

// rows [row0, row0 + kBK) x columns [col0, col0 + kTile) of y into a
// panel with cp.async, zero outside y: the path for a d that is not a
// multiple of 8, which TMA cannot address (4-byte copies for an even d)
__device__ __forceinline__ void load_panel(__nv_bfloat16* dst, const __nv_bfloat16* y, int n,
                                           int d, int row0, int col0, int vec) {
  if (vec == 2) {
    for (int e = threadIdx.x; e < kBK * kTile / 2; e += kThreads) {
      const int r = e / (kTile / 2), c = (e % (kTile / 2)) * 2;
      const bool ok = row0 + r < n && col0 + c < d;
      ptdeco::cp_async4_zfill(dst + panel_offset(r, c),
                              ok ? y + static_cast<size_t>(row0 + r) * d + col0 + c : y, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < kBK * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const bool ok = row0 + r < n && col0 + c < d;
      dst[panel_offset(r, c)] = ok ? y[static_cast<size_t>(row0 + r) * d + col0 + c] : zero;
    }
  }
}

// wgmma descriptor of a panel: LBO the next 64 of m or n, SBO the next 8
// rows of k (wgmma.cuh); every start is 1 KB aligned
__device__ __forceinline__ uint64_t panel_desc(const __nv_bfloat16* p) {
  return ptdeco::wgmma::desc(p, kAtom * 2, kKGroup * 2);
}

// Element e (0..63) of a warpgroup thread's m64n128 accumulator fragment:
// its row and column in the 128 x 128 tile
__device__ __forceinline__ int frag_row(int mrow, int e) { return mrow + ((e & 3) >= 2) * 8; }
__device__ __forceinline__ int frag_col(int t4, int e) { return (e >> 2) * 8 + 2 * t4 + (e & 1); }

// The block's running f32 tile: its own slot of `partial` (128 x 128,
// row-major) when N is split, else the output tile (i0, j0) of g itself.
// add == false stores the accumulators, else adds them (rounded f32).
__device__ __forceinline__ void promote(const float* acc, float* slot, float* g, int d, int i0,
                                        int j0, int mrow, int t4, bool add) {
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = frag_row(mrow, e), c = frag_col(t4, e);
    float* p;
    if (slot != nullptr) {
      p = slot + r * kTile + c;
    } else {
      if (i0 + r >= d || j0 + c >= d) continue;
      p = g + static_cast<size_t>(i0 + r) * d + j0 + c;
    }
    *p = add ? *p + acc[e] : acc[e];
  }
}

// kTma: panels by TMA from `map` (d a multiple of 8), else by cp.async.
// kLong: more than kChunkRows rows a block, or N split: block b takes lower
// tile b % n_lower over the rows of split b / n_lower, promotes its
// accumulators every chunk, and with `partial` (N split) leaves its tile in
// its slot for syrk_reduce_kernel, else writes g.  Without kLong a block
// sums all of N at once, as before the split: at N 1024-4096 (TinyLlama's
// Grams) that instance ran 4-7% faster than kLong's on an H100.
template <bool kTma, bool kLong>
__global__ void __launch_bounds__(kThreads, 2)
    syrk_bf16_kernel(const __grid_constant__ CUtensorMap map,
                     const __nv_bfloat16* __restrict__ y, float* __restrict__ g, int n, int d,
                     int vec_in, int vec_out, int rows_per_split, float* __restrict__ partial) {
  const int tt = (d + kTile - 1) / kTile, n_lower = tt * (tt + 1) / 2;
  const int tile = kLong ? blockIdx.x % n_lower : blockIdx.x;
  const int split = kLong ? blockIdx.x / n_lower : 0;
  int ti, tj;
  triangle_tile(tile, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  const bool diag = ti == tj;  // one panel serves both sides
  const int k0 = split * rows_per_split;  // a multiple of kBK
  float* slot = kLong && partial != nullptr
                    ? partial + static_cast<size_t>(split * n_lower + tile) * kTileElems
                    : nullptr;

  // stage s: panel A = y[k0 : k0 + kBK, i0 : i0 + kTile] and panel B the
  // same at j0, both read along the rows as they lie in memory
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;  // warpgroup: 64-row half of the tile
  const int steps = kLong ? (min(n, k0 + rows_per_split) - k0 + kBK - 1) / kBK
                          : (n + kBK - 1) / kBK;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);  // [kStages]
  if (kTma) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i)
        ptdeco::mbar_init(&full[i]);
      ptdeco::fence_barrier_init();
    }
    __syncthreads();
  }

  auto load_step = [&](int s) {
    __nv_bfloat16* pa = ring + (s % kStages) * 2 * kPanel;
    if (kTma) {
      if (tid == 0) {
        uint64_t* bar = &full[s % kStages];
        ptdeco::mbar_expect(bar, (diag ? 2 : 4) * kBoxBytes);
        ptdeco::tma_box(pa, &map, i0, k0 + s * kBK, bar);
        ptdeco::tma_box(pa + kAtom, &map, i0 + 64, k0 + s * kBK, bar);
        if (!diag) {
          ptdeco::tma_box(pa + kPanel, &map, j0, k0 + s * kBK, bar);
          ptdeco::tma_box(pa + kPanel + kAtom, &map, j0 + 64, k0 + s * kBK, bar);
        }
      }
    } else {
      load_panel(pa, y, n, d, k0 + s * kBK, i0, vec_in);
      if (!diag) load_panel(pa + kPanel, y, n, d, k0 + s * kBK, j0, vec_in);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps) load_step(s);
    ptdeco::async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (kTma) {
      ptdeco::mbar_wait(&full[s % kStages], (s / kStages) & 1);
    } else {
      ptdeco::async_wait<kStages - 3>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    }
    // step s landed everywhere; step s - 2's products, the last readers of
    // the stage loaded next, are done (each warpgroup waited for them)
    __syncthreads();
    if (s + kStages - 2 < steps) load_step(s + kStages - 2);
    ptdeco::async_commit();
    const __nv_bfloat16* pa = ring + (s % kStages) * 2 * kPanel;
    const __nv_bfloat16* pb = diag ? pa : pa + kPanel;
    ptdeco::wgmma::fence_acc<64>(acc);
    ptdeco::wgmma::fence();
    // kLong: acc was promoted at the chunk's start, overwrite it
    const int restart = kLong && s > 0 && s % kChunkSteps == 0;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      ptdeco::wgmma::ss_m64n128k16<1, 1>(acc, panel_desc(pa + wg * kAtom + kk * 2 * kKGroup),
                                         panel_desc(pb + kk * 2 * kKGroup), kk > 0 || !restart);
    ptdeco::wgmma::commit();
    ptdeco::wgmma::wait<0>();
    if (kLong && (s + 1) % kChunkSteps == 0 && s + 1 < steps) {
      ptdeco::wgmma::fence_acc<64>(acc);
      promote(acc, slot, g, d, i0, j0, wg * 64 + (warp & 3) * 16 + g8, t4,
              s + 1 > kChunkSteps);
    }
  }
  ptdeco::wgmma::fence_acc<64>(acc);
  ptdeco::async_wait<0>();
  const int mrow = wg * 64 + (warp & 3) * 16 + g8;  // the fragment's first row
  if (kLong) {
    if (steps > kChunkSteps) {  // add the running tile of the earlier chunks
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = frag_row(mrow, e), c = frag_col(t4, e);
        if (slot != nullptr)
          acc[e] += slot[r * kTile + c];
        else if (i0 + r < d && j0 + c < d)
          acc[e] += g[static_cast<size_t>(i0 + r) * d + j0 + c];
      }
    }
    if (slot != nullptr) {  // syrk_reduce_kernel sums the splits
      promote(acc, slot, g, d, i0, j0, mrow, t4, false);
      return;
    }
  }
  __syncthreads();  // the ring is free: stage the tile there

  // tile (i, j) row by row, then for an off-diagonal tile its mirror (j, i);
  // accumulator fragment: register 4q + e holds row 16 (warp % 4) + g8
  // (+ 8 for e >= 2), column 8q + 2 t4 + (e & 1) of the warpgroup's rows
  float* st = reinterpret_cast<float*>(smem);  // [kTile][kOutLd]
  for (int side = 0; side < (diag ? 1 : 2); ++side) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int c = q * 8 + 2 * t4;
      if (side == 0) {
        *reinterpret_cast<float2*>(&st[mrow * kOutLd + c]) =
            make_float2(acc[4 * q], acc[4 * q + 1]);
        *reinterpret_cast<float2*>(&st[(mrow + 8) * kOutLd + c]) =
            make_float2(acc[4 * q + 2], acc[4 * q + 3]);
      } else {
        st[c * kOutLd + mrow] = acc[4 * q];
        st[(c + 1) * kOutLd + mrow] = acc[4 * q + 1];
        st[c * kOutLd + mrow + 8] = acc[4 * q + 2];
        st[(c + 1) * kOutLd + mrow + 8] = acc[4 * q + 3];
      }
    }
    __syncthreads();
    const int r0 = side == 0 ? i0 : j0, c0 = side == 0 ? j0 : i0;
    for (int e = tid; e < kTile * (kTile / 4); e += kThreads) {
      const int m = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
      const int gr = r0 + m, gc = c0 + c;
      if (gr >= d || gc >= d) continue;
      const float4 v = *reinterpret_cast<const float4*>(&st[m * kOutLd + c]);
      float* dst = g + static_cast<size_t>(gr) * d + gc;
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        dst[0] = v.x;
        if (gc + 1 < d) dst[1] = v.y;
        if (gc + 2 < d) dst[2] = v.z;
        if (gc + 3 < d) dst[3] = v.w;
      }
    }
    __syncthreads();
  }
}

// Sums the `splits` slots of each lower tile in split order and writes the
// tile and, off the diagonal, its mirror: block (tile, strip) takes kStrip
// rows of the tile, read and written as 16-byte rows, and writes the
// mirror's columns from a shared-memory copy as 128-byte runs.
constexpr int kStrip = 32;

__global__ void __launch_bounds__(kThreads)
    syrk_reduce_kernel(const float* __restrict__ partial, float* __restrict__ g, int d,
                       int splits, int vec_out) {
  __shared__ float strip[kStrip][kTile + 1];
  const int tt = (d + kTile - 1) / kTile, n_lower = tt * (tt + 1) / 2;
  const int tile = blockIdx.x, r0 = blockIdx.y * kStrip;
  int ti, tj;
  triangle_tile(tile, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;
  for (int e = threadIdx.x; e < kStrip * kTile / 4; e += kThreads) {
    const int r = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(
          partial + static_cast<size_t>(sp * n_lower + tile) * kTileElems + (r0 + r) * kTile + c);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    strip[r][c] = v.x;
    strip[r][c + 1] = v.y;
    strip[r][c + 2] = v.z;
    strip[r][c + 3] = v.w;
    const int gr = i0 + r0 + r, gc = j0 + c;
    if (gr >= d || gc >= d) continue;
    float* dst = g + static_cast<size_t>(gr) * d + gc;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (gc + 1 < d) dst[1] = v.y;
      if (gc + 2 < d) dst[2] = v.z;
      if (gc + 3 < d) dst[3] = v.w;
    }
  }
  if (ti == tj) return;
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kStrip; e += kThreads) {
    const int c = e / kStrip, r = e % kStrip;  // mirror row j0 + c, column i0 + r0 + r
    if (j0 + c < d && i0 + r0 + r < d)
      g[static_cast<size_t>(j0 + c) * d + i0 + r0 + r] = strip[r][c];
  }
}

__global__ void __launch_bounds__(kThreads)
    syrk_f32_kernel(const float* __restrict__ y, float* __restrict__ g, int n,
                    int d) {
  int ti, tj;
  triangle_tile(blockIdx.x, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;

  // sa[k][m] = y[k0 + k][i0 + m],  sb[k][m] = y[k0 + k][j0 + m]
  __shared__ float sa[kStep][kTile + 4];
  __shared__ float sb[kStep][kTile + 4];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16x16 threads, 8x8 outputs each
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kStep) {
    for (int e = tid; e < kStep * kTile; e += kThreads) {
      const int kk = e / kTile, m = e % kTile;
      const int row = k0 + kk;
      float va = 0.f, vb = 0.f;
      if (row < n) {
        if (i0 + m < d) va = y[static_cast<size_t>(row) * d + i0 + m];
        if (j0 + m < d) vb = y[static_cast<size_t>(row) * d + j0 + m];
      }
      sa[kk][m] = va;
      sb[kk][m] = vb;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kStep; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        a[q] = sa[kk][ty + 16 * q];
        b[q] = sb[kk][tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }

  const bool mirror = ti != tj;
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      store_sym(g, d, i0 + ty + 16 * p, j0 + tx + 16 * q, acc[p][q], mirror);
}

}  // namespace

// y: (n, d) row-major, bf16 when is_bf16 else f32; g: (d, d) f32 output.
// bf16: `rows_per_split` rows of y a block (a multiple of 32; n or more for
// one block a tile), and when that splits n, `workspace` holds
// ceil(n / rows_per_split) x (lower tiles) x 128 x 128 floats.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ptdeco_syrk_gram(const void* y, void* g, int n, int d, int is_bf16,
                                int rows_per_split, void* workspace, void* stream) {
  const int tiles = (d + kTile - 1) / kTile;
  const int blocks = tiles * (tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    static unsigned opted_in = 0;  // once per device, as lowrank_matmul.cu does
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32 || !(opted_in & (1u << dev))) {
      const void* kernels[4] = {reinterpret_cast<const void*>(syrk_bf16_kernel<true, false>),
                                reinterpret_cast<const void*>(syrk_bf16_kernel<false, false>),
                                reinterpret_cast<const void*>(syrk_bf16_kernel<true, true>),
                                reinterpret_cast<const void*>(syrk_bf16_kernel<false, true>)};
      for (const void* fn : kernels) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      if (dev < 32) opted_in |= 1u << dev;
    }
    const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
    const int vec_out = d % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    if (rows_per_split < n && (rows_per_split <= 0 || rows_per_split % kBK != 0 ||
                               workspace == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const int splits = rows_per_split < n ? (n + rows_per_split - 1) / rows_per_split : 1;
    float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
    const int rows = splits > 1 ? rows_per_split : (n > 1 ? n : 1);
    const bool long_rows = splits > 1 || n > kChunkSteps * kBK;
    CUtensorMap map = {};
    const bool tma = n > 0 && d % 8 == 0 && ya % 16 == 0;
    if (tma) {
      // y as a (n, d) row-major tensor, read in 32-row x 64-column boxes
      const int rc = ptdeco::encode_rows(&map, y, n, d, kBK);
      if (rc != 0) return rc;
    }
    const int vec_in = tma ? 8 : d % 2 == 0 && ya % 4 == 0 ? 2 : 1;
    auto kernel = tma ? (long_rows ? syrk_bf16_kernel<true, true> : syrk_bf16_kernel<true, false>)
                      : (long_rows ? syrk_bf16_kernel<false, true>
                                   : syrk_bf16_kernel<false, false>);
    kernel<<<blocks * splits, kThreads, kBf16Smem, s>>>(
        map, static_cast<const __nv_bfloat16*>(y), static_cast<float*>(g), n, d, vec_in, vec_out,
        rows, partial);
    if (splits > 1)
      syrk_reduce_kernel<<<dim3(blocks, kTile / kStrip), kThreads, 0, s>>>(
          partial, static_cast<float*>(g), d, splits, vec_out);
  } else {
    syrk_f32_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(y),
                                                static_cast<float*>(g), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
