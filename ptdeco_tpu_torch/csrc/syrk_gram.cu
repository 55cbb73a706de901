// Symmetric Gram G = Y^T Y (SYRK) of calibration activations, f32 result.
//
// Replaces: ptdeco_tpu/ops/gram_pallas.py:_syrk_kernel (via _syrk_padded),
// the lower-triangle Pallas kernel of the calibration Gram.
//
// What bounds it on an H100: bytes, closely followed by operations.  For Y
// of shape (N, d) the lower triangle costs N*d*d flops (half of the full
// 2*N*d*d product) against N*d*2 bytes read and d*d*4 bytes written; at the
// slice's shapes (N = 1024, d = 5632) that is ~32 GFLOP over ~139 MB, about
// 235 flops per byte, just under the card's bf16 ridge of ~295.  Writing
// the f32 Gram dominates the bytes, so the tile is written once per side.
//
// Design:
//   * one block per lower-triangle 128x128 output tile (i >= j); the block
//     derives (i, j) from blockIdx.x itself (the TPU kernel streamed the
//     pairs in by scalar prefetch);
//   * a loop inside the block walks N in 32-row steps; each step stages the
//     two 32x128 column panels of Y in shared memory, transposed so that
//     the tensor-core fragments are 32-bit loads along N;
//   * bf16 input: 8 warps, each a 64x32 sub-tile of mma.sync m16n8k16
//     products with f32 accumulators in registers;  f32 input: the same
//     tiling on the CUDA cores in exact f32 (the TPU kernel took both);
//   * the epilogue writes tile (i, j) and its transpose (j, i), replacing
//     the TPU version's separate mirror pass (gram_pallas.py:102-105);
//   * ragged N and d are masked in the kernel (zero rows and columns are
//     exact no-ops for a Gram), so nothing is padded in device memory.
// Not yet done (later work): a TMA/wgmma pipeline and a larger k-step;
// today each block re-reads its two panels from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 128;      // output tile edge
constexpr int kStep = 32;       // rows of Y per k-step
constexpr int kPad = kStep + 8; // padded row of a transposed bf16 panel
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

__global__ void __launch_bounds__(kThreads)
    syrk_bf16_kernel(const __nv_bfloat16* __restrict__ y,
                     float* __restrict__ g, int n, int d) {
  int ti, tj;
  triangle_tile(blockIdx.x, &ti, &tj);
  const int i0 = ti * kTile, j0 = tj * kTile;

  // sa[m][k] = y[k0 + k][i0 + m],  sb[m][k] = y[k0 + k][j0 + m]
  __shared__ __align__(16) __nv_bfloat16 sa[kTile][kPad];
  __shared__ __align__(16) __nv_bfloat16 sb[kTile][kPad];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2;  // 64-row half of the tile
  const int wn = warp & 3;   // 32-column quarter of the tile
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const bool vec = (d & 7) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kStep) {
    if (vec) {
      // 16-byte loads of 8 consecutive columns, scattered transposed
      for (int e = tid; e < kStep * kTile / 8; e += kThreads) {
        const int kk = e / (kTile / 8), m = (e % (kTile / 8)) * 8;
        const int row = k0 + kk;
        uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
        if (row < n && i0 + m < d)
          va = *reinterpret_cast<const uint4*>(y + static_cast<size_t>(row) * d + i0 + m);
        if (row < n && j0 + m < d)
          vb = *reinterpret_cast<const uint4*>(y + static_cast<size_t>(row) * d + j0 + m);
        const __nv_bfloat16* pa = reinterpret_cast<const __nv_bfloat16*>(&va);
        const __nv_bfloat16* pb = reinterpret_cast<const __nv_bfloat16*>(&vb);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          sa[m + q][kk] = pa[q];
          sb[m + q][kk] = pb[q];
        }
      }
    } else {
      for (int e = tid; e < kStep * kTile; e += kThreads) {
        const int kk = e / kTile, m = e % kTile;
        const int row = k0 + kk;
        __nv_bfloat16 va = zero, vb = zero;
        if (row < n) {
          if (i0 + m < d) va = y[static_cast<size_t>(row) * d + i0 + m];
          if (j0 + m < d) vb = y[static_cast<size_t>(row) * d + j0 + m];
        }
        sa[m][kk] = va;
        sb[m][kk] = vb;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kStep; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g8;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&sa[r][ks + 2 * t4]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&sa[r + 8][ks + 2 * t4]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&sa[r][ks + 2 * t4 + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&sa[r + 8][ks + 2 * t4 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g8;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&sb[c][ks + 2 * t4]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&sb[c][ks + 2 * t4 + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) ptdeco::mma_16816(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  const bool mirror = ti != tj;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = i0 + wm * 64 + mt * 16 + g8;
      const int c = j0 + wn * 32 + nt * 8 + 2 * t4;
      store_sym(g, d, r, c, acc[mt][nt][0], mirror);
      store_sym(g, d, r, c + 1, acc[mt][nt][1], mirror);
      store_sym(g, d, r + 8, c, acc[mt][nt][2], mirror);
      store_sym(g, d, r + 8, c + 1, acc[mt][nt][3], mirror);
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
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ptdeco_syrk_gram(const void* y, void* g, int n, int d,
                                int is_bf16, void* stream) {
  const int tiles = (d + kTile - 1) / kTile;
  const int blocks = tiles * (tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    syrk_bf16_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<float*>(g), n, d);
  } else {
    syrk_f32_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(y),
                                                static_cast<float*>(g), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
