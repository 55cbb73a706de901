// The block-level tile product of the bf16 grouped expert matmul's
// mma.sync route (grouped_matmul.cu), and the walk over the group sizes
// that both grouped kernels (grouped_matmul.cu, gmm_int8.cu) share:
//
//   acc[BM x BN] = lhs[rows r0 .. r0+BM) @ W[cols n0 .. n0+BN)^T
//
// with lhs (M, K) bf16 row-major and W (N, K) row-major, torch.nn.Linear's
// own layout, so both operands are read along the contraction axis.
//
// A ring of STAGES shared-memory stages is filled with cp.async (16 bytes a
// thread) while the warps run mma.sync m16n8k16 (bf16 in, f32 accumulate) on
// the stage that has arrived.  Ragged edges (rows past the group, columns
// past N, K past the last full step, or a row pitch that is not a multiple
// of 16 bytes) are loaded element by element with zeros outside the matrix.
//
// Fragments are read from shared memory with 64-bit loads by permuting the
// 16 contraction indices of each mma step: lane t supplies actual k =
// 4t..4t+3 where mma.sync expects k = 2t, 2t+1, 2t+8, 2t+9.  The product
// sums over k, and A and B use the same permutation, so the result is
// unchanged.  Row pitches are padded so that these loads are free of bank
// conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ptdeco {
namespace gmm {

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename WT>
struct Weight;

template <>
struct Weight<__nv_bfloat16> {
  static constexpr int kBytes = 2;
  static constexpr int kPad = 32;  // pitch = 32 (mod 64) bytes: 4 rows, 4 banks apart
  // B fragment of lane (g, t): row n = g, actual k = 4t..4t+3
  __device__ __forceinline__ static void frag(const unsigned char* p, uint32_t b[2]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    b[0] = v.x;
    b[1] = v.y;
  }
};

template <typename WT, int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tile {
  using W = Weight<WT>;
  using WeightT = WT;
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWarpRows = BM / WM, kWarpCols = BN / WN;
  static constexpr int MT = kWarpRows / 16, NT = kWarpCols / 8;
  static constexpr int kALd = BK * 2 + 32;                // bytes per staged lhs row
  static constexpr int kBLd = BK * W::kBytes + W::kPad;   // bytes per staged weight row
  static constexpr int kStageBytes = BM * kALd + BN * kBLd;
  static constexpr int kSmemBytes = STAGES * kStageBytes;
  static_assert(kWarpRows % 16 == 0 && kWarpCols % 8 == 0, "warp tile");
  static_assert(BK % 16 == 0 && (BK * W::kBytes) % 16 == 0, "k step");
  static_assert(STAGES >= 2, "stages");
};

// The rows of m-tile slot `slot` when m rows sorted by expert are split into
// n_experts consecutive groups of group_sizes[i] rows and each group is cut
// into BM-row tiles: sets the expert e and the rows [r0, r1) and returns
// true, or returns false for a slot past the last group's last tile.  A
// walk of n_experts steps over group_sizes on the card (no host sync), the
// same in every thread.  ceil(m / BM) + n_experts slots cover any split.
template <int BM>
__device__ __forceinline__ bool group_slot(int slot, const int* group_sizes, int n_experts,
                                           int m, int& e, int& r0, int& r1) {
  for (int i = 0, tiles = 0, off = 0; i < n_experts; ++i) {
    const int size = max(group_sizes[i], 0);
    const int nt = (size + BM - 1) / BM;
    if (slot < tiles + nt) {
      e = i;
      r0 = off + (slot - tiles) * BM;
      r1 = min(min(r0 + BM, off + size), m);
      return r0 < r1;
    }
    tiles += nt;
    off += size;
  }
  return false;
}

// Stage a (ROWS x BYTES) tile: row r of the tile is src + r * src_ld; rows
// at or past rows_valid and bytes at or past bytes_valid are zero.
template <int ROWS, int BYTES, int THREADS>
__device__ __forceinline__ void load_tile(unsigned char* dst, int dst_ld,
                                          const unsigned char* src, size_t src_ld,
                                          int rows_valid, int bytes_valid,
                                          bool vec_ok) {
  constexpr int kChunks = BYTES / 16;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks, b = (c % kChunks) * 16;
    unsigned char* d = dst + r * dst_ld + b;
    if (r < rows_valid && b < bytes_valid) {
      const unsigned char* s = src + r * src_ld + b;
      if (vec_ok && b + 16 <= bytes_valid) {
        cp_async_16(d, s);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) d[i] = (b + i < bytes_valid) ? s[i] : 0;
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc += lhs[0 .. rows) @ w[0 .. cols)^T over k, lhs and w already offset
// to the tile's first row and column; rows <= BM and cols may exceed BN.
template <class T>
__device__ __forceinline__ void tile_product(float (&acc)[T::MT][T::NT][4],
                                             unsigned char* smem,
                                             const __nv_bfloat16* lhs, int rows,
                                             const typename T::WeightT* w,
                                             int cols, int k) {
  using W = typename T::W;
  const bool a_vec = (k % 8) == 0;
  const bool b_vec = (k * W::kBytes) % 16 == 0;
  const int n_k = (k + T::BK - 1) / T::BK;
  const unsigned char* a_src = reinterpret_cast<const unsigned char*>(lhs);
  const unsigned char* b_src = reinterpret_cast<const unsigned char*>(w);

  auto load = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * T::kStageBytes;
    unsigned char* sb = sa + T::BM * T::kALd;
    const int k0 = kt * T::BK;
    load_tile<T::BM, T::BK * 2, T::kThreads>(
        sa, T::kALd, a_src + static_cast<size_t>(k0) * 2, static_cast<size_t>(k) * 2,
        rows, (k - k0) * 2, a_vec);
    load_tile<T::BN, T::BK * W::kBytes, T::kThreads>(
        sb, T::kBLd, b_src + static_cast<size_t>(k0) * W::kBytes,
        static_cast<size_t>(k) * W::kBytes, cols, (k - k0) * W::kBytes, b_vec);
  };

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WN, wn = warp % T::WN;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    {
      const int next = kt + T::STAGES - 1;
      if (next < n_k) load(next % T::STAGES, next);
      cp_async_commit();
    }
    const unsigned char* sa = smem + (kt % T::STAGES) * T::kStageBytes;
    const unsigned char* sb = sa + T::BM * T::kALd;
#pragma unroll
    for (int ks = 0; ks < T::BK; ks += 16) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const unsigned char* p =
            sa + (wm * T::kWarpRows + mt * 16 + g) * T::kALd + (ks + 4 * t) * 2;
        const uint2 lo = *reinterpret_cast<const uint2*>(p);
        const uint2 hi = *reinterpret_cast<const uint2*>(p + 8 * T::kALd);
        a[mt][0] = lo.x;
        a[mt][1] = hi.x;
        a[mt][2] = lo.y;
        a[mt][3] = hi.y;
      }
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        uint32_t b[2];
        W::frag(sb + (wn * T::kWarpCols + nt * 8 + g) * T::kBLd + (ks + 4 * t) * W::kBytes, b);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) mma_16816(acc[mt][nt], a[mt], b);
      }
    }
  }
  cp_async_wait<0>();
}

// Write the tile's rows [0, rows) and columns [n0, n) of out (which points
// at the tile's first row; row pitch n), scaled per column by scale[col]
// when scale is not null, rounded once to bf16.
template <class T>
__device__ __forceinline__ void store_tile(const float (&acc)[T::MT][T::NT][4],
                                           __nv_bfloat16* out, int rows, int n0,
                                           int n, const float* scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WN, wn = warp % T::WN;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const int col = n0 + wn * T::kWarpCols + nt * 8 + 2 * t;
      if (col >= n) continue;
      float s0 = 1.f, s1 = 1.f;
      if (scale != nullptr) {
        s0 = scale[col];
        s1 = col + 1 < n ? scale[col + 1] : 0.f;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * T::kWarpRows + mt * 16 + g + 8 * half;
        if (row >= rows) continue;
        const float v0 = acc[mt][nt][2 * half] * s0;
        const float v1 = acc[mt][nt][2 * half + 1] * s1;
        __nv_bfloat16* o = out + static_cast<size_t>(row) * n + col;
        if (col + 1 < n && (n & 1) == 0) {
          *reinterpret_cast<uint32_t*>(o) = pack_f32_as_bf16(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (col + 1 < n) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

}  // namespace gmm
}  // namespace ptdeco
