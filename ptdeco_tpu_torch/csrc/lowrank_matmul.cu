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
// flops against (n*d_in + r*d_in + r*d_out + n*d_out)*2 bytes; at the
// slice's shapes (n = 1024, d_in = 2048, r = 256, d_out = 5632) that is
// ~4 GFLOP over ~19 MB, about 210 flops per byte, under the card's bf16
// ridge, and at smaller r it falls further.  The hidden never goes to
// device memory, which is the whole point of fusing the pair.
//
// Design:
//   * one block of 4 warps per 16-row tile of x;
//   * phase 1 computes the (16 x r) hidden once, mma.sync m16n8k16 over
//     d_in in 64-wide steps of x staged in shared memory, each warp owning
//     64 of the hidden's columns per pass; the hidden is rounded to bf16
//     (x's dtype), as the TPU kernel and lowrank_xla both do, and kept in
//     shared memory;
//   * phase 2 loops over the d_out column tiles (64 per warp per pass),
//     reading A fragments from the hidden, adds the bias in f32 and casts;
//   * the factor fragments are read straight from global memory (they are
//     shared by every block and stay in L2);
//   * r is any value >= 1: the hidden is zero-padded to a multiple of 16 in
//     shared memory and the factor loads are masked, as are ragged n, d_in
//     and d_out.  The hidden needs 16 * (r_pad + 8) * 2 bytes of shared
//     memory; the wrapper raises when that exceeds the 227 KB a block may
//     use (r above ~7000), it never falls back.
// Not yet done (later work): more rows per block to cut the factor
// re-reads, wgmma, and a gate measured on this card for tiny shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kRows = 16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStep = 64;      // d_in columns of x staged per step
constexpr int kXld = kStep + 8;
constexpr int kWarpCols = 64;  // output columns per warp per pass (8 n-tiles)

__global__ void __launch_bounds__(kThreads)
    lowrank_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int n, int d_in, int r,
                   int d_out, int r_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hld = r_pad + 8;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][hld]
  __nv_bfloat16* xs = hs + kRows * hld;                         // [kRows][kXld]

  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // phase 1: hidden = x_tile @ W1^T, rounded to bf16 into shared memory
  for (int c0 = 0; c0 < r_pad; c0 += kWarps * kWarpCols) {
    const int wc = c0 + warp * kWarpCols;
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    for (int k0 = 0; k0 < d_in; k0 += kStep) {
      __syncthreads();
      for (int e = tid; e < kRows * kStep; e += kThreads) {
        const int rr = e / kStep, kk = e % kStep;
        const int gr = row0 + rr, gk = k0 + kk;
        xs[rr * kXld + kk] =
            (gr < n && gk < d_in) ? x[static_cast<size_t>(gr) * d_in + gk] : zero;
      }
      __syncthreads();
      if (wc < r) {
#pragma unroll
        for (int ks = 0; ks < kStep; ks += 16) {
          uint32_t a[4];
          const int c = ks + 2 * t4;
          a[0] = *reinterpret_cast<const uint32_t*>(&xs[g8 * kXld + c]);
          a[1] = *reinterpret_cast<const uint32_t*>(&xs[(g8 + 8) * kXld + c]);
          a[2] = *reinterpret_cast<const uint32_t*>(&xs[g8 * kXld + c + 8]);
          a[3] = *reinterpret_cast<const uint32_t*>(&xs[(g8 + 8) * kXld + c + 8]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = wc + nt * 8 + g8;
            uint32_t b[2];
            b[0] = ptdeco::load_pair(w1, col, k0 + c, r, d_in, d_in);
            b[1] = ptdeco::load_pair(w1, col, k0 + c + 8, r, d_in, d_in);
            ptdeco::mma_16816(acc[nt], a, b);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = wc + nt * 8 + 2 * t4;
      if (col < r_pad) {
        *reinterpret_cast<uint32_t*>(&hs[g8 * hld + col]) =
            ptdeco::pack_f32_as_bf16(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<uint32_t*>(&hs[(g8 + 8) * hld + col]) =
            ptdeco::pack_f32_as_bf16(acc[nt][2], acc[nt][3]);
      }
    }
  }
  __syncthreads();

  // phase 2: y = hidden @ W2^T + b, column tile by column tile
  for (int c0 = 0; c0 < d_out; c0 += kWarps * kWarpCols) {
    const int wc = c0 + warp * kWarpCols;
    if (wc >= d_out) continue;
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int ks = 0; ks < r_pad; ks += 16) {
      uint32_t a[4];
      const int c = ks + 2 * t4;
      a[0] = *reinterpret_cast<const uint32_t*>(&hs[g8 * hld + c]);
      a[1] = *reinterpret_cast<const uint32_t*>(&hs[(g8 + 8) * hld + c]);
      a[2] = *reinterpret_cast<const uint32_t*>(&hs[g8 * hld + c + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&hs[(g8 + 8) * hld + c + 8]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = wc + nt * 8 + g8;
        uint32_t b[2];
        b[0] = ptdeco::load_pair(w2, col, c, d_out, r, r);
        b[1] = ptdeco::load_pair(w2, col, c + 8, d_out, r, r);
        ptdeco::mma_16816(acc[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = wc + nt * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + g8 + 8 * half;
        if (row >= n) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int cc = col + q;
          if (cc >= d_out) continue;
          float val = acc[nt][2 * half + q];
          if (bias != nullptr) val += __bfloat162float(bias[cc]);
          out[static_cast<size_t>(row) * d_out + cc] = __float2bfloat16_rn(val);
        }
      }
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs at rank r.
extern "C" int ptdeco_lowrank_smem_bytes(int r) {
  const int r_pad = (r + 15) / 16 * 16;
  return (kRows * (r_pad + 8) + kRows * kXld) * static_cast<int>(sizeof(__nv_bfloat16));
}

// x: (n, d_in), w1: (r, d_in), w2: (d_out, r), bias: (d_out,) or null,
// out: (n, d_out); all contiguous bf16.  Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int ptdeco_lowrank_matmul(const void* x, const void* w1,
                                     const void* w2, const void* bias,
                                     void* out, int n, int d_in, int r,
                                     int d_out, void* stream) {
  const int r_pad = (r + 15) / 16 * 16;
  const int smem = ptdeco_lowrank_smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(
      lowrank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  lowrank_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), n, d_in, r, d_out, r_pad);
  return static_cast<int>(cudaGetLastError());
}
