// Causal flash-attention forward: O = softmax(Q K^T * scale + causal) V.
//
// Replaces: ptdeco_tpu/ops/flash_attention.py:_core, which on a TPU calls
// the library Pallas kernel jax.experimental.pallas.ops.tpu.flash_attention
// (causal=True); every calibration and metric forward of an LLM runs it.
//
// What bounds it on an H100: operations.  Per (batch, head) the causal
// products cost about 2 * 2 * s*s/2 * d flops against 4 * s*d*2 bytes of
// q, k, v and o; at the slice's shapes (s = 1024, d = 64) that is ~256
// flops per byte per head, at the card's bf16 ridge.  What a naive
// attention loses is the s x s f32 logits tensor in device memory (128 MB
// per layer at 32 heads); this kernel never writes it.
//
// Design:
//   * one block of 4 warps per (batch, head, 64-row query tile); each warp
//     owns 16 query rows, whose Q fragments stay in registers;
//   * the block walks the key/value tiles of 64 up to the causal diagonal
//     (tiles above it are never loaded), staging K and V in shared memory;
//   * S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with f32
//     accumulators; the running row max and row sum are f32 (online
//     softmax in base 2), and P is re-packed from the S accumulators into
//     A fragments in registers, so it never touches shared memory;
//   * grouped-query attention: k and v keep their h_kv heads and query
//     head h reads kv head h / (h / h_kv), so no repeated copy is made;
//   * head_dim is a template parameter (64 and 128); a sequence length
//     that is not a multiple of 64 is masked in the kernel, so the TPU
//     path's s % 128 == 0 tiling rule does not apply here.
// Not yet done (later work): wgmma, TMA loads, double-buffered K/V tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kRows = 64;  // query rows per block (16 per warp)
constexpr int kKeys = 64;  // keys per tile
constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int h, int h_kv, int s,
                     float scale_log2) {
  constexpr int KS = D / 16;  // k-steps of the QK^T product
  constexpr int DT = D / 8;   // n-tiles of the PV product
  constexpr int LD = D + 8;   // padded shared-memory row

  __shared__ __align__(16) __nv_bfloat16 ks[kKeys][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeys][LD];

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kvh = head / (h / h_kv);
  const size_t q_off = static_cast<size_t>(bh) * s * D;
  const size_t kv_off = static_cast<size_t>(b * h_kv + kvh) * s * D;
  const __nv_bfloat16* qp = q + q_off;
  const __nv_bfloat16* kp = k + kv_off;
  const __nv_bfloat16* vp = v + kv_off;
  __nv_bfloat16* op = o + q_off;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = qt * kRows + warp * 16;  // this warp's first query row
  const int row_a = r0 + g8, row_b = r0 + g8 + 8;

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = ptdeco::load_pair(qp, row_a, c, s, D, D);
    qf[kk][1] = ptdeco::load_pair(qp, row_b, c, s, D, D);
    qf[kk][2] = ptdeco::load_pair(qp, row_a, c + 8, s, D, D);
    qf[kk][3] = ptdeco::load_pair(qp, row_b, c + 8, s, D, D);
  }

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    for (int e = tid; e < kKeys * D / 8; e += kThreads) {
      const int rr = e / (D / 8), cc = (e % (D / 8)) * 8;
      const int key = kt * kKeys + rr;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < s) {
        kv = *reinterpret_cast<const uint4*>(kp + static_cast<size_t>(key) * D + cc);
        vv = *reinterpret_cast<const uint4*>(vp + static_cast<size_t>(key) * D + cc);
      }
      *reinterpret_cast<uint4*>(&ks[rr][cc]) = kv;
      *reinterpret_cast<uint4*>(&vs[rr][cc]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(&ks[nt * 8 + g8][kk * 16 + 2 * t4]);
        bfr[1] = *reinterpret_cast<const uint32_t*>(&ks[nt * 8 + g8][kk * 16 + 2 * t4 + 8]);
        ptdeco::mma_16816(sc[nt], qf[kk], bfr);
      }
    }

    // scale (to base 2), causal and ragged-edge mask, row max
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int key = kt * kKeys + nt * 8 + 2 * t4 + (e & 1);
        float val = sc[nt][e] * scale_log2;
        if (key > row || key >= s) val = -INFINITY;
        sc[nt][e] = val;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[nt][0], sc[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with every key masked so far keeps a finite base (no inf - inf)
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - base_a), alpha_b = exp2f(m_b - base_b);

    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - base_a);
      sc[nt][1] = exp2f(sc[nt][1] - base_a);
      sc[nt][2] = exp2f(sc[nt][2] - base_b);
      sc[nt][3] = exp2f(sc[nt][3] - base_b);
      rs_a += sc[nt][0] + sc[nt][1];
      rs_b += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
      rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
    }
    l_a = l_a * alpha_a + rs_a;
    l_b = l_b * alpha_b + rs_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= alpha_a;
      oacc[dt][1] *= alpha_a;
      oacc[dt][2] *= alpha_b;
      oacc[dt][3] *= alpha_b;
    }

    // O += P V; the S accumulators of key tiles 2j, 2j+1 are the A
    // fragment of the j-th 16-key step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = ptdeco::pack_f32_as_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[1] = ptdeco::pack_f32_as_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[2] = ptdeco::pack_f32_as_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[3] = ptdeco::pack_f32_as_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const int key = j * 16 + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + g8;
        uint32_t bfr[2];
        bfr[0] = ptdeco::pack_bf16(vs[key][col], vs[key + 1][col]);
        bfr[1] = ptdeco::pack_bf16(vs[key + 8][col], vs[key + 9][col]);
        ptdeco::mma_16816(oacc[dt], pa, bfr);
      }
    }
  }

  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t4;
    if (row_a < s)
      *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(row_a) * D + col) =
          ptdeco::pack_f32_as_bf16(oacc[dt][0] * inv_a, oacc[dt][1] * inv_a);
    if (row_b < s)
      *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(row_b) * D + col) =
          ptdeco::pack_f32_as_bf16(oacc[dt][2] * inv_b, oacc[dt][3] * inv_b);
  }
}

}  // namespace

// q, o: (b, h, s, d); k, v: (b, h_kv, s, d); all contiguous bf16 with
// 16-byte aligned rows, h % h_kv == 0, d in {64, 128}.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for an unsupported head_dim).
extern "C" int ptdeco_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, int b, int h,
                                          int h_kv, int s, int d,
                                          float sm_scale, void* stream) {
  const dim3 grid((s + kRows - 1) / kRows, b * h);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (d == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(qb, kb, vb, ob, h, h_kv, s, scale_log2);
  } else if (d == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(qb, kb, vb, ob, h, h_kv, s, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
