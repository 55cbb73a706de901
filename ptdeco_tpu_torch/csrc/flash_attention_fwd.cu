// Causal flash-attention forward: O = softmax(Q K^T * scale + causal) V.
//
// Replaces: ptdeco_tpu/ops/flash_attention.py:_core, which on a TPU calls
// the library Pallas kernel jax.experimental.pallas.ops.tpu.flash_attention
// (causal=True); every calibration and metric forward of an LLM runs it,
// and every prefill of the served models.
//
// What bounds it on an H100: operations at long sequences, bytes at short
// ones.  Per (batch, head) the causal products cost about 2 * 2 * s*s/2 * d
// flops against s*d*2 bytes each of q and o and (s*d*2 bytes each of k and
// v) / (heads per kv head); at s = 1024, d = 64 that is ~256 flops a byte,
// at the card's bf16 ridge, and at the Mixtral prefill (s = 512, d = 128,
// 4 kv heads a group) the bytes bound it (0.0125 ms).  What a naive
// attention loses is the s x s f32 logits tensor in device memory (128 MB
// per layer at 32 heads); this kernel never writes it.
//
// Design (after FlashAttention-3):
//   * a persistent grid of one CTA an SM walks the (batch, head, 128-row
//     query tile) tiles, heaviest first; a CTA is three warpgroups: a
//     producer warpgroup whose one thread issues TMA loads (its registers
//     handed to the consumers with setmaxnreg), and two consumer warpgroups
//     of 64 query rows each;
//   * for each tile the producer loads Q (once the consumers are done with
//     the last tile's), then the K and V tiles of kBN keys (128; 64 at head
//     dim 256, where a 128-key ring would not fit shared memory) up to the
//     causal diagonal (tiles above it are never loaded) into a 2-stage ring
//     (3 and 4 stages measured no faster), each tile completing on its own
//     mbarrier; a consumer warp arrives on the stage's "empty" barrier when
//     its products have read it.  The tensor maps are 4D (head_dim, seq,
//     heads, batch) with the caller's strides, so the model's transposed
//     (b, s, h, d) views are read as they lie, and a box that runs past seq
//     is zero-filled instead of reading the next head's rows;
//   * S = Q K^T is wgmma m64n{kBN}k16 with Q and K both K-major (head_dim
//     contiguous) in 128-byte-swizzled shared memory, a head_dim of 128 or
//     256 being two or four 64-column swizzle atoms;
//   * online softmax in base 2 and f32 on the accumulator layout, each
//     thread holding two rows, the scale folded into one FMA before the
//     special-function unit's 2^x; only the key tiles that reach the query
//     tile's first row are masked (key > row, and key >= seq, which TMA's
//     zeros would not hide: a zero key gives a logit of 0, not -inf);
//   * P is rounded to bf16 in registers and re-packed from the S
//     accumulators into wgmma's register A fragments, and O += P V is
//     wgmma m64n{64,128,256}k16 in its register-A form with V as an MN-major
//     B operand (the transpose bit); O is normalised once at the end.  At
//     head dim 256 a consumer thread's O is 128 f32 registers; S and P of a
//     64-key tile add 48, inside the 240 that setmaxnreg gives it;
//   * the tiles with the most key tiles come first (ops/flash_attention.py:
//     flash_schedule), so the causal tail is short, and the next tile's Q
//     and first K/V tiles load while the last tile's products and stores
//     finish;
//   * grouped-query attention: query head h reads kv head h / (h / h_kv), so
//     no repeated copy is made;
//   * a head dim of 96 (Phi-3) or 80 (Arcee) is one and a half or one and
//     a quarter 64-column swizzle atoms a row, so it runs the 128-wide
//     instance with its tensor maps 96 or 80 wide: TMA zero-fills columns
//     96-127 (80-127) of Q, K and V (as it zero-fills rows past seq), the
//     zero columns add nothing to Q K^T and give zero columns of O, and
//     only the real columns of O are stored (DS).  The tensor cores do
//     4/3 (1.6x) of the head's work;
//   * each consumer warpgroup pipelines its own work (FlashAttention-3's
//     intra-warpgroup overlap): S_j = Q K_j^T is issued before
//     P_{j-1} V_{j-1}, and the softmax of S_j runs while that product is
//     on the tensor cores.
// Not yet done (later work): explicit ping-pong scheduling of the two
// consumer warpgroups, TMA stores of O.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // query rows a CTA: 64 a consumer warpgroup
// K/V ring depth, chosen by measurement (tools/tile_sweep.py; PERF.md)
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;

template <int D>
struct Layout {
  // keys a K/V tile (ops/flash_attention.py:block_n): 128 keys of a 256-wide
  // head would make a 320 KB CTA
  static constexpr int kBN = D == 256 ? 64 : 128;
  static_assert(kBM % kBN == 0, "a query tile's diagonal spans whole key tiles");
  static constexpr int kAtoms = D / 64;    // 64-column swizzle atoms of a row
  static constexpr int kQ = kBM * D;       // elements of the Q tile
  static constexpr int kKV = kBN * D;      // elements of one K or V tile
  static constexpr int kTiles = kQ + 2 * kStages * kKV;
  static constexpr int kBarriers = 2 + 4 * kStages;
  // + 1 KB to align the tiles (each swizzle atom must be 1 KB aligned)
  static constexpr int kSmemBytes = kTiles * 2 + kBarriers * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of a CTA");
};

// 2^x on the special-function unit, subnormal results flushed to zero
// (a probability below 2^-126 of the row's largest is zero either way)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* p, uint64_t db) {
  if constexpr (D == 64) {
    ptdeco::wgmma::rs_m64n64k16<1>(o, p, db, 1);
  } else if constexpr (D == 128) {
    ptdeco::wgmma::rs_m64n128k16<1>(o, p, db, 1);
  } else {
    ptdeco::wgmma::rs_m64n256k16<1>(o, p, db, 1);
  }
}

// S (+)= Q K^T for one 16-wide step of head_dim: a key tile of N keys
template <int N>
__device__ __forceinline__ void qk_product(float* s, uint64_t dq, uint64_t dk, int scale_d) {
  if constexpr (N == 64) {
    ptdeco::wgmma::ss_m64n64k16<0, 0>(s, dq, dk, scale_d);
  } else {
    ptdeco::wgmma::ss_m64n128k16<0, 0>(s, dq, dk, scale_d);
  }
}

// The tile a CTA takes in its turn: the grid's CTAs walk the (batch * head,
// q-tile) tiles in the order t = 0, 1, ..., CTA c taking t = c, c + grid,
// ...; tile t is head bh = t % bh_count and q-tile n_q - 1 - t / bh_count,
// so the tiles with the most causal key tiles (qt + 1) come first
// (ops/flash_attention.py:flash_schedule).
struct TileOf {
  int b, head, qt;
  __device__ TileOf(int t, int bh_count, int h, int n_q) {
    const int bh = t % bh_count;
    qt = n_q - 1 - t / bh_count;
    b = bh / h;
    head = bh % h;
  }
};

// D: the instance's head dim (its tiles and products); DS <= D: the columns
// of O stored, the head dim of the tensors
template <int D, int DS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                     int bh_count, int h, int h_kv, int s, int n_q, float scale_log2,
                     long long o_sb, long long o_sh, long long o_ss) {
  using L = Layout<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (ptdeco::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + L::kQ;             // [kStages][kKV]
  bf16* vs = ks + kStages * L::kKV;  // [kStages][kKV]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * L::kKV);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  const int n_tiles = bh_count * n_q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    ptdeco::mbar_init(q_full, 1);
    ptdeco::mbar_init(q_empty, kConsumerWarps);
    for (int i = 0; i < kStages; ++i) {
      ptdeco::mbar_init(&k_full[i], 1);
      ptdeco::mbar_init(&v_full[i], 1);
      ptdeco::mbar_init(&k_empty[i], kConsumerWarps);
      ptdeco::mbar_init(&v_empty[i], kConsumerWarps);
    }
    ptdeco::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // producer: one thread keeps the ring full across this CTA's tiles, so
    // the next tile's Q and first K/V tiles load while the consumers finish
    // the current one; no barrier follows that would need the others
    ptdeco::wgmma::regs_dec<24>();
    if (warp == 0 && lane == 0) {
      int it = 0;  // K/V tiles loaded so far: ring stage it % kStages
      for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
        const TileOf tile(t, bh_count, h, n_q);
        const int kvh = tile.head / (h / h_kv);
        const int n_blocks = (tile.qt + 1) * (kBM / kBN);  // key tiles up to the diagonal
        ptdeco::mbar_wait(q_empty, (tc & 1) ^ 1);
        ptdeco::mbar_expect(q_full, L::kQ * 2);
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a)
          ptdeco::tma_box4(qs + a * kBM * 64, &qmap, a * 64, tile.qt * kBM, tile.head, tile.b,
                           q_full);
        for (int j = 0; j < n_blocks; ++j, ++it) {
          const int st = it % kStages, ph = (it / kStages) & 1;
          ptdeco::mbar_wait(&k_empty[st], ph ^ 1);
          ptdeco::mbar_expect(&k_full[st], L::kKV * 2);
#pragma unroll
          for (int a = 0; a < L::kAtoms; ++a)
            ptdeco::tma_box4(ks + st * L::kKV + a * kBN * 64, &kmap, a * 64, j * kBN, kvh,
                             tile.b, &k_full[st]);
          ptdeco::mbar_wait(&v_empty[st], ph ^ 1);
          ptdeco::mbar_expect(&v_full[st], L::kKV * 2);
#pragma unroll
          for (int a = 0; a < L::kAtoms; ++a)
            ptdeco::tma_box4(vs + st * L::kKV + a * kBN * 64, &vmap, a * 64, j * kBN, kvh,
                             tile.b, &v_full[st]);
        }
      }
    }
    return;
  }

  ptdeco::wgmma::regs_inc<240>();
  const int wg = (warp >> 2) - 1;  // consumer warpgroup: query rows 64 wg .. of a tile
  const int g8 = lane >> 2, t4 = lane & 3;
  const bf16* qw = qs + wg * 64 * 64;  // this warpgroup's rows in each Q atom

  // S fragment: register 4 q + e holds row row_a (row_b for e >= 2), key
  // 8 q + 2 t4 + (e & 1) of the tile; O's the same with head_dim columns
  float sacc[kBN / 2];
  float oacc[D / 2];
  uint32_t pf[kBN / 16][4];  // P of the tile whose P V is next
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sacc[i] = 0.f;

  int it = 0;  // K/V tiles consumed so far, as the producer counts them
  for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
    const TileOf tile(t, bh_count, h, n_q);
    const int n_blocks = (tile.qt + 1) * (kBM / kBN);  // key tiles up to the diagonal
    const int row_a = tile.qt * kBM + wg * 64 + (warp & 3) * 16 + g8, row_b = row_a + 8;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    // running max (base 2, scaled) and this thread's share of the row sums
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    // S = Q K^T of key tile j into sacc, in 16-wide steps of head_dim, 4 to
    // a swizzle atom (issued, not waited for)
    auto s_product = [&](int j) {
      const bf16* kb = ks + ((it + j) % kStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int atom = kk >> 2, col = (kk & 3) * 16;
        qk_product<kBN>(sacc, ptdeco::wgmma::desc(qw + atom * kBM * 64 + col, 16, 1024),
                        ptdeco::wgmma::desc(kb + atom * kBN * 64 + col, 16, 1024),
                        kk > 0 ? 1 : 0);
      }
    };
    // O += P V of key tile j, in 16-key steps (8 KB of V rows each)
    auto pv = [&](int j) {
      const bf16* vb = vs + ((it + j) % kStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        pv_product<D>(oacc, pf[kk], ptdeco::wgmma::desc(vb + kk * 16 * 64, kBN * 64 * 2, 1024));
    };
    // the online softmax of key tile j's logits in sacc: on a key tile that
    // reaches the query tile's first row (the diagonal's kBM / kBN tiles,
    // which hold every key >= seq too) mask keys past the row or seq, raise
    // the running max (base 2,
    // scaled: sm_scale > 0, so the scaled max is the max scaled), leave
    // exp2(logit * scale - max) in sacc, rescale the row sums; returns the
    // factors by which O's rows must be rescaled
    auto softmax = [&](int j, float& alpha_a, float& alpha_b) {
      if ((j + 1) * kBN > tile.qt * kBM) {
#pragma unroll
        for (int q = 0; q < kBN / 8; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * kBN + q * 8 + 2 * t4 + (e & 1);
            if (key > (e < 2 ? row_a : row_b) || key >= s) sacc[4 * q + e] = -INFINITY;
          }
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int q = 0; q < kBN / 8; ++q) {
        mx_a = fmaxf(mx_a, fmaxf(sacc[4 * q], sacc[4 * q + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[4 * q + 2], sacc[4 * q + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a * scale_log2), mn_b = fmaxf(m_b, mx_b * scale_log2);
      // a row with every key masked so far keeps a finite base (no inf - inf)
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      alpha_a = ex2(m_a - base_a);
      alpha_b = ex2(m_b - base_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int q = 0; q < kBN / 8; ++q) {
        sacc[4 * q] = ex2(fmaf(sacc[4 * q], scale_log2, -base_a));
        sacc[4 * q + 1] = ex2(fmaf(sacc[4 * q + 1], scale_log2, -base_a));
        sacc[4 * q + 2] = ex2(fmaf(sacc[4 * q + 2], scale_log2, -base_b));
        sacc[4 * q + 3] = ex2(fmaf(sacc[4 * q + 3], scale_log2, -base_b));
        sum_a += sacc[4 * q] + sacc[4 * q + 1];
        sum_b += sacc[4 * q + 2] + sacc[4 * q + 3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
    };
    // P in bf16 as the A fragments of the 16-key steps: step kk is S's
    // n8-blocks 2 kk and 2 kk + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pf[kk][0] = ptdeco::pack_f32_as_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pf[kk][1] = ptdeco::pack_f32_as_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = ptdeco::pack_f32_as_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = ptdeco::pack_f32_as_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    auto rescale_o = [&](float alpha_a, float alpha_b) {
#pragma unroll
      for (int q = 0; q < D / 8; ++q) {
        oacc[4 * q] *= alpha_a;
        oacc[4 * q + 1] *= alpha_a;
        oacc[4 * q + 2] *= alpha_b;
        oacc[4 * q + 3] *= alpha_b;
      }
    };
    auto stage = [&](int j) { return (it + j) % kStages; };
    auto phase = [&](int j) { return ((it + j) / kStages) & 1; };

    // Software pipeline (FlashAttention-3's intra-warpgroup overlap): while
    // the tensor cores run P_{j-1} V_{j-1}, this warpgroup's softmax of S_j
    // runs; S_j itself is issued before P_{j-1} V_{j-1}.
    float alpha_a, alpha_b;
    ptdeco::mbar_wait(q_full, tc & 1);
    if (n_blocks > 0) {  // always, but never wait for a tile no one loads
      ptdeco::mbar_wait(&k_full[stage(0)], phase(0));
      ptdeco::wgmma::fence_acc<kBN / 2>(sacc);
      ptdeco::wgmma::fence();
      s_product(0);
      ptdeco::wgmma::commit();
      ptdeco::wgmma::wait<0>();
      ptdeco::wgmma::fence_acc<kBN / 2>(sacc);
      if (lane == 0) ptdeco::mbar_arrive(&k_empty[stage(0)]);
      softmax(0, alpha_a, alpha_b);
      pack_p();
      for (int j = 1; j < n_blocks; ++j) {
        ptdeco::mbar_wait(&k_full[stage(j)], phase(j));
        ptdeco::mbar_wait(&v_full[stage(j - 1)], phase(j - 1));
        ptdeco::wgmma::fence_acc<kBN / 2>(sacc);
        ptdeco::wgmma::fence_acc<D / 2>(oacc);
        ptdeco::wgmma::fence();
        s_product(j);
        ptdeco::wgmma::commit();
        pv(j - 1);
        ptdeco::wgmma::commit();
        ptdeco::wgmma::wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
        ptdeco::wgmma::fence_acc<kBN / 2>(sacc);
        if (lane == 0) ptdeco::mbar_arrive(&k_empty[stage(j)]);
        softmax(j, alpha_a, alpha_b);
        ptdeco::wgmma::wait<0>();
        ptdeco::wgmma::fence_acc<D / 2>(oacc);
        if (lane == 0) ptdeco::mbar_arrive(&v_empty[stage(j - 1)]);
        rescale_o(alpha_a, alpha_b);
        pack_p();
      }
      const int last = n_blocks - 1;
      ptdeco::mbar_wait(&v_full[stage(last)], phase(last));
      ptdeco::wgmma::fence_acc<D / 2>(oacc);
      ptdeco::wgmma::fence();
      pv(last);
      ptdeco::wgmma::commit();
      ptdeco::wgmma::wait<0>();
      ptdeco::wgmma::fence_acc<D / 2>(oacc);
      if (lane == 0) ptdeco::mbar_arrive(&v_empty[stage(last)]);
    }
    // every product that reads this tile's Q is done: the next tile's Q may land
    if (lane == 0) ptdeco::mbar_arrive(q_empty);
    it += n_blocks;

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    bf16* ob = o + tile.b * o_sb + tile.head * o_sh;
#pragma unroll
    for (int q = 0; q < DS / 8; ++q) {
      const int col = q * 8 + 2 * t4;
      if (row_a < s)
        *reinterpret_cast<uint32_t*>(ob + row_a * o_ss + col) =
            ptdeco::pack_f32_as_bf16(oacc[4 * q] * inv_a, oacc[4 * q + 1] * inv_a);
      if (row_b < s)
        *reinterpret_cast<uint32_t*>(ob + row_b * o_ss + col) =
            ptdeco::pack_f32_as_bf16(oacc[4 * q + 2] * inv_b, oacc[4 * q + 3] * inv_b);
    }
  }
}

template <int D, int DS = D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h, int h_kv, int s,
           float scale_log2, const long long* st, cudaStream_t stream) {
  static int sms[32] = {};  // each device's SM count, the persistent grid's size, once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<D>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  CUtensorMap qmap, kmap, vmap;
  // the maps are DS wide: a box's columns past DS are zero-filled
  int rc = ptdeco::encode_heads(&qmap, q, b, h, s, DS, st[0], st[1], st[2], kBM);
  constexpr int kBN = Layout<D>::kBN;
  if (rc == 0) rc = ptdeco::encode_heads(&kmap, k, b, h_kv, s, DS, st[3], st[4], st[5], kBN);
  if (rc == 0) rc = ptdeco::encode_heads(&vmap, v, b, h_kv, s, DS, st[6], st[7], st[8], kBN);
  if (rc != 0) return rc;
  const int n_q = (s + kBM - 1) / kBM;
  const long long n_tiles = static_cast<long long>(b) * h * n_q;
  const int grid = static_cast<int>(n_tiles < sms[dev] ? n_tiles : sms[dev]);
  flash_fwd_kernel<D, DS><<<grid, kThreads, Layout<D>::kSmemBytes, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), b * h, h, h_kv, s, n_q, scale_log2, st[9], st[10],
      st[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (b, h, s, d); k, v: (b, h_kv, s, d); bf16, d contiguous, h % h_kv
// == 0, d in {64, 80, 96, 128, 256}, sm_scale > 0.  strides: the (batch, head, seq) element strides
// of q, k, v and o in that order (12 values), each a multiple of 8; every
// base 16-byte aligned.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported head_dim or
// a layout TMA cannot address).
extern "C" int ptdeco_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                          int b, int h, int h_kv, int s, int d, float sm_scale,
                                          const long long* strides, void* stream) {
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, b, h, h_kv, s, scale_log2, strides, st);
  if (d == 80) return launch<128, 80>(q, k, v, o, b, h, h_kv, s, scale_log2, strides, st);
  if (d == 96) return launch<128, 96>(q, k, v, o, b, h, h_kv, s, scale_log2, strides, st);
  if (d == 128) return launch<128>(q, k, v, o, b, h, h_kv, s, scale_log2, strides, st);
  if (d == 256) return launch<256>(q, k, v, o, b, h, h_kv, s, scale_log2, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory of one CTA at head_dim d (0 for another d); 80 and
// 96 run the 128 instance
extern "C" int ptdeco_flash_smem_bytes(int d) {
  return d == 64                             ? Layout<64>::kSmemBytes
         : d == 80 || d == 96 || d == 128 ? Layout<128>::kSmemBytes
         : d == 256 ? Layout<256>::kSmemBytes
                    : 0;
}
