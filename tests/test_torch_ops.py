"""The PyTorch port's kernel wrappers on the CPU (where they run their plain
versions) against the JAX package's Pallas kernels in interpret mode, on
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu.ops.flash_attention import flash_attention as jax_flash
from ptdeco_tpu.ops.gram_pallas import syrk_gram as jax_syrk
from ptdeco_tpu.ops.lowrank_pallas import lowrank_matmul as jax_lowrank
from ptdeco_tpu_torch import nn as tnn, ops
from ptdeco_tpu_torch.ops import lowrank

JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype: torch.dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    return torch.from_numpy(a).to(dtype), jnp.asarray(a, JNP_DTYPE[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_syrk_gram_matches_pallas_interpret(dtype):
    y = np.random.default_rng(0).standard_normal((1024, 512)).astype(np.float32) * 0.1
    yt, yj = _pair(y, dtype)
    g = ops.syrk_gram(yt)
    ref = np.asarray(jax_syrk(yj, interpret=True))
    assert g.dtype == torch.float32 and g.shape == (512, 512)
    if dtype == torch.float32:
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize(
    "dtype,kv_heads,atol",
    [(torch.float32, 4, 1e-5), (torch.bfloat16, 4, 2e-2), (torch.float32, 2, 1e-5)],
)
def test_attention_matches_jax_op(dtype, kv_heads, atol):
    rng = np.random.default_rng(1)
    b, h, s, d = 1, 4, 128, 64
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kv_heads, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kv_heads, s, d)).astype(np.float32)
    qt, qj = _pair(q, dtype)
    kt, kj = _pair(k, dtype)
    vt, vj = _pair(v, dtype)
    out = ops.flash_attention(qt, kt, vt, d ** -0.5)
    # the JAX op takes k/v already repeated to every query head (GQA layout
    # on the port's side: kv head j serves query heads j*rep .. j*rep+rep-1)
    rep = h // kv_heads
    ref = jax_flash(qj, jnp.repeat(kj, rep, axis=1), jnp.repeat(vj, rep, axis=1), d ** -0.5)
    assert out.dtype == dtype and out.shape == (b, h, s, d)
    np.testing.assert_allclose(
        out.to(torch.float32).numpy(), np.asarray(ref, np.float32), atol=atol
    )


def test_attention_backward_is_the_plain_recompute():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 64)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    ops.flash_attention(q, k, v, 0.125).square().sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ops.causal_attention_plain(q, k, v, 0.125).square().sum().backward()
    for g, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(g, t.grad)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_lowrank_matmul_matches_pallas_interpret(dtype, atol):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 256)).astype(np.float32) * 0.1
    k1 = rng.standard_normal((256, 128)).astype(np.float32) * 0.1
    k2 = rng.standard_normal((128, 512)).astype(np.float32) * 0.1
    bias = rng.standard_normal(512).astype(np.float32)
    (xt, xj), (k1t, k1j), (k2t, k2j), (bt, bj) = (
        _pair(a, dtype) for a in (x, k1, k2, bias)
    )
    y = ops.lowrank_matmul(xt, k1t, k2t, bt)
    ref = jax_lowrank(xj, k1j, k2j, bj, interpret=True)
    assert y.dtype == dtype and y.shape == (256, 512)
    np.testing.assert_allclose(
        y.to(torch.float32).numpy(), np.asarray(ref, np.float32), atol=atol
    )


def test_lowrank_matmul_keeps_leading_dims():
    x = torch.randn(2, 3, 8)
    k1, k2 = torch.randn(8, 4), torch.randn(4, 5)
    y = ops.lowrank_matmul(x, k1, k2)
    torch.testing.assert_close(y, (x @ k1) @ k2)


def test_should_use_syrk_rule():
    assert ops.should_use_syrk(torch.bfloat16, 512, is_cuda=True)
    assert not ops.should_use_syrk(torch.bfloat16, 256, is_cuda=True)
    assert not ops.should_use_syrk(torch.float32, 2048, is_cuda=True)
    assert not ops.should_use_syrk(torch.bfloat16, 2048, is_cuda=False)


def test_cpu_tensors_never_launch_a_kernel():
    ops.reset_launch_counts()
    ops.syrk_gram(torch.randn(64, 600, dtype=torch.bfloat16))
    ops.flash_attention(*(torch.randn(1, 2, 8, 64, dtype=torch.bfloat16) for _ in range(3)), 0.125)
    ops.lowrank_matmul(torch.randn(4, 8), torch.randn(8, 2), torch.randn(2, 8), torch.randn(8))
    sizes = torch.tensor([3, 0, 2], dtype=torch.int32)
    lhs = torch.randn(5, 16, dtype=torch.bfloat16)
    ops.grouped_matmul(lhs, [torch.randn(8, 16, dtype=torch.bfloat16)] * 3, sizes)
    ops.grouped_matmul_int8(lhs, [torch.ones(8, 16, dtype=torch.int8)] * 3,
                            [torch.ones(8)] * 3, sizes)
    assert ops.launch_counts() == {"syrk_gram": 0, "flash_attention": 0, "lowrank_matmul": 0,
                                   "grouped_matmul": 0, "gmm_int8": 0}


@pytest.mark.parametrize(
    "dtype,r,takes",
    [(torch.bfloat16, 32, True), (torch.bfloat16, lowrank.MAX_RANK, True),
     (torch.float32, 32, True), (torch.float32, lowrank.MAX_RANK_F32, True),
     (torch.float16, 32, False), (torch.bfloat16, lowrank.MAX_RANK + 1, False),
     (torch.float32, lowrank.MAX_RANK_F32 + 1, False)],
)
def test_lowrank_kernel_takes(dtype, r, takes):
    assert lowrank.kernel_takes(dtype, r) is takes


@pytest.mark.parametrize("n,d_out", [(256, 2048), (1, 9), (5, 64), (4096, 5632), (17, 1001)])
def test_lowrank_f32_launch_shape_covers_the_output(n, d_out):
    s = lowrank.launch_shape_f32(n, 2048, 32, d_out)
    # the cluster's CTAs split d_in and d_out: every column is covered and
    # no column group is empty
    group_cols = s.cluster * s.cols_per_cta
    assert s.cols_per_cta % 16 == 0
    assert s.groups * group_cols >= d_out > (s.groups - 1) * group_cols
    assert s.groups == 1 or s.ctas <= lowrank.SM_COUNT


def test_fuse_leaves_pairs_the_kernel_cannot_take():
    """An f32 pair is fused and equals the unfused pair on the CPU; an f16
    pair and a bf16 pair over MAX_RANK stay unfused."""
    def pair(d, r, dtype):
        return torch.nn.Sequential(
            torch.nn.Linear(d, r, bias=False), torch.nn.Linear(r, 24)
        ).to(dtype)

    root = torch.nn.Sequential(pair(16, 3, torch.float32), pair(16, 3, torch.float16),
                               pair(8, lowrank.MAX_RANK + 1, torch.bfloat16))
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        ref = root[0](x)
        tnn.fuse_factor_pairs(root)
        ops.reset_launch_counts()
        y = root[0](x)
    assert [type(m).__name__ for m in root] == ["FusedLowRankLinear", "Sequential", "Sequential"]
    assert ops.lowrank_matmul.launches == 0
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)


def test_block_rows_picks_the_smallest_tile_holding_a_mean_group():
    from ptdeco_tpu_torch.ops.gmm import block_rows

    assert [block_rows(m, 8) for m in (8, 128, 129, 512, 513, 4096)] == [16, 16, 64, 64, 128, 128]
    assert [block_rows(m, 8, (16, 64)) for m in (16, 512, 4096)] == [16, 64, 64]
    assert block_rows(0, 0) == 16


@pytest.mark.parametrize("n", [1, 4, 17, 512, 1000, 1024])
@pytest.mark.parametrize(
    "d_in,r,d_out",
    [(2048, 32, 5632), (5632, 32, 2048), (2048, 256, 5632), (70, 1, 9), (576, 1500, 1001),
     (64, lowrank.MAX_RANK, 640)],
)
def test_lowrank_launch_shape_covers_the_output_once(n, d_in, r, d_out):
    s = lowrank.launch_shape(n, d_in, r, d_out)
    assert s.bm in lowrank.ROW_TILES and lowrank.smem_bytes(s.bm, r) <= lowrank.MAX_SHARED_BYTES
    assert 1 <= s.cluster <= min(8, -(-d_in // 64)) and s.cluster & (s.cluster - 1) == 0
    assert s.cols_per_cta % 8 == 0
    # rows: tile t holds [t * bm, (t + 1) * bm); columns: slot q of the
    # cluster * groups slots holds [q * cols, (q + 1) * cols), cut at d_out
    rows = np.zeros(n, np.int64)
    for t in range(s.row_tiles):
        rows[t * s.bm:(t + 1) * s.bm] += 1
    cols = np.zeros(d_out, np.int64)
    for q in range(s.cluster * s.groups):
        cols[q * s.cols_per_cta:(q + 1) * s.cols_per_cta] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert (s.row_tiles - 1) * s.bm < n
    if d_out == 5632 and n in (4, 512, 1024):
        assert s.ctas >= 64


def test_lowrank_rank_limit():
    assert lowrank.smem_bytes(8, lowrank.MAX_RANK) <= lowrank.MAX_SHARED_BYTES
    assert lowrank.smem_bytes(8, lowrank.MAX_RANK + 1) > lowrank.MAX_SHARED_BYTES
    assert lowrank.MAX_RANK >= 7184  # every rank the 16-row first design took
    with pytest.raises(ValueError, match=str(lowrank.MAX_RANK)):
        lowrank.launch_shape(4, 64, lowrank.MAX_RANK + 1, 64)


@pytest.mark.parametrize("n,d", [(1024, 5632), (1024, 2048), (3136, 2048), (50176, 512),
                                 (200704, 512), (200704, 256), (12544, 1024), (5000, 600),
                                 (70000, 130), (0, 512), (1, 512)])
def test_syrk_split_rows_cover_n(n, d):
    """The SYRK kernel's row splits: a tall Gram of few tiles splits into
    32-row multiples that cover every row once and bring the grid near
    two blocks an SM; a Gram whose tiles fill the card takes one block a
    tile (TinyLlama's 1024 rows at d 2048 and 5632, as before)."""
    from ptdeco_tpu_torch.ops import gram

    rows = gram.split_rows(n, d)
    t = -(-d // 128)
    tiles = t * (t + 1) // 2
    if rows >= n:
        assert rows == n and (tiles >= gram.TARGET_BLOCKS // 2 or n < 2 * gram.MIN_SPLIT_ROWS)
        return
    splits = -(-n // rows)
    assert rows % 32 == 0 and (splits - 1) * rows < n <= splits * rows
    assert rows >= gram.MIN_SPLIT_ROWS - 32 and splits * tiles <= gram.TARGET_BLOCKS


def test_lowrank_rows_within_the_grid():
    """ResNet-50's fused conv pairs at batch 64 (200704 rows at 56 x 56)
    and batch 256 (802816) launch within the grid's 65535 row tiles; past
    them the wrapper raises instead of launching a short grid."""
    for n in (200704, 802816, lowrank.MAX_ROW_TILES * 64):
        shape = lowrank.launch_shape(n, 256, 16, 64)
        assert shape.row_tiles <= lowrank.MAX_ROW_TILES and shape.row_tiles * shape.bm >= n
    with pytest.raises(ValueError, match="row tiles"):
        lowrank.launch_shape(lowrank.MAX_ROW_TILES * 64 + 1, 256, 16, 64)


@pytest.mark.parametrize("n_ctas", [132, 7, 10_000])
@pytest.mark.parametrize("b,h,s", [(1, 8, 1), (2, 4, 127), (1, 3, 129), (2, 8, 1000), (4, 32, 512)])
def test_flash_schedule_covers_every_tile_once_heaviest_first(b, h, s, n_ctas):
    from ptdeco_tpu_torch.ops.flash_attention import BLOCK_M, flash_schedule

    per_cta = flash_schedule(b, h, s, n_ctas)
    n_q = -(-s // BLOCK_M)
    tiles = [tile for cta in per_cta for tile in cta]
    assert sorted(tiles) == [(bh, qt) for bh in range(b * h) for qt in range(n_q)]
    assert len(per_cta) == min(n_ctas, b * h * n_q)
    # each CTA takes its heaviest tile (qt + 1 causal key tiles) first, and
    # the first round of tiles is the heaviest of the walk
    for cta in per_cta:
        work = [qt + 1 for _, qt in cta]
        assert work == sorted(work, reverse=True)
    first = [cta[0][1] for cta in per_cta]
    rest = [qt for cta in per_cta for _, qt in cta[1:]]
    assert not rest or min(first) >= max(rest)


def test_flash_smem_fits_a_cta():
    from ptdeco_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS, smem_bytes

    assert all(smem_bytes(d) <= 232448 for d in KERNEL_HEAD_DIMS)


@pytest.mark.parametrize(
    "sizes,n,bm",
    [([300, 0, 211, 190], 392, 128), ([40, 0, 90, 33], 264, 64), ([513, 130, 7, 900], 512, 128),
     ([0, 0, 77, 0], 256, 128), ([128, 128, 1], 256, 128), ([0, 5], 300, 64)],
)
def test_grouped_schedule_covers_each_group_tile_once(sizes, n, bm):
    from ptdeco_tpu_torch.ops.gmm import WGMMA_BLOCK_COLS, grouped_schedule

    m, bn = sum(sizes), WGMMA_BLOCK_COLS
    tiles = grouped_schedule(sizes, m, n, bm, bn)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    cover = np.zeros((m, -(-n // bn)), np.int64)
    for e, r0, r1, n0 in tiles:
        # no m-tile crosses its group, none is empty or over bm rows
        assert starts[e] <= r0 < r1 <= starts[e + 1] and r1 - r0 <= bm
        assert n0 % bn == 0 and n0 < n
        cover[r0:r1, n0 // bn] += 1
    assert (cover == 1).all()
    # the slot is the fast grid dimension: one n-tile's slots before the next's
    assert [t[3] for t in tiles] == sorted(t[3] for t in tiles)


def test_grouped_route_rule():
    from ptdeco_tpu_torch.ops.gmm import MAX_TMA_EXPERTS, kernel_route, wgmma_smem_bytes

    assert kernel_route(4096, 4096, 14336, 8) == "wgmma"  # Mixtral prefill, 128-row tiles
    assert kernel_route(4096, 14336, 4096, 8) == "wgmma"
    assert kernel_route(512, 4096, 14336, 8) == "wgmma"  # 64-row tiles
    assert kernel_route(16, 4096, 14336, 8) == "mma_sync"  # the 16-row decode tile
    assert kernel_route(4096, 100, 512, 8) == "mma_sync"  # K * 2 not a multiple of 16 bytes
    assert kernel_route(4096, 256, 333, 8) == "mma_sync"  # N * 2 not a multiple of 16 bytes
    assert kernel_route(4096, 0, 512, 8) == "mma_sync"
    # 40-row mean groups: past the expert limit only the count refuses
    assert kernel_route(40 * MAX_TMA_EXPERTS, 256, 512, MAX_TMA_EXPERTS) == "wgmma"
    assert kernel_route(40 * (MAX_TMA_EXPERTS + 1), 256, 512, MAX_TMA_EXPERTS + 1) == "mma_sync"
    assert all(wgmma_smem_bytes(bm) <= 232448 for bm in (64, 128))


def test_int8_route_rule():
    from ptdeco_tpu_torch.ops.gmm import MAX_TMA_EXPERTS
    from ptdeco_tpu_torch.ops.gmm_int8 import batch_rows, kernel_route

    assert kernel_route(8, 4096, 14336, 8) == "decode"  # a decode step of batch 4
    assert kernel_route(16, 14336, 4096, 8) == "decode"  # batch 8
    assert kernel_route(128, 4096, 14336, 8) == "decode"  # a mean group of 16 rows
    assert kernel_route(129, 4096, 14336, 8) == "batch"
    assert kernel_route(512, 4096, 14336, 8) == "batch" and batch_rows(512, 8) == 128
    assert kernel_route(1024, 4096, 14336, 8) == "batch" and batch_rows(1024, 8) == 128
    assert batch_rows(1032, 8) == 256
    assert kernel_route(4096, 14336, 4096, 8) == "batch" and batch_rows(4096, 8) == 256
    assert kernel_route(4096, 100, 512, 8) == "decode"  # K not a multiple of 16 (TMA's pitch)
    assert kernel_route(4096, 4104, 512, 8) == "decode"
    assert kernel_route(4096, 256, 333, 8) == "decode"  # N not a multiple of 8
    assert kernel_route(4096, 0, 512, 8) == "decode"
    assert kernel_route(40 * (MAX_TMA_EXPERTS + 1), 256, 512, MAX_TMA_EXPERTS + 1) == "decode"
    assert kernel_route(40 * MAX_TMA_EXPERTS, 256, 512, MAX_TMA_EXPERTS) == "batch"


@pytest.mark.parametrize(
    "sizes,k,n",
    [([2, 1, 0, 2, 1, 1, 0, 1], 4096, 14336), ([2, 1, 0, 2, 1, 1, 0, 1], 14336, 4096),
     ([2, 3, 1, 2, 4, 1, 2, 1], 4160, 392), ([0, 1, 7, 64, 65, 256, 257, 600], 512, 200),
     ([0, 0, 40, 0], 100, 50), ([3, 0, 5, 0], 0, 128)],
)
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("cols,block_k", [(128, 256), (64, 512)])
def test_decode_schedule_reduces_each_unit_once(sizes, k, n, sms, cols, block_k):
    """Every routed (row, column tile) is one cluster of ks CTAs whose
    k-ranges tile [0, k) in rank order: one deterministic reduction each."""
    from ptdeco_tpu_torch.ops.gmm_int8 import (
        DECODE_ROWS, MAX_SPLIT, decode_schedule, decode_split)

    m = sum(sizes)
    ks, steps = decode_split(m, k, n, len(sizes), sms, block_k, cols)
    assert 1 <= ks <= MAX_SPLIT and ks * steps * block_k >= k
    assert k == 0 or (ks - 1) * steps * block_k < k  # no split without work
    ctas = decode_schedule(sizes, m, k, n, ks, steps, block_k, cols)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    units: dict[tuple, list] = {}
    for e, r0, r1, n0, k0, k1 in ctas:
        assert starts[e] <= r0 < r1 <= starts[e + 1] and r1 - r0 <= DECODE_ROWS
        assert n0 % cols == 0 and n0 < n
        units.setdefault((e, r0, r1, n0), []).append((k0, k1))
    cover = np.zeros((m, -(-n // cols)), np.int64)
    for (e, r0, r1, n0), ranges in units.items():
        assert len(ranges) == ks
        assert [a for a, _ in ranges] == sorted(a for a, _ in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(ranges[i][1] == ranges[i + 1][0] for i in range(ks - 1))
        cover[r0:r1, n0 // cols] += 1
    assert (cover == 1).all()


def test_decode_split_covers_the_card_at_the_decode_shapes():
    """A decode step of batch 4 over 8 experts: the gate/up and the narrow
    down projection both split K until the grid holds several CTAs an SM."""
    from ptdeco_tpu_torch.ops.gmm_int8 import (
        DECODE_COLS, DECODE_CTAS_PER_SM, decode_split)

    for k, n in ((4096, 14336), (14336, 4096)):
        ks, _ = decode_split(8, k, n, 8, 132)
        assert ks * 8 * -(-n // DECODE_COLS) >= DECODE_CTAS_PER_SM * 132
    assert decode_split(8, 4096, 14336, 8, 132)[0] < decode_split(8, 14336, 4096, 8, 132)[0]
    assert decode_split(4096, 4096, 14336, 8, 132)[0] == 1  # enough units already
