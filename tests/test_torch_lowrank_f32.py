"""The f32 path of the fused low-rank kernel, on the CPU: its launch shape
(``ops.lowrank.launch_shape_f32``) and a model of its arithmetic.

The kernel forms each product in 3xTF32 on the tensor cores: every f32
operand is split into a TF32 high part (rounded as ``cvt.rna`` rounds: to
nearest, ties away from zero) and the rest, which the tensor cores
truncate to TF32 (they read an operand's top 19 bits), and a * b is taken
as hi*hi + hi*lo + lo*hi.  The model below does the same rounding by bit
operations and sums in f64; at bench.py's MLP pair it must sit far inside
the gate ``chip_smoke.py`` holds the kernel to, 2^-14 * (|ref| + RMS(ref)),
while one-pass TF32 must break that gate: so the gate tells the designs
apart.  The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from ptdeco_tpu_torch.ops import lowrank

# (n, d_in, r, d_out): bench.py's MLP pair (dwain_mlp's served rank 32,
# and rank 256), a decode step into TinyLlama's MLP width, ConvNeXt-Tiny's
# stage-1 pwconv1 and stage-4 pwconv2 pairs (batch 64), and the card
# tests' edges: a rank of 1, ragged shapes, an empty contraction and the
# largest rank
CHIP_SHAPES = [(256, 2048, 32, 2048), (256, 2048, 256, 2048), (8, 2048, 32, 5632),
               (200704, 96, 24, 384), (3136, 3072, 192, 768)]
EDGE_SHAPES = [(3, 70, 1, 9), (17, 130, 33, 257), (1000, 576, 256, 1001), (5, 0, 8, 64),
               (4, 64, lowrank.MAX_RANK_F32, 72), (1, 2048, 32, 9), (4096, 2048, 32, 5632),
               (17, 2048, 32, 1001), (5, 2048, 32, 64)]

GATE = 2.0 ** -14  # chip_smoke.py's f32 kernel lines: GATE * (|ref| + RMS(ref))


@pytest.mark.parametrize("n,d_in,r,d_out", CHIP_SHAPES + EDGE_SHAPES)
def test_launch_shape_f32_contract(n, d_in, r, d_out):
    s = lowrank.launch_shape_f32(n, d_in, r, d_out)
    assert s.bm in lowrank.ROW_TILES_F32
    assert lowrank.smem_bytes_f32(s.bm, r) <= lowrank.MAX_SHARED_BYTES
    k_steps = max(1, -(-d_in // 32))
    # a power of two, at most 8 and at most one CTA per 32-wide step, and
    # each CTA of the cluster owns whole rows of the exchange
    assert 1 <= s.cluster <= min(8, k_steps) and s.cluster & (s.cluster - 1) == 0
    assert s.bm % s.cluster == 0
    assert s.cols_per_cta % 16 == 0
    # every row and every column is written by exactly one CTA
    rows = np.zeros(n, np.int64)
    for t in range(s.row_tiles):
        rows[t * s.bm:(t + 1) * s.bm] += 1
    cols = np.zeros(d_out, np.int64)
    for q in range(s.cluster * s.groups):
        cols[q * s.cols_per_cta:(q + 1) * s.cols_per_cta] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert (s.row_tiles - 1) * s.bm < n
    # about one wave: the grid fits the CTAs the card holds at once unless
    # the row tiles alone exceed them; a column group recomputes the
    # hidden, so groups come only where the grid leaves SMs idle
    slots = lowrank.SM_COUNT * lowrank._ctas_per_sm_f32(s.bm, r)
    assert s.ctas <= slots or (s.cluster == 1 and s.groups == 1)
    assert s.groups == 1 or s.ctas <= lowrank.SM_COUNT


def test_launch_shape_f32_runs_phase_1_once_a_row_tile():
    # dwain_mlp's pair: 16 row tiles of 16 rows, each split over a cluster
    # of 8, one column group: 128 CTAs, no hidden computed twice
    s = lowrank.launch_shape_f32(256, 2048, 32, 2048)
    assert (s.bm, s.cluster, s.groups, s.cols_per_cta) == (16, 8, 1, 256)
    # ConvNeXt's stage-1 pair has rows for 3136 tiles of 64: no split
    s = lowrank.launch_shape_f32(200704, 96, 24, 384)
    assert (s.bm, s.cluster, s.groups, s.row_tiles) == (64, 1, 1, 3136)


def test_smem_bytes_f32_fits_every_rank_it_takes():
    assert lowrank.MAX_RANK_F32 >= 2560  # every rank the first f32 design took
    for r in range(1, lowrank.MAX_RANK_F32 + 1):
        assert lowrank.smem_bytes_f32(16, r) <= lowrank.MAX_SHARED_BYTES
        assert lowrank.kernel_takes(torch.float32, r)
    assert lowrank.smem_bytes_f32(16, lowrank.MAX_RANK_F32 + 1) > lowrank.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match=str(lowrank.MAX_RANK_F32)):
        lowrank.launch_shape_f32(4, 64, lowrank.MAX_RANK_F32 + 1, 64)


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 stored mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the last kept
    bit to the magnitude's bits and clear the 13 dropped bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = torch.tensor(1.0)
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -20, -(1 + ulp / 2), 1 + 3 * ulp / 4, 0.0,
                      3.0])
    want = torch.tensor([1 + ulp, 1.0, -(1 + ulp), 1 + ulp, 0.0, 3.0])
    torch.testing.assert_close(tf32_rna(x), want, rtol=0, atol=0)
    assert tf32_rna(one).item() == 1.0


def tf32_truncate(a: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 toward zero: the tensor cores' reading of an f32 operand."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b (f32 operands) as the tensor cores form it, summed in f64:
    one pass takes hi*hi; three add hi*lo + lo*hi."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
        out += ah.double() @ bl.double() + al.double() @ bh.double()
    return out


def pair_error_to_gate(n, d_in, r, d_out, passes, seed=0) -> float:
    """max |y - ref| / (GATE * (|ref| + RMS(ref))) for the fused pair at
    chip_smoke.py's inputs, the f32 hidden and output rounded once each."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d_in), dtype=np.float32))
    k1 = torch.from_numpy(rng.standard_normal((d_in, r), dtype=np.float32) / np.float32(d_in ** 0.5))
    k2 = torch.from_numpy(rng.standard_normal((r, d_out), dtype=np.float32) / np.float32(r ** 0.5))
    bias = torch.from_numpy(rng.standard_normal(d_out, dtype=np.float32))
    h = product(x, k1, passes).float()
    y = (product(h, k2, passes) + bias.double()).float().double()
    ref = (x.double() @ k1.double()) @ k2.double() + bias.double()
    limit = GATE * (ref.abs() + ref.square().mean().sqrt())
    return float(((y - ref).abs() / limit).max())


@pytest.mark.parametrize("r", [32, 256])
def test_3xtf32_passes_the_f32_gate_and_one_pass_tf32_does_not(r):
    three = pair_error_to_gate(256, 2048, r, 2048, passes=3)
    one = pair_error_to_gate(256, 2048, r, 2048, passes=1)
    assert three * 20 <= 1.0, three
    assert one > 1.0, one
