"""The port's weight-only int8 against the JAX package, on the CPU: the
plain grouped int8 product against the Pallas kernel in interpret mode, the
quantization grids, and the serving conversion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import nn as jnn, quant as jquant
from ptdeco_tpu.ops import gmm_int8 as jgmm
from ptdeco_tpu_torch import ops, quant as tquant

from test_torch_moe import tiny_mixtral


@pytest.mark.parametrize("bm", [16, 64])
def test_int8_layout_and_plain_product_match_the_pallas_kernel(bm):
    """Mirrors the JAX package's interpret-mode test: group sizes with an
    empty group and a total that no tile divides.  The JAX kernel runs on
    its padded layout at m-tile ``bm``; the port's product takes the sorted
    rows as they are."""
    rng = np.random.default_rng(0)
    e, k, d_out = 4, 160, 96
    sizes = np.asarray([37, 0, 129, 61], np.int32)
    m = int(sizes.sum())
    lhs = rng.standard_normal((m, k), np.float32)
    w_q = rng.integers(-127, 128, size=(e, k, d_out)).astype(np.int8)  # JAX (E, K, N)
    scale = (0.01 + rng.random((e, d_out))).astype(np.float32)

    n_tiles = -(-m // bm) + e
    jdst, jte, _ = jgmm.pad_groups_for_tiles(jnp.asarray(sizes), m, n_tiles, bm)
    xp = jnp.zeros((n_tiles * bm, k), jnp.float32).at[jdst].set(lhs)
    want = np.asarray(
        jgmm.grouped_matmul_int8(xp, jnp.asarray(w_q), jnp.asarray(scale), jte,
                                 bm=bm, interpret=True)
    )[np.asarray(jdst)]

    got = ops.grouped_matmul_int8(
        torch.from_numpy(lhs),
        [torch.from_numpy(np.ascontiguousarray(w.T)) for w in w_q],
        [torch.from_numpy(s) for s in scale],
        torch.from_numpy(sizes),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-3)


def test_quantize_linear_grids_and_scales_equal_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 40), np.float32)  # torch (out, in)
    w[5] = 0.0  # an all-zero channel: scale 1
    w[7, :3] = [2.0, -2.0, 0.5]  # ties of the absmax
    lin = torch.nn.Linear(40, 48, bias=True)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    q = tquant.quantize_linear(lin)
    jq = jquant.quantize_linear(jnn.Linear(kernel=jnp.asarray(w.T), bias=jnp.zeros(48)))
    np.testing.assert_array_equal(q.weight_q.numpy(), np.asarray(jq.w_q).T)
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
    assert q.scale[5] == 1.0 and q.weight_q.dtype == torch.int8 and q.bias is lin.bias
    # quantizing the dequantized weight reproduces the grid exactly
    again = tquant.quantize_linear(tquant.dequantize_linear(q))
    assert torch.equal(again.weight_q, q.weight_q) and torch.equal(again.scale, q.scale)


def test_quantize_for_serving_skips_router_gates():
    jm, tm = tiny_mixtral()
    tquant.quantize_for_serving(tm, skip_names=["lm_head"])
    jq = jquant.quantize_for_serving(jm, skip_names=["lm_head"])
    ours = {n for n, m in tm.named_modules() if isinstance(m, tquant.QuantLinear)}
    theirs = {n for n, m in jnn.named_modules(jq) if type(m) is jquant.QuantLinear}
    assert ours == theirs
    assert "model.layers.0.mlp.gate" not in ours and "lm_head" not in ours
    assert "model.layers.1.mlp.experts.2.up_proj" in ours
    assert type(tm.model.layers[0].mlp.gate) is torch.nn.Linear
    q = tm.model.layers[1].mlp.experts[2].up_proj
    jw = np.asarray(jnn.get_submodule(jq, "model.layers.1.mlp.experts.2.up_proj").w_q)
    np.testing.assert_array_equal(q.weight_q.numpy(), jw.T)
    tquant.dequantize_for_serving(tm)
    assert not any(isinstance(m, tquant.QuantLinear) for m in tm.modules())
