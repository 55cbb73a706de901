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
from ptdeco_tpu_torch import ops

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
    assert ops.launch_counts() == {"syrk_gram": 0, "flash_attention": 0, "lowrank_matmul": 0}
