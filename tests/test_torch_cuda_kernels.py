"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at ragged and odd shapes (the main path's shapes are checked
by chip_smoke.py).  Every test here needs a CUDA device and skips without
one.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from ptdeco_tpu_torch import nn as tnn, ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    return torch.device("cuda")


@pytest.mark.parametrize("n,d", [(1024, 512), (100, 300), (37, 1030), (5, 129), (0, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_syrk_gram(dev, n, d, dtype):
    y = torch.randn(n, d, device=dev).to(dtype)
    before = ops.syrk_gram.launches
    g = ops.syrk_gram(y)
    torch.cuda.synchronize()
    assert ops.syrk_gram.launches == before + 1
    ref = ops.syrk_gram_plain(y)
    # f32 sums in another order; bf16 products are exact in f32
    scale = max(float(ref.abs().max()), 1.0)
    torch.testing.assert_close(g, ref, rtol=0, atol=3e-5 * scale)
    assert torch.equal(g, g.t())


@pytest.mark.parametrize(
    "b,h,h_kv,s,d", [(1, 4, 4, 128, 64), (2, 4, 2, 100, 64), (1, 2, 1, 70, 128), (1, 8, 2, 1, 64)]
)
def test_flash_attention(dev, b, h, h_kv, s, d):
    q = torch.randn(b, h, s, d, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, device=dev, dtype=torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, device=dev, dtype=torch.bfloat16)
    out = ops.flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    ref = ops.causal_attention_plain(q, k, v, d ** -0.5)
    # both round p (or softmax(p)) to bf16 before PV, at different points
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=3e-2)


def test_flash_attention_backward_recomputes(dev):
    q, k, v = (torch.randn(1, 2, 64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    ops.flash_attention(q, k, v, 0.125).float().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_flash_attention_rejects_unsupported(dev):
    q = torch.randn(1, 2, 8, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, 0.1)
    with pytest.raises(ValueError):
        ops.flash_attention(q.float(), q.float(), q.float(), 0.1)


@pytest.mark.parametrize(
    "n,d_in,r,d_out,bias",
    [(256, 256, 128, 512, True), (1000, 2048, 44, 5632, True), (3, 70, 1, 9, False),
     (17, 130, 33, 257, True), (64, 512, 1024, 640, False)],
)
def test_lowrank_matmul(dev, n, d_in, r, d_out, bias):
    x = torch.randn(n, d_in, device=dev, dtype=torch.bfloat16)
    k1 = (torch.randn(d_in, r, device=dev) / d_in ** 0.5).to(torch.bfloat16)
    k2 = (torch.randn(r, d_out, device=dev) / r ** 0.5).to(torch.bfloat16)
    b = torch.randn(d_out, device=dev, dtype=torch.bfloat16) if bias else None
    y = ops.lowrank_matmul(x, k1, k2, b)
    torch.cuda.synchronize()
    ref = ops.lowrank_matmul_plain(x, k1, k2, b)
    # the hidden is rounded to bf16 in both; sums differ in order only
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_lowrank_matmul_rejects_unsupported(dev):
    x = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError):
        ops.lowrank_matmul(x, torch.randn(8, 2, device=dev), torch.randn(2, 8, device=dev))
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):  # a hidden over the shared-memory limit
        ops.lowrank_matmul(xb, torch.zeros(8, 8000, device=dev, dtype=torch.bfloat16),
                           torch.zeros(8000, 8, device=dev, dtype=torch.bfloat16))


def test_fused_linear_pair_launches_the_kernel(dev):
    pair = torch.nn.Sequential(
        torch.nn.Linear(64, 8, bias=False), torch.nn.Linear(8, 96)
    ).to(dev, torch.bfloat16)
    x = torch.randn(5, 7, 64, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        ref = pair(x)
        root = torch.nn.Sequential(pair)
        tnn.fuse_factor_pairs(root)
        before = ops.lowrank_matmul.launches
        y = root(x)
    assert ops.lowrank_matmul.launches == before + 1
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_views_with_unaligned_starts(dev):
    def view(*shape):  # contiguous, starting one element into its storage
        n = 1
        for s in shape:
            n *= s
        return torch.randn(n + 1, device=dev, dtype=torch.bfloat16)[1:].view(*shape)

    y = view(64, 512)
    torch.testing.assert_close(ops.syrk_gram(y), ops.syrk_gram_plain(y), rtol=0, atol=1e-3)
    q, k, v = view(1, 2, 64, 64), view(1, 1, 64, 64), view(1, 1, 64, 64)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, 0.125).float(),
        ops.causal_attention_plain(q, k, v, 0.125).float(), rtol=0, atol=3e-2,
    )
    x, k1, k2 = view(8, 64), view(64, 16), view(16, 32)
    torch.testing.assert_close(
        ops.lowrank_matmul(x, k1, k2).float(), ops.lowrank_matmul_plain(x, k1, k2, None).float(),
        rtol=2e-2, atol=2e-2,
    )
