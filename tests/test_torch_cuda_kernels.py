"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at ragged and odd shapes (the main path's shapes are checked
by chip_smoke.py).  Every test here needs a CUDA device and skips without
one.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import ctypes

import pytest
import torch

from ptdeco_tpu_torch import nn as tnn, ops
from ptdeco_tpu_torch.ops import _build, lowrank

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n,d",
    [(100, 300), (37, 1030), (5, 129), (0, 256), (1, 130), (64, 2050)]
    + [(n, d) for d in (512, 600, 5632) for n in (1, 37, 1024)]
    # GPT-J-6B's and OPT-6.7B's width
    + [(1024, 4096)]
    # rows split over blocks (TMA and cp.async panels, a ragged last split),
    # and one block a tile summing several 4096-row chunks
    + [(5000, 512), (5000, 600), (70000, 130), (9000, 2048)]
    # Moshi's gated MLP (11264) and Mllama's (14336)
    + [(1024, 11264), (1024, 14336)]
    # DeepSeek-V3's width (7168) and q_lora (1536), DeepSeek-V2-Lite's dense
    # MLP (10944, off the 128 grid) and the latent plus rope head (576)
    + [(1024, 7168), (1024, 10944), (1024, 1536), (1024, 576)],
)
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
    "b,h,h_kv,s,d",
    [(1, 4, 4, 128, 64), (2, 4, 2, 100, 64), (1, 2, 1, 70, 128), (1, 8, 2, 1, 64),
     # Qwen2-1.5B's heads (group 6) and Gemma-2B's (head dim 256, one kv head)
     (1, 12, 2, 300, 128), (1, 8, 1, 300, 256), (2, 4, 2, 257, 256),
     # head dim 96 on the 128 instance: Phi-3-mini's ungrouped heads, grouped
     # heads and ragged sequences
     (1, 32, 32, 1024, 96), (2, 8, 2, 300, 96), (1, 4, 1, 77, 96), (3, 6, 3, 129, 96),
     # GPT-J-6B's heads (head dim 256 with no grouping), OPT-6.7B's (32 / 32
     # of 128) and StarCoderBase-1B's (16 over one kv head of 128), whole
     # and ragged
     (1, 16, 16, 1024, 256), (2, 16, 16, 257, 256), (1, 32, 32, 1024, 128),
     (2, 32, 32, 300, 128), (1, 16, 1, 1024, 128), (3, 16, 1, 129, 128),
     # BitNet's 20 query heads over 5 kv heads of 128: the walk's 1 x 1024,
     # its cached generate's 4 x 128 prefill, and ragged
     (1, 20, 5, 1024, 128), (4, 20, 5, 128, 128), (2, 20, 5, 301, 128),
     # Mllama's text model's 32 query heads over 8 kv heads of 128: the walk's
     # 1 x 1024, its cached generate's 4 x 128 prefill, and ragged
     (1, 32, 8, 1024, 128), (4, 32, 8, 128, 128), (2, 32, 8, 301, 128)],
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


@pytest.mark.parametrize(
    "b,h,h_kv,s,d",
    [(1, 20, 20, 1024, 128), (2, 4, 4, 129, 128), (1, 8, 2, 300, 64), (1, 16, 16, 257, 256)],
)
def test_flash_attention_unscaled(dev, b, h, h_kv, s, d):
    """Scale 1 (GPT-Neo's and unscaled GPTBigCode's logits), at about
    sqrt(d) times the usual logits: the online max and the exp2 rescaling
    keep every row normalised."""
    q = torch.randn(b, h, s, d, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, device=dev, dtype=torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, device=dev, dtype=torch.bfloat16)
    out = ops.flash_attention(q, k, v, 1.0)
    torch.cuda.synchronize()
    ref = ops.causal_attention_plain(q, k, v, 1.0)
    assert torch.isfinite(out).all()
    # a row's probabilities nearly pick one value of v, so outputs reach
    # |4| and more, where each side's rounding to bf16 is an ulp of up to
    # 2^-7 |ref|
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -6, atol=3e-2)


@pytest.mark.parametrize("n_heads,n_kv", [(32, 32), (6, 6), (4, 2)])
def test_alibi_attention_takes_no_flash(dev, n_heads, n_kv):
    """A bf16 ALiBi layer on the card (BLOOM's 32 heads of 128, 6 heads, a
    count that is not a power of two, and MPT's grouped heads) launches no
    flash kernel, which has no logit bias, and equals its f32 twin on the
    card within bf16's rounding; the same layer without the bias takes
    flash and gives other outputs."""
    import dataclasses

    from ptdeco_tpu_torch import models

    cfg = models.TransformerConfig(
        vocab_size=64, dim=n_heads * 128, n_layers=1, n_heads=n_heads, n_kv_heads=n_kv,
        hidden_dim=64, norm_type="layernorm", qkv_bias=True, o_proj_bias=True, use_rope=False,
        use_alibi=True, dtype=torch.float32)
    twin = models.transformer.Attention(cfg, dev)
    layer = models.transformer.Attention(dataclasses.replace(cfg, dtype=torch.bfloat16), dev)
    layer.load_state_dict(twin.state_dict())
    x = torch.randn(2, 300, cfg.dim, device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = layer(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 0
        ref = twin(x)
        # bf16 inputs, weights, probabilities and output against f32
        torch.testing.assert_close(out.float(), ref, rtol=0, atol=5e-2 * float(ref.abs().max()))
        layer.use_alibi = False
        plain = layer(x.to(torch.bfloat16))
        torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert float((plain.float() - out.float()).abs().max()) > 0.1 * float(ref.abs().max())


@pytest.mark.parametrize("kind", ["doge", "diffllama"])
def test_mixer_layers_take_no_flash(dev, kind):
    """A bf16 one-layer doge model (its dynamic-mask key bias) and a
    diffllama one (differential attention) on the card launch no flash
    kernel, in the forward or in a cached prefill from an empty cache, and
    equal their f32 twins on the card within bf16's rounding; the doge
    layer without its bias takes flash and gives other logits."""
    import dataclasses

    from ptdeco_tpu_torch import models, serving

    knobs = (dict(dyn_mask_keep_window=2048, residual_scales=True, qk_norm=True, n_kv_heads=4)
             if kind == "doge" else dict(diff_attention=True, n_kv_heads=8))
    cfg = models.TransformerConfig(vocab_size=64, dim=1024, n_layers=1, n_heads=8,
                                   hidden_dim=256, dtype=torch.float32, **knobs)
    twin = models.CausalLM(cfg, dev)
    if kind == "doge":  # A off zeros (a constant bias the softmax drops)
        with torch.no_grad():
            twin.model.layers[0].self_attn.dyn_mask_A.normal_()
    lm = models.CausalLM(dataclasses.replace(cfg, dtype=torch.bfloat16), dev)
    lm.load_state_dict(twin.state_dict())
    ids = torch.randint(0, 64, (2, 300), device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = lm(ids)
        cached, _ = serving.forward_with_cache(lm, ids, serving.init_cache(lm, 2, 300), 0)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 0
        ref = twin(ids)
        # bf16 inputs, weights, probabilities and output against f32
        tol = 5e-2 * float(ref.abs().max())
        torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)
        torch.testing.assert_close(cached.float(), ref, rtol=0, atol=tol)
        if kind == "doge":
            lm.model.layers[0].self_attn.dt_proj = None
            plain = lm(ids)
            torch.cuda.synchronize()
            assert ops.launch_counts()["flash_attention"] == 1
            assert float((plain.float() - out.float()).abs().max()) > 0.1 * float(ref.abs().max())


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("s", [1, 63, 127, 129, 1000])
def test_flash_attention_edges(dev, s, d, rep):
    """Sequences shorter than, one past and ragged against the 128-row tile
    (and the 64-key tile of head dim 256), at every head dim and
    grouped-query repeats of 1, 4 and 8."""
    h = 8
    q = torch.randn(1, h, s, d, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, h // rep, s, d, device=dev, dtype=torch.bfloat16)
    v = torch.randn(1, h // rep, s, d, device=dev, dtype=torch.bfloat16)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    ref = ops.causal_attention_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=3e-2)


@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_flash_attention_strided_views(dev, d):
    """The model's transposed (b, s, h, d) views are read as they lie and the
    output takes q's layout; a view whose seq stride TMA cannot address
    (not a multiple of 8 elements) is copied first, with the same result."""
    from ptdeco_tpu_torch.ops.flash_attention import _tma_strides

    b, s, h, h_kv = 2, 200, 8, 2
    q = torch.randn(b, s, h, d, device=dev, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.randn(b, s, h_kv, d, device=dev, dtype=torch.bfloat16).transpose(1, 2)
    v = torch.randn(b, s, h_kv, d, device=dev, dtype=torch.bfloat16).transpose(1, 2)
    assert all(_tma_strides(t) is not None for t in (q, k, v))
    out = ops.flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    ref = ops.causal_attention_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=3e-2)
    odd = torch.randn(b, h, s, d + 4, device=dev, dtype=torch.bfloat16)[..., :d]
    assert _tma_strides(odd) is None
    out = ops.flash_attention(odd, k, v, d ** -0.5)
    torch.cuda.synchronize()
    ref = ops.causal_attention_plain(odd, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=3e-2)


def test_flash_smem_bytes_agree(dev):
    import importlib

    fa = importlib.import_module("ptdeco_tpu_torch.ops.flash_attention")
    fn = _build.kernel_function("flash_attention_fwd", "ptdeco_flash_smem_bytes", [ctypes.c_int])
    for d in fa.KERNEL_HEAD_DIMS:
        assert fn(d) == fa.smem_bytes(d)
    assert fn(80) == fn(96) == fn(128)  # the 128 instance runs head dims 80 and 96
    assert fn(72) == 0


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
    q = torch.randn(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sm_scale"):  # the kernel takes the max before scaling
        ops.flash_attention(q, q, q, -0.125)


@pytest.mark.parametrize(
    "n,d_in,r,d_out,bias",
    [(256, 256, 128, 512, True), (1000, 2048, 44, 5632, True), (3, 70, 1, 9, False),
     (17, 130, 33, 257, True), (64, 512, 1024, 640, False), (4, 64, 7184, 72, True)]
    # the served site's row counts (a decode step of 4, a 4 x 128 prefill,
    # one row), ranks from 1 to past the 16-row tile's limit, d_out that is
    # a multiple of no tile
    + [(n, 576, r, 1001, bias) for n in (1, 4, 512) for r in (1, 17, 256, 1500)
       for bias in (True, False)]
    # GPT-J-6B's and OPT-6.7B's biased MLP pairs, StarCoderBase-1B's k/v
    # pairs with 128-wide outputs (a prefill and a decode step)
    + [(1024, 4096, 32, 16384, True), (1024, 16384, 32, 4096, True), (1024, 2048, 32, 128, True),
       (4, 2048, 32, 128, True)]
    # Moshi's (4096 <-> 11264) and Mllama's (4096 <-> 14336) MLP pairs, a
    # prefill and a decode step
    + [(1024, 4096, 32, 11264, False), (1024, 11264, 32, 4096, False),
       (1024, 4096, 32, 14336, False), (4, 14336, 32, 4096, False)]
    # DeepSeek's pairs at their walks' ranks off the 16 grid: V3's q_a / q_b
    # at 24, kv_a_proj_with_mqa at 18, o_proj at 28; V2-Lite's dense MLP
    # (10944) at 32; a prefill and a decode step
    + [(1024, 7168, 24, 1536, False), (4, 1536, 24, 24576, False), (1024, 7168, 18, 576, False),
       (1024, 16384, 28, 7168, False), (4, 10944, 32, 2048, False),
       (1024, 2048, 32, 10944, False)],
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


@pytest.fixture
def no_tf32():
    """f32 references in full f32: cuBLAS without TF32."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize(
    "n,d_in,r,d_out,bias",
    # bench.py's MLP pair (rank 32 at d 2048), ranks from 1 to the f32
    # limit, ragged rows and columns, an empty contraction
    [(256, 2048, 32, 2048, True), (3, 70, 1, 9, False), (17, 130, 33, 257, True),
     (1000, 576, 256, 1001, False), (4, 64, lowrank.MAX_RANK_F32, 72, True),
     (5, 0, 8, 64, True),
     # a decode step split into column groups; 64-row tiles in clusters of
     # 4; 32-row tiles in clusters of 2; hidden chunks 64 and 96 wide (k
     # split over 2 warps, 6 warps busy) and 128 + 96; a rank whose W2 rows
     # TMA cannot address; ConvNeXt's stage-1 pair in 64-row tiles
     (8, 2048, 32, 5632, False), (4096, 2048, 32, 5632, True), (3136, 3072, 192, 768, True),
     (300, 512, 36, 200, True), (77, 512, 96, 130, False), (64, 512, 200, 200, True),
     (130, 256, 30, 96, True), (20000, 96, 24, 384, True)],
)
def test_lowrank_matmul_f32(dev, no_tf32, n, d_in, r, d_out, bias):
    x = torch.randn(n, d_in, device=dev)
    k1 = torch.randn(d_in, r, device=dev) / max(d_in, 1) ** 0.5
    k2 = torch.randn(r, d_out, device=dev) / r ** 0.5
    b = torch.randn(d_out, device=dev) if bias else None
    ops.reset_launch_counts()
    y = ops.lowrank_matmul(x, k1, k2, b)
    torch.cuda.synchronize()
    assert ops.lowrank_matmul.launches == 1
    ref = ops.lowrank_matmul_plain(x, k1, k2, b)
    # f32 sums of f32 products in another order
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)


def test_lowrank_matmul_rejects_unsupported(dev):
    x = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError):  # an f16 input
        ops.lowrank_matmul(x.half(), torch.randn(8, 2, device=dev).half(),
                           torch.randn(2, 8, device=dev).half())
    with pytest.raises(ValueError):  # mixed dtypes
        ops.lowrank_matmul(x, torch.randn(8, 2, device=dev).to(torch.bfloat16),
                           torch.randn(2, 8, device=dev).to(torch.bfloat16))
    r = lowrank.MAX_RANK_F32 + 64  # an f32 hidden over the shared-memory limit
    with pytest.raises(ValueError, match=str(lowrank.MAX_RANK_F32)):
        ops.lowrank_matmul(x, torch.zeros(8, r, device=dev), torch.zeros(r, 8, device=dev))
    xb = x.to(torch.bfloat16)
    r = 12000  # a hidden over the shared-memory limit (MAX_RANK, 10944)
    with pytest.raises(ValueError, match=str(lowrank.MAX_RANK)):
        ops.lowrank_matmul(xb, torch.zeros(8, r, device=dev, dtype=torch.bfloat16),
                           torch.zeros(r, 8, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("bm", lowrank.ROW_TILES)
def test_lowrank_smem_bytes_agree(dev, bm):
    fn = _build.kernel_function("lowrank_matmul", "ptdeco_lowrank_smem_bytes",
                                [ctypes.c_int, ctypes.c_int])
    for r in (1, 32, 64, 65, 256, 1500, lowrank.MAX_RANK):
        assert fn(r, bm) == lowrank.smem_bytes(bm, r)
    fn32 = _build.kernel_function("lowrank_matmul", "ptdeco_lowrank_f32_smem_bytes",
                                  [ctypes.c_int, ctypes.c_int])
    if bm in lowrank.ROW_TILES_F32:
        for r in (1, 32, 65, 1500, lowrank.MAX_RANK_F32):
            assert fn32(r, bm) == lowrank.smem_bytes_f32(bm, r)


@pytest.mark.parametrize("n,d_in,r,d_out", [(256, 2048, 32, 2048), (3136, 3072, 192, 768),
                                            (17, 130, 33, 257)])
def test_lowrank_matmul_f32_is_deterministic(dev, n, d_in, r, d_out):
    """The cluster sums its partials in rank order: the same bits every run."""
    x = torch.randn(n, d_in, device=dev)
    k1 = torch.randn(d_in, r, device=dev) / d_in ** 0.5
    k2 = torch.randn(r, d_out, device=dev) / r ** 0.5
    b = torch.randn(d_out, device=dev)
    first = ops.lowrank_matmul(x, k1, k2, b)
    assert all(torch.equal(first, ops.lowrank_matmul(x, k1, k2, b)) for _ in range(3))


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


def test_fused_f32_pair_launches_the_kernel(dev, no_tf32):
    pair = torch.nn.Sequential(torch.nn.Linear(64, 8, bias=False), torch.nn.Linear(8, 96)).to(dev)
    root = torch.nn.Sequential(pair)
    x = torch.randn(5, 3, 64, device=dev)
    with torch.no_grad():
        ref = root(x)
        tnn.fuse_factor_pairs(root)
        ops.reset_launch_counts()
        y = root(x)
    assert type(root[0]) is tnn.FusedLowRankLinear and ops.lowrank_matmul.launches == 1
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)


def test_fuse_leaves_a_pair_over_max_rank_unfused(dev):
    r = lowrank.MAX_RANK + 64
    pair = torch.nn.Sequential(
        torch.nn.Linear(64, r, bias=False), torch.nn.Linear(r, 96)
    ).to(dev, torch.bfloat16)
    root = torch.nn.Sequential(pair)
    tnn.fuse_factor_pairs(root)
    assert root[0] is pair


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
    for n, d_in, r, d_out in ((8, 64, 16, 32), (512, 2048, 32, 5632)):
        x, k1, k2, b = view(n, d_in), view(d_in, r) / d_in ** 0.5, view(r, d_out), view(d_out)
        torch.testing.assert_close(
            ops.lowrank_matmul(x, k1, k2, b).float(),
            ops.lowrank_matmul_plain(x, k1, k2, b).float(), rtol=2e-2, atol=2e-2,
        )


def _bf16_limit(ref):
    """One bf16 rounding of the f32 sum (at most 2^-7 |ref|), plus room for
    f32 sums taken in another order near zero."""
    return 2.0 ** -7 * ref.abs() + 1e-3 * ref.square().mean().sqrt()


def _assert_within(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= _bf16_limit(ref)).all()), float((out - ref).abs().max())


@pytest.mark.parametrize(
    "sizes,k,n",
    [
        ([37, 0, 129, 74], 128, 256),  # an empty expert
        ([1], 64, 64),  # one row
        ([5, 0, 0, 300], 200, 333),  # K and N not multiples of the tile
        ([3, 9], 100, 70),  # a row pitch that is not a multiple of 16 bytes
        ([0, 0, 77, 0], 512, 160),  # every row routed to one expert
        ([2, 3, 1, 2, 4, 1, 2, 1], 1024, 512),  # decode: 16-row tiles
        ([20, 41, 33, 7, 60, 30, 40, 25], 256, 384),  # 64-row tiles
        ([90, 200, 150, 40, 160, 130, 170, 84], 512, 384),  # 128-row tiles
    ],
)
def test_grouped_matmul(dev, sizes, k, n):
    m = sum(sizes)
    lhs = torch.randn(m, k, device=dev).to(torch.bfloat16)
    weights = [(torch.randn(n, k, device=dev) / k ** 0.5).to(torch.bfloat16) for _ in sizes]
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = ops.grouped_matmul.launches
    out = ops.grouped_matmul(lhs, weights, group_sizes)
    torch.cuda.synchronize()
    assert ops.grouped_matmul.launches == before + 1
    _assert_within(out, ops.grouped_matmul_plain(lhs, weights, group_sizes))


def _grouped_route_launches():
    return dict(ops.grouped_matmul.route_launches)


@pytest.mark.parametrize(
    "sizes,k,n",
    [
        ([300, 0, 211, 190], 200, 392),  # 128-row tiles: empty expert, ragged M, N, K
        ([40, 0, 90, 33], 136, 264),  # 64-row tiles: the same edges
        ([513, 130, 7, 900], 4096, 512),  # K of the served model, groups ending mid-tile
    ],
)
def test_grouped_matmul_wgmma_edges(dev, sizes, k, n):
    """The TMA + wgmma route at the edges it must mask: an empty expert, M
    not a multiple of the m-tile, N not a multiple of 256, K not a multiple
    of 64."""
    from ptdeco_tpu_torch.ops import gmm

    m = sum(sizes)
    assert gmm.kernel_route(m, k, n, len(sizes)) == "wgmma"
    lhs = torch.randn(m, k, device=dev).to(torch.bfloat16)
    weights = [(torch.randn(n, k, device=dev) / k ** 0.5).to(torch.bfloat16) for _ in sizes]
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = _grouped_route_launches()
    out = ops.grouped_matmul(lhs, weights, group_sizes)
    torch.cuda.synchronize()
    assert _grouped_route_launches()["wgmma"] == before["wgmma"] + 1
    _assert_within(out, ops.grouped_matmul_plain(lhs, weights, group_sizes))


@pytest.mark.parametrize("sizes", [[200, 312, 77, 435], [50, 90, 33, 70]])
def test_grouped_matmul_wgmma_keeps_to_its_group(dev, sizes):
    """Groups that end inside an m-tile (128 rows, then 64): the tile's rows
    past its group are multiplied by the wrong expert, so a store of them
    would overwrite the next group's output.  Small integers make every
    product and sum exact, so the output must equal the plain version's
    exactly, neighbouring rows included."""
    from ptdeco_tpu_torch.ops import gmm

    m, k, n = sum(sizes), 256, 512
    assert gmm.kernel_route(m, k, n, len(sizes)) == "wgmma"
    g = torch.Generator(device=dev).manual_seed(3)
    lhs = torch.randint(-2, 3, (m, k), device=dev, generator=g).to(torch.bfloat16)
    weights = [torch.randint(-2, 3, (n, k), device=dev, generator=g).to(torch.bfloat16)
               for _ in sizes]
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    out = ops.grouped_matmul(lhs, weights, group_sizes)
    torch.cuda.synchronize()
    ref = ops.grouped_matmul_plain(lhs, weights, group_sizes)
    ends = torch.tensor(sizes).cumsum(0)[:-1].tolist()
    for end in ends:  # the next group's first rows
        assert torch.equal(out[end:end + 64], ref[end:end + 64]), end
    assert torch.equal(out, ref)


@pytest.mark.parametrize(
    "sizes,k,n,route",
    [
        ([300, 200, 100, 400], 256, 512, "wgmma"),  # prefill, 128-row tiles
        ([60, 40, 50, 70], 256, 512, "wgmma"),  # 64-row tiles
        ([2, 3, 1, 2], 256, 512, "mma_sync"),  # the 16-row decode tile
        ([300, 200, 100, 400], 100, 512, "mma_sync"),  # K * 2 not a multiple of 16 bytes
        ([300, 200, 100, 400], 256, 333, "mma_sync"),  # N * 2 not a multiple of 16 bytes
        ([40] * 17, 256, 512, "wgmma"),  # past the 16 maps a kernel's parameters held
        ([40] * 257, 256, 512, "mma_sync"),  # more experts than the map table takes
    ],
)
def test_grouped_matmul_route_rule(dev, sizes, k, n, route):
    """One case per rule of ``kernel_route``, asserting the route taken."""
    from ptdeco_tpu_torch.ops import gmm

    m = sum(sizes)
    assert gmm.kernel_route(m, k, n, len(sizes)) == route
    lhs = torch.randn(m, k, device=dev).to(torch.bfloat16)
    weights = [(torch.randn(n, k, device=dev) / k ** 0.5).to(torch.bfloat16) for _ in sizes]
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = _grouped_route_launches()
    out = ops.grouped_matmul(lhs, weights, group_sizes)
    torch.cuda.synchronize()
    after = _grouped_route_launches()
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in ("wgmma", "mma_sync")}
    _assert_within(out, ops.grouped_matmul_plain(lhs, weights, group_sizes))


def test_grouped_wgmma_smem_bytes_agree(dev):
    from ptdeco_tpu_torch.ops import gmm

    fn = _build.kernel_function("grouped_matmul", "ptdeco_grouped_wgmma_smem_bytes",
                                [ctypes.c_int])
    for bm in (64, 128):
        assert fn(bm) == gmm.wgmma_smem_bytes(bm)
    assert fn(16) == 0
    most = _build.kernel_function("grouped_matmul", "ptdeco_grouped_wgmma_max_experts", [])
    assert most() == gmm.MAX_TMA_EXPERTS
    most = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_batch_max_experts", [])
    assert most() == gmm.MAX_TMA_EXPERTS


@pytest.mark.parametrize("e,k,n", [(60, 2048, 1408), (64, 1024, 2048), (128, 2048, 768)])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_many_experts_take_the_tensor_core_routes(dev, e, k, n, kind):
    """Qwen1.5-MoE's 60, OLMoE's 64 and Qwen3-MoE's 128 experts at a
    prefill's mean group of 32-64 rows (some experts unrouted): the bf16
    kernel's wgmma route and the int8 kernel's batch route, each reading
    its experts' tensor maps from a device table.  A second call finds the
    table encoded already and gives the same bits."""
    from ptdeco_tpu_torch.ops import gmm, gmm_int8

    g = torch.Generator().manual_seed(e)
    sizes = (torch.randint(0, 97, (e,), generator=g) * (torch.rand(e, generator=g) > 0.1)).tolist()
    m = sum(sizes)
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    lhs = torch.randn(m, k, device=dev).to(torch.bfloat16)
    if kind == "bf16":
        assert gmm.kernel_route(m, k, n, e) == "wgmma"
        w = [(torch.randn(n, k, device=dev) / k ** 0.5).to(torch.bfloat16) for _ in sizes]
        run = lambda: ops.grouped_matmul(lhs, w, group_sizes)  # noqa: E731
        plain = ops.grouped_matmul_plain(lhs, w, group_sizes)
        routes, route = ops.grouped_matmul.route_launches, "wgmma"
    else:
        assert gmm_int8.kernel_route(m, k, n, e) == "batch"
        w_q, scales, _ = _int8_case(dev, sizes, k, n)[1:]
        run = lambda: ops.grouped_matmul_int8(lhs, w_q, scales, group_sizes)  # noqa: E731
        plain = ops.grouped_matmul_int8_plain(lhs, w_q, scales, group_sizes)
        routes, route = ops.grouped_matmul_int8.route_launches, "batch"
    before = routes[route]
    first = run()
    tables = dict(_build._map_tables)
    second = run()
    torch.cuda.synchronize()
    assert routes[route] == before + 2
    assert _build._map_tables.keys() == tables.keys()  # the second call encoded nothing
    assert torch.equal(first, second)
    _assert_within(first, plain)


def test_grouped_matmul_rejects_unsupported(dev):
    lhs = torch.randn(4, 8, device=dev)
    w = [torch.randn(8, 8, device=dev)]
    with pytest.raises(ValueError):
        ops.grouped_matmul(lhs, w, torch.tensor([4], device=dev))
    with pytest.raises(ValueError):
        ops.grouped_matmul(lhs.bfloat16(), [torch.zeros(8, 9, device=dev, dtype=torch.bfloat16)],
                           torch.tensor([4], device=dev))


def _int8_case(dev, sizes, k, n):
    m = sum(sizes)
    lhs = torch.randn(m, k, device=dev).to(torch.bfloat16)
    w_q = [torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8) for _ in sizes]
    scales = [0.01 + torch.rand(n, device=dev) for _ in sizes]
    return lhs, w_q, scales, torch.tensor(sizes, dtype=torch.int32, device=dev)


# (sizes, k, n): one case per edge of the two routes
_INT8_CASES = [
    ([37, 0, 129, 61], 160, 96),  # an empty expert
    ([0, 1, 0], 64, 64),  # one row
    ([5, 0, 13], 208, 333),  # K and N not multiples of the tile
    ([3, 9], 100, 50),  # a row pitch that is not a multiple of 16 bytes
    ([0, 0, 40, 0], 512, 256),  # every row routed to one expert
    ([2, 3, 1, 2, 4, 1, 2, 1], 1024, 512),  # decode
    ([60, 40, 50, 70], 256, 392),  # 128-row batch tiles, an N tail
    ([100, 130, 120, 150], 4112, 256),  # K not a multiple of 64
    ([0, 1, 7, 64, 65, 256, 257, 600], 512, 392),  # groups of every size around the tiles
    ([0, 0, 600, 0], 4160, 136),  # all rows in one expert, K not a multiple of 256
]


def _batch_takes(k, n, e):
    from ptdeco_tpu_torch.ops import gmm

    return k % 16 == 0 and n % 8 == 0 and e <= gmm.MAX_TMA_EXPERTS


@pytest.mark.parametrize(
    "sizes,k,n,route",
    [(*c, r) for c in _INT8_CASES for r in ("decode", "batch")
     if r == "decode" or _batch_takes(c[1], c[2], len(c[0]))],
)
def test_gmm_int8(dev, monkeypatch, sizes, k, n, route):
    """Each case on each route that takes its shape, whatever its mean
    group size; the launch is counted once, on that route."""
    from ptdeco_tpu_torch.ops import gmm_int8

    monkeypatch.setattr(gmm_int8, "kernel_route", lambda m, k, n, e: route)
    lhs, w_q, scales, group_sizes = _int8_case(dev, sizes, k, n)
    before = ops.grouped_matmul_int8.launches
    routes = dict(ops.grouped_matmul_int8.route_launches)
    out = ops.grouped_matmul_int8(lhs, w_q, scales, group_sizes)
    torch.cuda.synchronize()
    assert ops.grouped_matmul_int8.launches == before + 1
    assert ops.grouped_matmul_int8.route_launches[route] == routes[route] + 1
    _assert_within(out, ops.grouped_matmul_int8_plain(lhs, w_q, scales, group_sizes))


@pytest.mark.parametrize("k,n", [(4096, 1024), (14336, 512), (4160, 392)])
def test_gmm_int8_split_k_is_deterministic(dev, k, n):
    """The decode route at decode's rows with K split over a cluster: the
    partials are summed in a fixed order, so two runs give the same bits."""
    from ptdeco_tpu_torch.ops import gmm_int8

    sizes = [2, 1, 0, 2, 1, 1, 0, 1]
    m = sum(sizes)
    assert gmm_int8.kernel_route(m, k, n, len(sizes)) == "decode"
    ks, _ = gmm_int8.decode_split(m, k, n, len(sizes), gmm_int8._sm_count(dev.index or 0))
    assert ks > 1
    lhs, w_q, scales, group_sizes = _int8_case(dev, sizes, k, n)
    first = ops.grouped_matmul_int8(lhs, w_q, scales, group_sizes)
    second = ops.grouped_matmul_int8(lhs, w_q, scales, group_sizes)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_within(first, ops.grouped_matmul_int8_plain(lhs, w_q, scales, group_sizes))


@pytest.mark.parametrize("route", ["decode", "batch"])
def test_gmm_int8_reads_no_weight_for_an_empty_tile(dev, route):
    """An unrouted expert's pointers are null: any read of them (by its own
    tile slot or by a trailing empty slot) faults, so a clean run shows that
    empty slots read no weight.  The batch route's table holds a zero map
    for a null grid."""
    from ptdeco_tpu_torch.ops import _build, gmm_int8

    sizes, k, n = ([3, 0, 5, 0], 256, 384) if route == "decode" else ([90, 0, 70, 0], 256, 384)
    lhs, w_q, scales, group_sizes = _int8_case(dev, sizes, k, n)
    m, e = lhs.shape[0], len(sizes)
    assert gmm_int8.kernel_route(m, k, n, e) == route
    live = [s > 0 for s in sizes]
    sptrs = torch.tensor([s.data_ptr() if ok else 0 for s, ok in zip(scales, live)], device=dev)
    out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    if route == "decode":
        ptrs = torch.tensor([w.data_ptr() if ok else 0 for w, ok in zip(w_q, live)], device=dev)
        ks, steps = gmm_int8.decode_split(m, k, n, e, gmm_int8._sm_count(dev.index or 0))
        fn = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_decode",
                                    gmm_int8._DECODE_ARGTYPES)
        rc = fn(lhs.data_ptr(), ptrs.data_ptr(), sptrs.data_ptr(), group_sizes.data_ptr(), e,
                out.data_ptr(), m, k, n, ks, steps, gmm_int8.DECODE_COLS,
                gmm_int8.DECODE_BLOCK_K, stream)
    else:
        table = _int8_map_table([w.data_ptr() if ok else 0 for w, ok in zip(w_q, live)], n, k, dev)
        fn = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_batch", gmm_int8._BATCH_ARGTYPES)
        rc = fn(lhs.data_ptr(), table.data_ptr(), sptrs.data_ptr(), group_sizes.data_ptr(), e,
                out.data_ptr(), m, k, n, gmm_int8.batch_rows(m, e), stream)
    assert rc == 0
    torch.cuda.synchronize()
    _assert_within(out, ops.grouped_matmul_int8_plain(lhs, w_q, scales, group_sizes))


def _int8_map_table(ptrs, n, k, dev, offset=0):
    """The batch route's device table of grid maps for raw pointers (null
    ones included), ``offset`` bytes into its allocation."""
    encode = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_encode_weights",
                                    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    host = torch.zeros(len(ptrs) * _build.TENSOR_MAP_BYTES, dtype=torch.uint8)
    assert encode((ctypes.c_uint64 * len(ptrs))(*ptrs), len(ptrs), n, k, host.data_ptr()) == 0
    table = torch.zeros(offset + host.numel(), dtype=torch.uint8, device=dev)
    table[offset:] = host.to(dev)
    return table[offset:]


def test_gmm_int8_rejects_unsupported(dev):
    from ptdeco_tpu_torch.ops import _build, gmm, gmm_int8

    lhs, w_q, scales, group_sizes = _int8_case(dev, [4, 4], 64, 32)
    with pytest.raises(ValueError):
        ops.grouped_matmul_int8(lhs, w_q, scales, group_sizes[:1])
    with pytest.raises(ValueError):
        ops.grouped_matmul_int8(lhs.float(), w_q, scales, group_sizes)
    # the C entries refuse what their route does not take
    out = torch.empty(8, 32, device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    table = _build.pointer_table(scales).data_ptr()
    batch = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_batch", gmm_int8._BATCH_ARGTYPES)
    maps = _int8_map_table([w.data_ptr() for w in w_q], 32, 64, dev)
    unaligned = _int8_map_table([w.data_ptr() for w in w_q], 32, 64, dev, offset=16)
    for m, k, n, e, bn, t in ((8, 60, 32, 2, 128, maps), (8, 64, 30, 2, 128, maps),
                              (8, 64, 32, gmm.MAX_TMA_EXPERTS + 1, 128, maps),
                              (8, 64, 32, 2, 64, maps), (8, 64, 32, 2, 128, unaligned)):
        assert batch(lhs.data_ptr(), t.data_ptr(), table, group_sizes.data_ptr(), e,
                     out.data_ptr(), m, k, n, bn, stream) != 0
    decode = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_decode",
                                    gmm_int8._DECODE_ARGTYPES)
    wt = _build.pointer_table(w_q).data_ptr()
    cols, bk = gmm_int8.DECODE_COLS, gmm_int8.DECODE_BLOCK_K
    for ks, steps, c, b in ((9, 1, cols, bk), (1, 0, cols, bk), (1, 1, cols, bk // 2),
                            (1, 1, 2 * cols, bk)):
        assert decode(lhs.data_ptr(), wt, table, group_sizes.data_ptr(), 2, out.data_ptr(),
                      8, 64, 32, ks, steps, c, b, stream) != 0
    torch.cuda.synchronize()


def test_moe_layer_routes_through_the_kernels(dev):
    from ptdeco_tpu_torch import models, quant

    cfg = models.TransformerConfig(
        vocab_size=64, dim=64, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=128,
        n_experts=4, dtype=torch.bfloat16,
    )
    moe = models.CausalLM(cfg, device=dev).model.layers[0].mlp
    x = torch.randn(2, 5, 64, device=dev, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        y = moe(x)
        assert ops.launch_counts()["grouped_matmul"] == 3
        dense = moe._dense_masked(x)
        torch.testing.assert_close(y.float(), dense.float(), rtol=2e-2, atol=2e-2)
        quant.quantize_for_serving(moe)
        y8 = moe(x)
    assert ops.launch_counts()["gmm_int8"] == 3
    assert ops.grouped_matmul_int8.route_launches["decode"] == 3
    torch.testing.assert_close(y8.float(), y.float(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("quantized", [False, True])
def test_moe_layer_is_deterministic_at_top_8(dev, quantized):
    """Eight expert rows a token (Qwen3-MoE's and OLMoE's top-8), on the
    grouped and grouped int8 routes: each token's rows are summed in slot
    order, so two calls give the same bits (an atomic scatter-add of three
    or more bf16 rows does not)."""
    from ptdeco_tpu_torch import models, quant

    cfg = models.TransformerConfig(
        vocab_size=64, dim=256, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=128,
        n_experts=64, n_experts_per_tok=8, norm_topk_prob=False, dtype=torch.bfloat16,
    )
    moe = models.CausalLM(cfg, device=dev).model.layers[0].mlp
    if quantized:
        quant.quantize_for_serving(moe)
    x = torch.randn(4, 256, 256, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        first, second = moe(x), moe(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# --- ResNet-50's shapes (falor's Grams, the fused 1x1-conv pairs) ---------


@pytest.mark.parametrize("n,d", [(50176, 512), (200704, 256)])
def test_syrk_gram_conv_rows(dev, n, d):
    """SYRK at falor's conv-site row counts: layer2's 50176 pixels (batch 64
    at 28 x 28) at d 512, and 200704 rows (layer1's 56 x 56) at d 256, which
    the engine's rule would give to an f32 matmul: called directly, to test
    the kernel's row range."""
    y = torch.randn(n, d, device=dev).to(torch.bfloat16)
    before = ops.syrk_gram.launches
    g = ops.syrk_gram(y)
    torch.cuda.synchronize()
    assert ops.syrk_gram.launches == before + 1
    ref = ops.syrk_gram_plain(y)
    torch.testing.assert_close(g, ref, rtol=0, atol=3e-5 * float(ref.abs().max()))
    assert torch.equal(g, g.t())


@pytest.mark.parametrize("n,c,hw,r,d_out", [(64, 256, 56, 16, 64), (8, 512, 28, 32, 2048),
                                            (3, 64, 7, 5, 256)])
def test_lowrank_matmul_channels_last_conv_rows(dev, n, c, hw, r, d_out):
    """A fused 1x1-conv pair's kernel input: the pixels of a channels_last
    NCHW activation as rows, read in place (no copy counted); an NCHW
    contiguous one is copied once."""
    x = torch.randn(n, c, hw, hw, device=dev).to(torch.bfloat16)
    x_cl = x.to(memory_format=torch.channels_last)
    k1 = (torch.randn(c, r, device=dev) / c ** 0.5).to(torch.bfloat16)
    k2 = (torch.randn(r, d_out, device=dev) / r ** 0.5).to(torch.bfloat16)
    ops.reset_launch_counts()
    y = ops.lowrank_matmul(x_cl.permute(0, 2, 3, 1), k1, k2)
    assert ops.lowrank_matmul.input_copies == 0
    y_nchw = ops.lowrank_matmul(x.permute(0, 2, 3, 1), k1, k2)
    assert ops.lowrank_matmul.input_copies == 1 and ops.lowrank_matmul.launches == 2
    torch.cuda.synchronize()
    ref = ops.lowrank_matmul_plain(x_cl.permute(0, 2, 3, 1), k1, k2, None)
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(y, y_nchw)


def test_fused_resnet_bottleneck_against_its_pairs(dev):
    """A decomposed ResNet bottleneck (both 1x1 convs as rank-16 pairs),
    bf16 channels_last: fused, its pairs launch the kernel once each, copy
    no input, keep the layout, and agree with the unfused pairs."""
    from ptdeco_tpu_torch import engine, models

    block = models.resnet.Bottleneck(256, 64, 256, 1, device=dev).eval()
    for name in ("conv1", "conv3"):
        site = engine.get_site(block, name)
        w = engine.get_site_weight2d(block, site)
        u = torch.linalg.qr(torch.randn(site.out_features, 16, device=dev))[0]
        w1, w2 = engine.build_factors(w, u, 16)
        tnn.replace_submodule(block, name, engine.build_decomposed_module(block, site, w1, w2))
    block = block.to(torch.bfloat16, memory_format=torch.channels_last)
    x = torch.randn(8, 256, 56, 56, device=dev).to(torch.bfloat16, memory_format=torch.channels_last)
    with torch.no_grad():
        y_pairs = block(x)
        tnn.fuse_factor_pairs(block)
        ops.reset_launch_counts()
        y = block(x)
    torch.cuda.synchronize()
    assert ops.lowrank_matmul.launches == 2 and ops.lowrank_matmul.input_copies == 0
    assert y.is_contiguous(memory_format=torch.channels_last)
    d = (y.float() - y_pairs.float())
    assert float(d.square().mean().sqrt() / y_pairs.float().square().mean().sqrt()) < 1e-2
