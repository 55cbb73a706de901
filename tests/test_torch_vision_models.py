"""The port's ConvNeXt, SwinV2 (and V1) and EfficientFormerV2 against the
JAX package's on the CPU, from the same weights (drawn from a numpy seed
and carried across by the state-dict names), against the upstream-torch
block mirrors of ``tests/test_vision_block_goldens.py``, and their sites
against the JAX models' at the published widths."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import engine as jengine, nn as jnn, utils as jutils
from ptdeco_tpu.models import convnext as jconvnext, efficientformer as jef, swin as jswin
from ptdeco_tpu_torch import engine, models, utils
from ptdeco_tpu_torch.models import convnext, efficientformer, swin

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "apps" / "trainer_vision" / "examples_config"

# tiny configurations: 32 x 32 images (64 for EfficientFormer's /32
# rule), one or two blocks a stage, widths <= 32
TINY = {
    "convnext": (lambda **kw: models.ConvNeXt((1, 1), (8, 16), 10, **kw),
                 lambda k: jconvnext.ConvNeXt.create(k, (1, 1), (8, 16), 10), 32),
    "convnextv2": (lambda **kw: models.ConvNeXt((1, 1), (8, 16), 10, use_grn=True, **kw),
                   lambda k: jconvnext.ConvNeXt.create(k, (1, 1), (8, 16), 10, use_grn=True), 32),
    # stage 0 at 8 x 8 tokens in 4 x 4 windows: an unshifted and a shifted block
    "swinv2": (lambda **kw: models.SwinV2(32, 4, 8, (2, 2), (2, 4), 4, 10, **kw),
               lambda k: jswin.SwinV2.create(k, 32, 4, 8, (2, 2), (2, 4), 4, 10), 32),
    "swin_v1": (lambda **kw: models.SwinV2(32, 4, 8, (2, 2), (2, 4), 4, 10, v1=True, **kw),
                lambda k: jswin.SwinV2.create(k, 32, 4, 8, (2, 2), (2, 4), 4, 10, v1=True), 32),
    "efficientformerv2": (
        lambda **kw: models.EfficientFormerV2(64, (8, 16, 16, 24), (1, 1, 1, 2),
                                              ((4,), (4,), (4,), (4, 3)), 1, 10, **kw),
        lambda k: jef.EfficientFormerV2.create(k, 64, (8, 16, 16, 24), (1, 1, 1, 2),
                                               ((4,), (4,), (4,), (4, 3)), 1, 10), 64),
}

_TABLES = ("rel_coords", "rel_index", "attn_mask", "bias_idx", "num_batches_tracked")


def randomized_state_dict(model: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """The model's state dict with every parameter and BatchNorm statistic
    drawn from a numpy seed (the tables of constants kept)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        a = v.numpy().copy()
        if not k.endswith(_TABLES):
            a = (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
            if k.endswith("running_var"):
                a = np.abs(a) + 0.5
        out[k] = a
    return out


def jax_twin(create, sd):
    """The JAX model's structure (no draws compiled) with ``sd`` loaded."""
    abstract = jax.eval_shape(lambda: create(jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), abstract)
    return jutils.load_state_dict(zeros, sd)


@pytest.fixture(scope="module", params=sorted(TINY))
def twins(request):
    make, create, hw = TINY[request.param]
    tm = make(device="cpu").eval()
    sd = randomized_state_dict(tm, seed=1)
    utils.load_numpy_state_dict(tm, sd)
    jm = jax_twin(create, sd)
    x = np.random.default_rng(2).standard_normal((2, 3, hw, hw)).astype(np.float32)
    y_jax = np.asarray(jax.jit(lambda m, v: m(v))(jm, jnp.asarray(x.transpose(0, 2, 3, 1))))
    return request.param, tm, jm, sd, x, y_jax


def test_logits_match_jax(twins):
    """Each family's logits within 1e-4 of the JAX model's (f32, JAX at
    highest matmul precision), NCHW and channels_last alike."""
    _, tm, _, _, x, y_jax = twins
    with torch.no_grad():
        y = tm(torch.from_numpy(x)).numpy()
        y_cl = tm.to(memory_format=torch.channels_last)(
            torch.from_numpy(x).to(memory_format=torch.channels_last)).numpy()
    assert np.abs(y_jax).max() > 0.1
    np.testing.assert_allclose(y, y_jax, atol=1e-4)
    np.testing.assert_allclose(y_cl, y_jax, atol=1e-4)


def test_state_dict_and_sites_match_jax(twins):
    """The same state-dict names and shapes, decomposable sites (Linear and
    groups-1 1x1 conv) and lockd targets (Linear and groups-1 conv)."""
    _, tm, jm, sd, _, _ = twins
    jsd = jutils.state_dict(jm)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jsd.items()}
    assert engine.get_decomposeable_submodule_names(tm) == \
        jengine.get_decomposeable_submodule_names(jm)
    wrappable = [n for n, m in tm.named_modules()
                 if type(m) is torch.nn.Linear or (type(m) is torch.nn.Conv2d and m.groups == 1)]
    jwrappable = [n for n, m in jnn.named_modules(jm)
                  if isinstance(m, jnn.Linear) or (isinstance(m, jnn.Conv2d) and m.groups == 1)]
    assert sorted(wrappable) == sorted(jwrappable)


def test_train_mode_batchnorm_statistics_match_jax():
    """EfficientFormerV2 (the family with BatchNorm) in train mode: its
    logits (batch statistics) and its updated running statistics
    (momentum 0.1, unbiased variance) as the JAX model's sown and applied
    ones."""
    make, create, hw = TINY["efficientformerv2"]
    sd = randomized_state_dict(make(device="cpu"), seed=3)
    jm = jax_twin(create, sd)
    x = np.random.default_rng(4).standard_normal((2, 3, hw, hw)).astype(np.float32)
    ctx = jnn.Ctx(key=jax.random.PRNGKey(0), train=True)

    def step(m, v):
        y = m(v, ctx=ctx)
        return y, ctx.sink["bn"]

    y_jax, sink = jax.jit(step)(jm, jnp.asarray(x.transpose(0, 2, 3, 1)))
    jsd = jutils.state_dict(jnn.apply_bn_updates(jm, sink))
    train = utils.load_numpy_state_dict(make(device="cpu"), sd).train()
    with torch.no_grad():
        y = train(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(y_jax), atol=1e-4)
    stats = {k: v for k, v in train.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in train.modules())
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), jsd[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,factory,jfactory,config", [
    ("convnext_tiny", models.convnext_tiny, jconvnext.convnext_tiny,
     "decompose_dwain_convnext.yaml"),
    ("swinv2_tiny", models.swinv2_tiny, jswin.swinv2_tiny, "decompose_dwain_swinv2_tiny.yaml"),
    ("efficientformerv2_s0", models.efficientformerv2_s0, jef.efficientformerv2_s0,
     "decompose_lockd_efficientformerv2_s0.yaml"),
])
def test_published_widths_match_jax(name, factory, jfactory, config):
    """At the shipped configs' widths: every state-dict name and shape, and
    the sites, as the JAX model's; the shipped yaml's blacklist names
    modules of the port's model."""
    import yaml

    tm = factory(device="cpu")
    abstract = jax.eval_shape(lambda: jfactory(jax.random.PRNGKey(0)))
    jm = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), abstract)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jutils.state_dict(jm).items()}
    assert engine.get_decomposeable_submodule_names(tm) == \
        jengine.get_decomposeable_submodule_names(jm)
    blacklist = yaml.safe_load((CONFIGS / config).read_text())["blacklisted_modules"]
    known = {n for n, _ in tm.named_modules()}
    assert blacklist and set(blacklist) <= known


def _mirrors():
    spec = importlib.util.spec_from_file_location(
        "torch_block_mirrors", ROOT / "aux" / "torch_block_mirrors.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_mirror_weights(mirror, block, seed):
    """The mirror's parameters and BatchNorm statistics drawn from a numpy
    seed, loaded into both (strict: the port's block has every name)."""
    sd = randomized_state_dict(mirror, seed)
    for k, v in mirror.state_dict().items():
        if k.endswith("logit_scale"):
            sd[k] = np.log(np.abs(sd[k]) * 20 + 2.0).astype(np.float32)
    mirror.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    utils.load_numpy_state_dict(block, sd)
    return mirror.eval(), block.eval()


@pytest.mark.parametrize("block", ["convnext", "swinv2_shift0", "swinv2_shift2", "attention4d"])
def test_blocks_match_upstream_torch(block):
    """The blocks of tests/test_vision_block_goldens.py against the same
    upstream-torch mirrors, from the same weights."""
    m = _mirrors()
    rng = np.random.default_rng(11)
    kw = {"device": "cpu", "dtype": torch.float32}
    if block == "convnext":
        mirror, ours = m.TorchConvNeXtBlock(24), convnext.ConvNeXtBlock(24, **kw)
        x = rng.standard_normal((2, 24, 12, 12))
    elif block.startswith("swinv2"):
        shift = int(block[-1])
        mirror = m.TorchSwinV2Block(16, 4, (8, 8), 4, shift)
        ours = swin.SwinBlock(16, 4, (8, 8), 4, shift, **kw)
        x = rng.standard_normal((2, 64, 16))
    else:
        mirror = m.TorchAttention4D(32, 6, n_heads=4, key_dim=8, attn_ratio=2)
        ours = efficientformer.Attention4D(32, 6, n_heads=4, key_dim=8, attn_ratio=2, **kw)
        x = rng.standard_normal((2, 32, 6, 6))
    mirror, ours = _load_mirror_weights(mirror, ours, seed=12)
    x = torch.from_numpy(x.astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(ours(x).numpy(), mirror(x).numpy(), atol=2e-5)
