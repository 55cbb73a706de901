"""The port's ResNet against the JAX package's on the CPU (weights carried
across by the state-dict export), its channels_last rows, and the fused
1x1-conv pairs of a decomposed bottleneck."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import utils as jutils
from ptdeco_tpu.models import resnet as jresnet
from ptdeco_tpu_torch import engine, falor, lockd, models, nn as pnn, utils


def _random_bn_stats(sd, seed=0):
    """The export with BatchNorm statistics drawn from a seed, so that the
    forward exercises them (the JAX package creates them at 0 / 1)."""
    rng = np.random.default_rng(seed)
    out = dict(sd)
    for k, v in sd.items():
        if k.endswith("running_mean") or k.endswith(".bias") and "bn" in k:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("running_var") or k.endswith(".weight") and "bn" in k:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def twins():
    # created in one compiled program: eager creation compiles every draw
    jm = jax.jit(lambda k: jresnet.ResNet.create(k, "bottleneck", (1, 1, 1, 1), num_classes=10))(
        jax.random.PRNGKey(0))
    sd = _random_bn_stats(jutils.state_dict(jm))
    jm = jutils.load_state_dict(jm, sd)
    tm = models.ResNet("bottleneck", (1, 1, 1, 1), 10, device="cpu").eval()
    utils.load_numpy_state_dict(tm, sd)  # strict: num_batches_tracked included
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    return jm, tm, sd, x


def test_forward_matches_jax(twins):
    jm, tm, sd, x = twins
    assert sd["bn1.num_batches_tracked"].shape == ()
    y_jax = np.asarray(jax.jit(lambda m, v: m(v))(jm, jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        y = tm(torch.from_numpy(x)).numpy()
        y_cl = tm.to(memory_format=torch.channels_last)(
            torch.from_numpy(x).to(memory_format=torch.channels_last)).numpy()
    np.testing.assert_allclose(y, y_jax, atol=1e-4)
    np.testing.assert_allclose(y_cl, y_jax, atol=1e-4)


def test_resnet50_names_match_jax():
    """ResNet-50's state-dict names and shapes, its 37 decomposable sites
    (36 1x1 convs and fc) and its 54 wrappable layers, as the JAX
    package's."""
    # the JAX model's structure, with zeros for its draws
    abstract = jax.eval_shape(lambda: jresnet.resnet50(jax.random.PRNGKey(0)))
    shapes = jutils.state_dict(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), abstract))
    tm = models.resnet50(device="cpu")
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}
    sites = engine.get_decomposeable_submodule_names(tm)
    assert len(sites) == 37 and sites[-1] == "fc" and "layer2.0.downsample.0" in sites
    wrappable = [n for n, m in tm.named_modules() if type(m) in (torch.nn.Conv2d, torch.nn.Linear)]
    assert len(wrappable) == 54


def test_channels_last_rows_are_a_view():
    """A conv site's rows, and a fused conv pair's kernel input, are views
    of a channels_last activation and copies of an NCHW one."""
    site = engine.Site("c", "conv2d1x1", 8, 16, False, torch.float32)
    x = torch.randn(2, 8, 5, 5)
    x_cl = x.to(memory_format=torch.channels_last)
    rows = engine._site_rows(site, x_cl)
    assert rows.shape == (50, 8) and rows.data_ptr() == x_cl.data_ptr()
    assert engine._site_rows(site, x).data_ptr() != x.data_ptr()
    torch.testing.assert_close(engine._site_rows(site, x), rows, rtol=0, atol=0)


def _calib(seed, n=6):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
            for _ in range(n)]


def _cycle(xs):
    i = 0
    while True:
        yield xs[i % len(xs)]
        i += 1


def test_fused_bottleneck_conv_pairs(twins):
    """falor decomposes the small ResNet; its stride-1 1x1 pairs fuse (the
    strided downsamples' stay pairs), the fused model agrees with the
    pairs, and unfusing restores the pairs bit-equal."""
    _, _, sd, _ = twins
    tm = utils.load_numpy_state_dict(
        models.ResNet("bottleneck", (1, 1, 1, 1), 10, device="cpu"), sd)
    keep = {"layer1.0.conv1", "layer1.0.conv3", "layer1.0.downsample.0",
            "layer2.0.downsample.0", "fc"}
    tm, config = falor.decompose(
        module=tm, data_iterator=_cycle(_calib(2)), proportion_threshold=1.0,
        nsr_final_threshold=0.5, kl_final_threshold=0.5, num_data_steps=2,
        num_metric_steps=1, device="cpu",
        blacklisted_module_names=[n for n in engine.get_decomposeable_submodule_names(tm)
                                  if n not in keep])
    strided = [n for n in config if config[n]["modules"]["0"].get("stride") == [2, 2]]
    plain = [n for n in config if n not in strided and n != "fc"]
    assert strided and plain
    sd_pairs = {k: v.clone() for k, v in tm.state_dict().items()}
    x = _calib(3, 1)[0].to(memory_format=torch.channels_last)
    with torch.no_grad():
        y_pairs = tm(x)
        pnn.fuse_factor_pairs(tm)
        fused = {n for n, m in tm.named_modules() if isinstance(m, pnn.FusedLowRankLinear)}
        y_fused = tm(x)
    assert fused == set(plain) | ({"fc"} & set(config))
    assert all(tm.get_submodule(n).from_conv for n in plain)
    torch.testing.assert_close(y_fused, y_pairs, rtol=1e-5, atol=1e-5)
    pnn.unfuse_factor_pairs(tm)
    assert {n: utils.get_module_config(tm.get_submodule(n)) for n in config} == {
        n: {k: v for k, v in c.items() if k != "__meta__"} for n, c in config.items()}
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd_pairs[k]), k


def test_padded_and_strided_conv_pairs_stay_unfused():
    def pair(**kw):
        return torch.nn.Sequential(torch.nn.Conv2d(8, 4, 1, bias=False, **kw),
                                   torch.nn.Conv2d(4, 8, 1))

    root = torch.nn.Sequential(pair(), pair(stride=2), pair(padding=1),
                               torch.nn.Sequential(torch.nn.Conv2d(8, 4, 1, bias=False),
                                                   torch.nn.Conv2d(4, 8, 3, padding=1)))
    pnn.fuse_factor_pairs(root)
    assert [type(m).__name__ for m in root] == [
        "FusedLowRankLinear", "Sequential", "Sequential", "Sequential"]


def test_lockd_pairs_of_a_wrapped_bottleneck_fuse(twins):
    """lockd's students: the 1x1 -> 1x1 pairs fuse, the 1x1 -> 3x3 pairs and
    the strided downsample's stay pairs."""
    _, _, sd, _ = twins
    tm = utils.load_numpy_state_dict(
        models.ResNet("bottleneck", (1, 1, 1, 1), 10, device="cpu"), sd)
    lockd.wrap(tm)
    for _, m in lockd.named_wrapped_modules(tm):
        with torch.no_grad():
            m.logits[1::2] = -3.0
    tm, config = lockd.decompose(tm, proportion_threshold=0.9)
    assert len(config) == 18  # every layer: 12 block convs, 4 downsamples, the stem, fc
    pnn.fuse_factor_pairs(tm)
    fused = {n for n, m in tm.named_modules() if isinstance(m, pnn.FusedLowRankLinear)}
    expected = {n for n, c in config.items()
                if c["modules"]["1"].get("kernel_size", [1, 1]) == [1, 1]
                and c["modules"]["1"].get("stride", [1, 1]) == [1, 1]}
    assert fused == expected and "layer1.0.conv1" in fused and "fc" in fused
    assert "layer1.0.conv2" not in fused and "layer2.0.downsample.0" not in fused
