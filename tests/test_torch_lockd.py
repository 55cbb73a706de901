"""The port's lockd on the CPU: the torch reference's goldens (the whole
walk on the CNN toy, the SmallNet artifact) and the JAX package (losses,
the eval-mode NSR sink and one training step's gradients with the JAX
run's Gumbel noise fed to the port; the trained gates in distribution),
and the gate-training step in bf16."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptdeco_tpu import lockd as jlockd, nn as jnn, utils as jutils
from ptdeco_tpu_torch import lockd, utils
from ptdeco_tpu_torch.lockd import train

from test_torch_dwain import _CNN
from test_whole_model_parity import make_cnn as jax_make_cnn

GOLDEN = pathlib.Path(__file__).parent / "golden"
LMBDA, NSR_THRESHOLD, LR = 0.1, 0.02, 1e-3


def _cnn_init():
    data = np.load(GOLDEN / "whole_cnn_data.npz")
    return data, {k[len("init__"):]: data[k] for k in data.files if k.startswith("init__")}


def _wrapped_sd(logits_seed=None):
    """The reference's wrapped CNN (students included); with a seed, gate
    logits drawn around 0 so that gates differ and some are closed."""
    sd = dict(np.load(GOLDEN / "whole_lockd_wrapped_sd.npz").items())
    if logits_seed is not None:
        rng = np.random.default_rng(logits_seed)
        for k in sd:
            if k.endswith("logits"):
                sd[k] = rng.uniform(-2.0, 4.0, sd[k].shape).astype(np.float32)
    return sd


def _port(logits_seed=None):
    _, init_sd = _cnn_init()
    return utils.load_numpy_state_dict(
        lockd.wrap(utils.load_numpy_state_dict(_CNN(), init_sd)), _wrapped_sd(logits_seed))


def _twins(logits_seed=None):
    _, init_sd = _cnn_init()
    # the wrapped structure without its draws (every leaf is loaded)
    abstract = jax.eval_shape(lambda m: jlockd.wrap(m, jax.random.PRNGKey(0)),
                              jax_make_cnn(init_sd))
    jm = jutils.load_state_dict(
        jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), abstract),
        _wrapped_sd(logits_seed))
    return jm, _port(logits_seed)


def test_whole_walk_golden():
    """The reference's wrapped CNN decomposed with its forced gates: an
    identical config, the state dict within 1e-6, the outputs within 1e-5
    (tests/test_whole_model_parity.py:333-375 for the port)."""
    model, config = lockd.decompose(_port(), proportion_threshold=0.9)
    with open(GOLDEN / "whole_lockd_config.json") as f:
        assert config == json.load(f)
    ref_sd = dict(np.load(GOLDEN / "whole_lockd_sd.npz").items())
    sd = utils.state_dict(model)
    assert set(sd) == set(ref_sd)
    for k, v in ref_sd.items():
        np.testing.assert_allclose(sd[k].numpy(), v, atol=1e-6, err_msg=k)
    io = np.load(GOLDEN / "whole_lockd_io.npz")
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(io["probe"])).numpy(), io["y"],
                                   atol=1e-5)


class _SmallNet(torch.nn.Module):
    """Torch twin of tests/test_compat_reference.py:SmallNet."""

    def __init__(self):
        super().__init__()
        self.conv1, self.conv2 = torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.Conv2d(16, 32, 1)
        self.fc1, self.fc2 = torch.nn.Linear(32, 64), torch.nn.Linear(64, 10)

    def forward(self, x):
        x = torch.relu(self.conv2(torch.relu(self.conv1(x))))
        return self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3)))))


def test_smallnet_artifact_golden():
    """The reference's lockd artifact applies to the port's model and gives
    its outputs; the port's config with the same forced gates has the
    reference's format."""
    with open(GOLDEN / "lockd_smallnet_config.json") as f:
        ref_config = json.load(f)
    io = np.load(GOLDEN / "lockd_smallnet_io.npz")
    model = utils.apply_decompose_config(_SmallNet(), ref_config)
    utils.load_state_dict(model, utils.load_state_dict_pt(str(GOLDEN / "lockd_smallnet_sd.pt")))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(io["x"])).numpy(), io["y"], atol=1e-5)
    wrapped = lockd.wrap(_SmallNet(), seed=1)
    for _, m in lockd.named_wrapped_modules(wrapped):
        with torch.no_grad():
            m.logits.fill_(-10.0)
            m.logits[::2] = 10.0
    _, config = lockd.decompose(wrapped, proportion_threshold=0.9)
    assert {n: {k: v for k, v in c.items() if k != "__meta__"} for n, c in config.items()} == {
        n: {k: v for k, v in c.items() if k != "__meta__"} for n, c in ref_config.items()}
    for n, c in ref_config.items():
        assert config[n]["__meta__"]["proportion"] == pytest.approx(c["__meta__"]["proportion"])


def test_losses_and_eval_sink_match_jax():
    jm, tm = _twins(logits_seed=3)
    data, _ = _cnn_init()
    x = data["probe"]
    y_jax, sink_jax = jax.jit(lambda m, v: jlockd.forward_collecting(m, v, key=None, train=False))(
        jm, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        y, sink = lockd.forward_collecting(tm, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), atol=1e-5)
    assert set(sink) == set(sink_jax) == {"conv1", "conv2", "conv3", "fc"}
    for name in sink:
        np.testing.assert_allclose(float(sink[name]), float(sink_jax[name]), rtol=1e-6, atol=1e-6)
    pairs = [
        (lockd.get_nsr_loss(sink, NSR_THRESHOLD), jlockd.get_nsr_loss(sink_jax, NSR_THRESHOLD)),
        (lockd.get_entropy_loss(tm), jlockd.get_entropy_loss(jm)),
        (lockd.get_proportion_loss(tm), jlockd.get_proportion_loss(jm)),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6, atol=1e-6)
    for ours, theirs in ((lockd.get_entropy_dict(tm), jlockd.get_entropy_dict(jm)),
                         (lockd.get_proportion_dict(tm), jlockd.get_proportion_dict(jm))):
        assert set(ours) == set(theirs)
        for k in ours:
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-6, atol=1e-6)
    # the softplus entropy stays finite where sigmoid saturates
    assert float(lockd.calc_entropy_from_logits(torch.tensor([-60.0, 60.0]))) == pytest.approx(0.01)


def _jax_noise(jm, key):
    """Each wrapped layer's Gumbel pair as the JAX step draws it."""
    return {m.rng_id: np.array(jax.random.gumbel(jax.random.fold_in(key, m.rng_id),
                                                 (2,) + m.logits.shape, jnp.float32))
            for _, m in jlockd.named_wrapped_modules(jm)}


def test_training_step_matches_jax():
    """One gate-training step (AdamW, clipped by global norm, f32) on the
    same model and batch, the JAX run's Gumbel noise fed to the port: the
    losses within 1e-6 and every trained gradient within 1e-5 of the
    largest |g| of its tensor (f32 sums in another order)."""
    jm, tm = _twins(logits_seed=4)
    data, _ = _cnn_init()
    x, key = data["calib_x"][0], jax.random.PRNGKey(7)

    trainable, frozen = jlockd.trainable_partition(jm)

    def loss_fn(tr):
        ctx = jnn.Ctx(key=key, train=False)
        m = jnn.combine(tr, frozen)
        m(jnp.asarray(x.transpose(0, 2, 3, 1)), ctx=ctx)
        nsr_sink = ctx.sink.get("nsr", {})
        nsr_loss = jlockd.get_nsr_loss(nsr_sink, NSR_THRESHOLD)
        return nsr_loss + LMBDA * jlockd.get_proportion_loss(m), nsr_loss

    (loss_jax, nsr_jax), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    grads_jax = jutils.state_dict(jnn.combine(grads, frozen))

    names = dict(lockd.trainable_partition(tm))
    assert len(names) == 16  # 4 layers x (two factors, the second's bias, logits)
    grads = {}
    for n, p in names.items():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().clone()))
    update = train._make_update(tm, train.get_optimizer(names.values(), "AdamW", LR),
                                LMBDA, NSR_THRESHOLD)
    noise = {i: torch.from_numpy(v) for i, v in _jax_noise(jm, key).items()}
    loss, (nsr_loss, _, _) = update(torch.from_numpy(x), lockd.Ctx(noise=noise))
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-6)
    np.testing.assert_allclose(float(nsr_loss), float(nsr_jax), rtol=1e-6)
    assert set(grads) == set(names)
    for n, g in grads.items():
        ref = grads_jax[n]
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5 * np.abs(ref).max(), err_msg=n)


D_IN, D_HID, D_OUT, DATA_RANK = 16, 16, 8, 3
N_STEPS, DIST_LR, DIST_LMBDA, DIST_NSR = 1500, 0.02, 2.0, 0.1


def _rank_limited_batches(n, bs=32, seed=0):
    rng = np.random.RandomState(seed)
    proj = rng.randn(DATA_RANK, D_IN).astype(np.float32)
    for _ in range(n):
        yield rng.randn(bs, DATA_RANK).astype(np.float32) @ proj


def _gate_stats(logits_by_layer):
    return ({k: float(np.mean(1.0 / (1.0 + np.exp(-np.clip(v, -30, 30)))))
             for k, v in logits_by_layer.items()},
            {k: int((v > 0).sum()) for k, v in logits_by_layer.items()})


def test_gate_training_matches_jax_in_distribution():
    """The gates trained by the port and by the JAX package from the same
    start on the same batches, each with its own Gumbel streams, agree by
    tests/test_lockd_parity.py:58's statistic: each layer's expected
    proportion within 0.15 and its open-gate count within 2."""

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1, self.fc2 = torch.nn.Linear(D_IN, D_HID), torch.nn.Linear(D_HID, D_OUT)

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    class JMLP(jnn.Module):
        fc1: jnn.Linear
        fc2: jnn.Linear

        def __call__(self, x, ctx=None):
            return self.fc2(jax.nn.relu(self.fc1(x, ctx)), ctx)

    torch.manual_seed(0)
    tm = lockd.wrap(MLP(), seed=1)
    sd = {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}
    k = jax.random.split(jax.random.PRNGKey(0), 2)
    jm = jlockd.wrap(JMLP(fc1=jnn.Linear.create(k[0], D_IN, D_HID),
                          fc2=jnn.Linear.create(k[1], D_HID, D_OUT)), jax.random.PRNGKey(1))
    jm = jutils.load_state_dict(jm, sd)

    params = [p for _, p in lockd.trainable_partition(tm)]
    update = train._make_update(tm, train.get_optimizer(params, "Adam", DIST_LR), DIST_LMBDA,
                                DIST_NSR, clip_norm=None)
    ctx_gens = lockd.make_generators(tm, seed=42)
    for x in _rank_limited_batches(N_STEPS):
        update(torch.from_numpy(x), lockd.Ctx(ctx_gens))

    trainable, frozen = jlockd.trainable_partition(jm)
    tx = optax.adam(DIST_LR)
    opt_state = tx.init(trainable)

    @jax.jit
    def step(tr, opt_state, x, key):
        def loss_fn(tr):
            m = jnn.combine(tr, frozen)
            ctx = jnn.Ctx(key=key, train=False)
            m(x, ctx=ctx)
            return (jlockd.get_nsr_loss(ctx.sink.get("nsr", {}), DIST_NSR)
                    + DIST_LMBDA * jlockd.get_proportion_loss(m))

        grads = jax.grad(loss_fn)(tr)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(tr, updates), opt_state

    key = jax.random.PRNGKey(42)
    for x in _rank_limited_batches(N_STEPS):
        key, sub = jax.random.split(key)
        trainable, opt_state = step(trainable, opt_state, jnp.asarray(x), sub)
    jm = jnn.combine(trainable, frozen)

    props, counts = _gate_stats({n: m.logits.detach().numpy()
                                 for n, m in lockd.named_wrapped_modules(tm)})
    jprops, jcounts = _gate_stats({n: np.asarray(m.logits)
                                   for n, m in jlockd.named_wrapped_modules(jm)})
    assert set(props) == set(jprops) == {"fc1", "fc2"}
    for n in props:
        assert abs(props[n] - jprops[n]) < 0.15, (n, props[n], jprops[n])
        assert abs(counts[n] - jcounts[n]) <= 2, (n, counts[n], jcounts[n])
    assert any(p < 0.8 for p in props.values())  # the gates moved off their 0.95 start


def test_gates():
    logits = torch.tensor([3.0, -0.5, 0.0, 1.0])
    gen = torch.Generator().manual_seed(0)
    g = lockd.sample_from_logits(logits, gen)
    assert g[1] == 0.0 and bool(((g > 0) & (g < 1))[[0, 2, 3]].all())
    # the same stream gives the same gate; the noise is Gumbel's transform
    noise = lockd.gumbel_noise((4,), torch.Generator().manual_seed(0))
    torch.testing.assert_close(lockd.sample_from_logits(logits, noise=noise), g)
    u = torch.rand((2, 4), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(noise, -torch.log(-torch.log(u)))
    torch.testing.assert_close(lockd.expected_gate(logits),
                               torch.where(logits < 0, 0.0, torch.sigmoid(logits / 0.5)))


def test_decompose_keeps_the_strongest_channel():
    """Every gate closed: the layer keeps its strongest channel (a zero-width
    pair would reduce it to its bias)."""
    tm = _port()
    for _, m in lockd.named_wrapped_modules(tm):
        with torch.no_grad():
            m.logits.copy_(-torch.arange(1.0, m.logits.numel() + 1))
            m.logits[1] = -0.5
    model, config = lockd.decompose(tm, proportion_threshold=0.9)
    assert all(c["modules"]["0"].get("out_channels", c["modules"]["0"].get("out_features")) == 1
               for c in config.values())
    torch.testing.assert_close(model.conv2[0].weight, tm.conv2[0].weight)  # in place
    assert not lockd.is_wrapped_module(model)


def test_bf16_step_keeps_f32_masters():
    """precision "bf16": the students and logits stay f32 masters, the
    teachers and the input run in bf16, the step is finite and moves the
    gates; frozen parameters take no gradient."""
    tm = _port()
    data, _ = _cnn_init()
    params = dict(lockd.trainable_partition(tm))
    before = {n: p.detach().clone() for n, p in params.items()}
    update = train._make_update(tm, train.get_optimizer(params.values(), "AdamW", LR), LMBDA,
                                NSR_THRESHOLD, precision="bf16")
    gens = lockd.make_generators(tm, seed=0)
    loss, (_, proportion, sink) = update(torch.from_numpy(data["calib_x"][0]), lockd.Ctx(gens))
    assert torch.isfinite(loss) and proportion.dtype == torch.bfloat16 and len(sink) == 4
    assert all(p.dtype == torch.float32 for p in params.values())
    assert tm.conv1.conv_orig.weight.dtype == torch.bfloat16
    assert not tm.conv1.conv_orig.weight.requires_grad
    assert all(not torch.equal(params[n], before[n]) for n in params)
