"""The port's falor on the CPU: against the torch reference's goldens (the
whole-model MLP, CNN and attention toys, the strided res-stage, the
rank-6 Linear) and against the JAX package (decisions and outputs on the
CNN with and without mean-centring, the mean-centred damped eigenbasis),
and its phase-1 checkpoint."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import engine as jengine, falor as jfalor
from ptdeco_tpu_torch import engine, falor, nn as pnn, utils

from test_torch_dwain import _CNN, _MLP
from test_torch_dwain_modes import _Attn
from test_whole_model_parity import (
    _cycle_tensors,
    _entry_full_rank,
    _entry_rank,
    _rewrite_rank,
    make_cnn as jax_make_cnn,
)

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _hparams(key="falor", name="whole_model_hparams.json"):
    with open(GOLDEN / name) as f:
        return json.load(f)[key]


def _family(stem):
    data = np.load(GOLDEN / f"{stem}_data.npz")
    return data, {k[len("init__"):]: data[k] for k in data.files if k.startswith("init__")}


def _tensors(xs):
    i = 0
    while True:
        yield torch.from_numpy(xs[i % len(xs)])
        i += 1


def _squeeze2d(w):
    return np.asarray(w).reshape(w.shape[0], w.shape[1])


def assert_golden(config, model, stem):
    """tests/test_whole_model_parity.py:assert_parity for the port: the
    reference's decisions exactly; its structure with the inner rank set
    to the accepted one (the reference builds the last tried candidate's
    factors, a documented bug both packages fix); the meta values; the
    state-dict keys; the composed factor product where the built ranks
    agree, and each bias."""
    with open(GOLDEN / f"{stem}_config.json") as f:
        ref_config = json.load(f)
    ref_sd = dict(np.load(GOLDEN / f"{stem}_sd.npz").items())
    assert set(config) == set(ref_config)
    agree = {}
    for name, ref in ref_config.items():
        ref_entry = {k: v for k, v in ref.items() if k != "__meta__"}
        entry = {k: v for k, v in config[name].items() if k != "__meta__"}
        ref_meta, meta = ref["__meta__"], config[name]["__meta__"]
        assert meta["proportion"] == ref_meta["proportion"], name
        rank_best = round(ref_meta["proportion"] * _entry_full_rank(ref_entry))
        assert _entry_rank(entry) == rank_best, name
        assert entry == _rewrite_rank(ref_entry, rank_best), name
        agree[name] = _entry_rank(ref_entry) == rank_best
        assert set(meta) == set(ref_meta), name
        for key in ("nsr_final", "kl_final"):
            np.testing.assert_allclose(meta[key], ref_meta[key], rtol=0.05, atol=1e-4,
                                       err_msg=f"{name}.{key}")
    sd = {k: v.numpy() for k, v in utils.state_dict(model).items()}
    assert set(sd) == set(ref_sd)
    for name in ref_config:
        if agree[name]:
            np.testing.assert_allclose(
                _squeeze2d(sd[f"{name}.1.weight"]) @ _squeeze2d(sd[f"{name}.0.weight"]),
                _squeeze2d(ref_sd[f"{name}.1.weight"]) @ _squeeze2d(ref_sd[f"{name}.0.weight"]),
                atol=1e-4, err_msg=name)
        np.testing.assert_allclose(sd[f"{name}.1.bias"], ref_sd[f"{name}.1.bias"], atol=1e-6)
    return agree


@pytest.mark.parametrize("family,make", [("mlp", _MLP), ("cnn", _CNN), ("attn", _Attn)])
def test_whole_model_goldens(family, make):
    data, init_sd = _family(f"whole_{family}")
    model, config = falor.decompose(
        module=utils.load_numpy_state_dict(make(), init_sd),
        data_iterator=_tensors(data["calib_x"]), device="cpu", **_hparams())
    agree = assert_golden(config, model, f"whole_falor_{family}")
    if all(agree.values()):  # the reference's final model has the same factors
        with torch.no_grad():
            y = model(torch.from_numpy(data["probe"])).numpy()
        np.testing.assert_allclose(y, data["y_falor"], atol=5e-4)


class _ResStage(torch.nn.Module):
    """Torch twin of tests/test_transformer_parity.py:ResStage (the
    generator's strided-conv stage, NCHW)."""

    def __init__(self):
        super().__init__()
        self.stem, self.bn_stem = torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.BatchNorm2d(16)
        self.conv_a, self.bn_a = torch.nn.Conv2d(16, 32, 1, stride=2), torch.nn.BatchNorm2d(32)
        self.conv_b, self.bn_b = torch.nn.Conv2d(32, 32, 1), torch.nn.BatchNorm2d(32)
        self.down, self.bn_down = torch.nn.Conv2d(16, 32, 1, stride=2), torch.nn.BatchNorm2d(32)
        self.fc = torch.nn.Linear(32, 10)

    def forward(self, x):
        x = torch.relu(self.bn_stem(self.stem(x)))
        h = torch.relu(self.bn_a(self.conv_a(x)))
        h = self.bn_b(self.conv_b(h))
        x = torch.relu(h + self.bn_down(self.down(x)))
        return self.fc(x.mean(dim=(2, 3)))


def test_resstage_golden():
    """Strided 1x1 sites behind BatchNorm: the reference's decisions, the
    accepted ranks, the stride on the first factor."""
    data, init_sd = _family("resstage")
    model, config = falor.decompose(
        module=utils.load_numpy_state_dict(_ResStage(), init_sd),
        data_iterator=_tensors(data["calib_x"]), device="cpu",
        **_hparams("resstage_falor", "transformer_goldens_hparams.json"))
    with open(GOLDEN / "resstage_falor_config.json") as f:
        ref_config = json.load(f)
    assert set(config) == set(ref_config)
    for name, ref in ref_config.items():
        ref_entry = {k: v for k, v in ref.items() if k != "__meta__"}
        assert config[name]["__meta__"]["proportion"] == ref["__meta__"]["proportion"], name
        rank_best = round(ref["__meta__"]["proportion"] * _entry_full_rank(ref_entry))
        assert {k: v for k, v in config[name].items() if k != "__meta__"} == _rewrite_rank(
            ref_entry, rank_best), name
    for name in ("conv_a", "down"):
        assert config[name]["modules"]["0"]["stride"] == [2, 2]
    assert not model.training  # falor runs the model in eval mode


def test_linear_rank6_golden():
    """The covariance path (no mean, damped) of the reference on one Linear:
    the rank-6 factor pair reproduces its output."""
    g = np.load(GOLDEN / "falor_linear_rank6.npz")
    lin = torch.nn.Linear(48, 40)
    lin.weight.data, lin.bias.data = torch.from_numpy(g["weight"]), torch.from_numpy(g["bias"])
    net = torch.nn.Sequential(lin)
    grams, means = engine.compute_output_grams(
        net, ["0"], iter([torch.from_numpy(b) for b in g["batches"]]), 8, device="cpu")
    assert not means["0"].any()
    u = engine.eigenvectors_from_gram(grams["0"], use_damping=True, in_float64=True)
    site = engine.get_site(net, "0")
    w1, w2 = engine.build_factors(engine.get_site_weight2d(net, site), u, int(g["rank"]))
    pnn.replace_submodule(net, "0", engine.build_decomposed_module(net, site, w1, w2))
    with torch.no_grad():
        y = net(torch.from_numpy(g["x0"])).numpy()
    np.testing.assert_allclose(y, g["y1"], atol=2e-5)


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("use_damping", [False, True])
def test_eigenbasis_matches_jax(use_mean, use_damping):
    """The mean-centred, damped eigenbasis against the JAX package's: the
    top-k projectors agree."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal((200, 24)) @ rng.standard_normal((24, 24)) + 3.0
    gram, mean = y.T @ y / 200, y.mean(axis=0)
    u = engine.eigenvectors_from_gram(torch.from_numpy(gram), use_damping=use_damping,
                                      mean=torch.from_numpy(mean) if use_mean else None)
    uj = jengine.eigenvectors_from_gram(jnp.asarray(gram, jnp.float32),
                                        use_damping=use_damping,
                                        mean=jnp.asarray(mean, jnp.float32) if use_mean else None)
    for k in (3, 10):
        np.testing.assert_allclose((u[:, -k:] @ u[:, -k:].t()).numpy(),
                                   uj[:, -k:] @ uj[:, -k:].T, atol=1e-6)


@pytest.mark.parametrize("use_mean", [False, True])
def test_cnn_matches_jax(use_mean):
    """The port and the JAX package on the CNN toy, mean-centred or not:
    the same sites at the same ranks, meta within a few percent, and the
    decomposed models' outputs within 5e-4."""
    data, init_sd = _family("whole_cnn")
    hp = {**_hparams(), "use_mean": use_mean}
    jmodel, jconfig = jfalor.decompose(
        module=jax_make_cnn(init_sd), data_iterator=_cycle_tensors(data["calib_x"], True), **hp)
    model, config = falor.decompose(
        module=utils.load_numpy_state_dict(_CNN(), init_sd),
        data_iterator=_tensors(data["calib_x"]), device="cpu", **hp)
    assert {n: {k: v for k, v in c.items() if k != "__meta__"} for n, c in config.items()} == {
        n: {k: v for k, v in c.items() if k != "__meta__"} for n, c in jconfig.items()}
    for name, c in jconfig.items():
        assert config[name]["__meta__"]["proportion"] == c["__meta__"]["proportion"], name
        for key in ("nsr_final", "kl_final"):
            np.testing.assert_allclose(config[name]["__meta__"][key], c["__meta__"][key],
                                       rtol=0.05, atol=1e-4)
    probe = data["probe"]
    y_jax = np.asarray(jmodel(jnp.asarray(probe.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        y = model(torch.from_numpy(probe)).numpy()
    np.testing.assert_allclose(y, y_jax, atol=5e-4)


def _walk(tmp, **kw):
    data, init_sd = _family("whole_cnn")
    return falor.decompose(
        module=utils.load_numpy_state_dict(_CNN(), init_sd),
        data_iterator=_tensors(data["calib_x"]), device="cpu", checkpoint_dir=str(tmp),
        **{**_hparams(), **kw})


def test_checkpoint_resumes_to_an_equal_config(tmp_path):
    """A second walk with the same directory replays every site: an equal
    config and bit-equal weights.  A walk cut after its first site resumes
    to the same decisions (its later sites see the batch stream from its
    start, so their meta values may differ).  Another walk with other
    hyperparameters refuses the directory."""
    model, config = _walk(tmp_path)
    progress = tmp_path / "falor_phase1.jsonl"
    lines = progress.read_text().splitlines()
    assert [json.loads(line)["site"] for line in lines] == ["conv2", "conv3", "fc"]
    replayed, config2 = _walk(tmp_path)
    assert config2 == config
    for k, v in utils.state_dict(model).items():
        assert torch.equal(v, utils.state_dict(replayed)[k]), k
    progress.write_text(lines[0] + "\n")
    _, config3 = _walk(tmp_path)
    assert config3["conv2"] == config["conv2"]
    assert {n: (c["modules"], c["__meta__"]["proportion"]) for n, c in config3.items()} == {
        n: (c["modules"], c["__meta__"]["proportion"]) for n, c in config.items()}
    with pytest.raises(ValueError, match="different falor hyperparameters"):
        _walk(tmp_path, use_mean=True)
