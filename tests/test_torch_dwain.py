"""The slice as a whole: the PyTorch port's dwain walk on the GQA golden
model (a 2-block grouped-query llama with thresholds near the accept
boundary), on the CPU, against the JAX package's walk on the same inputs
and against the torch reference's goldens."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu_torch import dwain, models, nn as tnn, utils

from test_torch_transformer import make_torch_gqa
from test_transformer_parity import _decompose_gqa, _hparams, _load, assert_decisions

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _cycle_ids(pool):
    i = 0
    while True:
        yield {"input_ids": torch.from_numpy(pool[i % len(pool)].astype(np.int64))}
        i += 1


def _hf_cfg():
    with open(GOLDEN / "gqa_hf_config.json") as f:
        return json.load(f)


def _probe(data):
    return {"input_ids": torch.from_numpy(data["probe_ids"].astype(np.int64))}


@pytest.fixture(scope="module")
def jax_run():
    data, _ = _load("gqa")
    return _decompose_gqa(data, _hparams()["gqa"])


@pytest.fixture(scope="module")
def port_run():
    hp = _hparams()["gqa"]
    data, init_sd = _load("gqa")
    model = make_torch_gqa(init_sd, _hf_cfg())
    model, config = dwain.decompose(
        module=model,
        data_iterator=_cycle_ids(data["calib_ids"]),
        loss_fn=models.ce_loss,
        metric_iterator=_cycle_ids(data["metric_ids"]),
        blacklisted_module_names=["lm_head"],
        num_data_steps=hp["num_data_steps"],
        num_metric_steps=hp["num_metric_steps"],
        nsr_final_threshold=hp["nsr_final_threshold"],
        min_rank=hp["min_rank"],
        trade_off_factor=hp["trade_off_factor"],
        reduction_factor=hp["reduction_factor"],
        max_accepted_ppl_diff=hp["max_accepted_ppl_diff"],
        decompose_in_float64=hp["decompose_in_float64"],
        device="cpu",
    )
    return data, model, config


def test_decisions_match_reference_golden(port_run):
    _, _, config = port_run
    assert len(config) == 14
    assert_decisions(config, "gqa")


def test_decisions_match_jax_package(port_run, jax_run):
    _, _, config = port_run
    _, jax_config = jax_run
    assert set(config) == set(jax_config)
    for name, entry in jax_config.items():
        ours = config[name]
        assert {k: v for k, v in ours.items() if k != "__meta__"} == {
            k: v for k, v in entry.items() if k != "__meta__"
        }, name
        assert ours["__meta__"]["proportion"] == entry["__meta__"]["proportion"], name
        assert ours["__meta__"]["drop_in_params"] == entry["__meta__"]["drop_in_params"], name
        for key in ("nsr_final", "ppl_final"):
            np.testing.assert_allclose(
                ours["__meta__"][key], entry["__meta__"][key], rtol=0.05, atol=1e-4,
                err_msg=f"{name}.{key}",
            )
    # the structure part of the config is the same JSON from either package
    def structure(c):
        return {k: {kk: vv for kk, vv in v.items() if kk != "__meta__"} for k, v in c.items()}

    assert json.dumps(structure(config), sort_keys=True) == json.dumps(
        structure(jax_config), sort_keys=True
    )


def test_probe_logits_match_reference(port_run, jax_run):
    data, model, _ = port_run
    with torch.no_grad():
        y = model(_probe(data)).numpy()
    np.testing.assert_allclose(y, data["y_gqa"], atol=2e-3)
    jax_model, _ = jax_run
    y_jax = np.asarray(jax_model({"input_ids": jnp.asarray(data["probe_ids"].astype(np.int32))}))
    np.testing.assert_allclose(y, y_jax, atol=2e-3)


def test_state_dict_keys_and_shapes_match_reference(port_run):
    _, model, _ = port_run
    ref_sd = dict(np.load(GOLDEN / "gqa_sd.npz").items())
    ours = utils.state_dict(model)
    assert set(ours) == set(ref_sd)
    for k, v in ref_sd.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k


def test_artifact_round_trip(port_run, tmp_path):
    data, model, config = port_run
    with open(tmp_path / "decompose_config.json", "w") as f:
        json.dump(config, f)
    utils.save_state_dict_pt(utils.state_dict(model), str(tmp_path / "decompose_state_dict.pt"))

    with open(tmp_path / "decompose_config.json") as f:
        config2 = json.load(f)
    fresh = models.CausalLM(
        models.TransformerConfig.from_hf_config(_hf_cfg(), dtype=torch.float32), device="cpu"
    )
    utils.apply_decompose_config(fresh, config2)
    utils.load_state_dict(fresh, utils.load_state_dict_pt(str(tmp_path / "decompose_state_dict.pt")))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(_probe(data)).numpy(), model(_probe(data)).numpy())


def test_fused_pairs_match_unfused(port_run):
    data, model, _ = port_run
    probe = _probe(data)
    with torch.no_grad():
        y_pairs = model(probe)
        tnn.fuse_factor_pairs(model)
        try:
            n_fused = sum(isinstance(m, tnn.FusedLowRankLinear) for m in model.modules())
            y_fused = model(probe)
        finally:
            tnn.unfuse_factor_pairs(model)
        y_back = model(probe)
    assert n_fused == 14
    np.testing.assert_allclose(y_fused.numpy(), y_pairs.numpy(), atol=1e-5)
    np.testing.assert_array_equal(y_back.numpy(), y_pairs.numpy())


def test_unported_options_raise():
    model = models.make_mlp(dim=8, depth=1, n_out=4, device="cpu")
    common = dict(
        module=model, data_iterator=iter([]), loss_fn=None, num_data_steps=1,
        metric_iterator=iter([]), num_metric_steps=1, nsr_final_threshold=0.1,
        device="cpu",
    )
    for extra in (
        {"finetune_fn": lambda m, names: m},
        {"precomputing_covariance_num_splits": 2},
        {"checkpoint_dir": "unused"},
        {"eigh_method": "randomized"},
    ):
        with pytest.raises(NotImplementedError):
            dwain.decompose(**common, **extra)


class _MLP(torch.nn.Module):
    """The reference generator's whole-model MLP (fc1-fc3, relu)."""

    def __init__(self):
        super().__init__()
        self.fc1, self.fc2, self.fc3 = (
            torch.nn.Linear(64, 96), torch.nn.Linear(96, 48), torch.nn.Linear(48, 10)
        )

    def forward(self, batch):
        x = batch["inp"] if isinstance(batch, dict) else batch
        return self.fc3(torch.relu(self.fc2(torch.relu(self.fc1(x)))))


class _CNN(torch.nn.Module):
    """The reference generator's whole-model CNN (NCHW; 1x1 conv sites)."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 16, 3, padding=1)
        self.conv2 = torch.nn.Conv2d(16, 32, 1)
        self.conv3 = torch.nn.Conv2d(32, 24, 1)
        self.fc = torch.nn.Linear(24, 10)

    def forward(self, batch):
        x = batch["inp"] if isinstance(batch, dict) else batch
        for conv in (self.conv1, self.conv2, self.conv3):
            x = torch.relu(conv(x))
        return self.fc(x.mean(dim=(2, 3)))


def _cycle_labelled(xs, ys):
    i = 0
    while True:
        yield {"inp": torch.from_numpy(xs[i % len(xs)]), "labels": torch.from_numpy(ys[i % len(ys)])}
        i += 1


@pytest.mark.parametrize("family,make", [("mlp", _MLP), ("cnn", _CNN)])
def test_whole_model_goldens(family, make):
    """Linear sites with biases and 1x1-conv sites, against the torch
    reference's decisions and final outputs (tests/test_whole_model_parity.py
    runs the JAX package on the same goldens)."""
    with open(GOLDEN / "whole_model_hparams.json") as f:
        hp = json.load(f)["dwain"]
    data = np.load(GOLDEN / f"whole_{family}_data.npz")
    init_sd = {k[len("init__"):]: data[k] for k in data.files if k.startswith("init__")}
    model = utils.load_numpy_state_dict(make(), init_sd)
    model, config = dwain.decompose(
        module=model,
        data_iterator=_cycle_labelled(data["calib_x"], data["calib_y"]),
        loss_fn=lambda batch, logits: torch.nn.functional.cross_entropy(logits, batch["labels"]),
        metric_iterator=_cycle_labelled(data["metric_x"], data["metric_y"]),
        device="cpu",
        **hp,
    )
    assert_decisions(config, f"whole_dwain_{family}")
    ref_sd = dict(np.load(GOLDEN / f"whole_dwain_{family}_sd.npz").items())
    ours = utils.state_dict(model)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref_sd.items()
    }
    with torch.no_grad():
        y = model(torch.from_numpy(data["probe"])).numpy()
    np.testing.assert_allclose(y, data["y_dwain"], atol=5e-4)
