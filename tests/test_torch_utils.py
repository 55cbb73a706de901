"""The PyTorch port's utils against the JAX package's: loss primitives,
decompose_config JSON, and the .pt state-dict artifact in both directions."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import models as jmodels, utils as jutils
from ptdeco_tpu_torch import models as tmodels, nn as tnn, utils as tutils

GOLDEN = pathlib.Path(__file__).parent / "golden"


def test_nsr_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 11)).astype(np.float32)
    y = rng.standard_normal((3, 7, 11)).astype(np.float32)
    for dims in [(0, 1), (0, 2), (1,)]:
        ours = tutils.calc_per_channel_noise_to_signal_ratio(
            torch.from_numpy(x), torch.from_numpy(y), non_channel_dim=dims
        )
        ref = jutils.calc_per_channel_noise_to_signal_ratio(
            jnp.asarray(x), jnp.asarray(y), non_channel_dim=dims
        )
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_kl_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((5, 9)).astype(np.float32)
    b = rng.standard_normal((5, 9)).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(
        tutils.calc_kl_divergence(ta, tb).numpy(),
        np.asarray(jutils.calc_kl_divergence(ja, jb)),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        float(tutils.calc_kl_loss(ta, tb)), float(jutils.calc_kl_loss(ja, jb)), rtol=1e-5
    )


@pytest.mark.parametrize(
    "stem", ["whole_dwain_mlp", "gqa", "whole_dwain_cnn", "resstage"]
)
def test_module_config_json_is_byte_identical(stem):
    with open(GOLDEN / f"{stem}_config.json") as f:
        golden = json.load(f)
    for name, entry in golden.items():
        structure = {k: v for k, v in entry.items() if k != "__meta__"}
        ours = tutils.get_module_config(
            tutils.build_module_from_config(structure, device="cpu")
        )
        theirs = jutils.get_module_config(jutils.build_module_from_config(structure))
        assert json.dumps(ours) == json.dumps(theirs), name
        assert json.dumps(ours, sort_keys=True) == json.dumps(structure, sort_keys=True), name


def test_built_modules_are_torch_modules():
    cfg = {"type": "Sequential", "modules": {
        "0": {"type": "Linear", "in_features": 6, "out_features": 2, "bias": False},
        "1": {"type": "Conv2d", "in_channels": 2, "out_channels": 5, "kernel_size": [1, 1],
              "bias": True, "groups": 1, "padding": [0, 0], "padding_mode": "zeros",
              "stride": [2, 2], "dilation": [1, 1]},
    }}
    m = tutils.build_module_from_config(cfg, dtype=torch.bfloat16, device="cpu")
    assert isinstance(m[0], torch.nn.Linear) and isinstance(m[1], torch.nn.Conv2d)
    assert m[1].stride == (2, 2) and m[0].weight.dtype == torch.bfloat16
    assert all(float(p.detach().abs().sum()) == 0.0 for p in m.parameters())


def test_num_params_and_names():
    m = tmodels.make_mlp(dim=8, depth=2, n_out=3, device="cpu")
    assert tutils.get_num_params(m) == 2 * (8 * 8 + 8) + 8 * 3 + 3
    assert tutils.split_module_parent_child_name("a.b.c") == ("a.b", "c")
    assert tutils.split_module_parent_child_name("a") == ("", "a")
    assert tnn.get_submodule(m, "blocks.1") is m.blocks[1]


def _jax_gqa_bf16():
    with open(GOLDEN / "gqa_hf_config.json") as f:
        hf = json.load(f)
    jcfg = jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.bfloat16)
    tcfg = tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.bfloat16)
    return jmodels.CausalLM.create(jax.random.PRNGKey(3), jcfg), tcfg


def test_numpy_state_dict_loads_bf16_weights_bit_exact():
    jm, tcfg = _jax_gqa_bf16()
    sd = jutils.state_dict(jm)
    tm = tutils.load_numpy_state_dict(tmodels.CausalLM(tcfg, device="cpu"), sd)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.to(torch.float32).numpy(), sd[k].astype(np.float32), k)


def test_pt_round_trips_between_packages(tmp_path):
    jm, tcfg = _jax_gqa_bf16()
    # port writes, JAX package reads
    tm = tutils.load_numpy_state_dict(tmodels.CausalLM(tcfg, device="cpu"), jutils.state_dict(jm))
    tutils.save_state_dict_pt(tutils.state_dict(tm), str(tmp_path / "port.pt"))
    back = jutils.load_state_dict_pt(str(tmp_path / "port.pt"))
    jm2 = jutils.load_state_dict(jm, back)
    for k, v in jutils.state_dict(jm2).items():
        np.testing.assert_array_equal(v.astype(np.float32), back[k].astype(np.float32), k)
    # JAX package writes, port reads
    jutils.save_state_dict_pt(jutils.state_dict(jm), str(tmp_path / "jax.pt"))
    sd = tutils.load_state_dict_pt(str(tmp_path / "jax.pt"))
    tm2 = tutils.load_state_dict(tmodels.CausalLM(tcfg, device="cpu"), sd)
    for k, v in tm2.state_dict().items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, tm.state_dict()[k], rtol=0, atol=0)


def test_safetensors_round_trip(tmp_path):
    pytest.importorskip("safetensors")
    m = tmodels.make_mlp(dim=8, depth=1, n_out=3, device="cpu")
    tutils.save_state_dict_safetensors(tutils.state_dict(m), str(tmp_path / "m.safetensors"))
    sd = tutils.load_state_dict_safetensors(str(tmp_path / "m.safetensors"))
    for k, v in m.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_apply_decompose_config_keeps_device_and_dtype():
    m = tmodels.make_mlp(dim=8, depth=1, n_out=3, dtype=torch.bfloat16, device="cpu")
    cfg = {"blocks.0": {"type": "Sequential", "modules": {
        "0": {"type": "Linear", "in_features": 8, "out_features": 2, "bias": False},
        "1": {"type": "Linear", "in_features": 2, "out_features": 8, "bias": True},
    }}}
    tutils.apply_decompose_config(m, cfg)
    assert isinstance(m.blocks[0], torch.nn.Sequential)
    assert m.blocks[0][1].weight.dtype == torch.bfloat16
    assert sorted(m.state_dict()) == [
        "blocks.0.0.weight", "blocks.0.1.bias", "blocks.0.1.weight", "head.bias", "head.weight",
    ]
