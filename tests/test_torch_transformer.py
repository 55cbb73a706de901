"""The PyTorch port's llama CausalLM against the JAX CausalLM, on the GQA
golden model's weights (a 2-block grouped-query llama), on the CPU."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import models as jmodels, utils as jutils
from ptdeco_tpu_torch import models as tmodels, utils as tutils

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _gqa():
    data = np.load(GOLDEN / "gqa_data.npz")
    init_sd = {k[len("init__"):]: data[k] for k in data.files if k.startswith("init__")}
    with open(GOLDEN / "gqa_hf_config.json") as f:
        hf_cfg = json.load(f)
    return data, init_sd, hf_cfg


def make_torch_gqa(init_sd, hf_cfg):
    cfg = tmodels.TransformerConfig.from_hf_config(hf_cfg, dtype=torch.float32)
    model = tmodels.CausalLM(cfg, device="cpu")
    return tutils.load_numpy_state_dict(model, init_sd)


def test_config_from_hf_llama():
    _, _, hf_cfg = _gqa()
    cfg = tmodels.TransformerConfig.from_hf_config(hf_cfg, dtype=torch.float32)
    assert (cfg.vocab_size, cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads) == (
        128, 64, 2, 4, 2,
    )
    assert cfg.hidden_dim == 128 and cfg.head_dim == 16 and cfg.norm_eps == 1e-5
    tl = tmodels.TransformerConfig.tinyllama_1_1b()
    assert (tl.dim, tl.n_heads, tl.n_kv_heads, tl.hidden_dim, tl.head_dim) == (
        2048, 32, 4, 5632, 64,
    )
    with pytest.raises(ValueError):
        tmodels.TransformerConfig.from_hf_config({**hf_cfg, "model_type": "modernbert-decoder"})


def test_parameter_names_follow_hf_llama():
    data, init_sd, hf_cfg = _gqa()
    model = make_torch_gqa(init_sd, hf_cfg)
    assert set(model.state_dict().keys()) == set(init_sd.keys())


@pytest.mark.parametrize("with_mask", [False, True])
def test_logits_match_jax(with_mask):
    data, init_sd, hf_cfg = _gqa()
    jcfg = jmodels.TransformerConfig.from_hf_config(hf_cfg, dtype=jnp.float32)
    jm = jutils.load_state_dict(jmodels.CausalLM.create(jax.random.PRNGKey(0), jcfg), init_sd)
    tm = make_torch_gqa(init_sd, hf_cfg)

    ids = data["probe_ids"].astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, -3:] = 0  # right padding
    jbatch = {"input_ids": jnp.asarray(ids)}
    tbatch = {"input_ids": torch.from_numpy(ids).long()}
    if with_mask:
        jbatch["attention_mask"] = jnp.asarray(mask)
        tbatch["attention_mask"] = torch.from_numpy(mask)
    y_jax = np.asarray(jm(jbatch))
    with torch.no_grad():
        y_torch = tm(tbatch)
    np.testing.assert_allclose(y_torch.numpy(), y_jax, atol=1e-4)
    loss_j = float(jmodels.transformer.ce_loss(jbatch, jnp.asarray(y_jax)))
    loss_t = float(tmodels.ce_loss(tbatch, y_torch))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
