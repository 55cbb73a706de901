"""The port's OLMo-2, OLMo-3, SmolLM3, GLM, GLM-4 and Ministral decoders and
the code_llama and got_ocr2 aliases against the JAX package's, on the CPU,
at tiny widths (hidden 32, 2 layers): each config field equal to JAX's, the
state-dict keys equal, f32 logits within 1e-4 and the loss within rtol 1e-5
on the JAX model's weights (norms and biases moved off their initial
values), carried over with ``utils.state_dict`` -> ``load_numpy_state_dict``,
in cases where each feature binds: OLMo-2's flat q/k norms, post-norm-only
blocks and ``clip_qkv``; OLMo-3's window of 4 against 16 tokens with yarn on
its full layer; SmolLM3's NoPE layer; GLM's and GLM-4's partial,
pair-interleaved rotary; Ministral's sliding and full layers.  Then
KV-cached ``generate`` against JAX ``serving.generate`` (OLMo-3 across its
window), the cache mask's window on OLMo-3 and Ministral, one ``dwain.decompose`` walk on OLMo-2 against the JAX walk, and
GLM and GLM-4 snapshots in their checkpoint layouts through the trainer's
builder."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, models as jmodels, serving as jserving, utils as jutils
from ptdeco_tpu_torch import dwain as tdwain, models as tmodels, serving as tserving
from ptdeco_tpu_torch import utils as tutils
from ptdeco_tpu_torch.apps.trainer_llm import builder

from test_torch_families import tiny_hf
from test_torch_moe import jax_logits, probe_ids
from test_torch_rope_gemma_phi3 import CONFIG_FIELDS as EARLIER_FIELDS, _cycle

SLIDING_FULL = ["sliding_attention", "full_attention"]
CASES = {
    # q and k normed over the whole projection (RMS ~1), then clamped at 0.5
    "olmo2": tiny_hf("olmo2", clip_qkv=0.5),
    # (sliding, full): the sliding layer rotates at rope_theta unscaled, the
    # full one with yarn
    "olmo3": tiny_hf("olmo3", layer_types=SLIDING_FULL, sliding_window=4, rope_scaling={
        "rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16}),
    # the second layer is NoPE
    "smollm3": tiny_hf("smollm3", no_rope_layers=[1, 0], tie_word_embeddings=True),
    # 4 of each head's 8 dims rotate, pair-interleaved; q/k/v biases by default
    "glm": tiny_hf("glm", head_dim=8, partial_rotary_factor=0.5),
    "glm4": tiny_hf("glm4", head_dim=8, partial_rotary_factor=0.5, attention_bias=True),
    "ministral": tiny_hf("ministral", layer_types=SLIDING_FULL, sliding_window=4),
    "code_llama": tiny_hf("code_llama", rope_theta=1e6),
    # the wrapper's text_config names no model type: qwen2 by default
    "got_ocr2": {"model_type": "got_ocr2", "text_config": {
        k: v for k, v in tiny_hf("qwen2", rope_theta=1e6).items() if k != "model_type"}},
}
CONFIG_FIELDS = (*EARLIER_FIELDS, "qk_norm_flat", "post_norm_only", "rope_layers",
                 "rope_partial_factor", "rope_interleaved", "clip_qkv")
# what makes each feature bind: the port without it gives other logits
WITHOUT_FEATURE = {
    "olmo2": {"clip_qkv": None},
    "olmo3": {"sliding_window": None},
    "smollm3": {"rope_layers": ()},
    "glm4": {"rope_interleaved": False},
    "ministral": {"sliding_window": None},
}


@functools.lru_cache(maxsize=None)
def _jax_model(case: str):
    """One JAX model a case (a model's first call compiles), shared by the
    tests: JAX modules are immutable, and each test gets a port copy."""
    seed = sorted(CASES).index(case)
    jm = jmodels.CausalLM.create(
        jax.random.PRNGKey(seed),
        jmodels.TransformerConfig.from_hf_config(CASES[case], dtype=jnp.float32))
    sd = jutils.state_dict(jm)
    rng = np.random.default_rng(seed)
    for k in sd:
        if "norm" in k or k.endswith("bias"):
            sd[k] = (sd[k] + 0.2 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return jutils.load_state_dict(jm, sd), sd


def port_model(case: str, sd: dict, **over) -> tmodels.CausalLM:
    tcfg = tmodels.TransformerConfig.from_hf_config(CASES[case], dtype=torch.float32)
    return tutils.load_numpy_state_dict(
        tmodels.CausalLM(dataclasses.replace(tcfg, **over), device="cpu"), sd)


def pair(case: str):
    """The JAX model and the port's, holding the same weights."""
    jm, sd = _jax_model(case)
    return jm, port_model(case, sd), dict(sd)


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_fields_match_jax(case):
    jcfg = jmodels.TransformerConfig.from_hf_config(CASES[case], dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(CASES[case], dtype=torch.float32)
    for field in CONFIG_FIELDS:
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_keys_match_jax(case):
    _, tm, sd = pair(case)
    assert set(tm.state_dict()) == set(sd)


@pytest.mark.parametrize("case", sorted(set(CASES) - {"code_llama", "got_ocr2"}))
def test_logits_match_jax(case):
    jm, tm, sd = pair(case)
    ids = probe_ids(128, (2, 16), seed=4)
    y_jax = jax_logits(jm, ids)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    with torch.no_grad():
        y = tm(batch)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)
    loss_j = float(jmodels.transformer.ce_loss({"input_ids": jnp.asarray(ids)}, jnp.asarray(y_jax)))
    np.testing.assert_allclose(float(tmodels.ce_loss(batch, y)), loss_j, rtol=1e-5)
    if case in WITHOUT_FEATURE:
        with torch.no_grad():
            y_without = port_model(case, sd, **WITHOUT_FEATURE[case])(batch)
        assert float((y_without - y).abs().max()) > 1e-3, "the feature does not bind"


def test_the_layers_take_their_own_norms_rope_and_window():
    """OLMo-2's blocks hold no input norm and flat q/k norms; OLMo-3's
    sliding layer rotates at rope_theta without yarn and sees 4 keys;
    SmolLM3's second layer is NoPE; GLM-4 rotates 4 of 8 dims interleaved
    and has sandwich norms."""
    _, olmo2, _ = pair("olmo2")
    block = olmo2.model.layers[0]
    assert block.input_layernorm is None and block.pre_feedforward_layernorm is None
    assert block.self_attn.q_norm.weight.shape == (32,) and block.self_attn.k_norm.weight.shape == (16,)
    sliding, full = (layer.self_attn for layer in pair("olmo3")[1].model.layers)
    assert (sliding.rope_theta, sliding.rope_yarn, sliding.sliding_window) == (10000.0, None, 4)
    assert full.rope_yarn is not None and full.sliding_window is None
    assert [layer.self_attn.use_rope for layer in pair("smollm3")[1].model.layers] == [True, False]
    glm4 = pair("glm4")[1].model.layers[0]
    assert (glm4.self_attn.rope_partial_dim, glm4.self_attn.rope_interleaved) == (4, True)
    assert glm4.pre_feedforward_layernorm is not None and glm4.self_attn.o_proj.bias is None


@pytest.mark.parametrize("case", ["glm4", "olmo3", "smollm3"])
def test_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache gives the JAX package's tokens
    (OLMo-3's 9 prompt and 8 new tokens cross its window of 4); the logits
    that chose each new token equal the JAX model's forward over the whole
    sequence (f32, 1e-4)."""
    jm, tm, _ = pair(case)
    prompt = probe_ids(128, (2, 9), seed=7)
    toks, step_logits = tserving.generate(tm, torch.from_numpy(prompt).long(), 8,
                                          return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(toks.numpy(), want)
    full = np.concatenate([prompt, want[:, :-1]], axis=1).astype(np.int32)
    np.testing.assert_allclose(step_logits.numpy(), jax_logits(jm, full)[:, 8:], atol=1e-4)


@pytest.mark.parametrize("case", ["ministral", "olmo3"])
def test_the_cache_mask_takes_the_window(case):
    """Cached ``generate`` over 9 prompt and 8 new tokens (a window of 4 on
    the sliding layer) chooses from the uncached forward's logits over the
    whole sequence (f32, 1e-4), which the model without the window does
    not give."""
    _, tm, sd = pair(case)
    prompt = torch.from_numpy(probe_ids(128, (2, 9), seed=7)).long()
    toks, step_logits = tserving.generate(tm, prompt, 8, return_logits=True)
    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.no_grad():
        y = tm(full)[:, 8:]
        y_unwindowed = port_model(case, sd, sliding_window=None)(full)[:, 8:]
    torch.testing.assert_close(step_logits, y, rtol=0, atol=1e-4)
    assert float((y_unwindowed - y).abs().max()) > 1e-3


def test_dwain_decompose_olmo2_matches_jax():
    """One walk over layer 0's q_proj, whose output the flat q norm reads:
    the JAX walk's sites, ranks and config (float metrics within rtol
    1e-4), and the decomposed model's logits within 1e-4 of JAX's."""
    hp = dict(num_data_steps=1, num_metric_steps=1, nsr_final_threshold=0.2, min_rank=8,
              trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
              decompose_in_float64=True)
    walked = ("model.layers.0.self_attn.q_proj",)
    jm, tm, _ = pair("olmo2")
    black = ["lm_head", *(n for n, m in tm.named_modules()
                          if isinstance(m, torch.nn.Linear) and n not in walked)]
    rng = np.random.default_rng(5)
    calib, metric = (rng.integers(0, 128, (2, 2, 16)).astype(np.int32) for _ in range(2))
    jm, jconf = jdwain.decompose(module=jm, data_iterator=_cycle(calib, False),
                                 metric_iterator=_cycle(metric, False), loss_fn=jmodels.ce_loss,
                                 blacklisted_module_names=black, **hp)
    tm, tconf = tdwain.decompose(module=tm, data_iterator=_cycle(calib, True),
                                 metric_iterator=_cycle(metric, True), loss_fn=tmodels.ce_loss,
                                 blacklisted_module_names=black, device="cpu", **hp)
    assert set(tconf) == set(jconf) == set(walked)
    for site, entry in jconf.items():
        for field, value in entry["__meta__"].items():
            if isinstance(value, float):
                np.testing.assert_allclose(tconf[site]["__meta__"][field], value, rtol=1e-4)
                tconf[site]["__meta__"][field] = value
    assert json.dumps(tconf) == json.dumps(jconf)
    ids = probe_ids(128, (2, 16), seed=4)
    with torch.no_grad():
        y = tm({"input_ids": torch.from_numpy(ids).long()})
    np.testing.assert_allclose(y.numpy(), jax_logits(jm, ids), atol=1e-4)


def _fused_gate_up(sd: dict) -> dict:
    """GLM's checkpoint layout: gate/up in ``mlp.gate_up_proj``."""
    out = {}
    for k, v in sd.items():
        if k.endswith("mlp.gate_proj.weight"):
            stem = k[: -len("gate_proj.weight")]
            out[stem + "gate_up_proj.weight"] = np.concatenate(
                [sd[stem + "gate_proj.weight"], sd[stem + "up_proj.weight"]])
        elif not k.endswith("mlp.up_proj.weight"):
            out[k] = v
    return out


def _glm4_layout(sd: dict) -> dict:
    """GLM-4's checkpoint layout: the fused gate/up and its own norm names
    (the attention output's ``post_self_attn_layernorm``, the pre-MLP
    ``post_attention_layernorm``, the MLP output's ``post_mlp_layernorm``)."""
    names = {".post_attention_layernorm.": ".post_self_attn_layernorm.",
             ".pre_feedforward_layernorm.": ".post_attention_layernorm.",
             ".post_feedforward_layernorm.": ".post_mlp_layernorm."}
    out = {}
    for k, v in _fused_gate_up(sd).items():
        for ours, theirs in names.items():
            if ours in k:
                k = k.replace(ours, theirs)
                break
        out[k] = v
    return out


@pytest.mark.parametrize("case,layout", [("glm", _fused_gate_up), ("glm4", _glm4_layout)])
def test_snapshot_loads_through_the_builder(case, layout, tmp_path, monkeypatch):
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    _, tm, sd = pair(case)
    stored = layout(sd)
    assert set(stored) != set(sd)
    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(CASES[case]))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in stored.items()},
               snap / "pytorch_model.bin")
    model, _ = builder.make_model_and_tokenizer(
        model_name=f"someorg/some-{case}", dtype="float32", checkpoint_path=str(snap), device="cpu")
    ids = torch.from_numpy(probe_ids(128, (2, 7), seed=6)).long()
    with torch.no_grad():
        torch.testing.assert_close(model({"input_ids": ids}), tm({"input_ids": ids}),
                                   rtol=0, atol=0)
