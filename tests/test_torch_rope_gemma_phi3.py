"""The port's rope scaling (llama3, yarn, linear, phi3's short-factor
longrope) and its gemma2, gemma3_text (and the gemma3 wrapper) and phi3
decoders against the JAX package's, on the CPU, at tiny widths (hidden 32,
2 layers): each config field equal to JAX's, the state-dict keys equal, f32
logits within 1e-4 and the loss within rtol 1e-5 on the JAX model's
weights (norms and biases moved off their initial values), carried over
with ``utils.state_dict`` -> ``load_numpy_state_dict``.  Then KV-cached
``generate`` against JAX ``serving.generate`` (gemma3 across its window),
one ``dwain.decompose`` walk on gemma3 against the JAX walk, and a fused
phi3 and a gemma3 wrapper snapshot through the trainer's builder."""

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

GEMMA3_TEXT = dict(
    head_dim=8, query_pre_attn_scalar=12, sliding_window=4, rope_theta=10000.0,
    rope_local_base_freq=100.0, rope_scaling={"rope_type": "linear", "factor": 2.0},
    hidden_activation="gelu_pytorch_tanh", attention_bias=True,
)
CASES = {
    # wavelengths 6.3 / 63 / 628 / 6283 against an original context of 64:
    # one passes, one is interpolated, two are divided by the factor
    "llama3_rope": tiny_hf("llama", rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 64}),
    "yarn_rope": tiny_hf("llama", rope_scaling={
        "rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16}),
    "linear_rope": tiny_hf("llama", rope_scaling={"type": "linear", "factor": 2.0}),
    # query_pre_attn_scalar != head_dim; caps small enough to bind
    "gemma2": tiny_hf("gemma2", head_dim=16, query_pre_attn_scalar=24, sliding_window=4096,
                      attn_logit_softcapping=0.5, final_logit_softcapping=0.05,
                      hidden_activation="gelu_pytorch_tanh"),
    # (sliding, full) layers, window 4 < seq 16, a local theta != theta,
    # linear scaling on the full layer, biases on all four projections
    "gemma3_text": tiny_hf("gemma3_text", layer_types=["sliding_attention", "full_attention"],
                           **GEMMA3_TEXT),
    # the multimodal wrapper; layer_types derived from the pattern
    "gemma3": {"model_type": "gemma3", "text_config": {
        k: v for k, v in tiny_hf("gemma3_text", sliding_window_pattern=2, **GEMMA3_TEXT).items()
        if k != "model_type"}},
    "phi3": tiny_hf("phi3", max_position_embeddings=128, original_max_position_embeddings=32,
                    sliding_window=2047, num_key_value_heads=4, rope_scaling={
                        "type": "longrope", "short_factor": [1.0, 1.5, 2.0, 3.0],
                        "long_factor": [4.0, 4.0, 4.0, 4.0]}),
}
CONFIG_FIELDS = (
    "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim", "norm_eps",
    "rope_theta", "qkv_bias", "tie_embeddings", "head_dim_override", "mlp_act",
    "scale_embeddings", "norm_plus_one", "qk_norm", "head_dim", "sandwich_norms",
    "attn_logit_softcap", "final_logit_softcap", "query_scale_override", "rope_llama3_scaling",
    "sliding_window", "layer_types", "o_proj_bias", "rope_yarn", "rope_local_theta",
)


@functools.lru_cache(maxsize=None)
def _jax_model(case: str, seed: int):
    jm = jmodels.CausalLM.create(
        jax.random.PRNGKey(seed),
        jmodels.TransformerConfig.from_hf_config(CASES[case], dtype=jnp.float32))
    sd = jutils.state_dict(jm)
    rng = np.random.default_rng(seed)
    for k in sd:
        if "norm" in k or k.endswith("bias"):
            sd[k] = (sd[k] + 0.2 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return jutils.load_state_dict(jm, sd), sd


def pair(case: str, seed: int = 0):
    """The JAX model and the port's, holding the same weights."""
    jm, sd = _jax_model(case, seed)
    tcfg = tmodels.TransformerConfig.from_hf_config(CASES[case], dtype=torch.float32)
    return jm, tutils.load_numpy_state_dict(tmodels.CausalLM(tcfg, device="cpu"), sd), dict(sd)


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_fields_match_jax(case):
    jcfg = jmodels.TransformerConfig.from_hf_config(CASES[case], dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(CASES[case], dtype=torch.float32)
    for field in CONFIG_FIELDS:
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case):
    jm, tm, sd = pair(case)
    assert set(tm.state_dict()) == set(sd)
    ids = probe_ids(128, (2, 16), seed=4)
    y_jax = jax_logits(jm, ids)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    with torch.no_grad():
        y = tm(batch)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)
    loss_j = float(jmodels.transformer.ce_loss({"input_ids": jnp.asarray(ids)}, jnp.asarray(y_jax)))
    np.testing.assert_allclose(float(tmodels.ce_loss(batch, y)), loss_j, rtol=1e-5)


def test_the_layers_take_their_own_rope_window_and_caps():
    """gemma3's sliding layer rotates at the local theta unscaled and sees 4
    keys; its full layer keeps theta and the linear scaling; gemma2 caps."""
    _, tm, _ = pair("gemma3")
    sliding, full = (layer.self_attn for layer in tm.model.layers)
    assert (sliding.rope_theta, sliding.rope_yarn, sliding.sliding_window) == (100.0, None, 4)
    assert full.rope_theta == 10000.0 and full.rope_yarn[1] == 1.0 and full.sliding_window is None
    assert full.o_proj.bias is not None and sliding.scale(8) == 12 ** -0.5
    _, tm2, _ = pair("gemma2")
    assert tm2.final_logit_softcap == 0.05
    assert tm2.model.layers[0].self_attn.logit_softcap == 0.5
    with torch.no_grad():
        assert float(tm2(torch.zeros((1, 3), dtype=torch.int64)).abs().max()) <= 0.05


@pytest.mark.parametrize("case", ["gemma2", "gemma3_text", "phi3"])
def test_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache gives the JAX package's tokens
    (gemma3's 6 prompt and 8 new tokens cross its window of 4); the logits
    that chose the last token equal the JAX cached forward's (f32, 1e-4)."""
    jm, tm, _ = pair(case, seed=2)
    prompt = probe_ids(128, (2, 6), seed=7)
    toks, step_logits = tserving.generate(tm, torch.from_numpy(prompt).long(), 8,
                                          return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(toks.numpy(), want)
    full = np.concatenate([prompt, want[:, :-1]], axis=1).astype(np.int32)
    caches = jserving.init_cache(jm, full.shape[0], full.shape[1])
    j_logits, _ = jserving.forward_with_cache(jm, jnp.asarray(full), caches, 0)
    np.testing.assert_allclose(step_logits[:, -1].numpy(), np.asarray(j_logits)[:, -1], atol=1e-4)


def _cycle(pool: np.ndarray, port: bool):
    i = 0
    while True:
        x = pool[i % len(pool)]
        i += 1
        yield {"input_ids": torch.from_numpy(x.astype(np.int64)) if port else jnp.asarray(x)}


def test_dwain_decompose_gemma3_matches_jax():
    """One walk over a site of the sliding layer (each JAX site compiles
    anew): the JAX walk's sites, ranks and config (float metrics within
    rtol 1e-4)."""
    hp = dict(num_data_steps=1, num_metric_steps=1, nsr_final_threshold=0.2, min_rank=2,
              trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
              decompose_in_float64=True)
    walked = ("model.layers.0.mlp.down_proj",)
    jm, tm, _ = pair("gemma3_text", seed=3)
    black = ["lm_head", *(n for n, m in tm.named_modules()
                          if isinstance(m, torch.nn.Linear) and n not in walked)]
    rng = np.random.default_rng(5)
    calib, metric = (rng.integers(0, 128, (2, 2, 16)).astype(np.int32) for _ in range(2))
    _, jconf = jdwain.decompose(module=jm, data_iterator=_cycle(calib, False),
                                metric_iterator=_cycle(metric, False), loss_fn=jmodels.ce_loss,
                                blacklisted_module_names=black, **hp)
    _, tconf = tdwain.decompose(module=tm, data_iterator=_cycle(calib, True),
                                metric_iterator=_cycle(metric, True), loss_fn=tmodels.ce_loss,
                                blacklisted_module_names=black, device="cpu", **hp)
    assert set(tconf) == set(jconf) and tconf
    for site, entry in jconf.items():
        for field, value in entry["__meta__"].items():
            if isinstance(value, float):
                np.testing.assert_allclose(tconf[site]["__meta__"][field], value, rtol=1e-4)
                tconf[site]["__meta__"][field] = value
    assert json.dumps(tconf) == json.dumps(jconf)


def _fused_phi3(sd: dict) -> dict:
    """phi3's checkpoint layout: q/k/v into ``qkv_proj``, gate/up into
    ``gate_up_proj``."""
    out = {}
    for k, v in sd.items():
        if k.endswith("self_attn.q_proj.weight"):
            stem = k[: -len("q_proj.weight")]
            out[stem + "qkv_proj.weight"] = np.concatenate(
                [sd[stem + f"{p}_proj.weight"] for p in "qkv"])
        elif k.endswith("mlp.gate_proj.weight"):
            stem = k[: -len("gate_proj.weight")]
            out[stem + "gate_up_proj.weight"] = np.concatenate(
                [sd[stem + "gate_proj.weight"], sd[stem + "up_proj.weight"]])
        elif not k.endswith(("k_proj.weight", "v_proj.weight", "up_proj.weight")):
            out[k] = v
    return out


def _wrapped_gemma3(sd: dict) -> dict:
    """The gemma3 wrapper's layout: the text model under
    ``model.language_model``, a vision tower beside it, a tied head stored."""
    out = {k.replace("model.", "model.language_model.", 1): v for k, v in sd.items()}
    out["model.vision_tower.patch_embedding.weight"] = np.ones((4, 3), np.float32)
    out["lm_head.weight"] = sd["model.embed_tokens.weight"]
    return out


@pytest.mark.parametrize("case,layout", [("phi3", _fused_phi3), ("gemma3", _wrapped_gemma3)])
def test_snapshot_loads_through_the_builder(case, layout, tmp_path, monkeypatch):
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    _, tm, sd = pair(case, seed=1)
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


def test_phi3_refusals():
    """Another phi3 rope type is refused by both packages; a partial rotary
    phi3 (Phi-4-mini) only by the port, naming ROADMAP.md."""
    other = tiny_hf("phi3", rope_scaling={"rope_type": "linear", "factor": 2.0})
    with pytest.raises(ValueError):
        jmodels.TransformerConfig.from_hf_config(other, dtype=jnp.float32)
    with pytest.raises(ValueError):
        tmodels.TransformerConfig.from_hf_config(other, dtype=torch.float32)
    partial = tiny_hf("phi3", partial_rotary_factor=0.75)
    jmodels.TransformerConfig.from_hf_config(partial, dtype=jnp.float32)
    with pytest.raises(ValueError, match="ROADMAP"):
        tmodels.TransformerConfig.from_hf_config(partial, dtype=torch.float32)
