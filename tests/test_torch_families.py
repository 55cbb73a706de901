"""The port's llama-family decoders beyond llama (mistral, qwen2, qwen3,
gemma, the MoE decoders and DeepSeek's) against the JAX package's, on the CPU: a tiny HF ``config.json`` of
each family goes through both ``from_hf_config``s, the JAX model's weights
(norm weights moved off their initial values) are carried into the port's
with ``utils.state_dict`` -> ``load_numpy_state_dict``, and the f32 logits
must agree within 1e-4 and the loss within rtol 1e-5 (as
``tests/test_torch_transformer.py``).  Then the configurations both
packages refuse, the trainer's ``qwen2-1.5b``, tied snapshots without an
``lm_head.weight``, and KV-cached ``generate`` of Qwen2, Gemma, Qwen3 and
Mistral against the JAX package's ``serving.generate``."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import models as jmodels, serving as jserving, utils as jutils
from ptdeco_tpu_torch import models as tmodels, serving as tserving, utils as tutils
from ptdeco_tpu_torch.apps.trainer_llm import builder

from test_torch_moe import jax_logits, probe_ids


def tiny_hf(model_type: str, **over) -> dict:
    hf = dict(model_type=model_type, vocab_size=128, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0)
    hf.update(over)
    return hf


FAMILIES = {
    "llama": tiny_hf("llama"),
    "mistral": tiny_hf("mistral", rope_theta=1e6, sliding_window=4096),
    "qwen2": tiny_hf("qwen2", rope_theta=1e6, tie_word_embeddings=True),
    "qwen3": tiny_hf("qwen3", rope_theta=1e6, head_dim=8, tie_word_embeddings=False),
    # head_dim * heads != hidden_size (gemma-7b's layout), one kv head, the
    # older snapshots' hidden_act "gelu"
    "gemma": tiny_hf("gemma", head_dim=16, num_key_value_heads=1, hidden_act="gelu"),
    # the MoE decoders (tests/test_torch_moe_families.py has their routes)
    "olmoe": tiny_hf("olmoe", num_experts=4, num_experts_per_tok=2),
    "qwen3_moe": tiny_hf("qwen3_moe", head_dim=8, num_experts=4, num_experts_per_tok=2,
                         moe_intermediate_size=16),
    # the latent-attention decoders (tests/test_torch_deepseek.py has their
    # routing branches and cached forms)
    "deepseek_v2": tiny_hf("deepseek_v2", n_routed_experts=4, num_experts_per_tok=2,
                           moe_intermediate_size=16, kv_lora_rank=8, q_lora_rank=None,
                           qk_rope_head_dim=4, qk_nope_head_dim=4, v_head_dim=8),
    "deepseek_v3": tiny_hf("deepseek_v3", n_routed_experts=4, num_experts_per_tok=2,
                           moe_intermediate_size=16, kv_lora_rank=8, q_lora_rank=None,
                           qk_rope_head_dim=4, qk_nope_head_dim=4, v_head_dim=8,
                           n_group=1, topk_group=1),
}


@functools.lru_cache(maxsize=None)
def _jax_model(family: str, seed: int):
    hf = FAMILIES[family]
    jm = jmodels.CausalLM.create(
        jax.random.PRNGKey(seed), jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    )
    sd = jutils.state_dict(jm)
    rng = np.random.default_rng(seed)
    for k in sd:
        if "norm" in k:  # off 1 (and off 0 for gemma's (1 + w) norms)
            sd[k] = (sd[k] + 0.2 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return jutils.load_state_dict(jm, sd), sd


def family_pair(family: str, seed: int = 0):
    """The JAX model of the family and the port's, holding the same weights."""
    jm, sd = _jax_model(family, seed)
    tm = tmodels.CausalLM(
        tmodels.TransformerConfig.from_hf_config(FAMILIES[family], dtype=torch.float32), device="cpu"
    )
    return jm, tutils.load_numpy_state_dict(tm, sd), dict(sd)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_logits_match_jax(family):
    hf = FAMILIES[family]
    jcfg = jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
                  "norm_eps", "rope_theta", "qkv_bias", "tie_embeddings", "head_dim_override",
                  "mlp_act", "scale_embeddings", "norm_plus_one", "qk_norm", "head_dim"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    jm, tm, sd = family_pair(family)
    assert set(tm.state_dict()) == set(sd)
    ids = probe_ids(hf["vocab_size"], (2, 11), seed=4)
    y_jax = jax_logits(jm, ids)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    with torch.no_grad():
        y = tm(batch)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)
    loss_j = float(jmodels.transformer.ce_loss({"input_ids": jnp.asarray(ids)}, jnp.asarray(y_jax)))
    np.testing.assert_allclose(float(tmodels.ce_loss(batch, y)), loss_j, rtol=1e-5)


# configurations the JAX package refuses, which the port refuses too; then
# ones the JAX package builds and the port does not have yet (ROADMAP.md)
REFUSED_BY_BOTH = {
    "llama_attention_bias": tiny_hf("llama", attention_bias=True),
    "mistral_mlp_bias": tiny_hf("mistral", mlp_bias=True),
    "gemma_attention_bias": tiny_hf("gemma", attention_bias=True),
    "qwen2_dynamic_rope": tiny_hf("qwen2", rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
    "llama_relu": tiny_hf("llama", hidden_act="relu"),
    "mamba": tiny_hf("mamba"),
    # the beyond-llama families' own refusals
    "falcon_alibi": tiny_hf("falcon", alibi=True),
    "stablelm_qk_layernorm": tiny_hf("stablelm", qk_layernorm=True),
    "stablelm_parallel_residual": tiny_hf("stablelm", use_parallel_residual=True),
    "cohere_qk_norm": tiny_hf("cohere", use_qk_norm=True),
    "gpt2_reorder_and_upcast_attn": dict(model_type="gpt2", vocab_size=128, n_embd=32, n_layer=2,
                                         n_head=4, n_positions=64, reorder_and_upcast_attn=True),
    "gpt2_scale_attn_by_inverse_layer_idx": dict(
        model_type="gpt2", vocab_size=128, n_embd=32, n_layer=2, n_head=4, n_positions=64,
        scale_attn_by_inverse_layer_idx=True),
    # the llama lineage's own refusals
    "olmo_attention_bias": tiny_hf("olmo", attention_bias=True),
    "hunyuan_rope_scaling": tiny_hf("hunyuan_v1_dense",
                                    rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
    "helium_gelu": tiny_hf("helium", hidden_act="gelu"),
    "open_llama_relu": tiny_hf("open-llama", hidden_act="relu"),
    "apertus_yarn": tiny_hf("apertus", rope_scaling={"rope_type": "yarn", "factor": 2.0}),
    # the position- and norm-knob decoders' own refusals
    "mpt_no_alibi": dict(model_type="mpt", vocab_size=128, d_model=32, n_heads=4, n_layers=2,
                         attn_config={"alibi": False}),
    "mpt_qk_ln": dict(model_type="mpt", vocab_size=128, d_model=32, n_heads=4, n_layers=2,
                      attn_config={"qk_ln": True}),
    "mpt_six_heads": dict(model_type="mpt", vocab_size=128, d_model=48, n_heads=6, n_layers=2),
    "mpt_alibi_bias_max": dict(model_type="mpt", vocab_size=128, d_model=32, n_heads=4, n_layers=2,
                               attn_config={"alibi_bias_max": 16}),
    "mpt_bias": dict(model_type="mpt", vocab_size=128, d_model=32, n_heads=4, n_layers=2,
                     no_bias=False),
    "bloom_residual_post_layernorm": dict(
        model_type="bloom", vocab_size=128, hidden_size=32, n_layer=2, n_head=4,
        apply_residual_connection_post_layernorm=True),
    "cohere2_qk_norm": tiny_hf("cohere2", use_qk_norm=True),
    "xglm_relu": dict(model_type="xglm", vocab_size=128, d_model=32, num_layers=2,
                      attention_heads=4, ffn_dim=64, activation_function="relu"),
    "xlm_bidirectional": dict(model_type="xlm", vocab_size=128, emb_dim=32, n_layers=2, n_heads=4,
                              causal=False),
    "xlm_asm": dict(model_type="xlm", vocab_size=128, emb_dim=32, n_layers=2, n_heads=4,
                    causal=True, asm=True),
    # the mixer decoders' and the mllama and moshi text paths' own refusals
    "doge_is_moe": tiny_hf("doge", is_moe=True),
    "doge_yarn": tiny_hf("doge", rope_scaling={"rope_type": "yarn", "factor": 2.0}),
    "diffllama_odd_heads": tiny_hf("diffllama", hidden_size=24, num_attention_heads=3,
                                   num_key_value_heads=3),
    "diffllama_rope_scaling": tiny_hf("diffllama",
                                      rope_scaling={"rope_type": "linear", "factor": 2.0}),
    "mllama_gelu": tiny_hf("mllama_text_model", hidden_act="gelu", cross_attention_layers=[1]),
    "moshi_gelu": dict(model_type="moshi", vocab_size=128, hidden_size=32, ffn_dim=128,
                       num_hidden_layers=2, num_attention_heads=4, hidden_act="gelu"),
}
REFUSED_BY_PORT = {
    # the MoE types still to come (ROADMAP.md Queue 1 item 6): attention
    # sinks and biased experts, granite's MoE
    "gpt_oss": tiny_hf("gpt_oss", head_dim=8, num_local_experts=4, num_experts_per_tok=2),
    "granitemoe": tiny_hf("granitemoe", num_local_experts=4, num_experts_per_tok=2),
    # dense types the port does not build yet: the bert lineage, as a causal
    # decoder (post-LN blocks, learned positions) and ModernBERT's decoder
    # (its first layer without an attention norm, a prediction head)
    "bert": tiny_hf("bert", hidden_act="gelu", layer_norm_eps=1e-12),
    "modernbert-decoder": tiny_hf("modernbert-decoder", hidden_activation="gelu", norm_eps=1e-5,
                                  global_rope_theta=160000.0, local_rope_theta=10000.0,
                                  sliding_window=8),
}


@pytest.mark.parametrize("case", sorted(REFUSED_BY_BOTH))
def test_refusals_match_jax(case):
    hf = REFUSED_BY_BOTH[case]
    with pytest.raises(ValueError):
        jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    with pytest.raises(ValueError):
        tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)


@pytest.mark.parametrize("case", sorted(REFUSED_BY_PORT))
def test_refusals_name_the_roadmap(case):
    hf = REFUSED_BY_PORT[case]
    jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)  # the JAX package builds it
    with pytest.raises(ValueError, match="ROADMAP"):
        tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "Qwen/Qwen2-1.5B"])
def test_qwen2_1_5b_resolves_in_the_builder(name):
    from apps.trainer_llm import builder as jbuilder

    ours = builder._KNOWN_CONFIGS[name](dtype=torch.bfloat16)
    theirs = jbuilder._KNOWN_CONFIGS[name](dtype=jnp.bfloat16)
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
                  "norm_eps", "rope_theta", "qkv_bias", "tie_embeddings", "head_dim"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.dtype == torch.bfloat16
    assert builder._HF_IDS.get("qwen2-1.5b") == jbuilder._HF_IDS["qwen2-1.5b"]


@pytest.mark.parametrize("family", ["qwen2", "gemma"])
@pytest.mark.parametrize("with_head", [False, True])
def test_tied_snapshot_loads(family, with_head, tmp_path, monkeypatch):
    """A tied model's snapshot with no ``lm_head.weight`` builds generically
    and gives the source's logits; one that holds the tied head anyway (as
    some HF snapshots do) loads the same."""
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    _, tm, sd = family_pair(family, seed=1)
    assert "lm_head.weight" not in sd
    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(FAMILIES[family]))
    if with_head:
        sd = {**sd, "lm_head.weight": sd["model.embed_tokens.weight"]}
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, snap / "pytorch_model.bin")
    model, _ = builder.make_model_and_tokenizer(
        model_name=f"someorg/some-{family}", dtype="float32", checkpoint_path=str(snap),
        device="cpu")
    assert isinstance(model, tmodels.CausalLM) and model.lm_head is None
    ids = torch.from_numpy(probe_ids(128, (2, 7), seed=6)).long()
    with torch.no_grad():
        torch.testing.assert_close(model({"input_ids": ids}), tm({"input_ids": ids}),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("family", ["qwen2", "gemma", "qwen3", "mistral"])
def test_cached_generate_matches_jax(family):
    """Greedy ``generate`` from the KV cache gives the JAX package's tokens;
    the logits that chose the last token equal the JAX cached forward's at
    that position (f32, 1e-4)."""
    jm, tm, _ = family_pair(family, seed=2)
    prompt = probe_ids(128, (2, 6), seed=7)
    toks, step_logits = tserving.generate(tm, torch.from_numpy(prompt).long(), 6,
                                          return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(toks.numpy(), want)
    full = np.concatenate([prompt, want[:, :-1]], axis=1).astype(np.int32)
    caches = jserving.init_cache(jm, full.shape[0], full.shape[1])
    j_logits, _ = jserving.forward_with_cache(jm, jnp.asarray(full), caches, 0)
    np.testing.assert_allclose(step_logits[:, -1].numpy(), np.asarray(j_logits)[:, -1], atol=1e-4)


def test_embedding_scale_is_the_jax_decoders():
    """Gemma's sqrt(dim) factor is rounded to the activation dtype before
    it multiplies, as the JAX decoder's ``embed_inputs`` rounds it."""
    cfg = tmodels.TransformerConfig.from_hf_config(FAMILIES["gemma"], dtype=torch.bfloat16)
    tm = tmodels.CausalLM(cfg, device="cpu")
    ids = torch.arange(10)[None]
    got = tm.model.embed_inputs(ids)
    factor = torch.tensor(cfg.dim ** 0.5, dtype=torch.bfloat16)
    assert torch.equal(got, tm.model.embed_tokens(ids) * factor)
