"""The port's first decoders beyond the llama graph (GPT-2, GPT-NeoX,
Falcon in its three wirings, StarCoder2, StableLM, Granite and Cohere)
against the JAX package's, on the CPU, at tiny widths (hidden 32, 2
layers): each config field equal to JAX's, the state-dict keys equal, f32
logits within 1e-4 and the loss within rtol 1e-5 on the JAX model's weights
(norms and biases moved off their initial values), carried over with
``utils.state_dict`` -> ``load_numpy_state_dict``, and each new knob shown
to bind (the port without it gives other logits): LayerNorm blocks,
non-gated biased MLPs and their activations, GPT-2's learned positions and
unscaled logits, partial and interleaved rotary, one-norm and two-norm
parallel residuals and Granite's multipliers.  Then KV-cached ``generate``
against JAX ``serving.generate`` (GPT-2 on right-padded ragged rows, whose
learned positions the cache must offset), one ``dwain.decompose`` walk on
GPT-NeoX against the JAX walk, and GPT-2, GPT-NeoX, Falcon and StarCoder2
snapshots in their checkpoint layouts through the trainer's builder."""

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
from test_torch_olmo_glm_smollm3 import CONFIG_FIELDS as EARLIER_FIELDS
from test_torch_rope_gemma_phi3 import _cycle

GPT2 = dict(model_type="gpt2", vocab_size=128, n_embd=32, n_layer=2, n_head=4, n_positions=64,
            layer_norm_epsilon=1e-5, activation_function="gelu_new")
FALCON = dict(model_type="falcon", vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, layer_norm_epsilon=1e-5, bias=False, alibi=False,
              new_decoder_architecture=False, multi_query=True, parallel_attn=True)
CASES = {
    "gpt2": GPT2,
    # the logits left unscaled
    "gpt2_unscaled": {**GPT2, "scale_attn_weights": False},
    # 4 of each head's 16 dims rotate, rotate-half; the two-norm parallel
    # block, or the sequential one
    "gpt_neox": tiny_hf("gpt_neox", num_attention_heads=2, rotary_pct=0.25,
                        layer_norm_eps=1e-5, hidden_act="gelu"),
    "gpt_neox_sequential": tiny_hf("gpt_neox", num_attention_heads=2, rotary_pct=0.25,
                                   use_parallel_residual=False, hidden_act="gelu"),
    # falcon-7b's wiring (one kv head, one norm for both branches), the new
    # architecture (two kv heads, two norms, biases) and falcon-rw's
    # sequential block
    "falcon": FALCON,
    "falcon_new": {**FALCON, "new_decoder_architecture": True, "num_kv_heads": 2, "bias": True},
    "falcon_rw": {**FALCON, "multi_query": False, "parallel_attn": False, "bias": True},
    "starcoder2": tiny_hf("starcoder2", use_bias=True, norm_epsilon=1e-5,
                          hidden_act="gelu_pytorch_tanh"),
    "stablelm": tiny_hf("stablelm", use_qkv_bias=True, partial_rotary_factor=0.25,
                        layer_norm_eps=1e-5, num_attention_heads=2, num_key_value_heads=1),
    "granite": tiny_hf("granite", embedding_multiplier=12.0, residual_multiplier=0.22,
                       attention_multiplier=0.5, logits_scaling=8.0),
    "cohere": tiny_hf("cohere", layer_norm_eps=1e-5, logit_scale=0.25),
}
CONFIG_FIELDS = (*EARLIER_FIELDS, "norm_type", "norm_bias", "mlp_gated", "mlp_bias", "use_rope",
                 "learned_pos", "parallel_residual", "embedding_multiplier",
                 "residual_multiplier", "logit_scale", "lm_head_bias", "post_ln", "final_norm",
                 "embed_vocab_size")
# what makes each knob bind: the port without it gives other logits
WITHOUT_FEATURE = [
    ("gpt2", {"learned_pos": None}),
    ("gpt2", {"use_rope": True}),
    ("gpt2", {"o_proj_bias": False}),
    ("gpt2_unscaled", {"query_scale_override": None}),
    ("gpt_neox", {"parallel_residual": "none"}),
    ("gpt_neox", {"rope_partial_factor": None}),
    ("gpt_neox", {"mlp_bias": False}),
    ("gpt_neox", {"mlp_act": "relu"}),
    ("falcon", {"parallel_residual": "none"}),
    ("falcon_new", {"parallel_residual": "one_norm"}),
    ("starcoder2", {"norm_type": "rmsnorm"}),
    ("stablelm", {"qkv_bias": False}),
    ("granite", {"embedding_multiplier": None}),
    ("granite", {"residual_multiplier": None}),
    ("granite", {"query_scale_override": None}),
    ("granite", {"logit_scale": None}),
    ("cohere", {"rope_interleaved": False}),
    ("cohere", {"logit_scale": None}),
]


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
    """The port's model of ``case`` with ``over`` replaced in its config,
    holding those of ``sd``'s weights it has (strictly without ``over``)."""
    tcfg = tmodels.TransformerConfig.from_hf_config(CASES[case], dtype=torch.float32)
    model = tmodels.CausalLM(dataclasses.replace(tcfg, **over), device="cpu")
    if not over:
        return tutils.load_numpy_state_dict(model, sd)
    own = model.state_dict()
    return tutils.load_numpy_state_dict(
        model, {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape},
        strict=False)


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case):
    jm, tm, _ = pair(case)
    ids = probe_ids(128, (2, 16), seed=4)
    y_jax = jax_logits(jm, ids)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    with torch.no_grad():
        y = tm(batch)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)
    loss_j = float(jmodels.transformer.ce_loss({"input_ids": jnp.asarray(ids)}, jnp.asarray(y_jax)))
    np.testing.assert_allclose(float(tmodels.ce_loss(batch, y)), loss_j, rtol=1e-5)


@pytest.mark.parametrize("case,over", WITHOUT_FEATURE, ids=lambda v: str(v))
def test_each_knob_binds(case, over):
    _, tm, sd = pair(case)
    batch = {"input_ids": torch.from_numpy(probe_ids(128, (2, 16), seed=4)).long()}
    with torch.no_grad():
        y, y_without = tm(batch), port_model(case, sd, **over)(batch)
    assert float((y_without - y).abs().max()) > 1e-3, "the feature does not bind"


def test_the_blocks_take_their_own_norms_and_mlps():
    """GPT-2 holds a position table of 64 and LayerNorms with offsets;
    Falcon-7B's one-norm block no post-attention norm and one kv head;
    GPT-NeoX's MLP no gate; Cohere's LayerNorms no offset; StableLM rotates
    int(16 * 0.25) = 4 dims a head."""
    gpt2 = pair("gpt2")[1]
    assert gpt2.model.pos_embed.weight.shape == (64, 32) and gpt2.lm_head is None
    assert gpt2.model.layers[0].input_layernorm.bias is not None
    falcon = pair("falcon")[1].model.layers[0]
    assert falcon.post_attention_layernorm is None and falcon.self_attn.n_kv_heads == 1
    assert pair("gpt_neox")[1].model.layers[0].mlp.gate_proj is None
    assert pair("cohere")[1].model.norm.bias is None
    assert pair("stablelm")[1].model.layers[0].self_attn.rope_partial_dim == 4


@pytest.mark.parametrize("case", ["gpt_neox", "gpt_neox_sequential", "falcon", "falcon_new",
                                  "falcon_rw", "starcoder2", "stablelm", "granite", "cohere"])
def test_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache gives the JAX package's tokens;
    the logits that chose each new token equal the JAX model's forward over
    the whole sequence (f32, 1e-4)."""
    jm, tm, _ = pair(case)
    prompt = probe_ids(128, (2, 9), seed=7)
    toks, step_logits = tserving.generate(tm, torch.from_numpy(prompt).long(), 8,
                                          return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(toks.numpy(), want)
    full = np.concatenate([prompt, want[:, :-1]], axis=1).astype(np.int32)
    np.testing.assert_allclose(step_logits.numpy(), jax_logits(jm, full)[:, 8:], atol=1e-4)


def test_gpt2_ragged_generate_takes_learned_positions():
    """Right-padded prompts of 5 and 9 tokens: each row's cached steps add
    the position table at its own positions, so the tokens equal JAX's
    ragged ``generate`` and the logits each row chose from equal the JAX
    forward of that row alone (f32, 1e-4); the port's decode steps without
    the positions' offset give other logits."""
    jm, tm, _ = pair("gpt2")
    lens = np.array([5, 9])
    prompt = probe_ids(128, (2, 9), seed=8)
    prompt[0, 5:] = 0
    toks, step_logits = tserving.generate(
        tm, torch.from_numpy(prompt).long(), 6, prompt_lens=torch.from_numpy(lens),
        return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 6,
                                        prompt_lens=jnp.asarray(lens)))
    np.testing.assert_array_equal(toks.numpy(), want)
    for row, n in enumerate(lens):
        full = np.concatenate([prompt[row, :n], want[row, :-1]])[None].astype(np.int32)
        np.testing.assert_allclose(step_logits[row].numpy(), jax_logits(jm, full)[0, n - 1:],
                                   atol=1e-4)
    real = tm.model.embed_inputs
    tm.model.embed_inputs = lambda ids, positions=None: real(ids)  # positions from 0 each step
    try:
        _, unplaced = tserving.generate(tm, torch.from_numpy(prompt).long(), 6,
                                        prompt_lens=torch.from_numpy(lens), return_logits=True)
    finally:
        del tm.model.embed_inputs
    assert float((unplaced[:, 1:] - step_logits[:, 1:]).abs().max()) > 1e-3


def test_dwain_decompose_gpt_neox_matches_jax():
    """One walk over layer 0's biased, non-gated up_proj, whose input is the
    two-norm block's second norm: the JAX walk's sites, ranks and config
    (float metrics within rtol 1e-4), byte-equal once those are set equal,
    and the decomposed model's logits within 1e-4 of JAX's."""
    hp = dict(num_data_steps=1, num_metric_steps=1, nsr_final_threshold=0.2, min_rank=8,
              trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
              decompose_in_float64=True)
    walked = ("model.layers.0.mlp.up_proj",)
    jm, tm, _ = pair("gpt_neox")
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


def _gpt2_layout(sd: dict) -> dict:
    """GPT-2's checkpoint layout: Conv1D weights (in, out), q/k/v fused in
    ``attn.c_attn``, HF's names, the causal-mask buffer and the tied head."""
    names = (("model.embed_tokens.", "transformer.wte."), ("model.pos_embed.", "transformer.wpe."),
             ("model.norm.", "transformer.ln_f."), ("model.layers.", "transformer.h."),
             (".input_layernorm.", ".ln_1."), (".post_attention_layernorm.", ".ln_2."),
             (".self_attn.o_proj.", ".attn.c_proj."), (".mlp.up_proj.", ".mlp.c_fc."),
             (".mlp.down_proj.", ".mlp.c_proj."))
    out = {"lm_head.weight": sd["model.embed_tokens.weight"]}
    for k, v in sd.items():
        if ".self_attn.k_proj." in k or ".self_attn.v_proj." in k:
            continue
        if ".self_attn.q_proj." in k:
            stem, leaf = k.split(".self_attn.q_proj.")
            v = np.concatenate([sd[f"{stem}.self_attn.{p}_proj.{leaf}"] for p in "qkv"])
            k = f"{stem}.attn.c_attn.{leaf}"
            out[stem.replace("model.layers.", "transformer.h.") + ".attn.bias"] = np.tril(
                np.ones((64, 64), np.float32))[None, None]
        for ours, theirs in names:
            k = k.replace(ours, theirs)
        conv1d = (".attn.c_attn.", ".attn.c_proj.", ".mlp.c_fc.", ".mlp.c_proj.")
        out[k] = v.T if k.endswith(".weight") and any(c in k for c in conv1d) else v
    return out


def _fused_qkv(sd: dict, fuse, names: tuple) -> dict:
    """q/k/v fused by ``fuse`` into ``query_key_value`` and the model's names
    mapped to the checkpoint's by ``names``."""
    out = {}
    for k, v in sd.items():
        if ".self_attn.k_proj." in k or ".self_attn.v_proj." in k:
            continue
        if ".self_attn.q_proj." in k:
            stem, leaf = k.split(".self_attn.q_proj.")
            v = fuse(*(sd[f"{stem}.self_attn.{p}_proj.{leaf}"] for p in "qkv"))
            k = f"{stem}.self_attn.query_key_value.{leaf}"
        for ours, theirs in names:
            k = k.replace(ours, theirs)
        out[k] = v
    return out


def _neox_layout(sd: dict) -> dict:
    """GPT-NeoX's checkpoint layout: q/k/v interleaved a head (2 heads of 16)."""
    def fuse(q, k, v):
        return np.stack([t.reshape(2, 16, *t.shape[1:]) for t in (q, k, v)], axis=1).reshape(
            96, *q.shape[1:])

    names = (("model.embed_tokens.", "gpt_neox.embed_in."),
             ("model.norm.", "gpt_neox.final_layer_norm."), ("model.layers.", "gpt_neox.layers."),
             ("lm_head.", "embed_out."), (".self_attn.query_key_value.", ".attention.query_key_value."),
             (".self_attn.o_proj.", ".attention.dense."), (".mlp.up_proj.", ".mlp.dense_h_to_4h."),
             (".mlp.down_proj.", ".mlp.dense_4h_to_h."))
    return _fused_qkv(sd, fuse, names)


def _falcon_layout(sd: dict) -> dict:
    """Falcon-7B's checkpoint layout: the q heads, then the one k and one v
    head, in ``self_attention.query_key_value``."""
    names = (("model.embed_tokens.", "transformer.word_embeddings."),
             ("model.norm.", "transformer.ln_f."), ("model.layers.", "transformer.h."),
             (".self_attn.query_key_value.", ".self_attention.query_key_value."),
             (".self_attn.o_proj.", ".self_attention.dense."),
             (".mlp.up_proj.", ".mlp.dense_h_to_4h."), (".mlp.down_proj.", ".mlp.dense_4h_to_h."))
    return _fused_qkv(sd, lambda q, k, v: np.concatenate([q, k, v]), names)


def _starcoder2_layout(sd: dict) -> dict:
    return {k.replace(".mlp.up_proj.", ".mlp.c_fc.").replace(".mlp.down_proj.", ".mlp.c_proj."): v
            for k, v in sd.items()}


@pytest.mark.parametrize("case,layout", [("gpt2", _gpt2_layout), ("gpt_neox", _neox_layout),
                                         ("falcon", _falcon_layout),
                                         ("starcoder2", _starcoder2_layout)])
def test_snapshot_loads_through_the_builder(case, layout, tmp_path, monkeypatch):
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    _, tm, sd = pair(case)
    stored = layout(sd)
    assert set(stored) != set(sd)
    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(CASES[case]))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in stored.items()},
               snap / "pytorch_model.bin")
    model, _ = builder.make_model_and_tokenizer(
        model_name=f"someorg/some-{case}", dtype="float32", checkpoint_path=str(snap), device="cpu")
    assert model.state_dict().keys() == tm.state_dict().keys()
    ids = torch.from_numpy(probe_ids(128, (2, 7), seed=6)).long()
    with torch.no_grad():
        torch.testing.assert_close(model({"input_ids": ids}), tm({"input_ids": ids}),
                                   rtol=0, atol=0)
