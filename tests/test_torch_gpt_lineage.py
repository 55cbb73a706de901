"""The port's GPT-lineage decoders (GPT-J, CodeGen, GPT-Neo, GPTBigCode,
OPT, GPT-1 and ImageGPT) and the gpt-sw3 and emu3 aliases against the JAX
package's, on the CPU, at tiny widths (hidden 32, 2 layers, vocab 128;
ImageGPT's 129, so that its head of vocab - 1 outputs covers the probes):
each config field equal to JAX's, the state-dict keys equal, f32 logits
within 1e-4 and the loss within rtol 1e-5 on the JAX model's weights (norms
and biases moved off their initial values), carried over with
``utils.state_dict`` -> ``load_numpy_state_dict``, and each new knob shown
to bind (the port without it gives other logits): GPT-J's head bias and
rotary, GPT-1's post-LN blocks and missing final norm, ImageGPT's larger
embedding and RMSNorm blocks, GPT-Neo's window and unscaled logits, OPT's
dropped position rows and CodeGen's (q, v, k) order.  Then KV-cached
``generate`` against JAX ``serving.generate`` (OPT on right-padded ragged
rows), one ``dwain.decompose`` walk on GPT-J against the JAX walk with the
fused serve after it, and the families' snapshots in their checkpoint
layouts through the trainer's builder."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, engine as jengine, models as jmodels, serving as jserving
from ptdeco_tpu import utils as jutils
from ptdeco_tpu_torch import dwain as tdwain, engine as tengine, models as tmodels, nn as pnn
from ptdeco_tpu_torch import serving as tserving
from ptdeco_tpu_torch import utils as tutils
from ptdeco_tpu_torch.apps.trainer_llm import builder
from ptdeco_tpu_torch.models import hf_loader

from test_torch_beyond_llama import CONFIG_FIELDS, _fused_qkv, _gpt2_layout
from test_torch_families import tiny_hf
from test_torch_moe import jax_logits, probe_ids
from test_torch_rope_gemma_phi3 import _cycle

GPT = dict(vocab_size=128, n_embd=32, n_layer=2, n_head=4, n_positions=64, layer_norm_epsilon=1e-5)
GPTJ = dict(model_type="gptj", rotary_dim=4, activation_function="gelu_new", **GPT)
BIGCODE = dict(model_type="gpt_bigcode", multi_query=True,
               activation_function="gelu_pytorch_tanh", **GPT)
OPT = dict(model_type="opt", vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, ffn_dim=64, max_position_embeddings=64, word_embed_proj_dim=32,
           do_layer_norm_before=True, enable_bias=True, activation_function="relu")
CASES = {
    # 4 of each head's 8 dims rotated in pairs; CodeGen the same graph
    "gptj": GPTJ,
    "codegen": {**GPTJ, "model_type": "codegen"},
    # a global layer, then a local one whose window of 5 binds at 16 tokens
    "gpt_neo": dict(model_type="gpt_neo", vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_position_embeddings=64, attention_layers=["global", "local"],
                    window_size=5, activation_function="gelu_new", layer_norm_epsilon=1e-5),
    "gpt_bigcode": BIGCODE,
    "gpt_bigcode_unscaled": {**BIGCODE, "scale_attn_weights": False},
    "opt": OPT,
    "openai_gpt": dict(model_type="openai-gpt", afn="gelu", **GPT),
    "imagegpt": dict(model_type="imagegpt", activation_function="quick_gelu",
                     **{**GPT, "vocab_size": 129}),
    "gpt_sw3": dict(model_type="gpt-sw3", activation_function="gelu", **GPT),
    # the text_config's own model_type left to its default, as JAX reads it
    "emu3": dict(model_type="emu3", text_config={
        k: v for k, v in tiny_hf("emu3_text_model", rope_theta=1e6).items() if k != "model_type"}),
}
NEW_FIELDS = ("lm_head_bias", "post_ln", "final_norm", "embed_vocab_size")
# what makes each knob bind: the port without it gives other logits
WITHOUT_FEATURE = [
    ("gptj", {"lm_head_bias": False}),
    ("gptj", {"rope_interleaved": False}),
    ("gptj", {"rope_partial_factor": None}),
    ("gptj", {"parallel_residual": "none"}),
    ("codegen", {"parallel_residual": "two_norm"}),
    ("gpt_neo", {"sliding_window": None}),
    ("gpt_neo", {"query_scale_override": None}),
    ("gpt_bigcode_unscaled", {"query_scale_override": None}),
    ("opt", {"mlp_act": "gelu_exact"}),
    ("openai_gpt", {"post_ln": False}),
    ("openai_gpt", {"final_norm": True}),
    ("imagegpt", {"embed_vocab_size": None}),
    ("imagegpt", {"norm_type": "layernorm"}),
    ("imagegpt", {"mlp_act": "gelu_tanh"}),
]
REFUSED_BY_BOTH = {
    "codegen_without_rotary_dim": {**GPTJ, "model_type": "codegen", "rotary_dim": None},
    "gpt_bigcode_multi_head_kv": {**BIGCODE, "multi_query": False},
    "opt_350m_projection": {**OPT, "word_embed_proj_dim": 16},
    "opt_post_norm": {**OPT, "do_layer_norm_before": False},
    "opt_non_affine_norm": {**OPT, "layer_norm_elementwise_affine": False},
    "openai_gpt_unknown_afn": dict(model_type="openai-gpt", afn="tanh", **GPT),
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


def _probe() -> np.ndarray:
    """Two rows of 16 tokens: past GPT-Neo's window of 5."""
    return probe_ids(128, (2, 16), seed=4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_fields_match_jax(case):
    jcfg = jmodels.TransformerConfig.from_hf_config(CASES[case], dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(CASES[case], dtype=torch.float32)
    assert set(NEW_FIELDS) <= set(CONFIG_FIELDS)
    for field in CONFIG_FIELDS:
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_keys_match_jax(case):
    _, tm, sd = pair(case)
    assert set(tm.state_dict()) == set(sd)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case):
    jm, tm, _ = pair(case)
    ids = _probe()
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
    batch = {"input_ids": torch.from_numpy(_probe()).long()}
    with torch.no_grad():
        y, y_without = tm(batch), port_model(case, sd, **over)(batch)
    assert float((y_without - y).abs().max()) > 1e-3, "the feature does not bind"


@pytest.mark.parametrize("case", sorted(REFUSED_BY_BOTH))
def test_refusals_match_jax(case):
    hf = REFUSED_BY_BOTH[case]
    with pytest.raises(ValueError):
        jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    with pytest.raises(ValueError, match="as in the JAX package"):
        tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)


def test_the_models_take_their_own_heads_norms_and_tables():
    """GPT-J's untied head has a bias and one norm a block; GPT-1 has no
    final norm; ImageGPT's table has 129 rows, its head 128 outputs, and
    its start token (128) reads the last row, as in JAX; GPTBigCode has one
    kv head; a tied GPT-J adds its own head bias, held at JAX's logits."""
    gptj = pair("gptj")[1]
    assert gptj.lm_head.bias is not None and gptj.model.layers[0].post_attention_layernorm is None
    assert isinstance(pair("openai_gpt")[1].model.norm, torch.nn.Identity)
    jm, igpt, _ = pair("imagegpt")
    assert igpt.model.embed_tokens.weight.shape[0] == 129 and igpt.lm_head.out_features == 128
    ids = _probe()
    ids[:, 0] = 128
    with torch.no_grad():
        y = igpt({"input_ids": torch.from_numpy(ids).long()})
    np.testing.assert_allclose(y.numpy(), jax_logits(jm, ids), atol=1e-4)
    assert pair("gpt_bigcode")[1].model.layers[0].self_attn.k_proj.out_features == 8
    tied = {**GPTJ, "tie_word_embeddings": True}
    jtied = jmodels.CausalLM.create(
        jax.random.PRNGKey(0), jmodels.TransformerConfig.from_hf_config(tied, dtype=jnp.float32))
    sd = jutils.state_dict(jtied)
    sd["tied_head_bias"] = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    jtied = jutils.load_state_dict(jtied, sd)
    ttied = tutils.load_numpy_state_dict(tmodels.CausalLM(
        tmodels.TransformerConfig.from_hf_config(tied, dtype=torch.float32), device="cpu"), sd)
    ids = _probe()
    with torch.no_grad():
        y = ttied({"input_ids": torch.from_numpy(ids).long()})
    np.testing.assert_allclose(y.numpy(), jax_logits(jtied, ids), atol=1e-4)


@pytest.mark.parametrize("case", ["gptj", "gpt_neo", "gpt_bigcode", "openai_gpt"])
def test_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache gives the JAX package's tokens;
    the logits that chose each new token equal the JAX model's forward over
    the whole sequence (f32, 1e-4): GPT-J's head bias, GPT-Neo's window
    past its 5 keys and GPT-1's post-LN blocks in the cache."""
    jm, tm, _ = pair(case)
    prompt = probe_ids(128, (2, 9), seed=7)
    toks, step_logits = tserving.generate(tm, torch.from_numpy(prompt).long(), 8,
                                          return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(toks.numpy(), want)
    full = np.concatenate([prompt, want[:, :-1]], axis=1).astype(np.int32)
    np.testing.assert_allclose(step_logits.numpy(), jax_logits(jm, full)[:, 8:], atol=1e-4)


def test_opt_ragged_generate_matches_jax():
    """OPT on right-padded prompts of 5 and 9 tokens: the tokens equal JAX's
    ragged ``generate`` and the logits each row chose from equal the JAX
    forward of that row alone (f32, 1e-4)."""
    jm, tm, _ = pair("opt")
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


def test_dwain_decompose_gptj_matches_jax():
    """One walk over layer 0's biased up_proj, whose input is the one-norm
    block's shared norm, with the biased head blacklisted as the trainers
    do: the JAX walk's sites, ranks and config (float metrics within rtol
    1e-4), byte-equal once those are set equal; the decomposed model's
    logits within 1e-4 of JAX's, and again once its pair is fused (the
    served form, the head's bias included)."""
    hp = dict(num_data_steps=1, num_metric_steps=1, nsr_final_threshold=0.3, min_rank=8,
              trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
              decompose_in_float64=True)
    walked = ("model.layers.0.mlp.up_proj",)
    jm, tm, _ = pair("gptj")
    # both packages list the biased head as a site until it is blacklisted
    sites = tengine.get_decomposeable_submodule_names(tm)
    assert sites == jengine.get_decomposeable_submodule_names(jm) and "lm_head" in sites
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
    ids = _probe()
    y_jax = jax_logits(jm, ids)
    with torch.no_grad():
        y = tm({"input_ids": torch.from_numpy(ids).long()})
        np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)
        pnn.fuse_factor_pairs(tm)
        assert isinstance(tm.model.layers[0].mlp.up_proj, pnn.FusedLowRankLinear)
        y_fused = tm({"input_ids": torch.from_numpy(ids).long()})
    np.testing.assert_allclose(y_fused.numpy(), y_jax, atol=1e-4)


def _renamed(sd: dict, names: tuple) -> dict:
    out = {}
    for k, v in sd.items():
        for ours, theirs in names:
            k = k.replace(ours, theirs)
        out[k] = v
    return out


GPTJ_NAMES = (("model.embed_tokens.", "transformer.wte."), ("model.norm.", "transformer.ln_f."),
              ("model.layers.", "transformer.h."), (".input_layernorm.", ".ln_1."),
              (".self_attn.o_proj.", ".attn.out_proj."), (".self_attn.", ".attn."),
              (".mlp.up_proj.", ".mlp.fc_in."), (".mlp.down_proj.", ".mlp.fc_out."))


def _gptj_layout(sd: dict) -> dict:
    """GPT-J's checkpoint layout, with its causal-mask buffers."""
    out = _renamed(sd, GPTJ_NAMES)
    out.update({f"transformer.h.{i}.attn.bias": np.ones((1, 1, 64, 64), bool) for i in range(2)})
    return out


def codegen_fuse(q, k, v, mp_num: int = 4):
    """CodeGen's ``qkv_proj``: each projection's rows cut in ``mp_num``
    shards, and per shard [q v k]."""
    return np.concatenate([t.reshape(mp_num, -1, *t.shape[1:]) for t in (q, v, k)], axis=1).reshape(
        3 * q.shape[0], *q.shape[1:])


def _codegen_layout(sd: dict, fuse=codegen_fuse) -> dict:
    return _fused_qkv(sd, fuse, ((".self_attn.query_key_value.", ".attn.qkv_proj."), *GPTJ_NAMES))


def _bigcode_layout(sd: dict) -> dict:
    """GPTBigCode's: [q | k | v] rows in ``attn.c_attn``, GPT-2's names,
    plain Linear weights, the tied head stored too."""
    out = _fused_qkv(sd, lambda q, k, v: np.concatenate([q, k, v]), (
        ("model.embed_tokens.", "transformer.wte."), ("model.pos_embed.", "transformer.wpe."),
        ("model.norm.", "transformer.ln_f."), ("model.layers.", "transformer.h."),
        (".input_layernorm.", ".ln_1."), (".post_attention_layernorm.", ".ln_2."),
        (".self_attn.query_key_value.", ".attn.c_attn."), (".self_attn.o_proj.", ".attn.c_proj."),
        (".mlp.up_proj.", ".mlp.c_fc."), (".mlp.down_proj.", ".mlp.c_proj.")))
    return {**out, "lm_head.weight": sd["model.embed_tokens.weight"]}


OPT_NAMES = (("model.embed_tokens.", "model.decoder.embed_tokens."),
             ("model.pos_embed.", "model.decoder.embed_positions."),
             ("model.norm.", "model.decoder.final_layer_norm."),
             ("model.layers.", "model.decoder.layers."), (".self_attn.o_proj.", ".self_attn.out_proj."),
             (".input_layernorm.", ".self_attn_layer_norm."),
             (".post_attention_layernorm.", ".final_layer_norm."), (".mlp.up_proj.", ".fc1."),
             (".mlp.down_proj.", ".fc2."))


def _opt_layout(sd: dict, offset_rows: np.ndarray) -> dict:
    """OPT's: ``offset_rows`` before the position table (HF's +2 offset),
    its names, the tied head stored too."""
    out = _renamed(sd, OPT_NAMES)
    table = "model.decoder.embed_positions.weight"
    out[table] = np.concatenate([offset_rows, out[table]])
    return {**out, "lm_head.weight": sd["model.embed_tokens.weight"]}


def _gpt1_layout(sd: dict) -> dict:
    """GPT-1's: GPT-2's layout (no ``ln_f``, as the model has no final norm)
    under GPT-1's table names."""
    return _renamed(_gpt2_layout(sd), (("transformer.wte.", "transformer.tokens_embed."),
                                       ("transformer.wpe.", "transformer.positions_embed.")))


LAYOUTS = {
    "gptj": _gptj_layout,
    "codegen": _codegen_layout,
    "gpt_bigcode": _bigcode_layout,
    "opt": lambda sd: _opt_layout(sd, np.full((2, 32), 7.0, np.float32)),
    "openai_gpt": _gpt1_layout,
    # GPT-2's, its untied head kept
    "imagegpt": _gpt2_layout,
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_snapshot_loads_through_the_builder(case, tmp_path, monkeypatch):
    """Each family's weights written in its checkpoint layout build
    generically through the trainer's builder and give the source's logits
    exactly."""
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    _, tm, sd = pair(case)
    stored = LAYOUTS[case](sd)
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


def test_codegen_split_takes_q_v_k_shards():
    """Distinct values a head (head h of q holds 100 + h, of k 200 + h, of v
    300 + h) come back to their projections from the sharded (q, v, k)
    layout, and the fused layout's shards read in (q, k, v) order give k and
    v swapped: a model loaded so gives other logits."""
    translate = hf_loader.translator_for(CASES["codegen"])
    heads = np.repeat(np.arange(4, dtype=np.float32), 8)[:, None] * np.ones((1, 32), np.float32)
    q, k, v = 100 + heads, 200 + heads, 300 + heads
    got = translate({"transformer.h.0.attn.qkv_proj.weight": codegen_fuse(q, k, v)})
    for name, want in (("q", q), ("k", k), ("v", v)):
        np.testing.assert_array_equal(got[f"model.layers.0.self_attn.{name}_proj.weight"], want)
    _, tm, sd = pair("codegen")
    swapped = translate(_codegen_layout(sd, lambda q, k, v: codegen_fuse(q, v, k)))
    wrong = tutils.load_numpy_state_dict(port_model("codegen", sd), swapped)
    ids = torch.from_numpy(_probe()).long()
    with torch.no_grad():
        assert float((wrong({"input_ids": ids}) - tm({"input_ids": ids})).abs().max()) > 1e-3


def test_opt_translator_drops_the_two_offset_rows():
    """OPT's position table comes back without its two leading rows, so the
    model's position 0 reads the checkpoint's row 2, as HF's +2 offset
    does; the same table kept whole (position 0 reading row 0) gives other
    logits."""
    _, tm, sd = pair("opt")
    offset_rows = np.full((2, 32), 7.0, np.float32)
    back = hf_loader.translator_for(OPT)(_opt_layout(sd, offset_rows))
    np.testing.assert_array_equal(back["model.pos_embed.weight"], sd["model.pos_embed.weight"])
    assert set(back) == set(sd)
    kept = dict(back, **{"model.pos_embed.weight": np.concatenate(
        [offset_rows, sd["model.pos_embed.weight"]])[:64]})
    unshifted = tutils.load_numpy_state_dict(port_model("opt", sd), kept)
    ids = torch.from_numpy(_probe()).long()
    with torch.no_grad():
        assert float((unshifted({"input_ids": ids}) - tm({"input_ids": ids})).abs().max()) > 1e-3
