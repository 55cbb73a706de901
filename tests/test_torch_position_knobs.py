"""The port's dense decoders with a position or norm knob of their own
(BLOOM and MPT's ALiBi, XGLM's and CTRL's computed sinusoids, BioGPT, XLM,
BitNet's sub-norms, Cohere2 and GPT-NeoX-Japanese) against the JAX
package's, on the CPU, at tiny widths (hidden 32, 2 layers, vocab 128;
BLOOM at 6 heads of 8, a head count that is not a power of two, MPT at 4
query heads over 2 kv heads, Cohere2 with a window of 5 at 16 tokens):
each config field equal to JAX's, the state-dict keys equal, f32 logits
within 1e-4 and the loss within rtol 1e-5 on the JAX model's weights
(norms and biases moved off their initial values), carried over with
``utils.state_dict`` -> ``load_numpy_state_dict``, and each new knob shown
to bind (the port without it gives other logits, or other parameters):
ALiBi, both sinusoid kinds and their offsets, both sub-norms,
GPT-NeoX-Japanese's last-layer-only o_proj bias, Cohere2's unrotated full
layers.  Then KV-cached ``generate`` on ragged prompts against JAX
``serving.generate``, one ``dwain.decompose`` walk on BLOOM against the JAX
walk with the fused serve after it, and the families' snapshots in their
checkpoint layouts through the trainer's builder."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, models as jmodels, serving as jserving
from ptdeco_tpu import utils as jutils
from ptdeco_tpu_torch import dwain as tdwain, models as tmodels, nn as pnn
from ptdeco_tpu_torch import serving as tserving
from ptdeco_tpu_torch import utils as tutils
from ptdeco_tpu_torch.apps.trainer_llm import builder
from ptdeco_tpu_torch.models import hf_loader, transformer as ttransformer

from test_torch_beyond_llama import _fused_qkv
from test_torch_families import tiny_hf
from test_torch_gpt_lineage import _renamed
from test_torch_llama_lineage import CONFIG_FIELDS as EARLIER_FIELDS
from test_torch_moe import jax_logits, probe_ids
from test_torch_rope_gemma_phi3 import _cycle

BLOOM = dict(model_type="bloom", vocab_size=128, hidden_size=48, n_layer=2, n_head=6,
             layer_norm_epsilon=1e-5)
MPT = dict(model_type="mpt", vocab_size=128, d_model=32, n_heads=4, n_layers=2,
           expansion_ratio=2, no_bias=True, max_seq_len=64,
           attn_config={"alibi": True, "alibi_bias_max": 8, "kv_n_heads": 2})
CASES = {
    "bloom": BLOOM,
    "mpt": MPT,
    "xglm": dict(model_type="xglm", vocab_size=128, d_model=32, num_layers=2, attention_heads=4,
                 ffn_dim=64, activation_function="gelu", scale_embedding=True,
                 max_position_embeddings=64),
    "ctrl": dict(model_type="ctrl", vocab_size=128, n_embd=32, n_layer=2, n_head=4, dff=64,
                 n_positions=64),
    "biogpt": tiny_hf("biogpt", hidden_act="gelu", layer_norm_eps=1e-12, scale_embedding=True),
    "xlm": dict(model_type="xlm", vocab_size=128, emb_dim=32, n_layers=2, n_heads=4, causal=True,
                max_position_embeddings=64, gelu_activation=True, layer_norm_eps=1e-12, n_langs=2),
    "bitnet": tiny_hf("bitnet", hidden_act="relu2", rms_norm_eps=1e-5, rope_theta=500000.0),
    # a sliding layer (window 5, rotated) and a full one (unrotated)
    "cohere2": tiny_hf("cohere2", layer_norm_eps=1e-5, logit_scale=0.25, sliding_window=5,
                       layer_types=["sliding_attention", "full_attention"]),
    "gpt_neox_japanese": tiny_hf("gpt_neox_japanese", rotary_pct=0.5, rotary_emb_base=10000,
                                 intermediate_multiple_size=2, hidden_act="gelu",
                                 layer_norm_eps=1e-5),
}
# configurations read for their fields only: Cohere2's layer types from
# sliding_window_pattern, BLOOM-176B's 112 heads, MPT without kv_n_heads
FIELDS_ONLY = {
    "cohere2_pattern": tiny_hf("cohere2", num_hidden_layers=4, sliding_window=5,
                               sliding_window_pattern=2),
    "bloom_176b_heads": dict(BLOOM, hidden_size=112 * 8, n_head=112),
    "mpt_mha": dict(MPT, attn_config={"alibi": True}),
}
NEW_FIELDS = ("use_alibi", "sub_norms", "sinusoidal_pos", "sinusoidal_offset", "sinusoidal_kind")
CONFIG_FIELDS = (*EARLIER_FIELDS, *NEW_FIELDS)
# what makes each knob bind: the port without it gives other logits (or
# other parameters)
WITHOUT_FEATURE = [
    ("bloom", {"use_alibi": False}),
    ("bloom", {"embed_norm": False}),
    ("mpt", {"use_alibi": False}),
    ("xglm", {"sinusoidal_pos": False}),
    ("xglm", {"sinusoidal_offset": 0}),
    ("xglm", {"sinusoidal_kind": "t2t"}),
    ("ctrl", {"sinusoidal_pos": False}),
    ("ctrl", {"sinusoidal_offset": 2}),
    ("ctrl", {"sinusoidal_kind": "fairseq"}),
    ("biogpt", {"scale_embeddings": False}),
    ("xlm", {"post_ln": False}),
    ("xlm", {"embed_norm": False}),
    ("bitnet", {"mlp_act": "relu"}),
    ("cohere2", {"rope_layers": ()}),
    ("cohere2", {"sliding_window": None}),
    ("gpt_neox_japanese", {"o_proj_bias": False}),
    ("gpt_neox_japanese", {"rope_partial_factor": None}),
]


@functools.lru_cache(maxsize=None)
def _jax_model(case: str):
    """One JAX model a case (a model's first call compiles), shared by the
    tests: JAX modules are immutable, and each test gets a port copy.
    GPT-NeoX-Japanese's o_proj biases but the last layer's stay zero, as a
    checkpoint's translation leaves them."""
    seed = sorted(CASES).index(case)
    jm = jmodels.CausalLM.create(
        jax.random.PRNGKey(seed),
        jmodels.TransformerConfig.from_hf_config(CASES[case], dtype=jnp.float32))
    sd = jutils.state_dict(jm)
    rng = np.random.default_rng(seed)
    for k in sd:
        if "norm" in k or k.endswith("bias"):
            sd[k] = (sd[k] + 0.2 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    if case == "gpt_neox_japanese":
        sd["model.layers.0.self_attn.o_proj.bias"] = np.zeros(32, np.float32)
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
    """Two rows of 16 tokens: past Cohere2's window of 5."""
    return probe_ids(128, (2, 16), seed=4)


def _logits(model: torch.nn.Module, ids: np.ndarray) -> torch.Tensor:
    with torch.no_grad():
        return model({"input_ids": torch.from_numpy(ids).long()})


@pytest.mark.parametrize("case", sorted(CASES) + sorted(FIELDS_ONLY))
def test_config_fields_match_jax(case):
    hf = {**CASES, **FIELDS_ONLY}[case]
    jcfg = jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)
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
    y = _logits(tm, ids)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)
    loss_j = float(jmodels.transformer.ce_loss({"input_ids": jnp.asarray(ids)}, jnp.asarray(y_jax)))
    batch = {"input_ids": torch.from_numpy(ids).long()}
    np.testing.assert_allclose(float(tmodels.ce_loss(batch, y)), loss_j, rtol=1e-5)


@pytest.mark.parametrize("case,over", WITHOUT_FEATURE, ids=lambda v: str(v))
def test_each_knob_binds(case, over):
    _, tm, sd = pair(case)
    without = port_model(case, sd, **over)
    ids = _probe()
    other_logits = float((_logits(without, ids) - _logits(tm, ids)).abs().max()) > 1e-3
    assert other_logits or set(without.state_dict()) != set(sd), "the feature does not bind"


@pytest.mark.parametrize("norm", ["attn_sub_norm", "ffn_sub_norm"])
def test_each_bitnet_sub_norm_binds(norm):
    """Each of BitNet's sub-norms, taken out of every layer (its weights
    kept), gives other logits; each sits inside its site's input, so a
    hook on o_proj / down_proj sees the normed activations."""
    _, tm, sd = pair("bitnet")
    without = port_model("bitnet", sd)
    owners = [m for m in without.modules() if getattr(m, norm, None) is not None]
    assert len(owners) == 2
    for m in owners:
        setattr(m, norm, torch.nn.Identity())
    ids = _probe()
    assert float((_logits(without, ids) - _logits(tm, ids)).abs().max()) > 1e-3
    site = {"attn_sub_norm": "o_proj", "ffn_sub_norm": "down_proj"}[norm]
    owner = next(m for m in tm.modules() if getattr(m, norm, None) is not None)
    seen = []
    handle = getattr(owner, site).register_forward_hook(lambda m, a, o: seen.append(a[0]))
    _logits(tm, ids)
    handle.remove()
    w = getattr(owner, norm).weight
    assert not torch.allclose(w, torch.ones_like(w))
    rms = seen[0].div(w).square().mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones_like(rms), rtol=1e-3, atol=1e-3)


def test_alibi_slopes_are_the_jax_packages():
    """The port's slopes equal the JAX package's bit for bit at powers of two
    and between them (BLOOM-176B's 112 heads interleave the 256-head
    table); the ALiBi layers never take the flash gate's route."""
    for n in (1, 4, 6, 8, 12, 32, 112):
        got = ttransformer.alibi_slopes(n)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jmodels.transformer.alibi_slopes(n))
    _, tm, _ = pair("bloom")
    assert all(layer.self_attn.use_alibi for layer in tm.model.layers)


@pytest.mark.parametrize("kind", ["fairseq", "t2t"])
def test_sinusoid_tables_are_the_jax_packages(kind):
    """Both computed tables equal the JAX package's up to position 2049:
    the two backends' f32 exp may round a frequency one ulp apart, which
    moves an angle by up to position * 2^-24, so each entry is held within
    position * 2^-23 + 1e-6."""
    pos = np.array([[0, 1, 2, 17, 63, 2049]])
    jfn = {"fairseq": jmodels.transformer._sinusoidal_positions,
           "t2t": jmodels.transformer._t2t_sinusoidal_positions}[kind]
    got = ttransformer.sinusoidal_positions(torch.from_numpy(pos), 32, kind).numpy()
    want = np.asarray(jfn(jnp.asarray(pos), 32))
    assert (np.abs(got - want) <= pos[..., None] * 2.0 ** -23 + 1e-6).all()


@pytest.mark.parametrize("case", ["bloom", "mpt", "xglm", "ctrl", "bitnet"])
def test_ragged_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache on right-padded prompts of 5 and
    9 tokens gives the JAX package's ragged tokens, and the logits each row
    chose from equal the JAX forward of that row alone (f32, 1e-4): ALiBi
    on the cache's slots (MPT's grouped heads too), the sinusoids at each
    row's positions, the sub-norms in the cached step."""
    jm, tm, _ = pair(case)
    lens = np.array([5, 9])
    prompt = probe_ids(128, (2, 9), seed=8)
    prompt[0, 5:] = 0
    toks, step_logits = tserving.generate(
        tm, torch.from_numpy(prompt).long(), 6, prompt_lens=torch.from_numpy(lens),
        return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 6,
                                        prompt_lens=jnp.asarray(lens)))
    np.testing.assert_array_equal(toks.numpy(), want)
    # each row alone, zero-padded on the right to the probe's 16 tokens (the
    # shape the logits test compiled)
    full = np.zeros(_probe().shape, np.int32)
    for row, n in enumerate(lens):
        full[row, :n + 5] = np.concatenate([prompt[row, :n], want[row, :-1]])
    ref = jax_logits(jm, full)
    for row, n in enumerate(lens):
        np.testing.assert_allclose(step_logits[row].numpy(), ref[row, n - 1:n + 5], atol=1e-4)


def test_dwain_decompose_bloom_matches_jax(tmp_path):
    """One walk over layer 0's biased up_proj, whose input is an ALiBi
    layer's residual, with the rest blacklisted: the JAX walk's sites,
    ranks and config (float metrics within rtol 1e-4), byte-equal once those
    are set equal; the decomposed models' state-dict keys equal, every
    tensor the walk did not replace equal and the pair's product within
    1e-4; logits within 1e-4 of JAX's; the artifact (decompose_config.json
    + decompose_state_dict.pt) reloads into a fresh model bit-equal; logits
    within 1e-4 of JAX's again once the pair is fused (the served form)."""
    hp = dict(num_data_steps=1, num_metric_steps=1, nsr_final_threshold=0.3, min_rank=8,
              trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
              decompose_in_float64=True)
    walked = "model.layers.0.mlp.up_proj"
    jm, tm, _ = pair("bloom")
    black = [n for n, m in tm.named_modules() if isinstance(m, torch.nn.Linear) and n != walked]
    rng = np.random.default_rng(5)
    calib, metric = (rng.integers(0, 128, (2, 2, 16)).astype(np.int32) for _ in range(2))
    jm, jconf = jdwain.decompose(module=jm, data_iterator=_cycle(calib, False),
                                 metric_iterator=_cycle(metric, False), loss_fn=jmodels.ce_loss,
                                 blacklisted_module_names=black, **hp)
    tm, tconf = tdwain.decompose(module=tm, data_iterator=_cycle(calib, True),
                                 metric_iterator=_cycle(metric, True), loss_fn=tmodels.ce_loss,
                                 blacklisted_module_names=black, device="cpu", **hp)
    assert set(tconf) == set(jconf) == {walked}
    for site, entry in jconf.items():
        for field, value in entry["__meta__"].items():
            if isinstance(value, float):
                np.testing.assert_allclose(tconf[site]["__meta__"][field], value, rtol=1e-4)
                tconf[site]["__meta__"][field] = value
    assert json.dumps(tconf) == json.dumps(jconf)
    jsd, tsd = jutils.state_dict(jm), tutils.state_dict(tm)
    assert set(tsd) == set(jsd)
    pair_keys = {f"{walked}.{i}.{leaf}" for i in range(2) for leaf in ("weight", "bias")}
    for k in set(jsd) - pair_keys:
        np.testing.assert_array_equal(tsd[k].numpy(), jsd[k], err_msg=k)
    first, second = (f"{walked}.{i}.weight" for i in range(2))
    np.testing.assert_allclose((tsd[second] @ tsd[first]).numpy(), jsd[second] @ jsd[first],
                               atol=1e-4)
    ids = _probe()
    y_jax = jax_logits(jm, ids)
    y = _logits(tm, ids)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)
    (tmp_path / "decompose_config.json").write_text(json.dumps(tconf))
    tutils.save_state_dict_pt(tutils.state_dict(tm), str(tmp_path / "decompose_state_dict.pt"))
    fresh = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(
        BLOOM, dtype=torch.float32), device="cpu")
    tutils.apply_decompose_config(fresh, json.loads((tmp_path / "decompose_config.json").read_text()))
    tutils.load_state_dict(fresh, tutils.load_state_dict_pt(str(tmp_path / "decompose_state_dict.pt")))
    assert torch.equal(_logits(fresh, ids), y)
    with torch.no_grad():
        pnn.fuse_factor_pairs(tm)
    assert isinstance(tm.model.layers[0].mlp.up_proj, pnn.FusedLowRankLinear)
    np.testing.assert_allclose(_logits(tm, ids).numpy(), y_jax, atol=1e-4)


def _per_head(q, k, v, n_heads: int):
    """q/k/v fused a head at a time: [head 0: q k v][head 1: q k v]..."""
    return np.stack([t.reshape(n_heads, -1, *t.shape[1:]) for t in (q, k, v)], axis=1).reshape(
        3 * q.shape[0], *q.shape[1:])


def _bloom_layout(sd: dict) -> dict:
    """BLOOM's: q/k/v fused a head at a time (6 of 8), its names."""
    return _fused_qkv(sd, lambda q, k, v: _per_head(q, k, v, 6), (
        ("model.embed_norm.", "transformer.word_embeddings_layernorm."),
        ("model.embed_tokens.", "transformer.word_embeddings."), ("model.norm.", "transformer.ln_f."),
        ("model.layers.", "transformer.h."),
        (".self_attn.query_key_value.", ".self_attention.query_key_value."),
        (".self_attn.o_proj.", ".self_attention.dense."), (".mlp.up_proj.", ".mlp.dense_h_to_4h."),
        (".mlp.down_proj.", ".mlp.dense_4h_to_h.")))


def _mpt_layout(sd: dict) -> dict:
    """MPT's: [q | k | v] rows in ``attn.Wqkv`` (k and v 2 heads each),
    its names, the tied head stored too."""
    out = _fused_qkv(sd, lambda q, k, v: np.concatenate([q, k, v]), (
        ("model.embed_tokens.", "transformer.wte."), ("model.norm.", "transformer.norm_f."),
        ("model.layers.", "transformer.blocks."), (".input_layernorm.", ".norm_1."),
        (".post_attention_layernorm.", ".norm_2."),
        (".self_attn.query_key_value.", ".attn.Wqkv."), (".self_attn.o_proj.", ".attn.out_proj."),
        (".mlp.", ".ffn.")))
    return {**out, "lm_head.weight": sd["model.embed_tokens.weight"]}


_OPT_NAMES = ((".self_attn.o_proj.", ".self_attn.out_proj."),
              (".input_layernorm.", ".self_attn_layer_norm."),
              (".post_attention_layernorm.", ".final_layer_norm."),
              (".mlp.up_proj.", ".fc1."), (".mlp.down_proj.", ".fc2."))


def _biogpt_layout(sd: dict) -> dict:
    """BioGPT's: OPT's names under ``biogpt.``, its position table after two
    offset rows, the tied ``output_projection`` stored too."""
    out = _renamed(sd, (("model.pos_embed.", "biogpt.embed_positions."),
                        ("model.norm.", "biogpt.layer_norm."), ("model.", "biogpt."), *_OPT_NAMES))
    table = out["biogpt.embed_positions.weight"]
    out["biogpt.embed_positions.weight"] = np.concatenate([np.full_like(table[:2], 7.0), table])
    return {**out, "output_projection.weight": sd["model.embed_tokens.weight"]}


def _xlm_layout(sd: dict) -> dict:
    """XLM's: per-layer lists, the head as ``pred_layer.proj`` (its weight
    the embedding), a language table the causal LM never reads."""
    lists = (("self_attn", "attentions"), ("input_layernorm", "layer_norm1"),
             ("post_attention_layernorm", "layer_norm2"), ("mlp", "ffns"))
    out = {}
    for k, v in _renamed(sd, (
            ("model.embed_tokens.", "transformer.embeddings."),
            ("model.pos_embed.", "transformer.position_embeddings."),
            ("model.embed_norm.", "transformer.layer_norm_emb."),
            ("tied_head_bias", "pred_layer.proj.bias"), (".q_proj.", ".q_lin."),
            (".k_proj.", ".k_lin."), (".v_proj.", ".v_lin."), (".o_proj.", ".out_lin."),
            (".up_proj.", ".lin1."), (".down_proj.", ".lin2."))).items():
        if k.startswith("model.layers."):
            layer, module, rest = k[len("model.layers."):].split(".", 2)
            k = f"transformer.{dict(lists)[module]}.{layer}.{rest}"
        out[k] = v
    return {**out, "pred_layer.proj.weight": sd["model.embed_tokens.weight"],
            "transformer.lang_embeddings.weight": np.ones((2, 32), np.float32)}


def _gpt_neox_japanese_layout(sd: dict) -> dict:
    """GPT-NeoX-Japanese's: q/k/v fused a head at a time, the o_proj bias
    only on the last layer (``attention.dense_bias``), its names."""
    sd = {k: v for k, v in sd.items() if k != "model.layers.0.self_attn.o_proj.bias"}
    return _fused_qkv(sd, lambda q, k, v: _per_head(q, k, v, 4), (
        ("model.embed_tokens.", "gpt_neox_japanese.embed_in."),
        ("model.norm.", "gpt_neox_japanese.final_layer_norm."),
        ("model.layers.", "gpt_neox_japanese.layers."), ("lm_head.", "embed_out."),
        (".self_attn.query_key_value.", ".attention.query_key_value."),
        (".self_attn.o_proj.bias", ".attention.dense_bias"),
        (".self_attn.o_proj.", ".attention.dense."), (".mlp.up_proj.", ".mlp.dense_h_to_4h."),
        (".mlp.down_proj.", ".mlp.dense_4h_to_h.")))


LAYOUTS = {
    "bloom": _bloom_layout,
    "mpt": _mpt_layout,
    "xglm": lambda sd: {**_renamed(sd, (("model.norm.", "model.layer_norm."), *_OPT_NAMES)),
                        "lm_head.weight": sd["model.embed_tokens.weight"]},
    "ctrl": lambda sd: _renamed({**sd, "lm_head.weight": sd["model.embed_tokens.weight"]}, (
        ("model.embed_tokens.", "transformer.w."), ("model.norm.", "transformer.layernorm."),
        ("model.layers.", "transformer.h."), (".self_attn.q_proj.", ".multi_head_attention.Wq."),
        (".self_attn.k_proj.", ".multi_head_attention.Wk."),
        (".self_attn.v_proj.", ".multi_head_attention.Wv."),
        (".self_attn.o_proj.", ".multi_head_attention.dense."),
        (".input_layernorm.", ".layernorm1."), (".post_attention_layernorm.", ".layernorm2."),
        (".mlp.up_proj.", ".ffn.0."), (".mlp.down_proj.", ".ffn.2."),
        ("tied_head_bias", "lm_head.bias"))),
    "biogpt": _biogpt_layout,
    "xlm": _xlm_layout,
    # HF's names are the port's
    "bitnet": dict,
    "cohere2": dict,
    "gpt_neox_japanese": _gpt_neox_japanese_layout,
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_snapshot_loads_through_the_builder(case, tmp_path, monkeypatch):
    """Each family's weights written in its checkpoint layout build
    generically through the trainer's builder and give the source's logits
    exactly."""
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    _, tm, sd = pair(case)
    stored = LAYOUTS[case](sd)
    assert (set(stored) == set(sd)) == (case in ("bitnet", "cohere2"))
    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(CASES[case]))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in stored.items()},
               snap / "pytorch_model.bin")
    model, _ = builder.make_model_and_tokenizer(
        model_name=f"someorg/some-{case}", dtype="float32", checkpoint_path=str(snap), device="cpu")
    assert model.state_dict().keys() == tm.state_dict().keys()
    ids = probe_ids(128, (2, 7), seed=6)
    torch.testing.assert_close(_logits(model, ids), _logits(tm, ids), rtol=0, atol=0)


def test_bloom_split_takes_heads_in_turn():
    """Distinct values a head (head h of q holds 100 + h, of k 200 + h, of v
    300 + h) come back to their projections from BLOOM's per-head fused
    layout, weights and biases; GPT-NeoX-Japanese's zero-fills the o_proj
    biases the checkpoint lacks; the same rows read as [q | k | v] blocks
    give other logits."""
    heads = np.repeat(np.arange(6, dtype=np.float32), 8)
    q, k, v = (base + heads[:, None] * np.ones((1, 48), np.float32) for base in (100, 200, 300))
    translate = hf_loader.translator_for(BLOOM)
    got = translate({"transformer.h.0.self_attention.query_key_value.weight": _per_head(q, k, v, 6),
                     "transformer.h.0.self_attention.query_key_value.bias":
                         _per_head(q[:, 0], k[:, 0], v[:, 0], 6)})
    assert len(got) == 6
    for name, want in (("q", q), ("k", k), ("v", v)):
        np.testing.assert_array_equal(got[f"model.layers.0.self_attn.{name}_proj.weight"], want)
        np.testing.assert_array_equal(got[f"model.layers.0.self_attn.{name}_proj.bias"], want[:, 0])
    neox_jp = hf_loader.translator_for(CASES["gpt_neox_japanese"])(
        {"gpt_neox_japanese.layers.1.attention.dense_bias": torch.ones(32)})
    assert torch.equal(neox_jp["model.layers.0.self_attn.o_proj.bias"], torch.zeros(32))
    assert torch.equal(neox_jp["model.layers.1.self_attn.o_proj.bias"], torch.ones(32))
    _, tm, sd = pair("bloom")
    blocks = translate(_fused_qkv(sd, lambda q, k, v: np.concatenate([q, k, v]), (
        (".self_attn.query_key_value.", ".self_attention.query_key_value."),)))
    wrong = tutils.load_numpy_state_dict(port_model("bloom", sd), blocks)
    ids = _probe()
    assert float((_logits(wrong, ids) - _logits(tm, ids)).abs().max()) > 1e-3
