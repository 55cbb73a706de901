"""The port's llama-lineage decoders with knobs of their own (OLMo,
Nemotron, Persimmon, ERNIE-4.5, Arcee, Seed-OSS, EXAONE-4, VaultGemma,
Apertus, HunYuan-dense, Helium and OpenLLaMA) and the fuyu wrapper against
the JAX package's, on the CPU, at tiny widths (hidden 32, 2 layers, vocab
128; head dims that make each knob bind: Arcee 4 heads of 10, Nemotron's
and Persimmon's partial rotary over 4 of 8 dims, windows of 5 at 16
tokens): each config field equal to JAX's, the state-dict keys equal, f32
logits within 1e-4 and the loss within rtol 1e-5 on the JAX model's weights
(norms, biases and the xIELU alphas moved off their initial values),
carried over with ``utils.state_dict`` -> ``load_numpy_state_dict``, and
each new knob shown to bind (the port without it gives other logits, or
other parameters): OLMo's norms without an affine, Nemotron's LayerNorm1P,
Persimmon's q/k LayerNorm, relu^2, xIELU and its learned alphas, OpenLLaMA's
embedding norm, EXAONE-4's unrotated full layers.  Then KV-cached
``generate`` against JAX ``serving.generate``, one ``dwain.decompose`` walk
on Apertus against the JAX walk with the fused serve after it, and the
families' snapshots in their checkpoint layouts through the trainer's
builder."""

import dataclasses
import functools
import importlib
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
from ptdeco_tpu_torch.models import hf_loader

from test_torch_beyond_llama import CONFIG_FIELDS as EARLIER_FIELDS, _fused_qkv
from test_torch_families import tiny_hf
from test_torch_gpt_lineage import _renamed
from test_torch_moe import jax_logits, probe_ids
from test_torch_rope_gemma_phi3 import _cycle

PERSIMMON = tiny_hf("persimmon", num_key_value_heads=None, layer_norm_eps=1e-5,
                    partial_rotary_factor=0.5, qk_layernorm=True, hidden_act="relu2",
                    rope_theta=25000.0)
CASES = {
    # clip_qkv at 0.5 binds at these widths
    "olmo": tiny_hf("olmo", clip_qkv=0.5),
    "nemotron": tiny_hf("nemotron", norm_eps=1e-5, partial_rotary_factor=0.5,
                        hidden_act="relu2"),
    "persimmon": PERSIMMON,
    # its text_config's model_type left to its default, as JAX reads it
    "fuyu": dict(model_type="fuyu",
                 text_config={k: v for k, v in PERSIMMON.items() if k != "model_type"}),
    "ernie4_5": tiny_hf("ernie4_5", use_bias=True, head_dim=16, rms_norm_eps=1e-5),
    "arcee": tiny_hf("arcee", head_dim=10, hidden_act="relu2", rms_norm_eps=1e-5),
    "seed_oss": tiny_hf("seed_oss", head_dim=8, attention_bias=True, attention_out_bias=True),
    # a sliding layer (window 5, rotated) and a full one (unrotated)
    "exaone4": tiny_hf("exaone4", head_dim=8, sliding_window=5,
                       layer_types=["sliding_attention", "full_attention"]),
    "vaultgemma": tiny_hf("vaultgemma", head_dim=16, sliding_window=5, query_pre_attn_scalar=16,
                          attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                          hidden_activation="gelu_pytorch_tanh"),
    "apertus": tiny_hf("apertus", head_dim=8, hidden_act="xielu", rms_norm_eps=1e-5,
                       rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 32}),
    "hunyuan": tiny_hf("hunyuan_v1_dense", head_dim=8, rms_norm_eps=1e-5),
    "helium": tiny_hf("helium", head_dim=8, attention_bias=True, mlp_bias=True,
                      rms_norm_eps=1e-8, rope_theta=100000.0),
    "open_llama": tiny_hf("open-llama", num_key_value_heads=None, use_stable_embedding=True,
                          shared_input_output_embedding=True),
}
NEW_FIELDS = ("norm_no_affine", "qk_norm_type", "embed_norm")
CONFIG_FIELDS = (*EARLIER_FIELDS, *NEW_FIELDS)
# what makes each knob bind: the port without it gives other logits (or,
# for OLMo's norms, other parameters than the JAX model's)
WITHOUT_FEATURE = [
    ("olmo", {"norm_no_affine": False}),
    ("olmo", {"clip_qkv": None}),
    ("nemotron", {"norm_plus_one": False}),
    ("nemotron", {"mlp_act": "relu"}),
    ("nemotron", {"rope_partial_factor": None}),
    ("persimmon", {"qk_norm_type": "rmsnorm"}),
    ("persimmon", {"qk_norm": False}),
    ("persimmon", {"mlp_act": "relu"}),
    ("ernie4_5", {"rope_interleaved": False}),
    ("ernie4_5", {"mlp_bias": False}),
    ("arcee", {"mlp_act": "relu"}),
    ("seed_oss", {"o_proj_bias": False}),
    ("exaone4", {"rope_layers": ()}),
    ("exaone4", {"sliding_window": None}),
    ("vaultgemma", {"sliding_window": None}),
    ("vaultgemma", {"norm_plus_one": False}),
    ("apertus", {"mlp_act": "relu2"}),
    ("apertus", {"rope_llama3_scaling": None}),
    ("hunyuan", {"qk_norm": False}),
    ("helium", {"rope_interleaved": False}),
    ("open_llama", {"embed_norm": False}),
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
        if "norm" in k or k.endswith("bias") or "act_alpha" in k:
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
    """Two rows of 16 tokens: past the windows of 5."""
    return probe_ids(128, (2, 16), seed=4)


def _logits(model: torch.nn.Module, ids: np.ndarray) -> torch.Tensor:
    with torch.no_grad():
        return model({"input_ids": torch.from_numpy(ids).long()})


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


def test_olmo_norms_have_no_parameters():
    """OLMo's block and final norms carry no weight and no bias (so no
    state-dict key) and run at eps 1e-5 whatever the config's rms eps."""
    _, tm, sd = pair("olmo")
    assert not any("norm" in k for k in sd)
    norms = [m for m in tm.modules() if isinstance(m, tmodels.transformer.LayerNorm)]
    assert len(norms) == 5 and all(m.weight is None and m.bias is None for m in norms)
    assert {m.eps for m in norms} == {1e-5} and CASES["olmo"]["rms_norm_eps"] == 1e-6


def test_xielu_alphas_bind():
    """Apertus's learned alphas reach the logits: the JAX model's weights
    with the alphas put back to their initial values (the port's own, equal
    to the JAX package's) give other logits; the alphas are f32 (1,)
    parameters of the MLP and no Linear site."""
    jm_init = jmodels.CausalLM.create(
        jax.random.PRNGKey(0), jmodels.TransformerConfig.from_hf_config(CASES["apertus"],
                                                                        dtype=jnp.float32))
    init_sd = jutils.state_dict(jm_init)
    _, tm, sd = pair("apertus")
    fresh = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(
        CASES["apertus"], dtype=torch.float32), device="cpu")
    alphas = {k: v for k, v in fresh.state_dict().items() if "act_alpha" in k}
    assert len(alphas) == 4
    for k, v in alphas.items():
        assert v.dtype == torch.float32 and v.shape == (1,)
        np.testing.assert_array_equal(v.numpy(), init_sd[k])
    at_init = tutils.load_numpy_state_dict(port_model("apertus", sd), {**sd, **{
        k: v.numpy() for k, v in alphas.items()}})
    ids = _probe()
    assert float((_logits(at_init, ids) - _logits(tm, ids)).abs().max()) > 1e-3
    assert not any("act_alpha" in n for n, m in tm.named_modules()
                   if isinstance(m, torch.nn.Linear))


@pytest.mark.parametrize("case", ["persimmon", "nemotron", "exaone4", "open_llama"])
def test_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache gives the JAX package's tokens;
    the logits that chose each new token equal the JAX model's forward over
    the whole sequence (f32, 1e-4): Persimmon's q/k LayerNorm, EXAONE-4's
    window past its 5 keys and its unrotated full layer, and OpenLLaMA's
    embedding norm in the cache."""
    jm, tm, _ = pair(case)
    prompt = probe_ids(128, (2, 9), seed=7)
    toks, step_logits = tserving.generate(tm, torch.from_numpy(prompt).long(), 8,
                                          return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(toks.numpy(), want)
    full = np.concatenate([prompt, want[:, :-1]], axis=1).astype(np.int32)
    np.testing.assert_allclose(step_logits.numpy(), jax_logits(jm, full)[:, 8:], atol=1e-4)


def test_dwain_decompose_apertus_matches_jax():
    """One walk over layer 0's xIELU up_proj with the rest blacklisted: the
    JAX walk's sites, ranks and config (float metrics within rtol 1e-4),
    byte-equal once those are set equal; the decomposed models' state-dict
    keys equal (the alphas' included), every tensor the walk did not
    replace equal and the pair's product within 1e-4; logits within 1e-4
    of JAX's, and again once the pair is fused (the served form)."""
    hp = dict(num_data_steps=1, num_metric_steps=1, nsr_final_threshold=0.3, min_rank=8,
              trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
              decompose_in_float64=True)
    walked = "model.layers.0.mlp.up_proj"
    jm, tm, _ = pair("apertus")
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
    assert set(tsd) == set(jsd) and sum("act_alpha" in k for k in tsd) == 4
    pair_keys = {f"{walked}.{i}.weight" for i in range(2)}
    for k in set(jsd) - pair_keys:
        np.testing.assert_array_equal(tsd[k].numpy(), jsd[k], err_msg=k)
    first, second = (f"{walked}.{i}.weight" for i in range(2))
    np.testing.assert_allclose((tsd[second] @ tsd[first]).numpy(), jsd[second] @ jsd[first],
                               atol=1e-4)
    ids = _probe()
    y_jax = jax_logits(jm, ids)
    np.testing.assert_allclose(_logits(tm, ids).numpy(), y_jax, atol=1e-4)
    with torch.no_grad():
        pnn.fuse_factor_pairs(tm)
    assert isinstance(tm.model.layers[0].mlp.up_proj, pnn.FusedLowRankLinear)
    np.testing.assert_allclose(_logits(tm, ids).numpy(), y_jax, atol=1e-4)


def _per_head(q, k, v):
    """q/k/v fused a head at a time: [head 0: q k v][head 1: q k v]..."""
    return np.stack([t.reshape(4, 8, *t.shape[1:]) for t in (q, k, v)], axis=1).reshape(
        96, *q.shape[1:])


def _persimmon_layout(sd: dict, prefix: str = "model.", fuse=_per_head) -> dict:
    """Persimmon's checkpoint layout: q/k/v fused by ``fuse`` (a head at a
    time, 4 heads of 8) in ``query_key_value``, its names; ``prefix`` in
    place of the decoder's ``model.``."""
    out = _fused_qkv(sd, fuse, (
        ("model.norm.", "model.final_layernorm."), (".self_attn.o_proj.", ".self_attn.dense."),
        (".self_attn.q_norm.", ".self_attn.q_layernorm."),
        (".self_attn.k_norm.", ".self_attn.k_layernorm."),
        (".mlp.up_proj.", ".mlp.dense_h_to_4h."), (".mlp.down_proj.", ".mlp.dense_4h_to_h.")))
    return {(prefix + k[len("model."):] if k.startswith("model.") else k): v
            for k, v in out.items()}


def _fuyu_layout(sd: dict) -> dict:
    """Fuyu's: Persimmon's under ``model.language_model.``, beside the
    patch embedding the text path never runs."""
    return {**_persimmon_layout(sd, "model.language_model."),
            "model.vision_embed_tokens.weight": np.ones((32, 48), np.float32)}


LAYOUTS = {
    "persimmon": _persimmon_layout,
    "fuyu": _fuyu_layout,
    "apertus": lambda sd: _renamed(sd, (
        (".input_layernorm.", ".attention_layernorm."),
        (".post_attention_layernorm.", ".feedforward_layernorm."),
        (".mlp.act_alpha_p", ".mlp.act_fn.alpha_p"), (".mlp.act_alpha_n", ".mlp.act_fn.alpha_n"))),
    "vaultgemma": lambda sd: _renamed(sd, (
        (".post_attention_layernorm.", ".pre_feedforward_layernorm."),)),
    "hunyuan": lambda sd: _renamed(sd, ((".self_attn.q_norm.", ".self_attn.query_layernorm."),
                                        (".self_attn.k_norm.", ".self_attn.key_layernorm."))),
    # the shared embedding stored as a head too, which the loader drops
    "open_llama": lambda sd: {**_renamed(sd, (("model.embed_norm.", "model.embed_layer_norm."),)),
                              "lm_head.weight": sd["model.embed_tokens.weight"]},
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
    ids = probe_ids(128, (2, 7), seed=6)
    torch.testing.assert_close(_logits(model, ids), _logits(tm, ids), rtol=0, atol=0)


def test_persimmon_split_takes_heads_in_turn():
    """Distinct values a head (head h of q holds 100 + h, of k 200 + h, of v
    300 + h) come back to their projections from the per-head fused layout,
    through Persimmon's translator and through fuyu's older layout, which
    nests the model under ``language_model.``; the same rows read as [q | k
    | v] blocks give other logits."""
    heads = np.repeat(np.arange(4, dtype=np.float32), 8)[:, None] * np.ones((1, 32), np.float32)
    q, k, v = 100 + heads, 200 + heads, 300 + heads
    fused = _per_head(q, k, v)
    key = "model.layers.0.self_attn.query_key_value.weight"
    for translate, stored in ((hf_loader.translator_for(PERSIMMON), {key: fused}),
                              (hf_loader.translator_for(CASES["fuyu"]),
                               {"language_model." + key: fused, "vision_embed_tokens.weight": q})):
        got = translate(stored)
        assert len(got) == 3
        for name, want in (("q", q), ("k", k), ("v", v)):
            np.testing.assert_array_equal(got[f"model.layers.0.self_attn.{name}_proj.weight"], want)
    _, tm, sd = pair("persimmon")
    blocks = hf_loader.translator_for(PERSIMMON)(
        _persimmon_layout(sd, fuse=lambda q, k, v: np.concatenate([q, k, v])))
    wrong = tutils.load_numpy_state_dict(port_model("persimmon", sd), blocks)
    ids = _probe()
    assert float((_logits(wrong, ids) - _logits(tm, ids)).abs().max()) > 1e-3


def test_arcee_head_dim_runs_on_the_flash_kernel():
    """Arcee's 80-wide heads (``ArceeConfig()``'s 32 of 80) pass the JAX
    model's flash gate (hd <= 128), and the port's kernel takes them on its
    128-wide instance: the same shared memory as head dim 128, only the 80
    real columns read and stored.  The CPU runs the plain version."""
    fa = importlib.import_module("ptdeco_tpu_torch.ops.flash_attention")
    hf = dict(CASES["arcee"], hidden_size=2560, num_attention_heads=32, num_key_value_heads=32,
              head_dim=80)
    cfg = tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.bfloat16)
    assert cfg.head_dim == 80 and cfg.head_dim_override is None
    assert cfg.head_dim <= 128 and cfg.head_dim in fa.KERNEL_HEAD_DIMS
    assert fa.tile_head_dim(80) == 128 and fa.smem_bytes(80) == fa.smem_bytes(128)
    q, k, v = (torch.randn(1, 2, 16, 80, dtype=torch.bfloat16) for _ in range(3))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, 80 ** -0.5)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(out, fa.causal_attention_plain(q, k, v, 80 ** -0.5), rtol=0, atol=0)
