"""DeepSeek-V2 and V3 in the port against the JAX package, on the CPU, at
the JAX package's own tiny widths (hidden 32, 4 heads, latent 16, rope 4,
nope 8, v 8; 8 experts of 16, top-3, groups 4 / 2, routed scaling 2.5, layer
0 dense by ``first_k_dense_replace``): config fields, every routing branch
(ids equal, weights within 1e-6, the group limit's 0.0 rule under negative
biases), the grouped route against the dense masked one, f32 logits within
1e-4 with a correction bias drawn at std 0.5, the f32 bias leaf in a bf16
model and the artifact, the absorbed cache (prefill + decode against the
full forward, ``generate`` against JAX's ``serving.generate``, ragged too,
beams and the continuous batcher), a dwain walk whose
``decompose_config.json`` is JAX's byte for byte and whose decomposed
``kv_b_proj`` pair the cache multiplies out, the refusals of a fused or
int8 ``kv_b_proj``, ``quantize_for_serving``'s sites, and the grouped
kernels' routes at DeepSeek's shapes.  Each JAX model is built once
(``_jax``) and its programs are shared."""

import copy
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, engine as jengine, models as jmodels, nn as jnn
from ptdeco_tpu import quant as jquant
from ptdeco_tpu import serving as jserving, utils as jutils
from ptdeco_tpu.models import hf_loader as jhf, transformer as jtf
from ptdeco_tpu.serving_batcher import ContinuousBatcher as JaxBatcher
from ptdeco_tpu_torch import dwain as tdwain, engine as tengine, models as tmodels, nn as pnn
from ptdeco_tpu_torch import quant as tquant, serving as tserving, utils as tutils
from ptdeco_tpu_torch.models import hf_loader as thf, transformer as ttf
from ptdeco_tpu_torch.serving_batcher import ContinuousBatcher

from test_torch_moe import jax_logits, jax_twin, probe_ids
from test_torch_moe_families import jax_quantized, moe_weights


def ds_hf(model_type: str, **over) -> dict:
    hf = dict(model_type=model_type, vocab_size=128, hidden_size=32, intermediate_size=48,
              moe_intermediate_size=16, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, q_lora_rank=24, kv_lora_rank=16, qk_rope_head_dim=4,
              qk_nope_head_dim=8, v_head_dim=8, n_routed_experts=8, n_shared_experts=2,
              num_experts_per_tok=3, routed_scaling_factor=2.5, norm_topk_prob=True,
              first_k_dense_replace=1, max_position_embeddings=64, rms_norm_eps=1e-5,
              rope_theta=10000.0, tie_word_embeddings=False, hidden_act="silu")
    hf.update(over)
    return hf


YARN = {"type": "yarn", "factor": 40.0, "original_max_position_embeddings": 4096,
        "beta_fast": 32, "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 1.0}
CASES = {
    # sigmoid scores, the correction bias, top-2-sum groups, scaling 2.5,
    # the q bottleneck; with DeepSeek-V3's yarn (mscale^2 on the scale)
    "v3": ds_hf("deepseek_v3", n_group=4, topk_group=2),
    "v3_yarn": ds_hf("deepseek_v3", n_group=4, topk_group=2, rope_scaling=YARN),
    # V2-Lite's layout: a direct q_proj, greedy softmax top-k, no renorm,
    # its yarn (mscale 0.707)
    "v2": ds_hf("deepseek_v2", q_lora_rank=None, topk_method="greedy", norm_topk_prob=False,
                routed_scaling_factor=1.0,
                rope_scaling={**YARN, "mscale": 0.707, "mscale_all_dim": 0.707}),
    # V2's group_limited_greedy: groups scored by their max
    "v2_groups": ds_hf("deepseek_v2", topk_method="group_limited_greedy", n_group=4, topk_group=2),
}
FIELDS = ("n_experts", "n_experts_per_tok", "norm_topk_prob", "moe_hidden_dim",
          "mlp_only_layers", "shared_expert_hidden_dim", "shared_expert_gated", "q_lora_rank",
          "kv_lora_rank", "qk_rope_head_dim", "qk_nope_head_dim", "v_head_dim",
          "mla_softmax_scale", "router_score_func", "router_n_group", "router_topk_group",
          "router_group_top2_sum", "router_correction_bias", "routed_scaling_factor",
          "rope_yarn", "rope_interleaved", "rope_theta", "norm_eps", "dim", "n_heads",
          "hidden_dim", "vocab_size", "n_layers", "tie_embeddings", "head_dim")
BIAS = "model.layers.1.mlp.gate_correction_bias"


def ds_weights(model: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """``moe_weights``, the correction bias drawn at std 0.5 (large enough
    to change the selection, as JAX tests/test_hf_config_family.py draws
    it)."""
    sd = moe_weights(model, seed)
    rng = np.random.default_rng(seed + 100)
    for k in sd:
        if k.endswith("gate_correction_bias"):
            sd[k] = (0.5 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return sd


@functools.lru_cache(maxsize=None)
def _jax(case: str, seed: int = 0):
    """The JAX model of the case and the numpy weights it holds."""
    hf = CASES[case]
    tm = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32),
                          device="cpu")
    sd = ds_weights(tm, seed)
    return jax_twin(hf, sd), sd


def pair(case: str, seed: int = 0, dtype=torch.float32):
    """The JAX model and a fresh port model holding the same weights."""
    jm, sd = _jax(case, seed)
    tm = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(CASES[case], dtype=dtype),
                          device="cpu")
    return jm, tutils.load_numpy_state_dict(tm, sd)


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_fields_match_jax(case):
    hf = CASES[case]
    jcfg = jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)
    for field in FIELDS:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert [tcfg.layer_is_sparse(i) for i in range(2)] == [False, True]
    if case in ("v3_yarn", "v2"):
        m = hf["rope_scaling"]["mscale_all_dim"]
        assert tcfg.mla_softmax_scale == pytest.approx((0.1 * m * np.log(40.0) + 1.0) ** 2)
        assert len(tcfg.rope_yarn[0]) == hf["qk_rope_head_dim"] // 2
    tm = tmodels.CausalLM(tcfg, device="cpu")
    attn = tm.model.layers[0].self_attn
    assert isinstance(attn, ttf.MLAttention) and attn.kv_a_layernorm.eps == 1e-6
    assert (attn.q_proj is None) == (hf["q_lora_rank"] is not None)
    moe = tm.model.layers[1].mlp
    assert isinstance(moe, ttf.MoEMLP) and moe.shared_expert_gate is None
    assert isinstance(tm.model.layers[0].mlp, ttf.MLP)


def test_unknown_topk_method_is_refused_as_jax():
    hf = ds_hf("deepseek_v2", topk_method="noaux_tc")
    with pytest.raises(ValueError):
        jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    with pytest.raises(ValueError, match="topk_method"):
        tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)


SIGMOID = dict(router_score_func="sigmoid", router_correction_bias=True, norm_topk_prob=True,
               routed_scaling_factor=2.5)
ROUTING = {
    "softmax": (dict(norm_topk_prob=False), 0.0),
    "softmax_groups_max": (dict(norm_topk_prob=False, router_n_group=4, router_topk_group=2), 0.0),
    "sigmoid_groups_top2": (dict(SIGMOID, router_n_group=4, router_topk_group=2,
                                 router_group_top2_sum=True), 0.5),
    # every bias below -1, so each eligible choice is negative and the
    # masked experts' 0.0 outranks them
    "sigmoid_negative_bias": (dict(SIGMOID, router_n_group=4, router_topk_group=2,
                                   router_group_top2_sum=True), -1.5),
    "sigmoid_no_groups": (dict(SIGMOID, norm_topk_prob=False), 0.5),
}


@pytest.mark.parametrize("branch", sorted(ROUTING))
def test_routing_matches_jax(branch):
    kw, bias_scale = ROUTING[branch]
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((8, 16)) / 2).astype(np.float32)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    bias = None
    if bias_scale:
        bias = (bias_scale * np.abs(rng.standard_normal(8)) if bias_scale < 0
                else bias_scale * rng.standard_normal(8)).astype(np.float32)
        if bias_scale < 0:
            bias = bias - 1.0
    common = dict(dim=16, n_experts=8, n_experts_per_tok=3, moe_hidden_dim=8, **kw)
    # built abstractly: the routing reads the router and the bias only
    jmoe = jax.eval_shape(lambda: jtf.MoEMLP.create(jax.random.PRNGKey(0), jmodels.TransformerConfig(
        dtype=jnp.float32, **common)))
    jmoe = dataclasses.replace(
        jmoe, gate=dataclasses.replace(jmoe.gate, kernel=jnp.asarray(w.T)),
        gate_correction_bias=None if bias is None else jnp.asarray(bias))
    j_vals, j_idx = jtf._moe_routing(jmoe, 8, jnp.asarray(x), None)
    tmoe = ttf.MoEMLP(ttf.TransformerConfig(dtype=torch.float32, **common), "cpu")
    with torch.no_grad():
        tmoe.gate.weight.copy_(torch.from_numpy(w))
        if bias is not None:
            tmoe.gate_correction_bias.copy_(torch.from_numpy(bias))
        vals, idx = ttf._moe_routing(tmoe, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=0, atol=1e-6)
    if branch == "sigmoid_negative_bias":
        # the 0.0 rule binds: -inf masking would pick other experts
        choice = torch.sigmoid(torch.from_numpy(x @ w.T)) + torch.from_numpy(bias)
        g = choice.reshape(64, 4, 2)
        keep = torch.topk(torch.topk(g, 2, dim=-1).values.sum(-1), 2, dim=-1).indices
        mask = torch.zeros(64, 4, dtype=torch.bool).scatter_(-1, keep, True)
        fixed = torch.where(mask.repeat_interleave(2, dim=-1), choice, -torch.inf)
        assert (torch.topk(fixed, 3, dim=-1).indices.sort(-1).values
                != idx.sort(-1).values).any(-1).float().mean() > 0.5


@pytest.mark.parametrize("branch", sorted(ROUTING))
def test_grouped_route_matches_dense_masked(branch):
    """JAX tests/test_moe_family.py:288 in the port, for every routing
    branch (sigmoid scores, the bias, max or top-2-sum groups, routed
    scaling): the grouped and the dense masked route agree."""
    kw, bias_scale = ROUTING[branch]
    cfg = ttf.TransformerConfig(dim=16, n_experts=8, n_experts_per_tok=3, moe_hidden_dim=16,
                                dtype=torch.float32, **kw)
    moe = ttf.MoEMLP(cfg, "cpu")
    ttf.init_weights(moe, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        if bias_scale:
            moe.gate_correction_bias.copy_(bias_scale * torch.randn(
                8, generator=torch.Generator().manual_seed(9)) - (1.0 if bias_scale < 0 else 0.0))
        x = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(1))
        assert moe._experts_are_pristine()
        torch.testing.assert_close(moe(x), moe._dense_masked(x), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case):
    jm, tm = pair(case)
    assert set(tm.state_dict()) == set(jutils.state_dict(jm))
    if case.startswith("v3"):
        assert float(tm.state_dict()[BIAS].abs().max()) > 0.5
    ids = probe_ids(128, (2, 11), seed=4)
    with torch.no_grad():
        got = tm({"input_ids": torch.from_numpy(ids).long()}).numpy()
    np.testing.assert_allclose(got, jax_logits(jm, ids), atol=1e-4)


def test_correction_bias_stays_f32_and_round_trips(tmp_path):
    """The leaf is f32 in a bf16 model, and the artifact writes and reloads
    it in f32, byte for byte the JAX package's export."""
    jm, _ = _jax("v3")
    _, tm = pair("v3", dtype=torch.bfloat16)
    moe = tm.model.layers[1].mlp
    assert moe.gate_correction_bias.dtype == torch.float32
    assert moe.gate.weight.dtype == torch.bfloat16
    path = str(tmp_path / "decompose_state_dict.pt")
    tutils.save_state_dict_pt(tutils.state_dict(tm), path)
    back = tutils.load_state_dict_pt(path)[BIAS]
    want = np.asarray(jutils.state_dict(jm)[BIAS])
    assert back.dtype == torch.float32 and want.dtype == np.float32
    assert back.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("case", ["v2", "v3"])
def test_prefill_and_decode_match_the_full_forward(case):
    _, tm = pair(case)
    ids = torch.from_numpy(probe_ids(128, (2, 9), seed=5)).long()
    with torch.no_grad():
        full = tm({"input_ids": ids})
    caches = tserving.init_cache(tm, 2, 9)
    assert [len(e) for e in caches] == [2, 2] and caches[0][0].shape == (2, 9, 16)
    logits, caches = tserving.forward_with_cache(tm, ids[:, :6], caches, 0)
    steps = [logits]
    for t in range(6, 9):
        logits, caches = tserving.forward_with_cache(tm, ids[:, t:t + 1], caches, t)
        steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=0, atol=1e-4)


def test_cache_layouts_are_checked():
    _, tm = pair("v3")
    mla = tserving.init_cache(tm, 1, 4)[0]
    assert tserving.layer_cache_tensors(mla, 0) == mla
    with pytest.raises(ValueError, match="cache entry"):
        tserving.layer_cache_tensors((mla[0], mla[1], mla[1]), 0)
    kv = (torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tserving.forward_with_cache(tm, torch.zeros(1, 2, dtype=torch.long), (kv, kv), 0)


@pytest.mark.parametrize("case,ragged", [("v2", False), ("v3", False), ("v3", True)])
def test_cached_generate_matches_jax(case, ragged):
    jm, tm = pair(case, seed=0)
    prompt = probe_ids(128, (2, 6), seed=7)
    lens = np.asarray([3, 6], np.int32) if ragged else None
    toks = tserving.generate(tm, torch.from_numpy(prompt).long(), 5,
                             prompt_lens=None if lens is None else torch.from_numpy(lens).long())
    want = jserving.generate(jm, jnp.asarray(prompt), 5,
                             prompt_lens=None if lens is None else jnp.asarray(lens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


def test_beams_and_batcher_match_jax():
    """Beam search and the continuous batcher on the V3 model (MLA caches
    fanned out, reordered and copied into slots) give the JAX package's
    tokens."""
    jm, tm = pair("v3")
    prompt = probe_ids(128, (2, 5), seed=8)
    got = tserving.generate_beam(tm, torch.from_numpy(prompt).long(), 4, num_beams=3)
    want = jserving.generate_beam(jm, jnp.asarray(prompt), 4, num_beams=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    engines = (ContinuousBatcher(tm, n_slots=2, max_len=16, decode_chunk=3),
               JaxBatcher(jm, n_slots=2, max_len=16, decode_chunk=3))
    rng = np.random.default_rng(9)
    for plen, budget in ((3, 5), (7, 4), (5, 9)):
        p = rng.integers(0, 128, plen).astype(np.int32)
        for eng in engines:
            eng.submit(p, budget)
    ours, theirs = ({f.req_id: f for f in eng.run()} for eng in engines)
    assert ours.keys() == theirs.keys() == {0, 1, 2}
    for rid in theirs:
        np.testing.assert_array_equal(ours[rid].tokens, theirs[rid].tokens)


KEEP = {"model.layers.0.self_attn.kv_b_proj"}


@functools.lru_cache(maxsize=None)
def _walks():
    """One dwain walk of the V3 model in each package, over ``KEEP``."""
    jm, tm = pair("v3", seed=3)
    names = tengine.get_decomposeable_submodule_names(tm)
    rng = np.random.default_rng(7)
    pool = {k: [rng.integers(0, 128, (2, 12)).astype(np.int32) for _ in range(4)] for k in "dm"}

    def batches(kind, as_torch):
        i = 0
        while True:
            ids = pool[kind][i % 4]
            i += 1
            yield {"input_ids": torch.from_numpy(ids).long() if as_torch else jnp.asarray(ids)}

    args = dict(num_data_steps=2, num_metric_steps=1, nsr_final_threshold=1e9,
                blacklisted_module_names=[n for n in names if n not in KEEP], min_rank=2,
                trade_off_factor=1e9, max_accepted_ppl_diff=1e9)
    jdeco, jcfg = jdwain.decompose(module=jm, data_iterator=batches("d", False),
                                   metric_iterator=batches("m", False), loss_fn=jmodels.ce_loss,
                                   **args)
    tdeco, tcfg = tdwain.decompose(module=tm, data_iterator=batches("d", True),
                                   metric_iterator=batches("m", True), loss_fn=tmodels.ce_loss,
                                   device="cpu", **args)
    return names, jdeco, jcfg, tdeco, tcfg


def test_walk_config_is_jax_and_reloads():
    """The walk decides as the JAX walk and writes the same
    ``decompose_config.json`` (its ``__meta__`` aside, byte for byte); the
    state dict, the f32 leaf included, reloads through
    ``apply_decompose_config`` into a fresh model with the same logits."""
    names, jdeco, jcfg, tdeco, tcfg = _walks()
    assert set(names) == set(jengine.get_decomposeable_submodule_names(_jax("v3", 3)[0]))
    assert set(tcfg) == set(jcfg) == KEEP

    def structure(c):
        return {k: {kk: vv for kk, vv in v.items() if kk != "__meta__"} for k, v in c.items()}

    assert json.dumps(structure(tcfg), sort_keys=True) == json.dumps(structure(jcfg),
                                                                     sort_keys=True)
    for name in KEEP:
        assert tcfg[name]["__meta__"]["proportion"] == jcfg[name]["__meta__"]["proportion"]
    sd = tutils.state_dict(tdeco)
    assert sd[BIAS].dtype == torch.float32
    fresh = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(CASES["v3"],
                                                                      dtype=torch.float32), "cpu")
    tutils.apply_decompose_config(fresh, json.loads(json.dumps(tcfg)))
    tutils.load_state_dict(fresh, sd)
    ids = torch.from_numpy(probe_ids(128, (2, 7), seed=6)).long()
    with torch.no_grad():
        torch.testing.assert_close(fresh({"input_ids": ids}), tdeco({"input_ids": ids}),
                                   rtol=0, atol=0)


def test_decomposed_kv_b_proj_generates_and_fused_is_refused():
    """The decomposed ``kv_b_proj`` is a factor pair that the absorbed
    cache multiplies out: cached ``generate`` gives the uncached decomposed
    model's greedy tokens and logits (JAX tests/test_serving.py:391; the
    walk above is JAX's); fused into one module it cannot be absorbed, and
    the cache refuses it before any step, as JAX refuses its own."""
    tdeco = copy.deepcopy(_walks()[3])
    assert isinstance(tdeco.model.layers[0].self_attn.kv_b_proj, torch.nn.Sequential)
    ids = torch.from_numpy(probe_ids(128, (2, 5), seed=10)).long()
    got, logits = tserving.generate(tdeco, ids, 4, return_logits=True)
    with torch.no_grad():
        full = tdeco({"input_ids": torch.cat([ids, got[:, :-1]], dim=1)})[:, 4:]
    torch.testing.assert_close(logits, full, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), full.argmax(-1).numpy())
    pnn.fuse_factor_pairs(tdeco)
    assert isinstance(tdeco.model.layers[0].self_attn.kv_b_proj, pnn.FusedLowRankLinear)
    with pytest.raises(ValueError, match="kv_b_proj"):
        tserving.check_decode_supported(tdeco)


def test_decomposed_kv_b_proj_is_multiplied_once_a_step(monkeypatch):
    """The cache's refusal check multiplies nothing: a decomposed
    ``kv_b_proj``'s factor product is computed once for each cached call of
    its layer, by the absorbed attention alone."""
    tdeco = _walks()[3]
    products, steps = [], []
    dense = tserving._dense_linear_kernel
    step = tserving.CachedMLAttention.__call__

    def counted_dense(m, what):
        if isinstance(m, torch.nn.Sequential):
            products.append(what)
        return dense(m, what)

    def counted_step(self, *args):
        if isinstance(self.inner.kv_b_proj, torch.nn.Sequential):
            steps.append(1)
        return step(self, *args)

    monkeypatch.setattr(tserving, "_dense_linear_kernel", counted_dense)
    monkeypatch.setattr(tserving.CachedMLAttention, "__call__", counted_step)
    ids = torch.from_numpy(probe_ids(128, (2, 5), seed=10)).long()
    tserving.generate(tdeco, ids, 4)
    assert len(steps) >= 4 and len(products) == len(steps)


def test_quantize_sites_match_jax_and_int8_kv_b_proj_is_refused():
    """``quantize_for_serving`` quantizes the JAX package's sites (the
    routers skipped, the bias leaf untouched) to its grids; an int8
    ``kv_b_proj`` makes cached ``generate`` refuse in both packages, and
    with the ``kv_b_proj``s skipped (as the card's int8 serve skips them)
    the cache serves the int8 model, the uncached forward's tokens."""
    jm, tm = pair("v3")
    jq = jax_quantized(jm, skip_names=["lm_head"])
    tquant.quantize_for_serving(tm, skip_names=["lm_head"])
    ours = {n for n, m in tm.named_modules() if isinstance(m, tquant.QuantLinear)}
    theirs = {n for n, m in jnn.named_modules(jq) if type(m) is jquant.QuantLinear}
    assert ours == theirs and "model.layers.1.mlp.gate" not in ours
    assert "model.layers.0.self_attn.kv_b_proj" in ours
    for name in ours:
        np.testing.assert_array_equal(tm.get_submodule(name).weight_q.numpy(),
                                      np.asarray(jnn.get_submodule(jq, name).w_q).T)
    assert tm.model.layers[1].mlp.gate_correction_bias.dtype == torch.float32
    prompt = probe_ids(128, (1, 4), seed=11)
    with pytest.raises(ValueError, match="kv_b_proj"):
        tserving.generate(tm, torch.from_numpy(prompt).long(), 2)
    with pytest.raises(ValueError, match="kv_b_proj"):
        jserving.generate(jq, jnp.asarray(prompt), 2)
    skip = ["lm_head", *(f"model.layers.{i}.self_attn.kv_b_proj" for i in range(2))]
    _, tm = pair("v3")
    tquant.quantize_for_serving(tm, skip_names=skip)
    ids = torch.from_numpy(prompt).long()
    got, logits = tserving.generate(tm, ids, 3, return_logits=True)
    with torch.no_grad():
        full = tm({"input_ids": torch.cat([ids, got[:, :-1]], dim=1)})[:, 3:]
    torch.testing.assert_close(logits, full, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), full.argmax(-1).numpy())


def test_translator_renames_as_jax():
    sd = {"model.layers.1.mlp.shared_experts.up_proj.weight": np.ones((2, 2), np.float32),
          "model.layers.1.mlp.gate.e_score_correction_bias": np.zeros(8, np.float32),
          "model.layers.1.mlp.gate.weight": np.ones((8, 2), np.float32),
          "model.layers.0.self_attn.kv_a_proj_with_mqa.weight": np.ones((3, 2), np.float32)}
    for mt in ("deepseek_v2", "deepseek_v3"):
        translate = thf.translator_for({"model_type": mt})
        assert translate is thf.translate_deepseek_state_dict
        assert list(translate(sd)) == list(jhf.translate_deepseek_state_dict(sd))
    assert "model.layers.1.mlp.gate_correction_bias" in thf.translate_deepseek_state_dict(sd)


@pytest.mark.parametrize("e,k,n,top_k", [(64, 7168, 2048, 8), (64, 2048, 7168, 8),
                                         (64, 2048, 1408, 6), (64, 1408, 2048, 6),
                                         (256, 7168, 2048, 8), (256, 2048, 7168, 8)])
def test_deepseek_shapes_route_to_the_tensor_cores(e, k, n, top_k):
    """The grouped kernels' routes at DeepSeek's shapes (``chip_smoke.py``'s
    phases: V3 cut to 64 experts, V2-Lite's 64; its kernel lines: V3's 256,
    ``MAX_TMA_EXPERTS``): the 1 x 1024 walk, and at 64 experts the 4 x
    128-token prefill, take ``wgmma`` and int8 ``batch``; the 4-token
    decode step ``mma_sync`` and ``decode`` (so does a 4 x 128 prefill
    over 256 experts: 16-row mean groups)."""
    from ptdeco_tpu_torch.ops import gmm, gmm_int8

    assert e <= gmm.MAX_TMA_EXPERTS
    for m in (1024 * top_k, *((512 * top_k,) if e == 64 else ())):
        assert gmm.kernel_route(m, k, n, e) == "wgmma"
        assert gmm_int8.kernel_route(m, k, n, e) == "batch"
    for m in (4 * top_k, *((512 * top_k,) if e == 256 else ())):
        assert gmm.kernel_route(m, k, n, e) == "mma_sync"
        assert gmm_int8.kernel_route(m, k, n, e) == "decode"
