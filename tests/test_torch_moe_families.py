"""The port's MoE decoders of the llama graph beyond Mixtral against the JAX
package, on the CPU: Qwen3-MoE, OLMoE, FlexOlmo and Qwen2-MoE with its
sigmoid-gated shared expert.  Tiny HF ``config.json``s (2 layers, d 48, 4
experts) go through both ``from_hf_config``s field by field; the same numpy
weights (``moe_weights``) go into both models, and the f32 logits must
agree within 1e-4 on each dispatch route (grouped, dense masked, int8),
cached ``generate`` must give the JAX package's tokens, a dwain walk over
two routed experts and a shared expert must write the JAX package's
``decompose_config.json`` byte for byte, and ``quantize_for_serving`` must
quantize the same sites to the same grids.  Then the grouped kernels'
routes at 60-128 experts, and the int8-vs-bf16 difference of each package
layer by layer (ROADMAP.md, Queue 3 item 2).  Each JAX model is built
once (``_jax_model``); one JAX compile per model and route (a fresh
``jax.jit`` each, so no route reuses another's program)."""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, engine as jengine, models as jmodels, quant as jquant
from ptdeco_tpu import nn as jnn, serving as jserving, utils as jutils
from ptdeco_tpu.models import transformer as jtf
from ptdeco_tpu_torch import dwain as tdwain, engine as tengine, models as tmodels
from ptdeco_tpu_torch import quant as tquant, serving as tserving, utils as tutils
from ptdeco_tpu_torch.models import transformer as ttf
from ptdeco_tpu_torch.ops import gmm, gmm_int8

from test_torch_moe import MIXTRAL_HF, jax_twin, probe_ids


def moe_hf(model_type: str, **over) -> dict:
    hf = dict(model_type=model_type, vocab_size=128, hidden_size=48, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=1e6, num_experts=4,
              num_experts_per_tok=2, tie_word_embeddings=False)
    hf.update(over)
    return hf


CASES = {
    # per-head q/k norms at head_dim 16 (4 x 16 != 48), renormalized top-k
    "qwen3_moe": moe_hf("qwen3_moe", head_dim=16, moe_intermediate_size=24, norm_topk_prob=True),
    # layer 1 listed in mlp_only_layers keeps the dense MLP at intermediate_size
    "qwen3_moe_mlp_only": moe_hf("qwen3_moe", head_dim=16, moe_intermediate_size=24,
                                 mlp_only_layers=[1], norm_topk_prob=False),
    # the shared expert and its gate, q/k/v biases by qwen2_moe's own knob
    "qwen2_moe": moe_hf("qwen2_moe", moe_intermediate_size=24,
                        shared_expert_intermediate_size=40, norm_topk_prob=False),
    # decoder_sparse_step 2: layer 0 dense, layer 1 sparse
    "qwen2_moe_step2": moe_hf("qwen2_moe", moe_intermediate_size=24,
                              shared_expert_intermediate_size=40, decoder_sparse_step=2,
                              norm_topk_prob=True, qkv_bias=False),
    # flat q/k norms, a clamp, experts at intermediate_size, top-3 (three
    # rows a token to combine)
    "olmoe": moe_hf("olmoe", intermediate_size=24, clip_qkv=8.0, num_experts_per_tok=3),
    # flat q/k norms, post-norm-only blocks
    "flex_olmo": moe_hf("flex_olmo", intermediate_size=24, norm_topk_prob=True),
}
MOE_FIELDS = ("n_experts", "n_experts_per_tok", "norm_topk_prob", "moe_hidden_dim",
              "mlp_only_layers", "decoder_sparse_step", "shared_expert_hidden_dim",
              "shared_expert_gated")
GRAPH_FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
                "norm_eps", "rope_theta", "qkv_bias", "tie_embeddings", "head_dim_override",
                "head_dim", "mlp_act", "qk_norm", "qk_norm_flat", "post_norm_only", "clip_qkv")


def moe_weights(model: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Numpy weights for every parameter, torch layout and names: matrices
    U(-1/sqrt(in), 1/sqrt(in)), norm weights 1 + N(0, 0.1), embeddings
    N(0, 1), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if "norm" in name:
            sd[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif "embed" in name:
            sd[name] = rng.standard_normal(shape, np.float32)
        elif len(shape) == 1:
            sd[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            bound = 1.0 / np.sqrt(shape[1])
            sd[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return sd


@functools.lru_cache(maxsize=None)
def _jax_model(hf_json: str, seed: int, jdtype) -> tuple:
    """The JAX model of a config and its numpy weights, built once a module
    for each config, seed and dtype (the JAX models are immutable, so the
    tests share them)."""
    hf = json.loads(hf_json)
    tm = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32),
                          device="cpu")
    sd = moe_weights(tm, seed)
    return jax_twin(hf, sd, jdtype), sd


def pair(case: str, seed: int = 0, jdtype=jnp.float32, tdtype=torch.float32, hf=None):
    """The JAX model of the case and a fresh port model, with the same
    weights."""
    hf = CASES[case] if hf is None else hf
    jm, sd = _jax_model(json.dumps(hf, sort_keys=True), seed, jdtype)
    tm = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(hf, dtype=tdtype), device="cpu")
    return jm, tutils.load_numpy_state_dict(tm, sd)


def jax_quantized(jm, **kw):
    """``quantize_for_serving`` of the JAX package as one program (its
    eager ops compile one by one, seconds a model)."""
    return jax.jit(functools.partial(jquant.quantize_for_serving, **kw))(jm)


def logits(jm, ids: np.ndarray) -> np.ndarray:
    """The JAX model's f32 logits through a program of its own."""
    fwd = jax.jit(lambda m, i: m({"input_ids": i}))
    return np.asarray(fwd(jm, jnp.asarray(ids)).astype(jnp.float32))


def force_route(monkeypatch, route: str) -> dict:
    """Send every MoE layer of both packages down ``route``, keeping the
    shared expert (the JAX ``__call__`` adds it after any route); returns
    the port's count of calls on that route."""
    calls = {"n": 0}
    method = {"grouped": "_grouped", "dense_masked": "_dense_masked", "int8": "_grouped_int8"}[route]
    if route == "dense_masked":
        monkeypatch.setattr(jtf.MoEMLP, "_experts_are_pristine",
                            lambda self, allow_quant=False: False)
        monkeypatch.setattr(ttf.MoEMLP, "_experts_are_pristine", lambda self: False)
    elif route == "int8":
        monkeypatch.setattr(jtf, "_INT8_GMM_INTERPRET", True)
        monkeypatch.setattr(ttf, "_use_int8_kernel", lambda x: True)
    inner = getattr(ttf.MoEMLP, method)

    def counted(self, x):
        calls["n"] += 1
        return inner(self, x)

    monkeypatch.setattr(ttf.MoEMLP, method, counted)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_fields_match_jax(case):
    hf = CASES[case]
    jcfg = jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)
    for field in MOE_FIELDS + GRAPH_FIELDS:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    sparse = [tcfg.layer_is_sparse(i) for i in range(tcfg.n_layers)]
    assert sparse == [jtf._layer_is_sparse(jcfg, i) for i in range(jcfg.n_layers)]
    want = {"qwen3_moe_mlp_only": [True, False], "qwen2_moe_step2": [False, True]}
    assert sparse == want.get(case, [True, True])
    tm = tmodels.CausalLM(tcfg, device="cpu")
    assert [type(layer.mlp) for layer in tm.model.layers] == [
        ttf.MoEMLP if s else ttf.MLP for s in sparse]


@pytest.mark.parametrize("case", ["qwen3_moe_mlp_only", "qwen2_moe", "olmoe", "flex_olmo"])
def test_parameter_names_and_grouped_logits_match_jax(monkeypatch, case):
    jm, tm = pair(case)
    assert set(tm.state_dict()) == set(jutils.state_dict(jm))
    calls = force_route(monkeypatch, "grouped")
    ids = probe_ids(128, (2, 9), seed=4)
    want = logits(jm, ids)
    with torch.no_grad():
        got = tm({"input_ids": torch.from_numpy(ids).long()}).numpy()
    assert calls["n"] == sum(isinstance(layer.mlp, ttf.MoEMLP) for layer in tm.model.layers)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("route", ["dense_masked", "int8"])
def test_shared_expert_logits_match_jax_on_each_route(monkeypatch, route):
    """Qwen2-MoE with its gated shared expert on the dense masked and int8
    routes (the grouped route is in the test above); the int8 models hold
    the JAX package's grids, its kernel in interpret mode."""
    jm, tm = pair("qwen2_moe")
    if route == "int8":
        jm = jax_quantized(jm)
        tquant.quantize_for_serving(tm)
    calls = force_route(monkeypatch, route)
    ids = probe_ids(128, (2, 9), seed=5)
    want = logits(jm, ids)
    with torch.no_grad():
        got = tm({"input_ids": torch.from_numpy(ids).long()}).numpy()
    assert calls["n"] == 2
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_shared_expert_gate_binds():
    """The shared expert's sigmoid gate changes the output, on the grouped
    and the dense route alike; with the shared expert's down projection at
    zero the layer is its routed experts alone."""
    _, tm = pair("qwen2_moe")
    moe = tm.model.layers[0].mlp
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 5, 48), np.float32))
    with torch.no_grad():
        y = moe(x)
        torch.testing.assert_close(moe._dense_masked(x) + moe.shared_expert(x) * torch.sigmoid(
            moe.shared_expert_gate(x)), y, rtol=1e-5, atol=1e-6)
        moe.shared_expert_gate.weight.zero_()  # sigmoid 0.5: half the shared expert
        assert (moe(x) - y).abs().max() > 1e-3
        moe.shared_expert.down_proj.weight.zero_()
        torch.testing.assert_close(moe(x), moe._grouped(x), rtol=0, atol=0)


def test_hooked_shared_expert_keeps_the_grouped_route():
    """A hook on the shared expert fires and leaves the routed experts on the
    grouped route; a hook on a routed expert sends the layer dense."""
    _, tm = pair("qwen2_moe")
    moe = tm.model.layers[1].mlp
    seen = []
    h = moe.shared_expert.up_proj.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape))
    assert moe._experts_are_pristine()
    with torch.no_grad():
        moe(torch.zeros(1, 3, 48))
    h.remove()
    assert seen == [(1, 3, 48)]
    h = moe.experts[3].down_proj.register_forward_pre_hook(lambda m, a: None)
    assert not moe._experts_are_pristine()
    h.remove()


@pytest.mark.parametrize("case", ["qwen2_moe", "olmoe"])
def test_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache gives the JAX package's tokens,
    Qwen2-MoE's shared expert and OLMoE's flat q/k norms and clamp
    included."""
    jm, tm = pair(case, seed=2)
    prompt = probe_ids(128, (2, 6), seed=7)
    toks = tserving.generate(tm, torch.from_numpy(prompt).long(), 6)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(toks.numpy(), want)


def test_decompose_experts_and_shared_expert_matches_jax():
    """dwain over two routed experts of layer 0 and layer 1's shared expert:
    both packages decide alike and write the same ``decompose_config.json``
    (its ``__meta__`` aside, byte for byte); the decomposed experts send
    layer 0 to the dense route, the decomposed shared expert leaves layer 1
    on the grouped route."""
    jm, tm = pair("qwen2_moe", seed=3, hf=dict(CASES["qwen2_moe"], vocab_size=64))
    keep = {"model.layers.0.mlp.experts.1.gate_proj", "model.layers.0.mlp.experts.3.down_proj",
            "model.layers.1.mlp.shared_expert.up_proj"}
    names = tengine.get_decomposeable_submodule_names(tm)
    assert set(names) == set(jengine.get_decomposeable_submodule_names(jm))
    assert keep <= set(names) and "model.layers.0.mlp.shared_expert_gate" in names
    rng = np.random.default_rng(7)
    pool = {k: [rng.integers(0, 64, (2, 12)).astype(np.int32) for _ in range(4)] for k in "dm"}

    def batches(kind, as_torch):
        i = 0
        while True:
            ids = pool[kind][i % 4]
            i += 1
            yield {"input_ids": torch.from_numpy(ids).long() if as_torch else jnp.asarray(ids)}

    args = dict(
        num_data_steps=2, num_metric_steps=1, nsr_final_threshold=1e9,
        blacklisted_module_names=[n for n in names if n not in keep], min_rank=2,
        trade_off_factor=1e9, max_accepted_ppl_diff=1e9,
    )
    _, jcfg = jdwain.decompose(
        module=jm, data_iterator=batches("d", False), metric_iterator=batches("m", False),
        loss_fn=jmodels.ce_loss, **args,
    )
    tm2, tcfg = tdwain.decompose(
        module=tm, data_iterator=batches("d", True), metric_iterator=batches("m", True),
        loss_fn=tmodels.ce_loss, device="cpu", **args,
    )
    assert set(tcfg) == set(jcfg) == keep

    def structure(c):
        return {k: {kk: vv for kk, vv in v.items() if kk != "__meta__"} for k, v in c.items()}

    assert json.dumps(structure(tcfg), sort_keys=True) == json.dumps(structure(jcfg), sort_keys=True)
    for name in keep:
        assert tcfg[name]["__meta__"]["proportion"] == jcfg[name]["__meta__"]["proportion"]
    assert not tm2.model.layers[0].mlp._experts_are_pristine()
    assert tm2.model.layers[1].mlp._experts_are_pristine()


@pytest.mark.parametrize("min_features", [1, 40])
def test_quantize_for_serving_skips_gates_and_small_linears_as_jax(min_features):
    """Router and shared-expert gates stay full precision; with
    ``min_features`` 40 the 24-wide expert projections and the 32-wide k/v
    projections stay too.  The same sites take the same grids."""
    jm, tm = pair("qwen2_moe")
    jq = jax_quantized(jm, skip_names=["lm_head"], min_features=min_features)
    tquant.quantize_for_serving(tm, skip_names=["lm_head"], min_features=min_features)
    ours = {n for n, m in tm.named_modules() if isinstance(m, tquant.QuantLinear)}
    theirs = {n for n, m in jnn.named_modules(jq) if type(m) is jquant.QuantLinear}
    assert ours == theirs
    assert "model.layers.0.mlp.shared_expert_gate" not in ours
    assert "model.layers.0.mlp.gate" not in ours
    assert ("model.layers.1.mlp.experts.3.up_proj" in ours) == (min_features == 1)
    assert "model.layers.1.mlp.shared_expert.up_proj" in ours
    for name in ours:
        want = np.asarray(jnn.get_submodule(jq, name).w_q).T
        np.testing.assert_array_equal(tm.get_submodule(name).weight_q.numpy(), want)


@pytest.mark.parametrize("e,k,n", [(60, 2048, 1408), (64, 2048, 1024), (128, 2048, 768),
                                   (60, 1408, 2048), (64, 1024, 2048), (128, 768, 2048)])
def test_many_experts_route_to_the_tensor_cores(e, k, n):
    """The generate prefill of the three MoE phases of ``chip_smoke.py`` (4 x
    128 tokens, top-4 over 60 experts or top-8 over 64 and 128) takes the
    bf16 kernel's wgmma route and the int8 kernel's batch route; the decode
    step's 32 rows take mma_sync and decode; past MAX_TMA_EXPERTS the
    tensor-core routes refuse the count."""
    m = 512 * (4 if e == 60 else 8)
    assert gmm.block_rows(m, e) == 64 and gmm.kernel_route(m, k, n, e) == "wgmma"
    assert gmm_int8.kernel_route(m, k, n, e) == "batch" and gmm_int8.batch_rows(m, e) == 128
    assert gmm.kernel_route(32, k, n, e) == "mma_sync"
    assert gmm_int8.kernel_route(32, k, n, e) == "decode"
    big = gmm.MAX_TMA_EXPERTS + 1
    assert gmm.MAX_TMA_EXPERTS >= 128
    assert gmm.kernel_route(64 * big, k, n, big) == "mma_sync"
    assert gmm_int8.kernel_route(64 * big, k, n, big) == "decode"


# --- ROADMAP.md Queue 3 item 2: int8 against bf16, layer by layer -------


def _rms_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _jax_layer_outputs(jm, jq, ids: np.ndarray, monkeypatch) -> list[float]:
    """For each layer of the JAX bf16 model ``jm``: its input from the bf16
    run, through the bf16 layer and the int8 layer (of ``jq``), the int8
    layer routed as the bf16 one; the RMS-relative difference of the two
    outputs.  Each call is traced anew, so the bf16 layer's routing is
    recorded and the int8 layer's forced at trace time."""
    own = jtf._moe_routing
    forced = {}

    def routing(mod, n, x, ctx):
        vals, idx = own(mod, n, x, ctx)
        if "ids" in forced:
            idx = jnp.asarray(np.asarray(forced.pop("ids"))).reshape(idx.shape)
            scores = jax.nn.softmax(mod.gate(x, ctx).astype(jnp.float32), axis=-1)
            vals = jnp.take_along_axis(scores, idx, axis=-1)
            if mod.norm_topk:
                vals = vals / jnp.sum(vals, axis=-1, keepdims=True)
        forced["seen"] = idx
        return vals, idx

    def run(layer, h, positions):
        """One program a call, the layer's output and its expert ids."""
        def fn(lyr, x):
            return lyr(x, None, positions=positions), forced.pop("seen")

        return jax.jit(fn)(layer, h)

    monkeypatch.setattr(jtf, "_moe_routing", routing)
    h, positions = jm.model.embed_inputs(jnp.asarray(ids), None)
    out = []
    for lb, lq in zip(jm.model.layers, jq.model.layers):
        y, forced["ids"] = run(lb, h, positions)
        yq, _ = run(lq, h, positions)
        out.append(_rms_rel(yq.astype(jnp.float32), y.astype(jnp.float32)))
        h = y
    return out


def _torch_layer_outputs(tm, tq, ids: np.ndarray) -> list[float]:
    """The same for the port's models (routing forced as ``chip_smoke.py``'s
    ``Routing`` forces it)."""
    h = tm.model.embed_inputs(torch.from_numpy(ids).long())
    out = []
    for lb, lq in zip(tm.model.layers, tq.model.layers):
        seen = {}
        own = lb.mlp._routing

        def record(x, own=own):
            vals, idx = own(x)
            seen["ids"] = idx
            return vals, idx

        def forced(x, moe=lq.mlp):
            idx = seen["ids"].reshape(*x.shape[:-1], moe.top_k)
            return ttf.moe_combine_weights(moe, ttf.router_scores(moe, x), idx), idx

        lb.mlp._routing, lq.mlp._routing = record, forced
        y = lb(h)
        yq = lq(h)
        del lb.mlp._routing, lq.mlp._routing
        out.append(_rms_rel(yq.float().numpy(), y.float().numpy()))
        h = y
    return out


def test_int8_against_bf16_per_layer_is_the_jax_packages(monkeypatch, capsys):
    """ROADMAP.md Queue 3 item 2, on the CPU at a small Mixtral-shaped
    config (d 64, MLP 96, 4 experts, top-2): each package's weight-only int8
    layer against its own bf16 layer, on the same bf16 input, routed alike.
    Both quantize to the same grids (``tests/test_torch_quant.py``) and run
    the int8 experts through the grouped int8 product (the port's plain
    version, the JAX kernel in interpret mode), so their differences are
    the quantization error and their bf16 roundings; the port's may exceed
    the JAX package's by rounding order alone, held to 1.25x."""
    monkeypatch.setattr(jtf, "_INT8_GMM_INTERPRET", True)
    monkeypatch.setattr(ttf, "_use_int8_kernel", lambda x: True)
    jm, tm = pair("mixtral", seed=11, jdtype=jnp.bfloat16, tdtype=torch.bfloat16, hf=MIXTRAL_HF)
    jq = jax_quantized(jm)
    tq = tquant.quantize_for_serving(copy.deepcopy(tm))
    ids = probe_ids(128, (2, 16), seed=12)
    with torch.no_grad():
        ours = _torch_layer_outputs(tm, tq, ids)
    theirs = _jax_layer_outputs(jm, jq, ids, monkeypatch)
    with capsys.disabled():
        print(f"\nint8 vs bf16 per layer, RMS-relative: port {ours}, JAX package {theirs}")
    assert all(0 < t < 0.05 for t in theirs)
    assert all(o <= 1.25 * t for o, t in zip(ours, theirs)), (ours, theirs)
