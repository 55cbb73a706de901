"""The port's Mixtral MoE layer and grouped matmul against the JAX package,
on the CPU: the plain grouped product against megablox ``gmm`` in
interpret mode, a tiny Mixtral's logits on each dispatch route, the
dense route's capture of routed rows, and dwain on expert sites."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, engine as jengine, models as jmodels, quant as jquant
from ptdeco_tpu import utils as jutils
from ptdeco_tpu.models import transformer as jtf
from ptdeco_tpu_torch import dwain as tdwain, engine as tengine, models as tmodels, ops
from ptdeco_tpu_torch import quant as tquant, utils as tutils
from ptdeco_tpu_torch.models import transformer as ttf

# a Mixtral config.json at toy width (the HF keys the converters read)
MIXTRAL_HF = dict(
    model_type="mixtral", vocab_size=128, hidden_size=64, intermediate_size=96,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    num_local_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-5, rope_theta=1e6,
    sliding_window=None, tie_word_embeddings=False,
)


def numpy_weights(model: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Weights for every parameter of ``model`` from a numpy seed, in torch
    layout and names: Linear weights U(-1/sqrt(in), 1/sqrt(in)), norm
    weights 1 + N(0, 0.1), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if "norm" in name:
            sd[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif "embed" in name:
            sd[name] = rng.standard_normal(shape, np.float32)
        else:
            bound = 1.0 / np.sqrt(shape[1])
            sd[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return sd


def jax_twin(hf: dict, sd: dict[str, np.ndarray], dtype=jnp.float32):
    """The JAX package's model of ``hf`` holding ``sd`` (built abstractly,
    so no random initialisation is compiled)."""
    cfg = jmodels.TransformerConfig.from_hf_config(hf, dtype=dtype)
    shapes = jax.eval_shape(lambda: jmodels.CausalLM.create(jax.random.PRNGKey(0), cfg))
    return jutils.load_state_dict(shapes, {k: v.astype(dtype) for k, v in sd.items()})


def tiny_mixtral(hf=None, seed=0, jdtype=jnp.float32, tdtype=torch.float32):
    """The port's model and its JAX twin, with the same numpy weights."""
    hf = MIXTRAL_HF if hf is None else hf
    tm = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(hf, dtype=tdtype), device="cpu")
    sd = numpy_weights(tm, seed)
    tutils.load_numpy_state_dict(tm, sd)
    return jax_twin(hf, sd, jdtype), tm


def jax_logits(jm, ids: np.ndarray) -> np.ndarray:
    """The JAX model's logits, one compiled program (the model is an
    argument, so a twin with other weights reuses it)."""
    return np.asarray(_jax_forward(jm, jnp.asarray(ids)).astype(jnp.float32))


@jax.jit
def _jax_forward(jm, ids):
    return jm({"input_ids": ids})


def probe_ids(vocab=128, shape=(2, 9), seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_config_from_hf_mixtral():
    cfg = tmodels.TransformerConfig.from_hf_config(MIXTRAL_HF, dtype=torch.float32)
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.hidden_dim) == (4, 2, 96)
    # the port's Mixtral routing always renormalizes and builds its experts
    # at hidden_dim: the JAX package's Mixtral arm says the same
    jcfg = jmodels.TransformerConfig.from_hf_config(MIXTRAL_HF)
    assert jcfg.norm_topk_prob and (jcfg.moe_hidden_dim or jcfg.hidden_dim) == cfg.hidden_dim
    # gpt_oss waits for the grouped kernels' per-expert biases (ROADMAP.md)
    with pytest.raises(ValueError, match="ROADMAP"):
        tmodels.TransformerConfig.from_hf_config({**MIXTRAL_HF, "model_type": "gpt_oss"})


def test_parameter_names_follow_the_jax_package():
    jm, tm = tiny_mixtral()
    assert set(tm.state_dict()) == set(jutils.state_dict(jm))
    assert "model.layers.1.mlp.experts.3.down_proj.weight" in tm.state_dict()
    assert "model.layers.0.mlp.gate.weight" in tm.state_dict()


def test_grouped_matmul_plain_matches_megablox_gmm():
    from jax.experimental.pallas.ops.tpu.megablox.ops import gmm

    rng = np.random.default_rng(0)
    sizes = [37, 0, 129, 74]
    m, k, n = sum(sizes), 128, 256
    lhs = rng.standard_normal((m, k), np.float32)
    w = rng.standard_normal((len(sizes), k, n), np.float32) / np.sqrt(k)  # (E, K, N)
    want = gmm(
        jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(sizes, jnp.int32), preferred_element_type=jnp.bfloat16,
        tiling=(16, 128, 128), interpret=True,
    )
    want = np.asarray(want.astype(jnp.float32))
    got = ops.grouped_matmul_plain(
        torch.from_numpy(lhs).bfloat16(),
        [torch.from_numpy(np.ascontiguousarray(we.T)).bfloat16() for we in w],
        torch.tensor(sizes, dtype=torch.int32),
    ).float().numpy()
    # both sum exact bf16 products in f32 and round once to bf16: one bf16
    # ulp (2^-7 |x|) where the f32 sums round apart
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


def _route(monkeypatch, route):
    """Force one dispatch route in both packages; returns the port's call
    counter for that route."""
    calls = {"n": 0}
    if route == "dense_masked":
        monkeypatch.setattr(jtf.MoEMLP, "__call__", lambda self, x, ctx=None: self._dense_masked(x, ctx))
        method = "_dense_masked"
        monkeypatch.setattr(ttf.MoEMLP, "forward", lambda self, x: self._dense_masked(x))
    elif route == "int8":
        monkeypatch.setattr(jtf, "_INT8_GMM_INTERPRET", True)
        monkeypatch.setattr(ttf, "_use_int8_kernel", lambda x: True)
        method = "_grouped_int8"
    else:
        method = "_grouped"
    inner = getattr(ttf.MoEMLP, method)

    def counted(self, x):
        calls["n"] += 1
        return inner(self, x)

    monkeypatch.setattr(ttf.MoEMLP, method, counted)
    return calls


@pytest.mark.parametrize("route", ["grouped", "dense_masked", "int8"])
def test_logits_match_jax_on_each_route(monkeypatch, route):
    jm, tm = tiny_mixtral()
    if route == "int8":
        jm = jquant.quantize_for_serving(jm)
        tquant.quantize_for_serving(tm)
    calls = _route(monkeypatch, route)
    ids = probe_ids()
    y_jax = jax_logits(jm, ids)
    with torch.no_grad():
        y_torch = tm({"input_ids": torch.from_numpy(ids).long()}).numpy()
    assert calls["n"] == 2  # one call per layer, on the forced route
    np.testing.assert_allclose(y_torch, y_jax, atol=1e-4)


def test_int8_route_past_512_rows_matches_jax(monkeypatch):
    """On the card the int8 route takes every row count (measured on an
    H100), past the TPU's 512: a prefill of 4 x 80 tokens routes 640 rows
    through the port's int8 route, held against the JAX int8 kernel in
    interpret mode."""
    jm, tm = tiny_mixtral()
    jm = jquant.quantize_for_serving(jm)
    tquant.quantize_for_serving(tm)
    calls = _route(monkeypatch, "int8")
    ids = probe_ids(shape=(4, 80))
    assert ids.size * MIXTRAL_HF["num_experts_per_tok"] > 512
    y_jax = jax_logits(jm, ids)
    with torch.no_grad():
        y_torch = tm({"input_ids": torch.from_numpy(ids).long()}).numpy()
    assert calls["n"] == 2  # one call per layer, on the int8 route
    np.testing.assert_allclose(y_torch, y_jax, atol=1e-4)


def test_hooked_expert_takes_the_dense_route_and_sees_routed_rows_only():
    cfg = tmodels.TransformerConfig(
        vocab_size=64, dim=16, n_layers=1, n_heads=2, n_kv_heads=2, hidden_dim=32,
        n_experts=4, n_experts_per_tok=1, dtype=torch.float32,
    )
    moe = tmodels.CausalLM(cfg, device="cpu").model.layers[0].mlp
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 6, 16), np.float32))
    top1 = torch.argmax(x @ moe.gate.weight.t(), dim=-1).reshape(-1)
    assert moe._experts_are_pristine()
    store = {}
    handles = [
        moe.experts[e].gate_proj.register_forward_pre_hook(
            lambda mod, args, e=e: store.__setitem__(e, args[0].reshape(-1, 16).clone())
        )
        for e in range(4)
    ]
    assert not moe._experts_are_pristine()
    with torch.no_grad():
        moe(x)
    for h in handles:
        h.remove()
    assert moe._experts_are_pristine()
    xf = x.reshape(-1, 16)
    for e in range(4):
        routed = top1 == e
        torch.testing.assert_close(store[e][routed], xf[routed], rtol=0, atol=0)
        assert bool((store[e][~routed] == 0).all())
    assert len(set(top1.tolist())) > 1  # non-degenerate routing


def test_decompose_two_expert_sites_matches_jax():
    hf = {**MIXTRAL_HF, "vocab_size": 64, "num_local_experts": 2}
    jm, tm = tiny_mixtral(hf)
    keep = {"model.layers.0.mlp.experts.1.gate_proj", "model.layers.1.mlp.experts.0.down_proj"}
    names = tengine.get_decomposeable_submodule_names(tm)
    assert set(names) == set(jengine.get_decomposeable_submodule_names(jm))
    assert keep <= set(names) and "model.layers.0.mlp.gate" in names
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
    # a decomposed expert is a factor pair: the layer takes the dense route
    assert not tm2.model.layers[0].mlp._experts_are_pristine()
