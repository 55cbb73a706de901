"""The port's decoders with a mixer of their own (doge's dynamic-mask
attention and learned residual scales, diffllama's differential attention),
the mllama and moshi text paths, and block pruning, against the JAX
package's, on the CPU, at tiny widths (hidden 32, vocab 128; 4 query heads
over 2 kv heads but for diffllama's and moshi's multi-head cases; mllama at
3 layers with layer 1 a cross-attention layer, bare and wrapped; doge with a
window of 32): each config field equal to JAX's, the state-dict keys and
the dwain sites equal, f32 logits within 1e-4 and the loss within rtol
1e-5 on the JAX model's weights (norms, biases, doge's ``dyn_mask_A`` and
residual scales and diffllama's lambda vectors moved off their initial
values), and each new parameter shown to bind; doge's window refusal;
ragged KV-cached ``generate`` against JAX ``serving.generate`` (beams and
the batcher over doge's three-tensor and mllama's empty cache entries);
one doge and one diffllama ``dwain.decompose`` walk whose
``decompose_config.json`` is JAX's byte for byte; the four translators and
the snapshots through the trainer's builder; then block pruning, the mirrors
of ``tests/test_block_pruning.py`` against the port's ``prune_blocks`` and
its two bp builders, which load JAX-written directories."""

import dataclasses
import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, engine as jengine, models as jmodels
from ptdeco_tpu import serving as jserving, utils as jutils
from ptdeco_tpu.models import hf_loader as jhf_loader
from ptdeco_tpu_torch import dwain as tdwain, engine as tengine, models as tmodels, nn as pnn
from ptdeco_tpu_torch import serving as tserving, serving_batcher, utils as tutils
from ptdeco_tpu_torch.apps.trainer_llm import builder
from ptdeco_tpu_torch.models import hf_loader, transformer as ttransformer

from test_torch_families import tiny_hf
from test_torch_moe import jax_logits, probe_ids
from test_torch_position_knobs import CONFIG_FIELDS as EARLIER_FIELDS
from test_torch_rope_gemma_phi3 import _cycle

MLLAMA = tiny_hf("mllama_text_model", num_hidden_layers=3, cross_attention_layers=[1],
                 rms_norm_eps=1e-5, rope_theta=500000.0,
                 rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0, "original_max_position_embeddings": 32})
CASES = {
    "doge": tiny_hf("doge", keep_window_size=32, tie_word_embeddings=False),
    "diffllama": tiny_hf("diffllama", num_key_value_heads=4, attention_bias=True),
    "diffllama_gqa": tiny_hf("diffllama", rms_norm_eps=1e-5),
    "mllama": MLLAMA,
    "mllama_wrapped": dict(model_type="mllama", text_config=MLLAMA,
                           vision_config={"hidden_size": 16}),
    "moshi": dict(model_type="moshi", vocab_size=128, hidden_size=32, ffn_dim=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=None,
                  rms_norm_eps=1e-8, sliding_window=3000),
}
# configurations read for their fields only: doge's default window and a
# tied head, mllama without rope scaling, moshi with grouped kv heads
FIELDS_ONLY = {
    "doge_defaults": tiny_hf("doge"),
    "mllama_default_rope": tiny_hf("mllama_text_model", cross_attention_layers=[0]),
    "moshi_gqa": dict(CASES["moshi"], num_key_value_heads=2),
}
NEW_FIELDS = ("diff_attention", "dyn_mask_keep_window", "residual_scales", "layer_types",
              "embed_vocab_size", "rope_llama3_scaling")
CONFIG_FIELDS = (*EARLIER_FIELDS, *NEW_FIELDS)
# the parameters the perturbation moves off their initial values: norms,
# biases, doge's key-bias parameter and residual scales, diffllama's lambdas
PERTURBED = ("norm", "bias", "dyn_mask_A", "_residual", "lambda_")


@functools.lru_cache(maxsize=None)
def _jax_model(case: str):
    """One JAX model a case, shared by the tests (a model's first call
    compiles); each test gets a port copy.  doge's ``dyn_mask_A`` starts at
    zeros (exp(0) = 1, a constant the softmax drops) and its residual
    scales at ones, so the perturbation is what makes them bind."""
    seed = sorted(CASES).index(case)
    jm = jmodels.CausalLM.create(
        jax.random.PRNGKey(seed),
        jmodels.TransformerConfig.from_hf_config(CASES[case], dtype=jnp.float32))
    sd = jutils.state_dict(jm)
    rng = np.random.default_rng(seed)
    for k in sd:
        if any(p in k for p in PERTURBED):
            sd[k] = (sd[k] + 0.5 * rng.standard_normal(sd[k].shape)).astype(np.float32)
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
    return probe_ids(128, (2, 16), seed=4)


def _logits(model: torch.nn.Module, ids: np.ndarray) -> torch.Tensor:
    with torch.no_grad():
        return model({"input_ids": torch.from_numpy(ids).long()})


def _differs(a: torch.Tensor, b: torch.Tensor) -> bool:
    return float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("case", sorted(CASES) + sorted(FIELDS_ONLY))
def test_config_fields_match_jax(case):
    hf = {**CASES, **FIELDS_ONLY}[case]
    jcfg = jmodels.TransformerConfig.from_hf_config(hf, dtype=jnp.float32)
    tcfg = tmodels.TransformerConfig.from_hf_config(hf, dtype=torch.float32)
    for field in CONFIG_FIELDS:
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_keys_and_sites_match_jax(case):
    """The state-dict keys and the dwain site list are JAX's: doge's
    ``dt_proj`` is a site, diffllama's lambdas are not, mllama's skipped
    layer has neither."""
    jm, tm, sd = pair(case)
    assert set(tm.state_dict()) == set(sd)
    assert (tengine.get_decomposeable_submodule_names(tm)
            == jengine.get_decomposeable_submodule_names(jm))
    if case.startswith("mllama"):
        assert isinstance(tm.model.layers[1], ttransformer.SkipBlock)
        assert not any(k.startswith("model.layers.1.") for k in sd)


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


def _neutral(case: str, what: str, sd: dict) -> dict:
    """``sd`` with one new parameter of every layer at its neutral value:
    doge's A at zeros (a constant bias), a residual scale at ones,
    diffllama's second lambda pair equal to its first (lambda =
    lambda_init)."""
    sd = dict(sd)
    for k in list(sd):
        if what == "lambda" and k.endswith(("lambda_q2", "lambda_k2")):
            sd[k] = sd[k[:-1] + "1"]
        elif what != "lambda" and k.endswith(what):
            sd[k] = (np.zeros_like if what == "dyn_mask_A" else np.ones_like)(sd[k])
    return sd


@pytest.mark.parametrize("case,what", [
    ("doge", "dyn_mask_A"), ("doge", "input_residual"), ("doge", "post_attention_residual"),
    ("diffllama", "lambda"), ("diffllama_gqa", "lambda"),
])
def test_each_new_parameter_binds(case, what):
    """Each new parameter, set to its neutral value in every layer, gives
    other logits: the perturbed weights reach the output through it."""
    _, tm, sd = pair(case)
    ids = _probe()
    neutral = port_model(case, _neutral(case, what, sd))
    assert _differs(_logits(neutral, ids), _logits(tm, ids))


def test_mllama_cross_layer_binds():
    """The port with mllama's cross layer built as a self-attention layer
    (its weights drawn anew) gives other logits and other parameters."""
    _, tm, sd = pair("mllama")
    full = port_model("mllama", sd, layer_types=("full_attention",) * 3)
    assert set(full.state_dict()) != set(sd)
    assert _differs(_logits(full, _probe()), _logits(tm, _probe()))


def test_flash_gates_refuse_doge():
    """Both model-level flash gates keep a doge layer plain (its key bias
    would be dropped by the kernel), as JAX's do; the same layer without
    its bias passes the cached prefill's gate on a bf16 card tensor."""
    import types

    _, tm, _ = pair("doge")
    a = tm.model.layers[0].self_attn
    card_bf16 = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    assert a.has_key_bias
    assert not tserving._flash_prefill_ok(a, 256, 64, card_bf16, None)
    a.dt_proj = None
    assert not a.has_key_bias
    assert tserving._flash_prefill_ok(a, 256, 64, card_bf16, None)


def test_diffllama_lambda_init_is_layer_indexed():
    jm, tm, _ = pair("diffllama")
    for j_layer, t_layer in zip(jm.model.layers, tm.model.layers):
        assert t_layer.self_attn.lambda_init == j_layer.self_attn.lambda_init
    assert tm.model.layers[0].self_attn.lambda_init != tm.model.layers[1].self_attn.lambda_init


def test_doge_window_is_refused_as_in_jax():
    """A forward longer than keep_window_size and a cache longer than it are
    refused with the JAX package's messages."""
    jm, tm, _ = pair("doge")
    ids = probe_ids(128, (1, 33), seed=1)
    with pytest.raises(ValueError) as want:  # raised while tracing
        jax.eval_shape(lambda m, i: m({"input_ids": i}), jm, jnp.asarray(ids))
    with pytest.raises(ValueError) as got:
        _logits(tm, ids)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jserving.init_cache(jm, 1, 33)
    with pytest.raises(ValueError) as got:
        tserving.init_cache(tm, 1, 33)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["doge", "diffllama_gqa", "mllama", "moshi"])
def test_ragged_cached_generate_matches_jax(case):
    """Greedy ``generate`` from the KV cache on right-padded prompts of 5 and
    9 tokens gives the JAX package's ragged tokens, and the logits each row
    chose from equal the JAX forward of that row alone (f32, 1e-4): doge's
    cached key bias, diffllama's cached differential attention, mllama's
    skipped layer (no cache entry)."""
    jm, tm, _ = pair(case)
    caches = tserving.init_cache(tm, 2, 16)
    want_layout = {"doge": [3, 3], "mllama": [2, 0, 2]}.get(case, [2, 2])
    assert [len(tserving.layer_cache_tensors(c, i)) for i, c in enumerate(caches)] == want_layout
    lens = np.array([5, 9])
    prompt = probe_ids(128, (2, 9), seed=8)
    prompt[0, 5:] = 0
    toks, step_logits = tserving.generate(
        tm, torch.from_numpy(prompt).long(), 6, prompt_lens=torch.from_numpy(lens),
        return_logits=True)
    want = np.asarray(jserving.generate(jm, jnp.asarray(prompt), 6,
                                        prompt_lens=jnp.asarray(lens)))
    np.testing.assert_array_equal(toks.numpy(), want)
    full = np.zeros(_probe().shape, np.int32)
    for row, n in enumerate(lens):
        full[row, :n + 5] = np.concatenate([prompt[row, :n], want[row, :-1]])
    ref = jax_logits(jm, full)
    for row, n in enumerate(lens):
        np.testing.assert_allclose(step_logits[row].numpy(), ref[row, n - 1:n + 5], atol=1e-4)


@pytest.mark.parametrize("case", ["doge", "mllama"])
def test_beams_and_batcher_carry_the_entries(case):
    """Beam search fans out and reorders doge's three cache tensors (JAX's
    beams and scores) and steps over mllama's empty entry (its beam of one
    is greedy decoding); the batcher's slot writes give each request the
    tokens ``generate`` gives that prompt alone; an entry of another layout
    is refused naming ROADMAP.md."""
    jm, tm, _ = pair(case)
    ids = probe_ids(128, (2, 6), seed=9)
    prompt = torch.from_numpy(ids).long()
    if case == "doge":
        got, got_s = tserving.generate_beam(tm, prompt, 5, num_beams=2, return_scores=True)
        want, want_s = jserving.generate_beam(jm, jnp.asarray(ids), 5, num_beams=2,
                                              return_scores=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    else:
        assert torch.equal(tserving.generate_beam(tm, prompt, 5, num_beams=1),
                           tserving.generate(tm, prompt, 5))
    engine = serving_batcher.ContinuousBatcher(tm, n_slots=2, max_len=16, decode_chunk=2)
    for row in prompt:
        engine.submit(row.numpy(), 5)
    done = sorted(engine.run(), key=lambda r: r.req_id)
    for row, req in zip(prompt, done):
        np.testing.assert_array_equal(req.tokens, tserving.generate(tm, row[None], 5)[0].numpy())
    with pytest.raises(ValueError, match="ROADMAP"):
        tserving.layer_cache_tensors((torch.zeros(1),) * 4, 0)


def _walk_matches_jax(case: str, tmp_path):
    """One walk over layer 0's up_proj (its input the output of the layer's
    new mixer), the rest blacklisted: the JAX walk's sites, ranks and config
    (float metrics within rtol 1e-4), byte-equal once those are set equal;
    every tensor the walk did not replace equal and the pair's product
    within 1e-4; logits within 1e-4 of JAX's; the artifact reloads into a
    fresh model bit-equal; logits within 1e-4 again once fused."""
    hp = dict(num_data_steps=1, num_metric_steps=1, nsr_final_threshold=0.3, min_rank=8,
              trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
              decompose_in_float64=True)
    walked = "model.layers.0.mlp.up_proj"
    jm, tm, _ = pair(case)
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
    pair_keys = {f"{walked}.{i}.weight" for i in range(2)}
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
        CASES[case], dtype=torch.float32), device="cpu")
    tutils.apply_decompose_config(fresh, json.loads((tmp_path / "decompose_config.json").read_text()))
    tutils.load_state_dict(fresh, tutils.load_state_dict_pt(str(tmp_path / "decompose_state_dict.pt")))
    assert torch.equal(_logits(fresh, ids), y)
    with torch.no_grad():
        pnn.fuse_factor_pairs(tm)
    assert isinstance(tm.model.layers[0].mlp.up_proj, pnn.FusedLowRankLinear)
    np.testing.assert_allclose(_logits(tm, ids).numpy(), y_jax, atol=1e-4)


@pytest.mark.parametrize("case", ["doge", "diffllama_gqa"])
def test_dwain_walk_matches_jax(case, tmp_path):
    _walk_matches_jax(case, tmp_path)


def _moshi_layout(sd: dict, swap: bool = False) -> dict:
    """Moshi's: the attention projections nested in ``.linear``, the MLP's
    gate and up fused into ``fc1`` ([up | gate] with ``swap``), down as
    ``fc2``, and a depth decoder the temporal transformer never reads."""
    out = {}
    for k, v in sd.items():
        if ".mlp.up_proj." in k:
            continue
        if ".mlp.gate_proj." in k:
            halves = [v, sd[k.replace("gate_proj", "up_proj")]]
            k, v = k.replace("gate_proj", "fc1"), np.concatenate(halves[::-1] if swap else halves)
        k = k.replace(".mlp.down_proj.", ".mlp.fc2.")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            k = k.replace(f".self_attn.{proj}.", f".self_attn.{proj}.linear.")
        out[k] = v
    return {**out, "depth_decoder.layers.0.weight": np.ones((2, 2), np.float32)}


def _mllama_layout(sd: dict) -> dict:
    """A full mllama snapshot's: the text model under
    ``model.language_model.``, a vision tower and projector, and the cross
    layer's own weights, which the text path never reads."""
    out = {k.replace("model.", "model.language_model.", 1): v for k, v in sd.items()}
    return {**out, "model.language_model.layers.1.cross_attn.q_proj.weight": np.ones((32, 32)),
            "model.language_model.layers.1.cross_attn_attn_gate": np.ones(1),
            "vision_model.patch_embedding.weight": np.ones((4, 3)),
            "multi_modal_projector.weight": np.ones((32, 16))}


LAYOUTS = {
    "doge": lambda sd: {k.replace("dyn_mask_A", "A"): v for k, v in sd.items()},
    "diffllama": dict,
    "mllama_wrapped": _mllama_layout,
    "moshi": _moshi_layout,
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_translators_match_jax(case):
    """Each translator gives the JAX package's translator's arrays, name for
    name, and the weights back from the checkpoint layout."""
    _, _, sd = pair(case)
    stored = LAYOUTS[case](sd)
    want = jhf_loader.translator_for(CASES[case])
    got = hf_loader.translator_for(CASES[case])
    assert (got is None) == (want is None) == (case == "diffllama")
    if got is None:
        return
    theirs, ours = want(stored), got(stored)
    assert set(ours) == set(theirs) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(ours[k]), sd[k], err_msg=k)


def test_moshi_fc1_halves_bind():
    """fc1 read as [up | gate] gives other logits than [gate | up]."""
    _, tm, sd = pair("moshi")
    swapped = hf_loader.translator_for(CASES["moshi"])(_moshi_layout(sd, swap=True))
    wrong = tutils.load_numpy_state_dict(port_model("moshi", sd),
                                         {k: v for k, v in swapped.items() if k in sd})
    assert _differs(_logits(wrong, _probe()), _logits(tm, _probe()))


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_snapshot_loads_through_the_builder(case, tmp_path, monkeypatch):
    """Each family's weights written in its checkpoint layout build
    generically through the trainer's builder and give the source's logits
    exactly."""
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    _, tm, sd = pair(case)
    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(CASES[case]))
    torch.save({k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in LAYOUTS[case](sd).items()}, snap / "pytorch_model.bin")
    model, _ = builder.make_model_and_tokenizer(
        model_name=f"someorg/some-{case}", dtype="float32", checkpoint_path=str(snap), device="cpu")
    assert model.state_dict().keys() == tm.state_dict().keys()
    ids = probe_ids(128, (2, 7), seed=6)
    torch.testing.assert_close(_logits(model, ids), _logits(tm, ids), rtol=0, atol=0)


# --- block pruning (the mirrors of tests/test_block_pruning.py) ----------


def _tiny(seed: int = 0) -> tmodels.CausalLM:
    return tmodels.CausalLM(tmodels.TransformerConfig.tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(seed))


@functools.lru_cache(maxsize=None)
def _jax_tiny():
    return jmodels.CausalLM.create(jax.random.PRNGKey(0), jmodels.TransformerConfig.tiny())


def _jax_pruned():
    """JAX's tiny model with layer 0's attention and layer 1's MLP pruned."""
    return jmodels.prune_blocks(_jax_tiny(), attn_indices=[0], mlp_indices=[1])


def _load_builder(name: str):
    path = (pathlib.Path(__file__).parent.parent
            / f"ptdeco_tpu_torch/apps/trainer_llm/examples_builder/{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prune_blocks_params_and_forward():
    model = _tiny()
    n0 = tutils.get_num_params(model)
    pruned = tmodels.prune_blocks(model, attn_indices=[0], mlp_indices=[1])
    assert tutils.get_num_params(pruned) < n0
    assert isinstance(pruned.model.layers[0].self_attn, tmodels.PrunedSublayer)
    assert isinstance(pruned.model.layers[1].mlp, tmodels.PrunedSublayer)
    y = _logits(pruned, np.ones((2, 16), np.int32))
    assert y.shape == (2, 16, 256) and bool(torch.isfinite(y).all())


def test_pruned_sublayer_is_identity_skip():
    """Pruning a sublayer equals zeroing its contribution: the block's
    residual carries the input through unchanged."""
    pruned = tmodels.prune_blocks(_tiny(), attn_indices=[], mlp_indices=[0])
    blk = pruned.model.layers[0]
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(8).expand(2, 8)
    with torch.no_grad():
        h_attn = x + blk.self_attn(blk.input_layernorm(x), None, pos)
        torch.testing.assert_close(blk(x, positions=pos), h_attn, rtol=0, atol=1e-6)


def test_prune_blocks_index_validation():
    with pytest.raises(ValueError, match="out of range"):
        tmodels.prune_blocks(_tiny(), attn_indices=[99], mlp_indices=[])
    model = _tiny()
    with pytest.raises(ValueError, match="out of range"):
        tmodels.prune_blocks(model, attn_indices=[0], mlp_indices=[-1])
    assert isinstance(model.model.layers[0].self_attn, ttransformer.Attention)  # nothing changed


def test_pruned_sites_not_decomposeable():
    """A pruned sublayer holds no site; the sites left are the JAX pruned
    model's."""
    pruned = tmodels.prune_blocks(_tiny(), attn_indices=[0], mlp_indices=[])
    names = tengine.get_decomposeable_submodule_names(pruned)
    assert not any(n.startswith("model.layers.0.self_attn") for n in names)
    assert any(n.startswith("model.layers.0.mlp") for n in names)
    assert any(n.startswith("model.layers.1.self_attn") for n in names)
    assert names == jengine.get_decomposeable_submodule_names(
        jmodels.prune_blocks(_jax_tiny(), attn_indices=[0], mlp_indices=[]))


def test_bp_builder_example():
    mod = _load_builder("bp_indices_builder")
    model, tok = mod.make_model_and_tokenizer(
        {"bp_attn_indices": [1], "bp_mlp_indices": [0], "seed": 3})
    assert isinstance(model.model.layers[1].self_attn, tmodels.PrunedSublayer)
    y = _logits(model, np.asarray([tok("hello")["input_ids"]]))
    assert bool(torch.isfinite(y).all())


def test_pruned_model_state_dict_roundtrip(tmp_path):
    """Pruned-model state dicts exclude removed sublayers and reload into a
    freshly pruned twin, also through the bp_state_dict path of the
    indices builder."""
    pruned = tmodels.prune_blocks(_tiny(), attn_indices=[0], mlp_indices=[1])
    sd = tutils.state_dict(pruned)
    assert not any(k.startswith("model.layers.0.self_attn") for k in sd)
    twin = tmodels.prune_blocks(_tiny(seed=5), attn_indices=[0], mlp_indices=[1])
    tutils.load_state_dict(twin, sd)
    ids = np.ones((1, 8), np.int32)
    torch.testing.assert_close(_logits(twin, ids), _logits(pruned, ids), rtol=0, atol=0)
    tutils.save_state_dict_pt(sd, str(tmp_path / "pruned.pt"))
    built, _ = _load_builder("bp_indices_builder").make_model_and_tokenizer(
        {"bp_attn_indices": [0], "bp_mlp_indices": [1], "seed": 7,
         "bp_state_dict": str(tmp_path / "pruned.pt")})
    torch.testing.assert_close(_logits(built, ids), _logits(pruned, ids), rtol=0, atol=0)


def test_bp_checkpoint_builder_example(tmp_path):
    """The port's bp_checkpoint_builder recreates a pruned model from a
    pruned-checkpoint directory (bp_config.json + state_dict.safetensors)
    and loads its weights exactly; bp_load_state_dict=False keeps the fresh
    weights (other logits)."""
    pruned = tmodels.prune_blocks(_tiny(), attn_indices=[1], mlp_indices=[0])
    tutils.save_state_dict_safetensors(tutils.state_dict(pruned),
                                       str(tmp_path / "state_dict.safetensors"))
    (tmp_path / "bp_config.json").write_text(json.dumps({"attn_indices": [1], "mlp_indices": [0]}))
    mod = _load_builder("bp_checkpoint_builder")
    model2, _ = mod.make_model_and_tokenizer({"bp_model_path": str(tmp_path), "seed": 9})
    assert isinstance(model2.model.layers[1].self_attn, tmodels.PrunedSublayer)
    ids = np.ones((1, 8), np.int32)
    torch.testing.assert_close(_logits(model2, ids), _logits(pruned, ids), rtol=0, atol=0)
    model3, _ = mod.make_model_and_tokenizer(
        {"bp_model_path": str(tmp_path), "seed": 9, "bp_load_state_dict": False})
    assert _differs(_logits(model3, ids), _logits(pruned, ids))


def test_prune_blocks_on_jax_weights_gives_jax_logits():
    """The port's pruned model on the JAX pruned model's weights gives its
    logits (f32, 1e-4): the same sublayers removed, nothing else."""
    jm = _jax_pruned()
    sd = jutils.state_dict(jm)
    tm = tmodels.prune_blocks(_tiny(), attn_indices=[0], mlp_indices=[1])
    assert set(tm.state_dict()) == set(sd)
    tutils.load_numpy_state_dict(tm, sd)
    ids = probe_ids(256, (2, 16), seed=2)
    np.testing.assert_allclose(_logits(tm, ids).numpy(), jax_logits(jm, ids), atol=1e-4)


def test_jax_bp_directory_loads_through_the_port_builder(tmp_path, monkeypatch):
    """A pruned-checkpoint directory the JAX package writes (its
    ``save_state_dict_safetensors`` of a pruned model) loads through the
    port's bp_checkpoint_builder, and through the JAX builder's
    ``hf_checkpoint_path`` path a snapshot of the original model: JAX's
    logits (f32, 1e-4), and the snapshot's weights kept in the layers left
    whole when bp_load_state_dict is False."""
    monkeypatch.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
    jm = _jax_pruned()
    jutils.save_state_dict_safetensors(jutils.state_dict(jm), str(tmp_path / "state_dict.safetensors"))
    (tmp_path / "bp_config.json").write_text(json.dumps({"attn_indices": [0], "mlp_indices": [1]}))
    mod = _load_builder("bp_checkpoint_builder")
    model, _ = mod.make_model_and_tokenizer({"bp_model_path": str(tmp_path), "vocab_size": 256})
    ids = probe_ids(256, (2, 16), seed=2)
    np.testing.assert_allclose(_logits(model, ids).numpy(), jax_logits(jm, ids), atol=1e-4)
    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(tiny_hf("llama", vocab_size=256)))
    orig = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(
        tiny_hf("llama", vocab_size=256), dtype=torch.float32), device="cpu",
        generator=torch.Generator().manual_seed(4))
    tutils.save_state_dict_pt(tutils.state_dict(orig), str(snap / "pytorch_model.bin"))
    kept, _ = mod.make_model_and_tokenizer(
        {"bp_model_path": str(tmp_path), "hf_checkpoint_path": str(snap),
         "bp_load_state_dict": False})
    assert kept.lm_head.weight.dtype == torch.bfloat16
    assert isinstance(kept.model.layers[0].self_attn, tmodels.PrunedSublayer)
    assert torch.equal(kept.model.layers[1].self_attn.q_proj.weight,
                       orig.model.layers[1].self_attn.q_proj.weight.to(torch.bfloat16))


def test_cached_generate_refuses_a_pruned_attention_as_jax():
    """A pruned attention has no cache, as in the JAX package; a model with
    only an MLP pruned generates JAX's tokens."""
    jm = _jax_pruned()
    tm = tutils.load_numpy_state_dict(
        tmodels.prune_blocks(_tiny(), attn_indices=[0], mlp_indices=[1]), jutils.state_dict(jm))
    prompt = probe_ids(256, (2, 6), seed=3)
    with pytest.raises(ValueError, match="PrunedSublayer"):
        jserving.generate(jm, jnp.asarray(prompt), 3)
    with pytest.raises(ValueError, match="PrunedSublayer"):
        tserving.generate(tm, torch.from_numpy(prompt).long(), 3)
    jm_mlp = jmodels.prune_blocks(_jax_tiny(), attn_indices=[], mlp_indices=[1])
    tm_mlp = tutils.load_numpy_state_dict(
        tmodels.prune_blocks(_tiny(), attn_indices=[], mlp_indices=[1]),
        jutils.state_dict(jm_mlp))
    np.testing.assert_array_equal(
        tserving.generate(tm_mlp, torch.from_numpy(prompt).long(), 4).numpy(),
        np.asarray(jserving.generate(jm_mlp, jnp.asarray(prompt), 4)))
