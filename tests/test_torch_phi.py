"""The port's phi model against the JAX package's, on the CPU: phi-tiny's
f32 logits (with and without per-block gradient checkpointing, and the
gradients of the loss) within 1e-4 on the JAX model's weights carried over
with ``utils.state_dict`` -> ``load_numpy_state_dict``; ``dwain.decompose``
on phi-tiny's biased sites giving the JAX walk's ranks and config, and its
decomposed state dict's pair products and logits within 1e-4; the fused
pair of a biased site equal to its pair; LoRA on a biased factor; and the
trainer CLI's ``decompose_dwain`` task on phi-tiny against the JAX
trainer's, plus a ``model_type: phi`` snapshot through the generic
builder."""

import copy
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apps.trainer_llm import run_decompose_dwain as jrun_decompose
from ptdeco_tpu import dwain as jdwain, models as jmodels, utils as jutils
from ptdeco_tpu_torch import dwain as tdwain, finetune, models as tmodels, nn as tnn
from ptdeco_tpu_torch import serving as tserving, utils as tutils
from ptdeco_tpu_torch.apps.trainer_llm import builder, run_decompose_dwain

from test_torch_moe import jax_logits
from test_torch_trainer_llm import _prose, decompose_cfg, offline  # noqa: F401 (a fixture)

VOCAB = 96
HPARAMS = dict(num_data_steps=4, num_metric_steps=2, nsr_final_threshold=0.2, min_rank=4,
               trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
               decompose_in_float64=True)
# every site; the walks visit three of layer 1's (each JAX site compiles anew)
SITES = [f"model.layers.{i}.{m}" for i in (0, 1) for m in (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.dense",
    "mlp.fc1", "mlp.fc2")]
WALKED = ("model.layers.1.self_attn.dense", "model.layers.1.mlp.fc1", "model.layers.1.mlp.fc2")


def all_but(*kept: str) -> list[str]:
    return ["lm_head", *(site for site in SITES if site not in kept)]


@functools.lru_cache(maxsize=None)
def _jax_phi(seed: int, vocab: int):
    jm = jmodels.PhiCausalLM.create(jax.random.PRNGKey(seed), jmodels.PhiConfig.tiny(vocab_size=vocab))
    sd = jutils.state_dict(jm)
    rng = np.random.default_rng(seed)
    for k in sd:
        if "layernorm" in k:
            sd[k] = (sd[k] + 0.2 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return jutils.load_state_dict(jm, sd), sd


def phi_pair(seed: int = 0, vocab: int = VOCAB, remat: bool = False):
    """The JAX phi-tiny and the port's, holding the same weights (LayerNorm
    weights and biases moved off their initial values)."""
    jm, sd = _jax_phi(seed, vocab)
    sd = dict(sd)
    tcfg = dataclasses.replace(tmodels.PhiConfig.tiny(vocab_size=vocab), remat=remat)
    tm = tutils.load_numpy_state_dict(tmodels.PhiCausalLM(tcfg, device="cpu"), sd)
    return jm, tm, sd


def ids_pool(seed: int, n: int, shape=(2, 24)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, VOCAB, (n, *shape)).astype(np.int32)


def cycle(pool: np.ndarray, port: bool):
    i = 0
    while True:
        x = pool[i % len(pool)]
        i += 1
        yield {"input_ids": torch.from_numpy(x.astype(np.int64)) if port else jnp.asarray(x)}


def test_config_and_names_follow_jax():
    jcfg, tcfg = jmodels.PhiConfig.phi2(), tmodels.PhiConfig.phi2()
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "hidden_dim", "rope_theta",
                  "partial_rotary_factor", "norm_eps", "head_dim", "rotary_dim"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (tcfg.head_dim, tcfg.rotary_dim, tcfg.dtype) == (80, 32, torch.bfloat16)
    hf = dict(model_type="phi", vocab_size=128, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4, partial_rotary_factor=0.5,
              layer_norm_eps=1e-5, rope_theta=10000.0, hidden_act="gelu_new")
    assert (tmodels.PhiConfig.from_hf_config(hf, dtype=torch.float32).__dict__
            == {**jmodels.PhiConfig.from_hf_config(hf, dtype=jnp.float32).__dict__,
                "dtype": torch.float32, "remat": False})
    for bad in ({**hf, "model_type": "llama"}, {**hf, "num_key_value_heads": 2},
                {**hf, "hidden_act": "relu"}):
        with pytest.raises(ValueError):
            jmodels.PhiConfig.from_hf_config(bad)
        with pytest.raises(ValueError):
            tmodels.PhiConfig.from_hf_config(bad)
    _, tm, sd = phi_pair()
    assert set(tm.state_dict()) == set(sd)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX phi-tiny's logits, loss and gradients on one batch."""
    jm, _, _ = phi_pair()
    ids = ids_pool(3, 1, (2, 13))[0]
    batch = {"input_ids": jnp.asarray(ids)}
    loss, grads = jax.jit(jax.value_and_grad(lambda m: jmodels.ce_loss(batch, m(batch))))(jm)
    return ids, jax_logits(jm, ids), float(loss), jutils.state_dict(grads)


@pytest.mark.parametrize("remat", [False, True])
def test_logits_and_gradients_match_jax(remat, jax_reference):
    """Checkpointed blocks (remat) recompute the same forward: both runs are
    held to the JAX model's logits, loss and gradients without remat, which
    the JAX package's own tests hold equal to its remat's."""
    ids, y_jax, loss_j, want = jax_reference
    _, tm, _ = phi_pair(remat=remat)
    batch = {"input_ids": torch.from_numpy(ids.astype(np.int64))}
    y = tm(batch)  # grad on: a checkpointed forward under remat
    np.testing.assert_allclose(y.detach().numpy(), y_jax, atol=1e-4)
    loss = tmodels.ce_loss(batch, y)
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    loss.backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def walks():
    """Both packages' dwain walks over three of phi-tiny's layer-1 sites, on
    the same weights and batches."""
    jm, tm, sd = phi_pair()
    calib, metric = ids_pool(1, 4), ids_pool(2, 2)
    black = all_but(*WALKED)
    jm2, jconf = jdwain.decompose(module=jm, data_iterator=cycle(calib, False),
                                  metric_iterator=cycle(metric, False), loss_fn=jmodels.ce_loss,
                                  blacklisted_module_names=black, **HPARAMS)
    tm2, tconf = tdwain.decompose(module=tm, data_iterator=cycle(calib, True),
                                  metric_iterator=cycle(metric, True), loss_fn=tmodels.ce_loss,
                                  blacklisted_module_names=black, device="cpu", **HPARAMS)
    return jm2, jconf, tm2, tconf


def test_dwain_matches_jax(walks):
    """The same sites at the same ranks, the same config JSON but for the
    float metrics' digits (within rtol 1e-4), every biased site's bias on
    its second factor; the pair products and logits within 1e-4."""
    jm2, jconf, tm2, tconf = walks
    ranks = {k: v["modules"]["0"]["out_features"] for k, v in tconf.items()}
    assert set(ranks) == set(WALKED) and len(set(ranks.values())) > 1, ranks
    assert ranks == {k: v["modules"]["0"]["out_features"] for k, v in jconf.items()}
    for site, entry in jconf.items():
        assert tconf[site]["modules"]["1"]["bias"] is True
        for field, value in entry["__meta__"].items():
            if isinstance(value, float):
                np.testing.assert_allclose(tconf[site]["__meta__"][field], value, rtol=1e-4)
                tconf[site]["__meta__"][field] = value
    assert json.dumps(tconf) == json.dumps(jconf)
    ours, theirs = tutils.state_dict(tm2), jutils.state_dict(jm2)
    assert ours.keys() == theirs.keys()
    for site in jconf:  # an eigenvector's sign is free: compare W2 @ W1
        w = [(ours[f"{site}.{i}.weight"].numpy(), theirs[f"{site}.{i}.weight"]) for i in (0, 1)]
        np.testing.assert_allclose(w[1][0] @ w[0][0], w[1][1] @ w[0][1], atol=1e-4, err_msg=site)
        np.testing.assert_array_equal(ours[f"{site}.1.bias"].numpy(), theirs[f"{site}.1.bias"])
    ids = ids_pool(4, 1)[0]
    with torch.no_grad():
        y = tm2({"input_ids": torch.from_numpy(ids.astype(np.int64))}).numpy()
    np.testing.assert_allclose(y, jax_logits(jm2, ids), atol=1e-4)


def test_artifact_and_fused_biased_pairs(walks, tmp_path):
    """The artifact reloads into a fresh PhiCausalLM bit-equal; each biased
    pair fuses (bias on the fused module) and serves its pair's logits."""
    _, _, tm2, tconf = walks
    utils_sd = tutils.state_dict(tm2)
    tutils.save_state_dict_pt(utils_sd, str(tmp_path / "decompose_state_dict.pt"))
    fresh = tmodels.PhiCausalLM(tmodels.PhiConfig.tiny(vocab_size=VOCAB), device="cpu")
    tutils.apply_decompose_config(fresh, json.loads(json.dumps(tconf)))
    tutils.load_state_dict(fresh, tutils.load_state_dict_pt(str(tmp_path / "decompose_state_dict.pt")))
    probe = {"input_ids": torch.from_numpy(ids_pool(5, 1)[0].astype(np.int64))}
    with torch.no_grad():
        y_pairs = tm2(probe)
        assert torch.equal(fresh(probe), y_pairs)
        tnn.fuse_factor_pairs(fresh)
        fused = [m for m in fresh.modules() if isinstance(m, tnn.FusedLowRankLinear)]
        assert len(fused) == len(tconf) and all(m.bias is not None for m in fused)
        torch.testing.assert_close(fresh(probe), y_pairs, rtol=0, atol=1e-5)


def test_phi_is_not_served_from_the_cache():
    """The JAX package's serving has no phi path, so the port's refuses it."""
    _, tm, _ = phi_pair()
    with pytest.raises(ValueError, match="PhiBlock"):
        tserving.init_cache(tm, 1, 8)


def test_lora_on_a_biased_factor():
    """An adapter on a biased Linear keeps the bias; merged, it computes
    what the adapter computed."""
    base = torch.nn.Linear(8, 12)
    adapter = finetune.LoRALinear.attach(torch.Generator().manual_seed(0), base, r=4, alpha=8.0)
    with torch.no_grad():
        adapter.lora_b.normal_(generator=torch.Generator().manual_seed(1))
    adapter.eval()
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y = adapter(x)
        merged = adapter.merge()
        torch.testing.assert_close(merged(x), y, rtol=0, atol=1e-6)
    assert merged is base and merged.bias is not None


def write_phi_snapshot(root, with_config: bool):
    """A local snapshot of the JAX phi-tiny's weights (vocab 256, the byte
    tokenizer's), with or without a ``model_type: phi`` config.json."""
    jm, tm, sd = phi_pair(seed=3, vocab=256)
    root.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, root / "pytorch_model.bin")
    if with_config:
        cfg = tmodels.PhiConfig.tiny()
        (root / "config.json").write_text(json.dumps(dict(
            model_type="phi", vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
            intermediate_size=cfg.hidden_dim, num_hidden_layers=cfg.n_layers,
            num_attention_heads=cfg.n_heads, partial_rotary_factor=cfg.partial_rotary_factor,
            layer_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta, hidden_act="gelu_new")))
    return jm, tm


def test_generic_phi_snapshot_builds(tmp_path, offline):  # noqa: F811
    jm, _ = write_phi_snapshot(tmp_path / "snap", with_config=True)
    model, _ = builder.make_model_and_tokenizer(
        model_name="someorg/custom-phi", dtype="float32", checkpoint_path=str(tmp_path / "snap"),
        device="cpu")
    assert isinstance(model, tmodels.PhiCausalLM)
    ids = np.random.default_rng(6).integers(0, 256, (2, 10)).astype(np.int32)
    with torch.no_grad():
        y = model({"input_ids": torch.from_numpy(ids.astype(np.int64))}).numpy()
    np.testing.assert_allclose(y, jax_logits(jm, ids), atol=1e-4)


def test_cli_decompose_phi_tiny_matches_jax(tmp_path, offline):  # noqa: F811
    """``decompose_dwain`` on ``phi-tiny`` (a known name, weights from a
    snapshot of the JAX model's), per-block gradient checkpointing on as in
    decompose_dwain_phi2.yaml, over layer 1's two MLP sites: the config is
    the JAX trainer's but for the float metrics' digits, the summary's
    parameter counts equal, and the artifact reloads."""
    write_phi_snapshot(tmp_path / "snap", with_config=False)
    data = tmp_path / "prose.jsonl"
    data.write_text("".join(json.dumps({"text": t}) + "\n" for t in _prose()))
    keep = ("model.layers.1.mlp.fc1", "model.layers.1.mlp.fc2")
    cfg = decompose_cfg(tmp_path / "snap", data, decomposed_model_name="phi-tiny",
                        decomposed_model_enable_gradient_checkpointing=True, min_rank=4,
                        blacklisted_modules=all_but(*keep))
    jrun_decompose.main(copy.deepcopy(cfg), tmp_path / "jax")
    run_decompose_dwain.main(copy.deepcopy(cfg), tmp_path / "port", device="cpu")
    theirs_text = (tmp_path / "jax" / "decompose_config.json").read_text()
    theirs = json.loads(theirs_text)
    ours = json.loads((tmp_path / "port" / "decompose_config.json").read_text())
    assert set(theirs) == set(keep)
    for site, entry in theirs.items():
        for field, value in entry["__meta__"].items():
            if isinstance(value, float):
                np.testing.assert_allclose(ours[site]["__meta__"][field], value, rtol=1e-4)
                ours[site]["__meta__"][field] = value
    assert json.dumps(ours) == theirs_text
    s_jax = json.loads((tmp_path / "jax" / "summary.json").read_text())
    s_port = json.loads((tmp_path / "port" / "summary.json").read_text())
    for k in ("mparams_initial", "mparams_final", "mparams_frac"):
        assert s_port[k] == s_jax[k], k
    np.testing.assert_allclose(s_port["ppl_final"], s_jax["ppl_final"], rtol=1e-4)
    model, _ = builder.make_model_and_tokenizer(model_name="phi-tiny", device="cpu")
    builder.apply_decompose_config_and_state_dict(
        model, str(tmp_path / "port" / "decompose_config.json"),
        str(tmp_path / "port" / "decompose_state_dict.pt"))
    assert isinstance(model.model.layers[1].mlp.fc1, torch.nn.Sequential)
