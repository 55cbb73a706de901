"""The port's LLM trainer CLI (``ptdeco_tpu_torch/apps/trainer_llm``)
against the JAX trainer (``apps/trainer_llm``) on the CPU, in one process:
the config schema, the loaders, the ``decompose_dwain`` task with
fine-tuning off and with full fine-tuning, the ``finetune`` task step by
step, the offline harness, the FLOP count, the CLI's dispatch and
refusals, and gradient checkpointing.  Both packages read one local HF
snapshot (a small llama, d 256, written from a seeded JAX model) and one
JSONL of the repository's prose; both builders take the byte tokenizer
without asking ``transformers``, and the HF libraries are held offline."""

import copy
import dataclasses
import json
import logging
import math
import pathlib
import re
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from apps.trainer_llm import builder as jbuilder
from apps.trainer_llm import configurator as jconfigurator
from apps.trainer_llm import datasets_hf as jdatasets
from apps.trainer_llm import eval_harness as jeval
from apps.trainer_llm import run_decompose_dwain as jrun_decompose
from apps.trainer_llm import run_finetune as jrun_finetune
from apps.trainer_llm.builder import ByteTokenizer as JByteTokenizer
from ptdeco_tpu import models as jmodels, utils as jutils
from ptdeco_tpu.data import native_packer as jnative
from ptdeco_tpu_torch import finetune, models, utils
from ptdeco_tpu_torch.apps.trainer_llm import (
    builder, configurator, datasets_hf, eval_harness, lm_eval_adapter, metrics, run,
    run_decompose_dwain, run_finetune,
)
from ptdeco_tpu_torch.data import native_packer
from ptdeco_tpu_torch.models import hf_loader
from ptdeco_tpu_torch.models import transformer as ttransformer

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "apps" / "trainer_llm" / "examples_config"
SEQ = 64

TINY_HF = dict(
    model_type="llama", vocab_size=256, hidden_size=256, intermediate_size=1024,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5,
    rope_theta=10000.0, hidden_act="silu", tie_word_embeddings=False,
)


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    """No HF library may reach the network: both builders take the byte
    tokenizer without asking transformers, and datasets and the hub client
    are held offline, their cache in a temporary directory."""
    import datasets.config
    import huggingface_hub.constants

    with pytest.MonkeyPatch.context() as mp:
        for var in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE", "TRANSFORMERS_OFFLINE"):
            mp.setenv(var, "1")
        mp.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
        mp.setattr(datasets.config, "HF_HUB_OFFLINE", True)
        mp.setattr(datasets.config, "HF_DATASETS_OFFLINE", True)
        mp.setattr(datasets.config, "HF_DATASETS_CACHE", tmp_path_factory.mktemp("hf_datasets"))
        mp.setattr(jbuilder, "make_tokenizer", lambda name, vocab, **kw: JByteTokenizer(vocab))
        mp.setattr(builder, "make_tokenizer", lambda name, vocab, **kw: builder.ByteTokenizer(vocab))
        yield


def _prose() -> list[str]:
    """Paragraphs of the repository's own prose, from files that do not
    change from one version of the code to the next."""
    paths = [ROOT / "SURVEY.md", *sorted((ROOT / "docs").glob("*.md"))]
    text = "\n\n".join(p.read_text() for p in paths)
    return [p.strip() for p in text.split("\n\n") if len(p.strip()) > 40]


def write_snapshot(root: pathlib.Path, seed: int = 0) -> pathlib.Path:
    """A local HF snapshot: TINY_HF's config.json and a pytorch_model.bin of
    a JAX CausalLM built from ``seed``."""
    snap = root / "snapshot"
    snap.mkdir(parents=True, exist_ok=True)
    (snap / "config.json").write_text(json.dumps(TINY_HF))
    jcfg = jmodels.TransformerConfig.from_hf_config(TINY_HF, dtype=np.float32)
    jm = jmodels.CausalLM.create(jax.random.PRNGKey(seed), jcfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jutils.state_dict(jm).items()}
    torch.save(sd, snap / "pytorch_model.bin")
    return snap


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_llm")
    snap = write_snapshot(root)
    data = root / "prose.jsonl"
    data.write_text("".join(json.dumps({"text": t}) + "\n" for t in _prose()))
    return root, snap, data


def decompose_cfg(snap, data, **over):
    cfg = dict(
        task="decompose_dwain",
        decomposed_model_name="tiny-snapshot",
        decomposed_model_checkpoint_path=str(snap),
        decomposed_model_dtype="float32",
        decomposition_data_name=str(data),
        decomposition_data_separator="\n\n",
        decomposition_data_max_length=SEQ,
        decomposition_data_batch_size=2,
        perplexity_data_name=str(data),
        perplexity_data_separator="",
        perplexity_data_max_length=SEQ,
        perplexity_data_batch_size=4,
        num_data_steps=2,
        num_metric_steps=1,
        trade_off_factor=1000.0,
        reduction_factor=0.5,
        max_accepted_ppl_diff=1.0,
        nsr_final_threshold=0.2,
        min_rank=16,
        decompose_in_float64=True,
        eigh_method="exact",
        decomposition_checkpoint_dir=None,
        blacklisted_modules=["lm_head"],
        finetuning_run=False,
        finetuning_use_lora=False,
    )
    cfg.update(over)
    return cfg


# --- the config schema -------------------------------------------------------


@pytest.mark.parametrize("name,jax_cls,port_cls", [
    ("decompose_dwain_tinyllama.yaml", jconfigurator.DecomposeDWAINConfig,
     configurator.DecomposeDWAINConfig),
    ("finetune_tinyllama.yaml", jconfigurator.FinetuneConfig, configurator.FinetuneConfig),
])
def test_schemas_read_the_example_configs_alike(name, jax_cls, port_cls):
    raw = yaml.safe_load((EXAMPLES / name).read_text())
    ours = dataclasses.asdict(port_cls.from_dict(raw))
    assert ours.pop("device") == "cuda"
    assert ours == jax_cls(**raw).model_dump()


@pytest.mark.parametrize("change,key", [
    ({"bogus_key": 1}, "bogus_key"),
    ({"decomposed_model_dtype": "float64"}, "decomposed_model_dtype"),
    ({"min_rank": "many"}, "min_rank"),
    ({"task": "finetune"}, "task"),
])
def test_schemas_refuse_bad_keys_alike(change, key):
    raw = {**yaml.safe_load((EXAMPLES / "decompose_dwain_tinyllama.yaml").read_text()), **change}
    with pytest.raises(Exception, match=key):
        jconfigurator.DecomposeDWAINConfig(**raw)
    with pytest.raises(ValueError, match=key):
        configurator.DecomposeDWAINConfig.from_dict(raw)


def test_schema_names_a_missing_field():
    raw = yaml.safe_load((EXAMPLES / "finetune_tinyllama.yaml").read_text())
    del raw["train_data_name"]
    with pytest.raises(ValueError, match="train_data_name"):
        configurator.FinetuneConfig.from_dict(raw)


@pytest.mark.parametrize("change,match", [
    ({"mesh_tp": 2}, "Queue 1 item 7"),
    ({"mesh_dp": 4}, "Queue 1 item 7"),
    ({"mesh_sp": 2}, "Queue 1 item 7"),
    ({"use_pallas_gram": False}, "Queue 1 preamble"),
])
def test_unported_options_raise(change, match):
    raw = {**yaml.safe_load((EXAMPLES / "decompose_dwain_tinyllama.yaml").read_text()), **change}
    jconfigurator.DecomposeDWAINConfig(**raw)  # the JAX schema takes them
    with pytest.raises(NotImplementedError, match=match):
        configurator.DecomposeDWAINConfig.from_dict(raw)
    ft_raw = {**yaml.safe_load((EXAMPLES / "finetune_tinyllama.yaml").read_text()), "mesh_pp": 2}
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        configurator.FinetuneConfig.from_dict(ft_raw)


# --- the loaders -------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["jsonl", "json", "jsonl.gz"])
def test_get_dataset_reads_json_as_datasets_does(fmt, tmp_path, offline):
    import gzip

    records = [{"text": t} for t in _prose()[:40]]
    records[3] = {"text": ""}
    records[7] = {"title": "no text"}
    path = tmp_path / f"data.{fmt}"
    if fmt == "json":
        path.write_text(json.dumps(records))
    else:
        body = "".join(json.dumps(r) + "\n" for r in records)
        path.write_bytes(gzip.compress(body.encode()) if fmt.endswith(".gz") else body.encode())
    theirs = jdatasets.get_dataset(str(path))
    assert len(theirs) == 38
    assert datasets_hf.get_dataset(str(path)) == theirs


def test_named_dataset_without_datasets_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        datasets_hf.get_dataset("wikitext2.test")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_loader_rows_equal_jax(version, native, monkeypatch):
    texts = _prose()
    if not native:
        def refuse(*args):
            raise RuntimeError("native packer off")

        monkeypatch.setattr(jnative, "pack_greedy", refuse)
        monkeypatch.setattr(native_packer, "pack_greedy", refuse)
    kw = dict(dataset=texts, max_seqlen=SEQ, batch_size=3, separator="\n\n")
    if version == "v1":
        kw.update(nsamples=20, seed=7)
        theirs = jdatasets.prepare_dataloader_v1(tokenizer=JByteTokenizer(256), **kw)
        ours = datasets_hf.prepare_dataloader_v1(tokenizer=builder.ByteTokenizer(256), **kw)
    else:
        theirs = jdatasets.prepare_dataloader_v2(tokenizer=JByteTokenizer(256), **kw)
        ours = datasets_hf.prepare_dataloader_v2(tokenizer=builder.ByteTokenizer(256), **kw)
    assert len(ours.sequences) > 10
    np.testing.assert_array_equal(ours.sequences, theirs.sequences)
    for _ in range(len(ours) + 2):  # through an epoch boundary
        a, b = next(ours), next(theirs)
        assert a["input_ids"].dtype == torch.int64
        for k in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    for a, b in zip(ours.one_epoch(shuffle=True), theirs.one_epoch(shuffle=True)):
        np.testing.assert_array_equal(a["input_ids"].numpy(), b["input_ids"])


def test_native_packer_builds_outside_the_source_tree():
    tok = builder.ByteTokenizer(256)
    lists = [tok(t)["input_ids"] for t in _prose()[:30]]
    rows = native_packer.pack_greedy(lists, tok("\n\n")["input_ids"], SEQ)
    assert rows.shape[1] == SEQ and len(rows) > 5
    assert native_packer._library_path().parent == ROOT / "build" / "ptdeco_tpu_torch_native"
    assert not list((ROOT / "ptdeco_tpu_torch" / "data").glob("*.so"))


# --- the decompose_dwain task ------------------------------------------------


def _run_both(root, cfg, name):
    jax_out, port_out = root / f"{name}_jax", root / f"{name}_port"
    jrun_decompose.main(copy.deepcopy(cfg), jax_out)
    run_decompose_dwain.main(copy.deepcopy(cfg), port_out, device="cpu")
    return jax_out, port_out


SITES = [f"model.layers.{i}.{m}" for i in (0, 1) for m in (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
    "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")]


def _all_but(*kept):
    return ["lm_head", *(site for site in SITES if site not in kept)]


@pytest.fixture(scope="module")
def decomposed(workdir, offline):
    """Both trainers' decompose_dwain on one snapshot, fine-tuning off, over
    four sites of layer 1, one of each shape (the JAX walk compiles per
    site)."""
    root, snap, data = workdir
    cfg = decompose_cfg(snap, data, blacklisted_modules=_all_but(
        "model.layers.1.self_attn.k_proj", "model.layers.1.self_attn.o_proj",
        "model.layers.1.mlp.up_proj", "model.layers.1.mlp.down_proj"))
    return _run_both(root, cfg, "plain")


@pytest.fixture(scope="module")
def decomposed_full_ft(workdir, offline):
    """Two MLP sites of layer 1, the last two fine-tuned after each (so the
    second fine-tune retrains the first pair)."""
    root, snap, data = workdir
    cfg = decompose_cfg(snap, data, finetuning_run=True, finetuning_num_steps=4,
                        finetuning_num_last_finetuned_modules=2, finetuning_lr=1e-3,
                        blacklisted_modules=_all_but(*SITES[12:]))
    return _run_both(root, cfg, "full_ft")


def _meta_floats(config):
    return {(site, k): v for site, entry in config.items()
            for k, v in entry["__meta__"].items() if isinstance(v, float)}


def test_decompose_matches_jax(decomposed):
    """decompose_config.json is the JAX trainer's byte for byte, apart from
    the digits of the two float metrics of each site's __meta__ (NSR and
    perplexity of the accepted candidate, within rtol 1e-4); the summary's
    parameter counts are equal, its perplexities within rtol 1e-4 and its
    FLOP fraction within 2%."""
    jax_out, port_out = decomposed
    theirs_text = (jax_out / "decompose_config.json").read_text()
    theirs, ours = json.loads(theirs_text), json.loads((port_out / "decompose_config.json").read_text())
    assert len(theirs) >= 3
    for key, value in _meta_floats(theirs).items():
        site, field = key
        np.testing.assert_allclose(ours[site]["__meta__"][field], value, rtol=1e-4, err_msg=str(key))
        ours[site]["__meta__"][field] = value
    assert json.dumps(ours) == theirs_text
    s_jax = json.loads((jax_out / "summary.json").read_text())
    s_port = json.loads((port_out / "summary.json").read_text())
    assert s_port.keys() == s_jax.keys()
    assert s_port["device"] == "cpu:cpu" and s_port["n_devices"] == 1
    for k in ("mparams_initial", "mparams_final", "mparams_frac"):
        assert s_port[k] == s_jax[k], k
    for k in ("ppl_initial", "ppl_final"):
        np.testing.assert_allclose(s_port[k], s_jax[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(s_port["gflops_frac"], s_jax["gflops_frac"], rtol=0.02)
    assert s_port["mparams_frac"] < 100.0
    # the artifact reloads onto a fresh model; .pt and .safetensors agree
    sd_pt = utils.load_state_dict_pt(str(port_out / "decompose_state_dict.pt"))
    sd_st = utils.load_state_dict_safetensors(str(port_out / "decompose_state_dict.safetensors"))
    assert sd_pt.keys() == sd_st.keys() and all(torch.equal(sd_pt[k], sd_st[k]) for k in sd_pt)
    jax_sd = utils.load_state_dict_pt(str(jax_out / "decompose_state_dict.pt"))
    assert {k: v.shape for k, v in sd_pt.items()} == {k: v.shape for k, v in jax_sd.items()}


def test_decompose_with_full_finetuning_matches_jax(decomposed_full_ft):
    """Interleaved full fine-tuning: the same decisions, and the trained
    weights within tests/test_torch_dwain_modes.py's limit for fine-tuned
    walks (atol 2e-2): every weight outside the factor pairs, and each
    pair's product W2 @ W1 (an eigenvector's sign is free, so each package
    may store a factor's row and column negated; the product, and AdamW's
    elementwise steps, do not see it)."""
    jax_out, port_out = decomposed_full_ft
    theirs = json.loads((jax_out / "decompose_config.json").read_text())
    ours = json.loads((port_out / "decompose_config.json").read_text())
    assert {k: v["modules"] for k, v in ours.items()} == {k: v["modules"] for k, v in theirs.items()}
    assert [v["__meta__"]["proportion"] for v in ours.values()] == [
        v["__meta__"]["proportion"] for v in theirs.values()]
    sd_jax = utils.load_state_dict_pt(str(jax_out / "decompose_state_dict.pt"))
    sd_port = utils.load_state_dict_pt(str(port_out / "decompose_state_dict.pt"))
    assert sd_port.keys() == sd_jax.keys() and len(ours) >= 2
    for site in ours:
        for sd in (sd_port, sd_jax):
            sd[site] = sd.pop(f"{site}.1.weight") @ sd.pop(f"{site}.0.weight")
    for k in sd_jax:
        np.testing.assert_allclose(sd_port[k].numpy(), sd_jax[k].numpy(), atol=2e-2, rtol=0, err_msg=k)



# --- the finetune task -------------------------------------------------------


def finetune_cfg(snap, data, artifact, schedule):
    return dict(
        task="finetune",
        decomposed_model_name="tiny-snapshot",
        decomposed_model_checkpoint_path=str(snap),
        decomposed_model_dtype="float32",
        decompose_config=str(artifact / "decompose_config.json"),
        decompose_state_dict=str(artifact / "decompose_state_dict.pt"),
        perplexity_data_name=str(data),
        perplexity_data_separator="",
        perplexity_data_max_length=SEQ,
        perplexity_data_batch_size=8,
        train_data_name=str(data),
        train_data_separator="\n\n",
        train_data_max_length=SEQ,
        train_data_batch_size=2,
        train_data_n_samples=16,
        test_data_name=str(data),
        test_data_separator=" ",
        test_data_max_length=SEQ,
        test_data_batch_size=4,
        test_data_n_samples=8,
        num_train_epochs=1,
        eval_steps=3,
        logging_steps=1,
        early_stopping_patience=2,
        learning_rate=1e-3,
        weight_decay=0.01,
        lr_scheduler_type=schedule,
        num_warmup_steps=2,
        lora_dropout=0.0,
    )


def _optax_schedule(cfg, num_steps):
    """The JAX trainer's schedule (apps/trainer_llm/run_finetune.py:58-70)."""
    lr, warmup = cfg["learning_rate"], cfg["num_warmup_steps"]
    if cfg["lr_scheduler_type"] == "cosine_with_warmup":
        return optax.warmup_cosine_decay_schedule(0.0, lr, warmup, num_steps)
    return optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warmup),
         optax.linear_schedule(lr, 0.0, max(num_steps - warmup, 1))], [warmup])


@pytest.mark.parametrize("schedule", ["linear_with_warmup", "cosine_with_warmup"])
def test_schedules_equal_optax(schedule):
    cfg = {"learning_rate": 3e-4, "num_warmup_steps": 5, "lr_scheduler_type": schedule}
    config = configurator.FinetuneConfig.from_dict({
        **yaml.safe_load((EXAMPLES / "finetune_tinyllama.yaml").read_text()), **cfg})
    for num_steps in (6, 40):
        ours, theirs = run_finetune.make_schedule(config, num_steps), _optax_schedule(cfg, num_steps)
        for count in range(num_steps + 3):
            np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6,
                                       atol=3e-4 * 2.0 ** -22, err_msg=f"{num_steps} {count}")


class _LogFields(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.mark.parametrize("schedule", ["linear_with_warmup", "cosine_with_warmup"])
def test_finetune_task_matches_jax(schedule, workdir, decomposed, monkeypatch, tmp_path):
    """LoRA on every factor pair of the JAX trainer's artifact, dropout 0,
    the JAX run's initial adapters carried across: the loss of each of the
    8 steps within rtol 1e-4 (the JAX trainer logs it to 4 decimals), every
    step's learning rate optax's, the step count, and the perplexities
    before and after within rtol 1e-4."""
    root, snap, data = workdir
    cfg = finetune_cfg(snap, data, decomposed[0], schedule)

    attach, seen = finetune.LoRALinear.attach, []

    def attach_jax_a(generator, base, r, alpha, dropout=0.05):
        # the JAX trainer's adapter i draws A from fold_in(PRNGKey(0), i)
        bound = 1 / math.sqrt(base.in_features)
        a = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), len(seen)),
                               (base.in_features, r), np.float32, -bound, bound)
        seen.append(base)
        adapter = attach(generator, base, r, alpha, dropout)
        with torch.no_grad():
            adapter.lora_a.copy_(torch.from_numpy(np.array(a).T))
        return adapter

    monkeypatch.setattr(finetune.LoRALinear, "attach", staticmethod(attach_jax_a))
    jax_log, port_log = _LogFields(), _LogFields()
    for name, handler in ((jrun_finetune.__name__, jax_log), (run_finetune.__name__, port_log)):
        monkeypatch.setattr(logging.getLogger(name), "level", logging.INFO)
        logging.getLogger(name).addHandler(handler)
    try:
        jrun_finetune.main(copy.deepcopy(cfg), tmp_path / "jax")
        run_finetune.main(copy.deepcopy(cfg), tmp_path / "port", device="cpu")
    finally:
        logging.getLogger(jrun_finetune.__name__).removeHandler(jax_log)
        logging.getLogger(run_finetune.__name__).removeHandler(port_log)
    assert len(seen) == 2 * len(json.loads((decomposed[0] / "decompose_config.json").read_text()))

    jax_losses = [float(m.group(1)) for r in jax_log.records
                  if (m := re.match(r"step \d+/\d+ loss=([-\d.]+)", r.getMessage()))]
    steps = [r for r in port_log.records if hasattr(r, "train_loss")]
    assert [r.train_step for r in steps] == list(range(len(jax_losses))) == list(range(8))
    np.testing.assert_allclose([r.train_loss for r in steps], jax_losses, rtol=1e-4)
    sched = _optax_schedule(cfg, 8)
    np.testing.assert_allclose([r.train_lr for r in steps], [float(sched(r.train_step)) for r in steps],
                               rtol=1e-6, atol=1e-3 * 2.0 ** -22)
    s_jax = json.loads((tmp_path / "jax" / "summary.json").read_text())
    s_port = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert s_port.keys() == s_jax.keys() and s_port["steps"] == s_jax["steps"] == 8
    for k in ("ppl_before", "ppl_after"):
        np.testing.assert_allclose(s_port[k], s_jax[k], rtol=1e-4, err_msg=k)
    assert s_port["ppl_after"] < s_port["ppl_before"]
    sd = utils.load_state_dict_pt(str(tmp_path / "port" / "finetuned_state_dict.pt"))
    assert not any("lora" in k for k in sd)


def test_finetune_task_stops_early_and_keeps_the_best(workdir, decomposed, tmp_path, monkeypatch):
    """An eval loss that stops improving ends training once patience runs
    out, at the step of that eval (the JAX trainer's count), and the
    adapters of the best eval are the ones merged.  With a learning rate
    of 1e-20 every update is far below f32 resolution in the forward, so
    the eval loss cannot improve after the first eval: with evals every 2
    steps and patience 1, training stops at step 3."""
    root, snap, data = workdir
    cfg = {**finetune_cfg(snap, data, decomposed[0], "cosine_with_warmup"),
           "learning_rate": 1e-20, "eval_steps": 2, "early_stopping_patience": 1}
    def adapters(model):
        return {n: m.lora_b.detach().clone() for n, m in model.named_modules()
                if isinstance(m, finetune.LoRALinear)}

    at_eval, merged = [], []
    eval_loss, merge = run_finetune._eval_loss, finetune.merge_lora
    monkeypatch.setattr(run_finetune, "_eval_loss",
                        lambda model, *a: at_eval.append(adapters(model)) or eval_loss(model, *a))
    monkeypatch.setattr(finetune, "merge_lora", lambda model: merged.append(adapters(model))
                        or merge(model))
    log = _LogFields()
    monkeypatch.setattr(logging.getLogger(run_finetune.__name__), "level", logging.INFO)
    logging.getLogger(run_finetune.__name__).addHandler(log)
    try:
        run_finetune.main(cfg, tmp_path, device="cpu")
    finally:
        logging.getLogger(run_finetune.__name__).removeHandler(log)
    evals = [r.eval_loss for r in log.records if hasattr(r, "eval_loss")]
    assert len(evals) == 2 and evals[1] == evals[0]
    assert json.loads((tmp_path / "summary.json").read_text())["steps"] == 3
    # merged: the adapters of the first eval (after step 1, B no longer
    # zero), not those of the second (two more updates)
    (best,), (first, second) = merged, at_eval
    assert all(torch.equal(best[n], first[n]) and torch.count_nonzero(first[n]) for n in first)
    assert any(not torch.equal(first[n], second[n]) for n in first)


# --- the offline harness -----------------------------------------------------


def _tiny_twins(seed=3):
    jm = jmodels.CausalLM.create(jax.random.PRNGKey(seed), jmodels.TransformerConfig.tiny())
    tm = models.CausalLM(models.TransformerConfig.tiny(), device="cpu")
    return jm, utils.load_numpy_state_dict(tm, jutils.state_dict(jm))


def test_offline_harness_matches_jax():
    """doc_lambada, resolved from the repository's task snapshots by path:
    equal accuracies, and each choice's log-likelihood within rtol 1e-5."""
    path = lm_eval_adapter.resolve_offline_task("doc_lambada")
    assert path == ROOT / "apps" / "trainer_llm" / "tasks" / "doc_lambada.jsonl"
    rows = eval_harness.load_task(str(path))
    assert rows == jeval.load_task(str(path)) and len(rows) > 50
    jm, tm = _tiny_twins()
    theirs = jeval.evaluate_loglikelihood_task(jm, JByteTokenizer(256), rows, max_len=128)
    ours = eval_harness.evaluate_loglikelihood_task(tm, builder.ByteTokenizer(256), rows, max_len=128)
    assert ours == theirs
    from apps.trainer_llm import lm_eval_adapter as jadapter

    tok = builder.ByteTokenizer(256)
    pairs = [(tok(r["query"])["input_ids"], tok(c)["input_ids"]) for r in rows[:6] for c in r["choices"]]
    theirs = jadapter.score_pairs(jm, pairs, max_len=128)
    got = lm_eval_adapter.score_pairs(tm, pairs, max_len=128)
    np.testing.assert_allclose([ll for ll, _ in got], [ll for ll, _ in theirs], rtol=1e-5)
    assert [g for _, g in got] == [g for _, g in theirs]


def test_offline_tasks_dir_from_the_environment(tmp_path, monkeypatch):
    (tmp_path / "mine.jsonl").write_text('{"query": "a b", "choices": [" c", " d"], "gold": 0}\n')
    monkeypatch.setenv(lm_eval_adapter.TASKS_DIR_ENV, str(tmp_path))
    assert lm_eval_adapter.resolve_offline_task("mine") == tmp_path / "mine.jsonl"
    assert lm_eval_adapter.resolve_offline_task("doc_lambada") is None
    _, tm = _tiny_twins()
    res = metrics.calc_lm_eval_metrics(tm, builder.ByteTokenizer(256), ["mine", "absent_task"])
    assert list(res) == ["mine"] and res["mine"]["n"] == 1.0


# --- FLOPs -------------------------------------------------------------------


def test_flop_count_is_the_same_where_kernels_hide_from_the_counter(monkeypatch):
    """On the card an unmasked bf16 forward sends attention to the flash
    kernel, launched through ctypes, where FlopCounterMode cannot see it.
    Emulated here (the gate opened for CPU tensors, the kernel replaced by
    a numpy computation the counter does not see): a count taken around
    that forward drops attention's products, while get_giga_flops, which
    counts on the meta device, gives the CPU count, which is the products'
    count by hand."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = models.TransformerConfig.tiny()
    model = models.CausalLM(cfg, device="cpu")
    s = 48
    batch = {"input_ids": torch.zeros((1, s), dtype=torch.int64)}
    hd, kv = cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * s * (cfg.dim * (cfg.dim + 2 * kv) + cfg.dim * cfg.dim + 3 * cfg.dim * cfg.hidden_dim)
    attention = 2 * 2 * s * s * hd * cfg.n_heads
    by_hand = cfg.n_layers * (per_layer + attention) + 2 * s * cfg.dim * cfg.vocab_size
    cpu_count = metrics.get_giga_flops(model, batch)
    assert cpu_count * 1e9 == by_hand

    def opaque_flash(q, k, v, scale):
        qn, kn, vn = (t.detach().numpy() for t in (q, k, v))
        rep = qn.shape[1] // kn.shape[1]
        kn, vn = np.repeat(kn, rep, axis=1), np.repeat(vn, rep, axis=1)
        logits = np.where(np.tril(np.ones((s, s), bool)), qn @ kn.swapaxes(-1, -2) * scale, -np.inf)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        return torch.from_numpy((p / p.sum(-1, keepdims=True)) @ vn)

    monkeypatch.setattr(ttransformer, "_use_flash_kernel",
                        lambda q, mask: mask is None and q.device.type == "cpu")
    monkeypatch.setattr(ttransformer, "flash_attention", opaque_flash)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(batch)
    assert counter.get_total_flops() == by_hand - cfg.n_layers * attention
    assert metrics.get_giga_flops(model, batch) == cpu_count


# --- the CLI -----------------------------------------------------------------

CUSTOM_BUILDER = """
import torch
from ptdeco_tpu_torch import models
from ptdeco_tpu_torch.apps.trainer_llm.builder import ByteTokenizer


def make_model_and_tokenizer(config):
    gen = torch.Generator().manual_seed(int(config.get("seed", 0)))
    return models.CausalLM(models.TransformerConfig.tiny(), device="cpu", generator=gen), ByteTokenizer(256)
"""


def _cli_config(tmp_path, data, **over):
    builder_file = tmp_path / "tiny_builder.py"
    builder_file.write_text(CUSTOM_BUILDER)
    cfg = decompose_cfg(None, data, **{
        "decomposed_model_name": "tiny-custom",
        "decomposed_model_checkpoint_path": None,
        "decomposed_model_custom_builder_path": str(builder_file),
        "decomposed_model_custom_builder_config": {"seed": 1},
        "blacklisted_modules": ["lm_head", "model.layers.0.mlp.up_proj"],
        "min_rank": 4,
        "device": "cpu",
        **over,
    })
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path, cfg


def test_cli_runs_both_tasks(workdir, tmp_path):
    """run.main reads a JSON config (PyYAML reads it alike), writes the repro
    bundle (version stamps, pip freeze, the custom builder file) and the
    task's outputs; the config's device "cpu" keeps it off the card; then
    the finetune task runs on the artifact."""
    import ptdeco_tpu_torch

    _, _, data = workdir
    path, cfg = _cli_config(tmp_path, data)
    out = tmp_path / "out"
    assert run.main(["--config", str(path), "--output-path", str(out)]) == 0
    for name in ("decompose_config.json", "decompose_state_dict.pt",
                 "decompose_state_dict.safetensors", "summary.json", "config_original.yaml",
                 "repro/requirements_freeze.txt", "repro/tiny_builder.py"):
        assert (out / name).exists(), name
    repro = yaml.safe_load((out / "repro" / "config.yaml").read_text())
    assert repro == {**cfg, "ptdeco_tpu_version": ptdeco_tpu_torch.__version__,
                     "ptdeco_trainer_llm_version": run.TRAINER_LLM_VERSION}
    summary = json.loads((out / "summary.json").read_text())
    assert summary["device"] == "cpu:cpu" and summary["mparams_frac"] < 100.0

    ft = {**finetune_cfg(None, data, out, "cosine_with_warmup"), "train_data_n_samples": 8,
          "decomposed_model_name": "tiny-custom", "decomposed_model_checkpoint_path": None,
          "decomposed_model_custom_builder_path": cfg["decomposed_model_custom_builder_path"],
          "decomposed_model_custom_builder_config": {"seed": 1}}
    (tmp_path / "ft.json").write_text(json.dumps(ft))
    assert run.main(["--config", str(tmp_path / "ft.json"), "--output-path", str(tmp_path / "ft"),
                     "--device", "cpu"]) == 0
    assert json.loads((tmp_path / "ft" / "summary.json").read_text())["steps"] == 4
    fresh = models.CausalLM(models.TransformerConfig.tiny(), device="cpu")
    builder.apply_decompose_config_and_state_dict(
        fresh, str(out / "decompose_config.json"), str(tmp_path / "ft" / "finetuned_state_dict.pt"))


def test_config_reads_without_pyyaml(workdir, tmp_path, monkeypatch):
    _, _, data = workdir
    path, cfg = _cli_config(tmp_path, data)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert run.load_config(path) == cfg
    run.copy_config(path, tmp_path / "out")
    monkeypatch.delitem(sys.modules, "yaml")
    assert yaml.safe_load((tmp_path / "out" / "repro" / "config.yaml").read_text())["min_rank"] == 4


@pytest.mark.parametrize("over,argv,error,match", [
    # a decompose_dwain config relabelled: the generate schema refuses its keys
    ({"task": "generate"}, [], ValueError, "extra fields not permitted"),
    ({"mesh_tp": 2}, [], NotImplementedError, "Queue 1 item 7"),
    ({}, ["--distributed"], NotImplementedError, "Queue 1 item 7"),
    ({}, ["--num-processes", "2"], NotImplementedError, "Queue 1 item 7"),
    ({"task": "nonsense"}, [], ValueError, "Unknown task"),
    ({"blacklisted_modules": ["model.no_such_layer"]}, [], ValueError, "Unknown module names"),
])
def test_cli_refuses(over, argv, error, match, workdir, tmp_path):
    _, _, data = workdir
    path, _ = _cli_config(tmp_path, data, **over)
    with pytest.raises(error, match=match):
        run.main(["--config", str(path), "--output-path", str(tmp_path / "out"), *argv])


# --- builder, loader, checkpointing ------------------------------------------


def test_builder_paths(tmp_path, monkeypatch):
    # without transformers the tokenizer is the byte one, and no lookup of
    # the name can leave the machine
    monkeypatch.setitem(sys.modules, "transformers", None)
    model, tok = builder.make_model_and_tokenizer(
        model_name="tiny", enable_gradient_checkpointing=True, device="cpu")
    assert model.model.remat and isinstance(tok, builder.ByteTokenizer)
    (tmp_path / "config.json").write_text(
        json.dumps({**TINY_HF, "model_type": "modernbert-decoder"}))
    with pytest.raises(ValueError,
                       match=r"model_type='modernbert-decoder': the port builds \['llama', "):
        builder.make_model_and_tokenizer(model_name="x", checkpoint_path=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        builder.make_model_and_tokenizer(model_name="qwen2-7b", device="cpu")
    for mt in ("llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2", "gemma3_text", "phi"):
        assert hf_loader.translator_for({"model_type": mt}) is None
    assert hf_loader.translator_for({"model_type": "mixtral"}) is hf_loader.translate_mixtral_state_dict
    # phi3's fused projections split at the config's head counts; the gemma3
    # wrapper's text path is unwrapped
    split = hf_loader.translator_for({"model_type": "phi3", "num_attention_heads": 2,
                                      "num_key_value_heads": 1, "hidden_size": 8})
    got = split({"m.self_attn.qkv_proj.weight": torch.arange(16.0)[:, None]})
    assert [int(got[f"m.self_attn.{p}_proj.weight"][0]) for p in "qkv"] == [0, 8, 12]
    unwrap = hf_loader.translator_for({"model_type": "gemma3", "text_config": {}})
    assert set(unwrap({"model.language_model.norm.weight": 1, "model.vision_tower.x": 2,
                       "lm_head.weight": 3})) == {"model.norm.weight"}
    with pytest.raises(ValueError, match="mixtral, phi3 and gemma3 only"):
        hf_loader.translator_for({"model_type": "modernbert-decoder"})
    assert isinstance(builder.make_tokenizer("tinyllama-1.1b", 32000), builder.ByteTokenizer)


def test_snapshot_loads_and_audits_missing_keys(workdir, tmp_path, caplog):
    _, snap, _ = workdir
    sd = hf_loader.read_hf_state_dict(str(snap))
    cfg = models.TransformerConfig.from_hf_config(hf_loader.read_hf_config(str(snap)), torch.float32)
    model = hf_loader.load_into_causal_lm(models.CausalLM(cfg, device="cpu"), str(snap))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    partial = tmp_path / "partial"
    partial.mkdir()
    (partial / "config.json").write_text(json.dumps(TINY_HF))
    torch.save({k: v for k, v in sd.items() if k != "lm_head.weight"}, partial / "pytorch_model.bin")
    with caplog.at_level(logging.WARNING, logger=hf_loader.__name__):
        hf_loader.load_into_causal_lm(models.CausalLM(cfg, device="cpu"), str(partial))
    assert "lm_head.weight" in caplog.text
    # a decompose config with a state dict that lacks its pair's keys
    (tmp_path / "one.json").write_text(json.dumps(
        {"lm_head": {"type": "Sequential", "modules": {
            "0": {"type": "Linear", "in_features": cfg.dim, "out_features": 4, "bias": False},
            "1": {"type": "Linear", "in_features": 4, "out_features": cfg.vocab_size,
                  "bias": False}}}}))
    torch.save({k: v for k, v in sd.items() if k != "lm_head.weight"}, tmp_path / "sd.pt")
    with pytest.raises(KeyError, match="missing 2 keys"):
        builder.apply_decompose_config_and_state_dict(
            models.CausalLM(cfg, device="cpu"), str(tmp_path / "one.json"), str(tmp_path / "sd.pt"))


def test_gradient_checkpointing_is_transparent():
    """Logits and every gradient are the same with and without per-block
    checkpointing, in train mode with LoRA dropout drawing from the
    adapters' own generators (which the recompute must replay)."""
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(models.TransformerConfig.tiny(), remat=remat)
        model = models.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        for i, name in enumerate(("model.layers.0.mlp.up_proj", "model.layers.1.self_attn.q_proj")):
            lora = finetune.LoRALinear.attach(torch.Generator().manual_seed(i),
                                              model.get_submodule(name), 8, 16.0, dropout=0.3)
            torch.nn.init.normal_(lora.lora_b, generator=torch.Generator().manual_seed(9))
            model.get_submodule(name.rsplit(".", 1)[0]).__setattr__(name.rsplit(".", 1)[1], lora)
        model.train()
        ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 32)))
        logits = model({"input_ids": ids})
        models.ce_loss({"input_ids": ids}, logits).backward()
        results.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (y0, g0), (y1, g1) = results
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    assert g1.keys() == g0.keys()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7, msg=n)
