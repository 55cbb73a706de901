"""The port's ``task: generate`` (``ptdeco_tpu_torch/apps/trainer_llm/
run_generate.py``) against the JAX trainer's on the CPU, in one process:
both read one local HF snapshot (a small llama, d 256, from
``test_torch_trainer_llm.write_snapshot``), one decomposed artifact (three
sites cut to rank 16 by SVD) and one ragged batch of prompts, with the byte
tokenizer.  Greedy decoding of the decomposed model, beam search and
speculative decoding (auto gate off) write equal ``generations.jsonl``
texts and ``summary.json`` keys and counts; then the port's own cases:
the CLI's dispatch, sampling, int8 and the refusals
(tests/test_serving.py:test_cli_generate_task)."""

import copy
import json

import numpy as np
import pytest
import torch

from apps.trainer_llm import run_generate as jrun_generate
from ptdeco_tpu_torch import utils
from ptdeco_tpu_torch.apps.trainer_llm import builder, run, run_generate

from test_torch_trainer_llm import offline, write_snapshot  # noqa: F401

SITES = ("model.layers.0.mlp.up_proj", "model.layers.1.self_attn.q_proj",
         "model.layers.1.mlp.down_proj")
RANK = 16
PROMPTS = ["the quick brown fox", "low rank", "tokens flow through the cache"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, offline):  # noqa: F811
    """The snapshot, and a decomposed artifact of it written by the port."""
    root = tmp_path_factory.mktemp("trainer_generate")
    snap = write_snapshot(root)
    model, _ = builder.make_model_and_tokenizer(
        model_name="tiny-snapshot", dtype="float32", checkpoint_path=str(snap), device="cpu")
    sd = {k: v.numpy() for k, v in utils.state_dict(model).items()}
    config = {}
    for name in SITES:
        w = sd.pop(name + ".weight").astype(np.float64)
        u, s, vt = np.linalg.svd(w, full_matrices=False)
        root_s = np.sqrt(s[:RANK])
        sd[name + ".0.weight"] = (root_s[:, None] * vt[:RANK]).astype(np.float32)
        sd[name + ".1.weight"] = (u[:, :RANK] * root_s).astype(np.float32)
        config[name] = utils.get_module_config(torch.nn.Sequential(
            torch.nn.Linear(w.shape[1], RANK, bias=False), torch.nn.Linear(RANK, w.shape[0], bias=False)))
    (root / "decompose_config.json").write_text(json.dumps(config))
    utils.save_state_dict_pt({k: torch.from_numpy(v) for k, v in sd.items()},
                             str(root / "decompose_state_dict.pt"))
    return root, snap


def generate_cfg(workdir, **over):
    root, snap = workdir
    cfg = dict(
        task="generate",
        decomposed_model_name="tiny-snapshot",
        decomposed_model_checkpoint_path=str(snap),
        decomposed_model_dtype="float32",
        decompose_config=str(root / "decompose_config.json"),
        decompose_state_dict=str(root / "decompose_state_dict.pt"),
        prompts=PROMPTS,
        max_new_tokens=6,
        batch_size=4,
        stop_at_eos=True,
    )
    cfg.update(over)
    return {k: v for k, v in cfg.items() if v is not None}


MODES = {
    "greedy_decomposed": dict(),
    "beam_original": dict(num_beams=2, length_penalty=1.5, decompose_config=None,
                          decompose_state_dict=None),
    "speculative_decomposed_draft": dict(speculative=True, speculative_k=2,
                                         speculative_auto_gate=False),
}
COUNTS = ("n_prompts", "max_new_tokens", "total_new_tokens", "num_beams", "decomposed")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_task_matches_jax(workdir, mode, tmp_path):
    cfg = generate_cfg(workdir, **MODES[mode])
    jrun_generate.main(copy.deepcopy(cfg), tmp_path / "jax")
    run_generate.main(copy.deepcopy(cfg), tmp_path / "port", device="cpu")
    texts = {side: (tmp_path / side / "generations.jsonl").read_text() for side in ("jax", "port")}
    assert texts["port"] == texts["jax"]
    rows = [json.loads(line) for line in texts["port"].splitlines()]
    assert [r["prompt"] for r in rows] == PROMPTS
    assert [r["n_prompt_tokens"] for r in rows] == [len(p.encode()) for p in PROMPTS]
    theirs, ours = (json.loads((tmp_path / side / "summary.json").read_text())
                    for side in ("jax", "port"))
    assert ours.keys() == theirs.keys()
    assert {k: ours[k] for k in COUNTS} == {k: theirs[k] for k in COUNTS}
    assert ours["device"] == "cpu:cpu" and ours["tokens_per_s"] > 0
    if mode.startswith("speculative"):
        assert ours["speculative"] == theirs["speculative"] and ours["speculative"]["rounds"] >= 1
        # speculative is exact: the original model's greedy generations
        run_generate.main(generate_cfg(workdir, decompose_config=None, decompose_state_dict=None),
                          tmp_path / "original", device="cpu")
        assert texts["port"] == (tmp_path / "original" / "generations.jsonl").read_text()


def test_cli_dispatches_generate_sampled_and_int8(workdir, tmp_path):
    """Through ``run.main``: sampling with the example YAML's values is
    reproducible from the config's seed; the int8 serving form runs."""
    outs = []
    for i, over in enumerate([dict(temperature=0.7, top_p=0.95, top_k=40, min_p=0.02,
                                   repetition_penalty=1.1)] * 2 + [dict(quantize_int8=True)]):
        path = tmp_path / f"cfg{i}.json"
        path.write_text(json.dumps(generate_cfg(workdir, **over)))
        assert run.main(["--config", str(path), "--output-path", str(tmp_path / f"out{i}"),
                         "--device", "cpu"]) == 0
        outs.append((tmp_path / f"out{i}" / "generations.jsonl").read_text())
        summary = json.loads((tmp_path / f"out{i}" / "summary.json").read_text())
        assert summary["n_prompts"] == 3 and 0 < summary["total_new_tokens"] <= 18
    assert outs[0] == outs[1]
    assert (tmp_path / "out2" / "repro" / "config.yaml").exists()


@pytest.mark.parametrize("over,match", [
    (dict(num_beams=2, temperature=0.5), "temperature"),
    (dict(num_beams=2, repetition_penalty=1.3), "repetition_penalty"),
    (dict(num_beams=0), "num_beams"),
    (dict(speculative=True, decompose_config=None, decompose_state_dict=None), "draft"),
    (dict(speculative=True, temperature=0.5), "greedy"),
    (dict(speculative=True, top_p=0.9), "top_p"),
    (dict(decompose_state_dict=None), "together"),
    (dict(prompts=None), "prompts"),
    (dict(prompts_file="prompts.txt"), "not both"),
    (dict(max_new_tokens="many"), "max_new_tokens"),
    (dict(temprature=0.5), "extra fields"),
])
def test_generate_task_refuses(workdir, over, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        run_generate.main(generate_cfg(workdir, **over), tmp_path, device="cpu")
