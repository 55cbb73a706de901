"""``task: generate``: batched KV-cache generation from a (decomposed)
causal LM through ``ptdeco_tpu_torch.serving``.

Counterpart of ``apps/trainer_llm/run_generate.py``: the model is built as
the finetune task builds it (the original, plus an optional decompose
config and state dict, whose factor pairs stay unfused), the prompts are
grouped in input order into right-padded ragged batches (``prompt_lens``),
and ``generations.jsonl`` and ``summary.json`` are written with the JAX
trainer's keys.  Speculative serving keeps the original as the target and
the decomposed artifact as the draft; its auto gate runs once, before the
batch loop.  Sampling draws from a ``torch.Generator`` seeded with the
config's ``seed`` on the task's device.
"""

from __future__ import annotations

import copy
import json
import logging
import pathlib
import time
from typing import Any, Optional

import torch

from ... import quant, serving
from . import builder, configurator
from .run_decompose_dwain import device_name

__all__ = ["main"]

logger = logging.getLogger(__name__)

_SAMPLERS = ("top_p", "top_k", "min_p", "repetition_penalty")


def _read_prompts(config: configurator.GenerateConfig) -> list[str]:
    if config.prompts is not None:
        if config.prompts_file is not None:
            raise ValueError("give prompts OR prompts_file, not both")
        return list(config.prompts)
    if config.prompts_file is None:
        raise ValueError("one of prompts / prompts_file is required")
    path = pathlib.Path(config.prompts_file)
    if path.suffix == ".jsonl":
        rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
        return [r["text"] for r in rows]
    return [ln for ln in path.read_text().splitlines() if ln.strip()]


def _tokenize(tokenizer: Any, text: str, max_len: Optional[int]) -> list[int]:
    ids = tokenizer(text, add_special_tokens=False)["input_ids"]
    if max_len is not None:
        ids = ids[:max_len]
    if not ids:
        raise ValueError(f"prompt tokenized to nothing: {text!r}")
    return ids


def _padded(token_lists: list[list[int]], device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-padded (b, longest) ids and their lengths (b,)."""
    s_max = max(len(t) for t in token_lists)
    padded = torch.zeros((len(token_lists), s_max), dtype=torch.int64)
    for i, t in enumerate(token_lists):
        padded[i, : len(t)] = torch.tensor(t)
    lens = torch.tensor([len(t) for t in token_lists])
    return padded.to(device), lens.to(device)


def _check_modes(config: configurator.GenerateConfig) -> None:
    if (config.decompose_config is None) != (config.decompose_state_dict is None):
        raise ValueError("decompose_config and decompose_state_dict must be given together")
    if config.speculative:
        if config.decompose_config is None:
            raise ValueError(
                "speculative serving needs the decomposed artifact as the draft: set "
                "decompose_config + decompose_state_dict"
            )
        if config.temperature != 0.0 or config.num_beams > 1:
            raise ValueError("speculative decoding is greedy: set temperature: 0 and num_beams: 1")
        samplers = [k for k in _SAMPLERS if getattr(config, k) is not None]
        if samplers:
            raise ValueError(f"speculative decoding does not apply {', '.join(samplers)}")
    if config.num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {config.num_beams}")
    if config.num_beams > 1:
        if config.temperature != 0.0:
            raise ValueError("beam search (num_beams > 1) is deterministic; set temperature: 0")
        dropped = [k for k in _SAMPLERS if getattr(config, k) is not None]
        if dropped:
            raise ValueError(
                f"beam search does not apply {', '.join(dropped)}; remove them or set num_beams: 1"
            )


def main(
    config_raw: dict[str, Any], output_path: pathlib.Path, device: Optional[str] = None
) -> None:
    config = configurator.GenerateConfig.from_dict(config_raw)
    dev = torch.device(device or config.device)
    _check_modes(config)
    output_path.mkdir(exist_ok=True, parents=True)

    model, tokenizer = builder.make_model_and_tokenizer(
        model_name=config.decomposed_model_name,
        model_revision=config.decomposed_model_revision,
        dtype=config.decomposed_model_dtype,
        custom_builder_path=config.decomposed_model_custom_builder_path,
        custom_builder_config=config.decomposed_model_custom_builder_config,
        checkpoint_path=config.decomposed_model_checkpoint_path,
        device=dev,
    )
    model.eval()
    draft = None
    if config.speculative:
        # target = the original model; the decomposed artifact drafts
        draft = builder.apply_decompose_config_and_state_dict(
            copy.deepcopy(model), config.decompose_config, config.decompose_state_dict
        )
        logger.info(
            f"Speculative serving: draft = {config.decompose_config}, k={config.speculative_k}, "
            f"auto_gate={config.speculative_auto_gate}"
        )
    elif config.decompose_config is not None:
        builder.apply_decompose_config_and_state_dict(
            model, config.decompose_config, config.decompose_state_dict
        )
        logger.info(f"Applied decomposed checkpoint {config.decompose_config}")
    if config.quantize_int8:
        model = quant.quantize_for_serving(model)
        if draft is not None:
            draft = quant.quantize_for_serving(draft)
        logger.info("Quantized Linear sites to weight-only int8")
    serving.check_decode_supported(model)
    if draft is not None:
        serving.check_decode_supported(draft)

    prompts = _read_prompts(config)
    token_lists = [_tokenize(tokenizer, p, config.max_prompt_length) for p in prompts]
    eos_id = getattr(tokenizer, "eos_token_id", None) if config.stop_at_eos else None

    results: list[dict[str, Any]] = []
    spec_stats: list[dict[str, Any]] = []
    total_new = 0
    generator = torch.Generator(device=dev).manual_seed(config.seed)
    # the speculative auto gate runs once, before the batch loop: a timed
    # probe of the real speculative loop against plain decode on the first
    # batch's prompts.  If drafting loses, every batch serves plain decode
    gate_info: Optional[dict[str, Any]] = None
    if draft is not None and config.speculative_auto_gate:
        ids0, lens0 = _padded(token_lists[: config.batch_size], dev)
        probe = serving.measure_speculative_speedup_probe(
            model, draft, ids0, k=config.speculative_k, eos_id=eos_id, prompt_lens=lens0
        )
        use_speculative = probe["measured_speedup"] >= 1.0
        gate_info = {"used_speculative": use_speculative, "basis": "measured_probe_throughput",
                     **probe}
        logger.info(f"Speculative gate (measured once): {gate_info}")
        if not use_speculative:
            draft = None  # serve plain decode for every batch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for start in range(0, len(token_lists), config.batch_size):
        chunk = token_lists[start : start + config.batch_size]
        ids, lens = _padded(chunk, dev)
        if draft is not None:
            # the gate, if any, ran above: batches run ungated
            out, stats = serving.generate_speculative(
                model, draft, ids, config.max_new_tokens, k=config.speculative_k,
                eos_id=eos_id, prompt_lens=lens, return_stats=True, auto_gate=False,
            )
            spec_stats.append(stats)
        elif config.num_beams > 1:
            out = serving.generate_beam(
                model, ids, config.max_new_tokens, num_beams=config.num_beams,
                length_penalty=config.length_penalty, eos_id=eos_id, prompt_lens=lens,
            )
        else:
            out = serving.generate(
                model, ids, config.max_new_tokens, temperature=config.temperature,
                top_p=config.top_p, top_k=config.top_k, min_p=config.min_p,
                repetition_penalty=config.repetition_penalty, generator=generator,
                eos_id=eos_id, prompt_lens=lens,
            )
        rows = out.cpu().tolist()
        for i, t in enumerate(chunk):
            new_ids = rows[i]
            if eos_id is not None and eos_id in new_ids:
                new_ids = new_ids[: new_ids.index(eos_id)]
            total_new += len(new_ids)
            results.append({
                "prompt": prompts[start + i],
                "completion": tokenizer.decode(new_ids),
                "n_prompt_tokens": len(t),
                "n_new_tokens": len(new_ids),
            })
    wall_s = time.perf_counter() - t0

    with open(output_path / "generations.jsonl", "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    summary: dict[str, Any] = {
        "n_prompts": len(prompts),
        "max_new_tokens": config.max_new_tokens,
        "total_new_tokens": total_new,
        "num_beams": config.num_beams,
        "generate_wall_s": round(wall_s, 3),
        "tokens_per_s": round(total_new / wall_s, 2) if wall_s > 0 else None,
        "decomposed": config.decompose_config is not None,
        "device": device_name(dev),
    }
    if spec_stats:
        drafted = sum(s["drafted"] for s in spec_stats)
        accepted = sum(s["accepted"] for s in spec_stats)
        summary["speculative"] = {
            "k": config.speculative_k,
            "rounds": sum(s["rounds"] for s in spec_stats),
            "drafted": drafted,
            "accepted": accepted,
            "acceptance": round(accepted / drafted, 4) if drafted else None,
            "gate": gate_info,
        }
    elif gate_info is not None:
        # the gate measured a losing regime and served plain decode
        summary["speculative"] = {"k": config.speculative_k, "gate": gate_info}
    with open(output_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"Generation summary: {summary}")
