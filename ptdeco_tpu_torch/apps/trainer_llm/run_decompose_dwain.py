"""dwain decomposition driver for LLMs.

Counterpart of ``apps/trainer_llm/run_decompose_dwain.py``: build the
model and loaders, measure the initial perplexity, parameters, FLOPs and
task accuracies, run ``dwain.decompose`` with the configured recovery
fine-tuning, and write ``decompose_config.json``,
``decompose_state_dict.pt`` (and ``.safetensors`` where that package is
importable) and ``summary.json``.  One calibration stream feeds the
Grams, the metric forwards and the fine-tuning, as in the JAX trainer.
Runs on the config's ``device`` (the card by default) unless the caller
passes one.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import pathlib
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ... import dwain, finetune, models, utils
from . import builder, configurator, datasets_hf, metrics

__all__ = ["PPL_N_SAMPLES", "main", "make_dataloaders", "device_name"]

logger = logging.getLogger(__name__)

PPL_N_SAMPLES = 1000  # reference run_decompose_dwain.py:21


def _make_infinite_iterator(loaders: list) -> Iterator[dict[str, torch.Tensor]]:
    """Random merger over several datasets."""
    rng = np.random.RandomState(0)
    iters = [iter(ld) for ld in loaders]
    while True:
        i = int(rng.randint(len(iters))) if len(iters) > 1 else 0
        yield next(iters[i])


def make_dataloaders(config: configurator.DecomposeDWAINConfig, tokenizer):
    names = config.decomposition_data_name
    if isinstance(names, str):
        names = [names]
    deco_loaders = []
    for name in names:
        ds = datasets_hf.get_dataset(name)
        deco_loaders.append(
            datasets_hf.prepare_dataloader_v2(
                dataset=ds,
                tokenizer=tokenizer,
                max_seqlen=config.decomposition_data_max_length,
                batch_size=config.decomposition_data_batch_size,
                separator=config.decomposition_data_separator,
            )
        )
    ppl_ds = datasets_hf.get_dataset(config.perplexity_data_name)
    ppl_loader = datasets_hf.prepare_dataloader_v1(
        dataset=ppl_ds,
        tokenizer=tokenizer,
        separator=config.perplexity_data_separator,
        max_seqlen=config.perplexity_data_max_length,
        batch_size=config.perplexity_data_batch_size,
        nsamples=min(PPL_N_SAMPLES, len(ppl_ds)),
    )
    return _make_infinite_iterator(deco_loaders), ppl_loader


def device_name(device: torch.device) -> str:
    """``cuda:<card name>`` on the card, ``cpu:cpu`` on the CPU."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return f"{device.type}:{device.type}"


def resolve_subdir(base: Any, maybe_relative: Optional[str]) -> Optional[str]:
    """A possibly-relative directory resolved under ``base``."""
    if not maybe_relative:
        return maybe_relative
    p = pathlib.Path(maybe_relative)
    return str(p) if p.is_absolute() else str(pathlib.Path(base) / p)


def main(
    config_raw: dict[str, Any], output_path: pathlib.Path, device: Optional[str] = None
) -> None:
    config = configurator.DecomposeDWAINConfig.from_dict(config_raw)
    dev = torch.device(device or config.device)
    output_path.mkdir(exist_ok=True, parents=True)

    model, tokenizer = builder.make_model_and_tokenizer(
        model_name=config.decomposed_model_name,
        model_revision=config.decomposed_model_revision,
        dtype=config.decomposed_model_dtype,
        custom_builder_path=config.decomposed_model_custom_builder_path,
        custom_builder_config=config.decomposed_model_custom_builder_config,
        checkpoint_path=config.decomposed_model_checkpoint_path,
        enable_gradient_checkpointing=config.decomposed_model_enable_gradient_checkpointing,
        device=dev,
    )
    builder.validate_module_names(model, config.blacklisted_modules)

    deco_iter, ppl_loader = make_dataloaders(config, tokenizer)

    t_start = time.perf_counter()
    ppl_initial = metrics.calc_perplexity(model, ppl_loader.one_epoch())
    params_initial = metrics.get_params_m(model)
    # GFLOPs on a fixed (1, 512) input, as the reference measures them
    flops_len = min(512, config.perplexity_data_max_length)
    flops_batch = {
        "input_ids": torch.zeros((1, flops_len), dtype=torch.int64),
        "attention_mask": torch.ones((1, flops_len), dtype=torch.int64),
    }
    gflops_initial = metrics.get_giga_flops(model, flops_batch)
    lm_eval_initial_results = None
    if config.lm_eval_initial and config.lm_eval_tasks:
        lm_eval_initial_results = metrics.calc_lm_eval_metrics(model, tokenizer, config.lm_eval_tasks)

    finetune_fn = None
    if config.finetuning_run:
        mode = "lora" if config.finetuning_use_lora else "full"
        kwargs: dict[str, Any] = dict(
            num_last_modules_to_finetune=config.finetuning_num_last_finetuned_modules,
            num_steps=config.finetuning_num_steps,
            lr=config.finetuning_lr,
        )
        if mode == "lora":
            kwargs["min_rank_to_finetune"] = config.finetuning_lora_min_rank
            kwargs["use_rank_pattern"] = config.finetuning_use_rank_pattern
        finetune_fn = finetune.make_finetune_fn(mode, deco_iter, models.ce_loss, **kwargs)

    t_deco_start = time.perf_counter()
    model, decompose_config = dwain.decompose(
        module=model,
        data_iterator=deco_iter,
        loss_fn=models.ce_loss,
        num_data_steps=config.num_data_steps,
        metric_iterator=deco_iter,
        num_metric_steps=config.num_metric_steps,
        nsr_final_threshold=config.nsr_final_threshold,
        finetune_fn=finetune_fn,
        blacklisted_module_names=config.blacklisted_modules,
        min_rank=config.min_rank,
        trade_off_factor=config.trade_off_factor,
        reduction_factor=config.reduction_factor,
        max_accepted_ppl_diff=config.max_accepted_ppl_diff,
        decompose_in_float64=config.decompose_in_float64,
        precomputing_covariance_num_splits=config.precomputing_covariance_num_splits,
        eigh_method=config.eigh_method,
        checkpoint_dir=resolve_subdir(output_path, config.decomposition_checkpoint_dir),
        device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_deco = time.perf_counter() - t_deco_start

    with open(output_path / "decompose_config.json", "w") as f:
        json.dump(decompose_config, f)
    sd = utils.state_dict(model)
    utils.save_state_dict_pt(sd, str(output_path / "decompose_state_dict.pt"))
    if importlib.util.find_spec("safetensors") is not None:
        utils.save_state_dict_safetensors(sd, str(output_path / "decompose_state_dict.safetensors"))

    ppl_final = metrics.calc_perplexity(model, ppl_loader.one_epoch())
    params_final = metrics.get_params_m(model)
    gflops_final = metrics.get_giga_flops(model, flops_batch)
    lm_eval_final_results = None
    if config.lm_eval_tasks:
        lm_eval_final_results = metrics.calc_lm_eval_metrics(model, tokenizer, config.lm_eval_tasks)

    summary = {
        "ppl_initial": ppl_initial,
        "ppl_final": ppl_final,
        "mparams_initial": params_initial,
        "mparams_final": params_final,
        # percent, the reference summary's convention
        "mparams_frac": params_final / params_initial * 100.0,
        "gflops_initial": gflops_initial,
        "gflops_final": gflops_final,
        "gflops_frac": gflops_final / gflops_initial * 100.0 if gflops_initial else None,
        "time_decomposition": t_deco,
        "time_total": time.perf_counter() - t_start,
        "device": device_name(dev),
        "n_devices": 1,
        "lm_eval_initial": lm_eval_initial_results,
        "lm_eval_final": lm_eval_final_results,
    }
    with open(output_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"Summary: {json.dumps(summary, indent=2)}")
