"""The vision dwain driver: accuracy, decompose with loss-reverting
fine-tuning, accuracy, save.

Counterpart of ``apps/trainer_vision/run_decompose_dwain.py``: the model
is wrapped (``dwain_wrapper_module.WrapperModule``, site names prefixed
``raw_model.`` during the walk and stripped in the artifact), one stream
of training batches feeds the Grams and the metric forwards, a second
one the fine-tuning, and the run writes ``decompose_config.json``,
``decompose_state_dict.pt`` and ``summary.json`` with the JAX trainer's
keys.  ``train_pipeline`` / ``val_pipeline`` replace the ImageNet folders
when given (tests and card runs pass ``SyntheticImagePipeline``s).  Runs
on the config's ``device`` (the card by default) unless the caller
passes one.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Any, Optional

import torch

from ... import dwain, utils
from ..trainer_llm.run_decompose_dwain import device_name, resolve_subdir
from . import builder, configurator, datasets_image, dwain_wrapper_module, metrics

__all__ = ["main", "make_pipelines", "model_stats"]

logger = logging.getLogger(__name__)


def make_pipelines(config: Any, model: torch.nn.Module, train_pipeline=None, val_pipeline=None):
    """The given pipelines, else the ImageNet folders' at the model's class count."""
    if train_pipeline is not None and val_pipeline is not None:
        return train_pipeline, val_pipeline
    return datasets_image.make_imagenet_pipelines(
        imagenet_root_dir=config.imagenet_root_dir,
        trn_imagenet_classes_fname=config.trn_imagenet_classes_fname,
        val_imagenet_classes_fname=config.val_imagenet_classes_fname,
        batch_size=config.batch_size,
        normalization=config.normalization,
        input_h_w=config.input_h_w,
        num_classes=builder.infer_num_classes(model, tuple(config.input_h_w)),
        use_rotation=config.use_rotation,
    )


def model_stats(model: torch.nn.Module, input_h_w: tuple[int, int],
                decomposeable: bool = True) -> dict[str, float]:
    shape = (1, *input_h_w, 3)
    stats = builder.get_model_stats(model, shape)
    if decomposeable:
        stats.update(builder.get_decomposeable_model_stats(model, shape))
    return stats


def main(config_raw: dict[str, Any], output_path: pathlib.Path, train_pipeline=None,
         val_pipeline=None, device: Optional[str] = None) -> None:
    config = configurator.DecomposeDWAINConfig.from_dict(config_raw)
    dev = torch.device(device or config.device)
    output_path.mkdir(exist_ok=True, parents=True)

    raw_model = builder.make_model(
        config.decompose_model_name, checkpoint_path=config.decompose_model_checkpoint_path,
        input_h_w=config.input_h_w, device=dev)
    train_pipeline, val_pipeline = make_pipelines(config, raw_model, train_pipeline, val_pipeline)
    stats_initial = model_stats(raw_model, config.input_h_w)
    model = dwain_wrapper_module.WrapperModule(raw_model)
    blacklist = dwain_wrapper_module.add_prefix(config.blacklisted_modules)
    builder.validate_module_names(model, blacklist)

    accuracy_initial = metrics.calc_accuracy(raw_model, val_pipeline)

    def batch_iter():
        for batch in datasets_image.infinite(train_pipeline):
            yield {"inputs": batch["inputs"], "targets": batch["targets"]}

    data_iter = batch_iter()
    ft_iter = batch_iter()

    finetune_fn = None
    if config.finetuning_run:
        def finetune_fn(module, decomposed_names):
            return dwain_wrapper_module.finetune_full(
                model=module,
                ft_iterator=ft_iter,
                decomposed_modules=decomposed_names,
                num_last_modules_to_finetune=config.finetuning_num_last_finetuned_modules,
                num_steps=config.finetuning_num_steps,
                num_log_steps=config.finetuning_num_log_steps,
                lr=config.finetuning_lr,
                optimizer=config.finetuning_optimizer,
                use_reverting=config.finetuning_reverting,
                batch_norms_in_eval=config.finetuning_batch_norms_in_eval,
            )

    t0 = time.perf_counter()
    model, decompose_config = dwain.decompose(
        module=model,
        data_iterator=data_iter,
        loss_fn=dwain_wrapper_module.ce_loss,
        num_data_steps=config.num_data_steps,
        metric_iterator=data_iter,
        num_metric_steps=config.num_metric_steps,
        nsr_final_threshold=config.nsr_final_threshold,
        finetune_fn=finetune_fn,
        blacklisted_module_names=blacklist,
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
    t_deco = time.perf_counter() - t0

    raw_final = model.raw_model
    accuracy_final = metrics.calc_accuracy(raw_final, val_pipeline)
    stats_final = model_stats(raw_final, config.input_h_w)

    with open(output_path / "decompose_config.json", "w") as f:
        json.dump(dwain_wrapper_module.strip_prefix_dict(decompose_config), f)
    sd = dwain_wrapper_module.strip_prefix_dict(utils.state_dict(model))
    utils.save_state_dict_pt(sd, str(output_path / "decompose_state_dict.pt"))

    summary = {
        "accuracy_initial": accuracy_initial,
        "accuracy_final": accuracy_final,
        "n_decomposed": len(decompose_config),
        "mparams_initial": stats_initial["mparams"],
        "mparams_final": stats_final["mparams"],
        "mparams_frac": stats_final["mparams"] / stats_initial["mparams"] * 100.0,
        "gflops_initial": stats_initial["gflops"],
        "gflops_final": stats_final["gflops"],
        "gflops_frac": stats_final["gflops"] / stats_initial["gflops"] * 100.0,
        "gflops_decomposeable_initial": stats_initial["gflops_decomposeable"],
        "gflops_decomposeable_final": stats_final["gflops_decomposeable"],
        "mparams_decomposeable_initial": stats_initial["mparams_decomposeable"],
        "mparams_decomposeable_final": stats_final["mparams_decomposeable"],
        "time_decomposition": t_deco,
        "device": device_name(dev),
    }
    with open(output_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"Summary: {json.dumps(summary, indent=2)}")
