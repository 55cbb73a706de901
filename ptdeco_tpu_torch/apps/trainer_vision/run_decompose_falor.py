"""The vision falor driver: accuracy, one-shot decompose, accuracy, save.

Counterpart of ``apps/trainer_vision/run_decompose_falor.py``: the
training images (NCHW views of the NHWC batches) feed ``falor.decompose``
with its vision settings (no mean-centring, damping on), and the run
writes ``decompose_config.json``, ``decompose_state_dict.pt`` and
``summary.json`` with the JAX trainer's keys.  Pipelines and device as in
``run_decompose_dwain``.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Any, Optional

import torch

from ... import falor, utils
from ..trainer_llm.run_decompose_dwain import device_name, resolve_subdir
from . import builder, configurator, datasets_image, metrics
from .run_decompose_dwain import make_pipelines, model_stats

__all__ = ["main"]

logger = logging.getLogger(__name__)


def main(config_raw: dict[str, Any], output_path: pathlib.Path, train_pipeline=None,
         val_pipeline=None, device: Optional[str] = None) -> None:
    config = configurator.DecomposeFALORConfig.from_dict(config_raw)
    dev = torch.device(device or config.device)
    output_path.mkdir(exist_ok=True, parents=True)

    model = builder.make_model(
        config.decompose_model_name, checkpoint_path=config.decompose_model_checkpoint_path,
        input_h_w=config.input_h_w, device=dev)
    train_pipeline, val_pipeline = make_pipelines(config, model, train_pipeline, val_pipeline)
    builder.validate_module_names(model, config.blacklisted_modules)
    stats_initial = model_stats(model, config.input_h_w)

    t0 = time.perf_counter()
    accuracy_initial = metrics.calc_accuracy(model, val_pipeline)
    t_eval = time.perf_counter() - t0

    def image_iter():
        for batch in datasets_image.infinite(train_pipeline):
            yield metrics.nchw(batch["inputs"], "cpu")

    t1 = time.perf_counter()
    model, decompose_config = falor.decompose(
        module=model,
        data_iterator=image_iter(),
        proportion_threshold=config.proportion_threshold,
        nsr_final_threshold=config.nsr_final_threshold,
        kl_final_threshold=config.kl_final_threshold,
        num_data_steps=config.num_data_steps,
        num_metric_steps=config.num_metric_steps,
        use_float64=config.use_float64,
        use_mean=False,
        use_damping=True,
        blacklisted_module_names=config.blacklisted_modules,
        checkpoint_dir=resolve_subdir(output_path, config.decomposition_checkpoint_dir),
        device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_deco = time.perf_counter() - t1

    accuracy_final = metrics.calc_accuracy(model, val_pipeline)
    stats_final = model_stats(model, config.input_h_w)

    with open(output_path / "decompose_config.json", "w") as f:
        json.dump(decompose_config, f)
    utils.save_state_dict_pt(utils.state_dict(model),
                             str(output_path / "decompose_state_dict.pt"))

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
        "kmapps_initial": stats_initial["kmapps"],
        "kmapps_final": stats_final["kmapps"],
        "kmapps_frac": stats_final["kmapps"] / stats_initial["kmapps"] * 100.0,
        "time_decomposition": t_deco,
        "time_eval": t_eval,
        "device": device_name(dev),
    }
    with open(output_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"Summary: {json.dumps(summary, indent=2)}")
