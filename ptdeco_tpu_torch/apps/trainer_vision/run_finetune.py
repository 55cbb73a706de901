"""Knowledge-distillation fine-tuning of a decomposed vision model.

Counterpart of ``apps/trainer_vision/run_finetune.py``: the decompose
config is filtered (entries at or above ``proportion_threshold`` and
blacklisted ones dropped, with their factor pairs' keys dropped from the
state dict so that the original layer's weights load), the student is
the original model with the kept pairs, and it trains against the
frozen original (the teacher, in eval mode) on the symmetric KL loss:
the kept pairs only (``finetune_only_decomposed``) or every parameter;
in train mode (BatchNorm on batch statistics, running statistics
updated) unless ``finetune_eval_mode``; with the configured optimizer,
schedule and clipping, and with ``precision: bf16`` bf16 compute over f32
masters.  Steps run ``steps_per_dispatch`` at a time between looks at the
loss and the checkpoint, which holds the trainable tensors and, in train
mode, the BatchNorm statistics.  Writes ``finetuned_state_dict.pt``, the
kept ``decompose_config.json`` and ``summary.json`` with the JAX
trainer's keys.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Any, Optional

import torch

from ... import utils
from ...utils.train_ckpt import TrainCheckpointer
from ..trainer_llm.run_decompose_dwain import device_name
from . import builder, configurator, datasets_image, metrics
from .run_decompose_dwain import make_pipelines, model_stats
from .run_decompose_lockd import LOG_EVERY, f32_snapshot, restore_f32
from .tb_writer import TBWriter

__all__ = ["filter_decompose_config", "filter_state_dict", "kd_loss", "main"]

logger = logging.getLogger(__name__)


def filter_decompose_config(decompose_config: dict[str, Any], proportion_threshold: float,
                            blacklisted_module_names: list[str]) -> dict[str, Any]:
    """The entries below the proportion threshold and not blacklisted."""
    out = {}
    for name, cfg in decompose_config.items():
        proportion = cfg.get(utils.MODCONFIG_META_KEY, {}).get("proportion", 0.0)
        if name in blacklisted_module_names:
            logger.info(f"Skipping blacklisted {name}")
            continue
        if proportion >= proportion_threshold:
            logger.info(f"Skipping {name}, proportion {proportion:.3f} >= "
                        f"{proportion_threshold:.3f}")
            continue
        out[name] = cfg
    return out


def filter_state_dict(sd: dict[str, Any], skipped_sites: set[str]) -> dict[str, Any]:
    """``sd`` without the factor-pair keys of the skipped sites."""
    return {k: v for k, v in sd.items()
            if not any(k.startswith((s + ".0.", s + ".1.")) for s in skipped_sites)}


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    return utils.calc_kl_loss(student_logits, teacher_logits)


def _trainable(student: torch.nn.Module, config: configurator.FinetuneConfig,
               kept: dict[str, Any]) -> dict[str, torch.nn.Parameter]:
    if not config.finetune_only_decomposed:
        return dict(student.named_parameters())
    return {f"{site}.{n}": p for site in kept
            for n, p in student.get_submodule(site).named_parameters()}


def _bn_stats(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {n: t for n, t in model.named_buffers() if n.endswith(("running_mean", "running_var"))}


def main(config_raw: dict[str, Any], output_path: pathlib.Path, train_pipeline=None,
         val_pipeline=None, device: Optional[str] = None) -> None:
    config = configurator.FinetuneConfig.from_dict(config_raw)
    dev = torch.device(device or config.device)
    output_path.mkdir(exist_ok=True, parents=True)

    def build():
        return builder.make_model(
            config.decompose_model_name, checkpoint_path=config.decompose_model_checkpoint_path,
            input_h_w=config.input_h_w, device=dev)

    teacher = build()
    teacher.requires_grad_(False)
    train_pipeline, val_pipeline = make_pipelines(config, teacher, train_pipeline, val_pipeline)

    with open(config.decompose_config) as f:
        decompose_config = json.load(f)
    kept = filter_decompose_config(decompose_config, config.proportion_threshold,
                                   config.blacklisted_modules)
    skipped = set(decompose_config) - set(kept)

    student = build()
    utils.apply_decompose_config(student, kept)
    if config.decompose_state_dict.endswith(".safetensors"):
        sd = utils.load_state_dict_safetensors(config.decompose_state_dict)
    else:
        sd = utils.load_state_dict_pt(config.decompose_state_dict)
    sd = filter_state_dict(sd, skipped)
    builder.log_state_dict_keys_stats("student:", student, sd)
    utils.load_state_dict(student, sd, strict=False)
    if dev.type == "cuda":
        student = student.to(memory_format=torch.channels_last)

    trainable = _trainable(student, config, kept)
    ids = {id(p) for p in trainable.values()}
    for p in student.parameters():
        p.requires_grad_(id(p) in ids)
    steps_per_epoch = max(len(train_pipeline), 1)
    num_steps = configurator.parse_duration(config.max_duration, steps_per_epoch)
    schedule = configurator.get_lr_schedule(config, num_steps, steps_per_epoch)
    optimizer = configurator.get_optimizer(config, list(trainable.values()), schedule(0))

    accuracy_initial = metrics.calc_accuracy(student, val_pipeline)

    bf16 = config.precision == "bf16"
    snapshot = f32_snapshot(student, trainable) if bf16 else {}
    compute = configurator.bf16_compute(student, trainable, config.precision)
    if bf16:
        teacher.to(torch.bfloat16)
    train_mode = not config.finetune_eval_mode
    params = list(trainable.values())

    def train_step(x: torch.Tensor, lr: float) -> torch.Tensor:
        if bf16:
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            teacher_logits = teacher(x)
        student.train(train_mode)
        logits = torch.func.functional_call(student, compute(), (x,))
        loss = kd_loss(logits, teacher_logits)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        configurator.clip_gradients(config, params)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return loss.detach()

    def state():
        out = {n: p.detach() for n, p in trainable.items()}
        if train_mode:
            # running statistics are training state too in train mode
            out.update({n: t.detach() for n, t in _bn_stats(student).items()})
        return out

    ckpt = TrainCheckpointer(str(output_path / "checkpoints"), config.save_interval_steps)
    saved, opt_state, start_step = ckpt.restore_or(None, None)
    if saved is not None:
        tensors = {**trainable, **_bn_stats(student)}
        with torch.no_grad():
            for n, v in saved.items():
                tensors[n].copy_(v)
        optimizer.load_state_dict(opt_state)

    tb = TBWriter(output_path / "tensorboard", config.tensorboard)
    data_iter = datasets_image.infinite(train_pipeline)
    spd = max(int(config.steps_per_dispatch), 1)
    t0 = time.perf_counter()
    step_idx = start_step
    while step_idx < num_steps:
        n = spd if spd > 1 and step_idx + spd <= num_steps else 1
        for j in range(n):
            loss = train_step(metrics.nchw(next(data_iter)["inputs"], dev),
                              schedule(step_idx + j))
        if any((step_idx + j) % LOG_EVERY == 0 for j in range(n)):
            logger.info(f"step {step_idx + n - 1}/{num_steps} kd_loss={float(loss):.5f}")
            tb.scalars(step_idx + n - 1, {"loss/kd": float(loss)})
        if n > 1:
            ckpt.maybe_save_chunk(step_idx, n, state(), optimizer.state_dict())
        else:
            ckpt.maybe_save(step_idx, state(), optimizer.state_dict())
        step_idx += n
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    time_training = time.perf_counter() - t0
    tb.close()

    restore_f32(student, snapshot)
    student.eval().requires_grad_(True)
    accuracy_final = metrics.calc_accuracy(student, val_pipeline)
    stats = model_stats(student, config.input_h_w, decomposeable=False)

    utils.save_state_dict_pt(utils.state_dict(student), str(output_path / "finetuned_state_dict.pt"))
    with open(output_path / "decompose_config.json", "w") as f:
        json.dump(kept, f)

    summary = {
        "accuracy_initial": accuracy_initial,
        "accuracy_final": accuracy_final,
        "mparams": stats["mparams"],
        "gflops": stats["gflops"],
        "kmapps": stats["kmapps"],
        "n_decomposed": len(kept),
        "n_skipped": len(skipped),
        "time_training": time_training,
        "device": device_name(dev),
    }
    with open(output_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"Summary: {json.dumps(summary, indent=2)}")
