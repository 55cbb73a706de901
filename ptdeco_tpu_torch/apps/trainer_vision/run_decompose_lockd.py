"""The lockd driver: train the channel gates by local distillation, then
decompose.

Counterpart of ``apps/trainer_vision/run_decompose_lockd.py``: every
Linear and groups-1 Conv2d outside the blacklist is wrapped
(``lockd.wrap``), the students and gate logits train with
``nsr_loss + lmbda * proportion_loss`` through the port's
``lockd.train._make_update`` (the model in eval mode, the gates sampled;
the configured optimizer, schedule and clipping, and with ``precision:
bf16`` bf16 compute over f32 masters), then ``lockd.decompose`` keeps
the open channels.  The steps run ``steps_per_dispatch`` at a time
between looks at the losses and the checkpoint, the cadence of the JAX
trainer's compiled chunks: the record of a multiple of 100 (loss, NSR
and proportion losses, per-layer NSR; entropy and per-layer proportions
at the chunk's end) goes to ``metrics.jsonl`` (and TensorBoard), and a
chunk that covers a multiple of ``save_interval_steps`` is checkpointed
at its last step.  Each step's Gumbel noise comes from generators seeded
by the step (``step_ctx``), so a resumed run draws what an unbroken one
would.  Writes ``decompose_config.json``, ``decompose_state_dict.pt``
and ``summary.json`` with the JAX trainer's keys.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Any, Optional

import torch

from ... import lockd, utils
from ...lockd import train as lockd_train
from ...lockd.decomposition import layer_seed
from ...utils.train_ckpt import TrainCheckpointer
from ..trainer_llm.run_decompose_dwain import device_name
from . import builder, configurator, datasets_image, metrics
from .run_decompose_dwain import make_pipelines, model_stats
from .tb_writer import TBWriter

__all__ = ["GUMBEL_SEED", "LOG_EVERY", "f32_snapshot", "main", "restore_f32", "step_ctx"]

logger = logging.getLogger(__name__)

GUMBEL_SEED = 42
LOG_EVERY = 100


def step_ctx(model: torch.nn.Module, step: int) -> lockd.Ctx:
    """The Gumbel streams of training step ``step``: each wrapped layer's
    generator seeded from (``GUMBEL_SEED``, step) and its ``rng_id``."""
    return lockd.Ctx(lockd.make_generators(model, layer_seed(GUMBEL_SEED, step)))


def f32_snapshot(model: torch.nn.Module, keep: dict[str, torch.nn.Parameter]) -> dict[str, Any]:
    """Copies of the model's floating tensors other than ``keep``, taken
    before a bf16 cast so that ``restore_f32`` can put them back."""
    ids = {id(p) for p in keep.values()}
    return {n: t.detach().clone() for n, t in (*model.named_parameters(), *model.named_buffers())
            if id(t) not in ids and t.is_floating_point()}


def restore_f32(model: torch.nn.Module, snapshot: dict[str, torch.Tensor]) -> None:
    """Every tensor of ``snapshot`` back as it was; BatchNorm statistics,
    kept f32 through training, stay as trained."""
    with torch.no_grad():
        for n, t in (*model.named_parameters(), *model.named_buffers()):
            if n in snapshot and t.dtype != snapshot[n].dtype:
                t.data = snapshot[n]


def _log(metrics_log, tb: TBWriter, model, step: int, num_steps: int, loss, nsr_loss,
         prop_loss, nsr_sink) -> None:
    with torch.no_grad():
        rec = {
            "step": step,
            "loss": float(loss),
            "loss_nsr": float(nsr_loss),
            "loss_proportion": float(prop_loss),
            "loss_entropy": float(lockd.get_entropy_loss(model)),
            "per_layer_nsr": {k: float(v) for k, v in nsr_sink.items()},
            "per_layer_p": {k: float(v) for k, v in lockd.get_proportion_dict(model).items()},
        }
    metrics_log.write(json.dumps(rec) + "\n")
    metrics_log.flush()
    tb.scalars(step, {
        "loss/total": rec["loss"], "loss/nsr": rec["loss_nsr"],
        "loss/proportion": rec["loss_proportion"], "loss/entropy": rec["loss_entropy"],
        **{f"nsr/{k}": v for k, v in rec["per_layer_nsr"].items()},
        **{f"proportion/{k}": v for k, v in rec["per_layer_p"].items()},
    })
    logger.info(f"step {step}/{num_steps} loss={rec['loss']:.4f} nsr={rec['loss_nsr']:.4f} "
                f"p={rec['loss_proportion']:.4f}")


def main(config_raw: dict[str, Any], output_path: pathlib.Path, train_pipeline=None,
         val_pipeline=None, device: Optional[str] = None) -> None:
    config = configurator.DecomposeLOCKDConfig.from_dict(config_raw)
    dev = torch.device(device or config.device)
    output_path.mkdir(exist_ok=True, parents=True)

    model = builder.make_model(
        config.decompose_model_name, checkpoint_path=config.decompose_model_checkpoint_path,
        input_h_w=config.input_h_w, device=dev)
    train_pipeline, val_pipeline = make_pipelines(config, model, train_pipeline, val_pipeline)
    builder.validate_module_names(model, config.blacklisted_modules)
    stats_initial = model_stats(model, config.input_h_w, decomposeable=False)

    lockd.wrap(model, seed=0, blacklisted_module_names=config.blacklisted_modules)
    n_wrapped = len(list(lockd.named_wrapped_modules(model)))
    if n_wrapped == 0:
        raise ValueError("lockd wrapped no layers: the model has no Linear / groups==1 "
                         "Conv2d outside the blacklist - nothing to train")
    trainable = dict(lockd.trainable_partition(model))

    steps_per_epoch = max(len(train_pipeline), 1)
    num_steps = configurator.parse_duration(config.max_duration, steps_per_epoch)
    schedule = configurator.get_lr_schedule(config, num_steps, steps_per_epoch)
    optimizer = configurator.get_optimizer(config, list(trainable.values()), schedule(0))
    precision = "bf16" if config.precision == "bf16" else None
    snapshot = f32_snapshot(model, trainable) if precision else {}
    clip = config.alg_gradient_clipping_type
    update = lockd_train._make_update(
        model, optimizer, config.lmbda, config.nsr_threshold, precision=precision,
        clip_norm=config.alg_gradient_clipping_threshold if clip == "norm" else None,
        clip_value=config.alg_gradient_clipping_threshold if clip == "value" else None)

    ckpt = TrainCheckpointer(str(output_path / "checkpoints"), config.save_interval_steps)
    saved, opt_state, start_step = ckpt.restore_or(None, None)
    if saved is not None:
        with torch.no_grad():
            for n, p in trainable.items():
                p.copy_(saved[n])
        optimizer.load_state_dict(opt_state)

    def state():
        return {n: p.detach() for n, p in trainable.items()}

    tb = TBWriter(output_path / "tensorboard", config.tensorboard)
    data_iter = datasets_image.infinite(train_pipeline)
    spd = max(int(config.steps_per_dispatch), 1)
    t0 = time.perf_counter()
    step_idx = start_step
    with open(output_path / "metrics.jsonl", "a") as metrics_log:
        while step_idx < num_steps:
            n = spd if spd > 1 and step_idx + spd <= num_steps else 1
            outs = []
            for j in range(n):
                x = metrics.nchw(next(data_iter)["inputs"], dev)
                outs.append(update(x, step_ctx(model, step_idx + j), lr=schedule(step_idx + j)))
            log_j = next((j for j in range(n) if (step_idx + j) % LOG_EVERY == 0), None)
            if log_j is not None:
                loss, (nsr_loss, prop_loss, nsr_sink) = outs[log_j]
                _log(metrics_log, tb, model, step_idx + log_j, num_steps, loss, nsr_loss,
                     prop_loss, nsr_sink)
            if n > 1:
                ckpt.maybe_save_chunk(step_idx, n, state(), optimizer.state_dict())
            else:
                ckpt.maybe_save(step_idx, state(), optimizer.state_dict())
            step_idx += n
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    time_training = time.perf_counter() - t0
    tb.close()

    restore_f32(model, snapshot)
    model_deco, decompose_config = lockd.decompose(
        model, proportion_threshold=config.proportion_threshold,
        blacklisted_module_names=config.blacklisted_modules)
    model_deco.requires_grad_(True)

    with open(output_path / "decompose_config.json", "w") as f:
        json.dump(decompose_config, f)
    utils.save_state_dict_pt(utils.state_dict(model_deco),
                             str(output_path / "decompose_state_dict.pt"))

    stats_final = model_stats(model_deco, config.input_h_w, decomposeable=False)
    accuracy = metrics.calc_accuracy(model_deco, val_pipeline)

    summary = {
        "accuracy_final": accuracy,
        "n_decomposed": len(decompose_config),
        "mparams_initial": stats_initial["mparams"],
        "mparams_final": stats_final["mparams"],
        "gflops_initial": stats_initial["gflops"],
        "gflops_final": stats_final["gflops"],
        "kmapps_initial": stats_initial["kmapps"],
        "kmapps_final": stats_final["kmapps"],
        "time_training": time_training,
        "device": device_name(dev),
    }
    with open(output_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"Summary: {json.dumps(summary, indent=2)}")
