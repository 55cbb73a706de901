"""Post-hoc LoRA fine-tuning of a decomposed LLM checkpoint.

Counterpart of ``apps/trainer_llm/run_finetune.py``: rebuild the original
model, apply ``decompose_config`` and the state dict, attach LoRA to every
factor pair (rank ``max(site_rank // 32, 8)``, the JAX trainer's rule;
adapter i draws its init from a generator seeded i), train the adapters
alone with AdamW (the config's betas, eps and weight decay) under the
config's schedule, evaluate every ``eval_steps`` with early stopping on the
best eval loss, restore the best adapters, merge, save, and measure the
perplexity before and after.  ``gradient_accumulation_steps`` micro-batches
make one optimizer step (the JAX trainer reads the field but steps on
every batch; the two agree at 1).  Each logged step's loss and learning
rate, and each eval's loss and seconds, are also log records' ``extra``
fields (``train_step``, ``train_loss``, ``train_lr``; ``eval_loss``,
``eval_s``).
"""

from __future__ import annotations

import json
import logging
import math
import pathlib
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ... import finetune as ft
from ... import models, nn as pnn, utils
from . import builder, configurator, datasets_hf, metrics
from .run_decompose_dwain import device_name

__all__ = ["main", "make_schedule"]

logger = logging.getLogger(__name__)


def _lora_targets(model: torch.nn.Module, decompose_config: dict[str, Any]) -> list[tuple[str, int]]:
    """Both factors of every decomposed site, at rank max(rank // 32, 8)."""
    targets = []
    for name in decompose_config.keys():
        rank = pnn.get_submodule(model, f"{name}.0").out_features
        r = max(rank // 32, 8)
        targets.append((f"{name}.0", r))
        targets.append((f"{name}.1", r))
    return targets


def _cosine_warmup_schedule(lr: float, num_steps: int, warmup: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, num_steps) at each
    count: a linear warmup from 0, then a cosine decay to 0 over the rest."""
    decay = num_steps - warmup
    if decay <= 0:
        raise ValueError(f"cosine_with_warmup needs more steps ({num_steps}) than warmup ({warmup})")

    def schedule(count: int) -> float:
        if count < warmup:
            return ft._linear_schedule(0.0, lr, warmup, count)
        t = min(count - warmup, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def make_schedule(config: configurator.FinetuneConfig, num_steps: int) -> Callable[[int], float]:
    """The learning rate of the optimizer step at each count (0-based),
    equal to the JAX trainer's optax schedule."""
    if config.lr_scheduler_type == "cosine_with_warmup":
        return _cosine_warmup_schedule(config.learning_rate, num_steps, config.num_warmup_steps)
    return ft._linear_warmup_schedule(config.learning_rate, num_steps, config.num_warmup_steps)


def _eval_loss(model: torch.nn.Module, loader: datasets_hf.BatchIterator, device) -> float:
    model.eval()
    with torch.no_grad():
        losses = [
            float(models.ce_loss(b, model(b)))
            for b in (utils.to_device(b, device) for b in loader.one_epoch())
        ]
    model.train()
    return float(np.mean(losses)) if losses else float("inf")


def main(
    config_raw: dict[str, Any], output_path: pathlib.Path, device: Optional[str] = None
) -> None:
    config = configurator.FinetuneConfig.from_dict(config_raw)
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
    with open(config.decompose_config) as f:
        decompose_config = json.load(f)
    builder.apply_decompose_config_and_state_dict(
        model, config.decompose_config, config.decompose_state_dict
    )

    def loader(name: str, separator: str, max_length: int, batch_size: int, **kw: Any):
        return datasets_hf.prepare_dataloader_v1(
            dataset=datasets_hf.get_dataset(name), tokenizer=tokenizer, separator=separator,
            max_seqlen=max_length, batch_size=batch_size, **kw,
        )

    train_loader = loader(config.train_data_name, config.train_data_separator,
                          config.train_data_max_length, config.train_data_batch_size,
                          nsamples=config.train_data_n_samples)
    test_loader = loader(config.test_data_name, config.test_data_separator,
                         config.test_data_max_length, config.test_data_batch_size,
                         nsamples=config.test_data_n_samples)
    ppl_loader = loader(config.perplexity_data_name, config.perplexity_data_separator,
                        config.perplexity_data_max_length, config.perplexity_data_batch_size)

    t0 = time.perf_counter()
    ppl_before = metrics.calc_perplexity(model, ppl_loader.one_epoch())

    # LoRA adapters on every factor pair, trained alone
    trainable: dict[str, torch.nn.Parameter] = {}
    for i, (name, r) in enumerate(_lora_targets(model, decompose_config)):
        adapter = ft.LoRALinear.attach(
            torch.Generator().manual_seed(i), pnn.get_submodule(model, name), r,
            alpha=config.lora_alpha, dropout=config.lora_dropout,
        )
        pnn.replace_submodule(model, name, adapter)
        trainable[f"{name}.lora_a"] = adapter.lora_a
        trainable[f"{name}.lora_b"] = adapter.lora_b
    for p in model.parameters():
        p.requires_grad_(False)
    for p in trainable.values():
        p.requires_grad_(True)

    accum = config.gradient_accumulation_steps
    steps_per_epoch = len(train_loader) // accum
    num_steps = steps_per_epoch * config.num_train_epochs
    schedule = make_schedule(config, num_steps)
    opt = torch.optim.AdamW(
        list(trainable.values()), lr=schedule(0),
        betas=(config.adam_beta1, config.adam_beta2), eps=config.adam_epsilon,
        weight_decay=config.weight_decay,
    )

    best_eval = float("inf")
    best_state = {k: p.detach().clone() for k, p in trainable.items()}
    patience = 0
    step = 0
    stop = False
    model.train()
    t_train = time.perf_counter()
    for _ in range(config.num_train_epochs):
        batches = train_loader.one_epoch(shuffle=True)
        for _ in range(steps_per_epoch):
            lr = schedule(step)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.zero_grad(set_to_none=True)
            loss = torch.zeros((), device=dev)
            for _ in range(accum):
                batch = utils.to_device(next(batches), dev)
                micro = models.ce_loss(batch, model(batch)) / accum
                micro.backward()
                loss += micro.detach()
            opt.step()
            if step % config.logging_steps == 0:
                value = float(loss)
                logger.info(f"step {step}/{num_steps} loss={value:.4f}",
                            extra={"train_step": step, "train_loss": value, "train_lr": lr})
            if (step + 1) % config.eval_steps == 0:
                t_eval = time.perf_counter()
                ev = _eval_loss(model, test_loader, dev)
                logger.info(f"eval loss={ev:.4f} (best {best_eval:.4f})",
                            extra={"eval_loss": ev, "eval_s": time.perf_counter() - t_eval})
                if ev < best_eval:
                    best_eval, patience = ev, 0
                    best_state = {k: p.detach().clone() for k, p in trainable.items()}
                else:
                    patience += 1
                    if patience >= config.early_stopping_patience:
                        logger.info("Early stopping")
                        stop = True
                        break
            step += 1
        if stop:
            break
    with torch.no_grad():
        if best_eval < float("inf"):
            for k, p in trainable.items():
                p.copy_(best_state[k])
        model.eval()
        ft.merge_lora(model)
    for p in model.parameters():
        p.requires_grad_(True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    time_finetuning = time.perf_counter() - t_train

    ppl_after = metrics.calc_perplexity(model, ppl_loader.one_epoch())
    utils.save_state_dict_pt(utils.state_dict(model), str(output_path / "finetuned_state_dict.pt"))

    summary = {
        "ppl_before": ppl_before,
        "ppl_after": ppl_after,
        "mparams": metrics.get_params_m(model),
        "time_finetuning": time_finetuning,
        "time_total": time.perf_counter() - t0,
        "steps": step,
        "device": device_name(dev),
    }
    with open(output_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"Summary: {json.dumps(summary, indent=2)}")
