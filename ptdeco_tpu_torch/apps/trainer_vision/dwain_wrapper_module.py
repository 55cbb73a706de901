"""The vision dwain adapter: a batch-dict -> logits wrapper, the CE loss,
and recovery fine-tuning with the loss-reverting safeguard.

Counterpart of ``apps/trainer_vision/dwain_wrapper_module.py``:
``WrapperModule`` takes ``{"inputs": NHWC, "targets": one-hot}`` batches
(the image becomes NCHW by a permuted view); ``finetune_full`` trains the
last N decomposed pairs at a constant rate with SGD, Adam or AdamW
(weight decay 0.01), BatchNorms on their running statistics (eval mode)
or on batch statistics (train mode, running statistics updated), and
restores the whole state it started from when the mean loss of the last
``num_log_steps`` steps ends above ``REVERTING_FACTOR`` times that of the
first.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Iterator

import torch

from ... import nn as pnn, utils

__all__ = ["REVERTING_FACTOR", "WrapperModule", "add_prefix", "ce_loss", "finetune_full",
           "strip_prefix_dict"]

logger = logging.getLogger(__name__)

REVERTING_FACTOR = 1.2


class WrapperModule(torch.nn.Module):
    """Adapts an NCHW image model to dict batches of NHWC images."""

    def __init__(self, raw_model: torch.nn.Module) -> None:
        super().__init__()
        self.raw_model = raw_model

    def forward(self, batch: Any) -> torch.Tensor:
        x = batch["inputs"] if isinstance(batch, dict) else batch
        return self.raw_model(x.permute(0, 3, 1, 2))


def ce_loss(batch: dict[str, torch.Tensor], output: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against one-hot targets, in f32."""
    logp = torch.log_softmax(output.to(torch.float32), dim=-1)
    return -torch.mean(torch.sum(batch["targets"] * logp, dim=-1))


def add_prefix(module_names: list[str]) -> list[str]:
    return ["raw_model." + n for n in module_names]


def strip_prefix_dict(d: dict[str, Any]) -> dict[str, Any]:
    prefix = "raw_model."
    return {k.removeprefix(prefix): v for k, v in d.items()}


def _optimizer(name: str, params: list[torch.nn.Parameter], lr: float) -> torch.optim.Optimizer:
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr)
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr)
    return torch.optim.AdamW(params, lr=lr, weight_decay=0.01)


def finetune_full(
    *,
    model: torch.nn.Module,
    ft_iterator: Iterator[dict[str, Any]],
    decomposed_modules: list[str],
    num_last_modules_to_finetune: int = 8,
    num_steps: int = 100,
    num_log_steps: int = 10,
    lr: float = 0.0001,
    optimizer: str = "AdamW",
    use_reverting: bool = True,
    batch_norms_in_eval: bool = True,
) -> torch.nn.Module:
    """Full fine-tuning of the last N decomposed pairs of ``model`` (in
    place; it is returned).  The snapshot a revert restores is held in
    device memory."""
    if len(decomposed_modules) == 0 or num_last_modules_to_finetune <= 0:
        logger.info("Skipping full fine-tuning - nothing selected")
        return model  # NB lst[-0:] == whole list; the guard is load-bearing
    start = time.perf_counter()
    to_ft = decomposed_modules[-num_last_modules_to_finetune:]
    params = list({id(p): p for name in to_ft
                   for p in pnn.get_submodule(model, name).parameters()}.values())
    device = params[0].device
    # the whole state: a revert also rolls back BatchNorm statistics
    snapshot = ({k: v.detach().clone() for k, v in model.state_dict().items()}
                if use_reverting else None)
    chosen = {id(p) for p in params}
    flags = [(p, p.requires_grad) for p in model.parameters()]
    modes = [(m, m.training) for m in model.modules()]
    opt = _optimizer(optimizer, params, lr)
    losses: list[torch.Tensor] = []
    try:
        for p, _ in flags:
            p.requires_grad_(id(p) in chosen)
        model.train(not batch_norms_in_eval)
        for i in range(num_steps):
            batch = utils.to_device(next(ft_iterator), device)
            opt.zero_grad(set_to_none=True)
            loss = ce_loss(batch, model(batch))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if i % num_log_steps == 0:
                logger.info(f"Step: {i}/{num_steps}, loss: {float(loss.detach()):.4f}")
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
            p.grad = None
        for m, mode in modes:
            m.training = mode
    # window means: single batches' CE noise would trigger or mask reverts
    values = [float(v) for v in losses]
    k = max(1, min(num_log_steps, len(values)))
    if use_reverting and values:
        initial, final = sum(values[:k]) / k, sum(values[-k:]) / k
        if final > REVERTING_FACTOR * initial:
            logger.warning(f"Reverting fine-tuning: final {final:.4f} > "
                           f"{REVERTING_FACTOR} x initial {initial:.4f}")
            model.load_state_dict(snapshot)
    logger.info(f"Full fine-tuning took {time.perf_counter() - start:.2f} s")
    return model
