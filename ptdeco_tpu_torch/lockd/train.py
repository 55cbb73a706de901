"""The lockd gate-training step.

Counterpart of ``apps/trainer_vision/run_decompose_lockd.py:_make_update``
with ``configurator.get_optimizer`` and ``configurator.bf16_compute``
(reference ``run_decompose_lockd.py:58-64``): the loss is
``nsr_loss + lmbda * proportion_loss`` over a forward of the wrapped model
in eval mode (BatchNorm on its running statistics) whose gates sample;
only the students and the gate logits train, with AdamW (weight decay
0.01) or Adam, the gradients clipped by their global norm first.  The
vision trainer's lockd task (``apps/trainer_vision/run_decompose_lockd``)
runs its steps through it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from .decomposition import Ctx, bind, calc_propotion_from_logits, named_wrapped_modules
from .decomposition import trainable_partition
from .losses import get_nsr_loss

__all__ = ["get_optimizer", "bf16_compute", "_make_update"]


def get_optimizer(params: Iterable[torch.nn.Parameter], optimizer: str = "AdamW",
                  lr: float = 1e-3) -> torch.optim.Optimizer:
    """``configurator.get_optimizer``'s Adam and AdamW; AdamW with torch's
    default weight decay, 0.01, as the JAX package sets optax's."""
    if optimizer == "Adam":
        return torch.optim.Adam(params, lr=lr)
    if optimizer == "AdamW":
        return torch.optim.AdamW(params, lr=lr, weight_decay=0.01)
    raise ValueError(f"Unknown optimizer {optimizer}")


def bf16_compute(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Mixed precision as ``configurator.bf16_compute`` sets it, in place:
    the trainable parameters become f32 masters, every other floating
    parameter and buffer (the teachers, BatchNorm) bf16.  Returns the
    masters by name; a step's forward sees bf16 copies of them."""
    masters = dict(trainable_partition(model))
    ids = {id(p) for p in masters.values()}
    with torch.no_grad():
        for p in masters.values():
            p.data = p.data.to(torch.float32)
        for t in list(model.parameters()) + list(model.buffers()):
            if id(t) not in ids and t.is_floating_point():
                t.data = t.data.to(torch.bfloat16)
    return masters


def _make_update(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    lmbda: float,
    nsr_threshold: float,
    precision: Optional[str] = None,
    clip_norm: Optional[float] = 1.0,
    clip_value: Optional[float] = None,
) -> Callable[..., tuple[torch.Tensor, tuple]]:
    """The gate-training update of ``model`` (wrapped) in place.

    ``update(inputs, ctx, lr=None)`` runs the forward under ``ctx`` (its
    generators or noise sample the gates), takes one optimizer step (at
    ``lr`` when given) and returns ``(loss, (nsr_loss, proportion_loss,
    nsr_sink))``, detached.  With ``precision`` "bf16" the model is cast
    by ``bf16_compute`` and the forward, the proportion loss included,
    sees bf16 copies of the f32 masters, as the JAX step's
    ``bf16_compute(nn.combine(trainable, frozen))`` does.  Parameters that
    do not train are frozen (``requires_grad`` False).  The gradients are
    clipped to a global norm of ``clip_norm`` unless it is None, and each
    to +-``clip_value`` when that is given (optax's ``clip``)."""
    if precision not in (None, "bf16"):
        raise ValueError(f"precision {precision!r} not in (None, 'bf16')")
    bf16 = precision == "bf16"
    masters = bf16_compute(model) if bf16 else dict(trainable_partition(model))
    ids = {id(p) for p in masters.values()}
    for p in model.parameters():
        p.requires_grad_(id(p) in ids)
    logit_names = [f"{n}.logits" for n, _ in named_wrapped_modules(model)]
    params = list(masters.values())

    def update(inputs: torch.Tensor, ctx: Ctx, lr: Optional[float] = None):
        model.eval()
        compute = {n: p.to(torch.bfloat16) for n, p in masters.items()} if bf16 else masters
        if bf16 and inputs.dtype == torch.float32:
            inputs = inputs.to(torch.bfloat16)
        with bind(model, ctx):
            torch.func.functional_call(model, compute, (inputs,))
        nsr_loss = get_nsr_loss(ctx.sink, nsr_threshold)
        proportion_loss = torch.stack(
            [calc_propotion_from_logits(compute[n]) for n in logit_names]).mean()
        loss = nsr_loss + lmbda * proportion_loss
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if clip_norm is not None:
            torch.nn.utils.clip_grad_norm_(params, clip_norm)
        if clip_value is not None:
            torch.nn.utils.clip_grad_value_(params, clip_value)
        if lr is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        sink = {k: v.detach() for k, v in ctx.sink.items()}
        return loss.detach(), (nsr_loss.detach(), proportion_loss.detach(), sink)

    return update
