"""Recovery fine-tuning: full (selected factor pairs) and LoRA, in PyTorch.

Counterpart of ``ptdeco_tpu/finetune.py`` (the reference's interleaved
recovery fine-tuning, ``dwain_wrapper_module.py:92-265``):

  * ``finetune_full``: AdamW (weight decay 0.01, torch's default and the
    reference's) on the factor pairs of the last N decomposed modules only,
    linear warmup over 10 steps then linear decay; every other parameter
    is frozen for the run and its ``requires_grad`` restored afterwards.
  * ``finetune_lora``: LoRA adapters on the factor pairs ``{name}.0`` /
    ``{name}.1`` (r 16, alpha 8, dropout 0.05; or r = rank // 16 and
    alpha = rank // 32 with ``use_rank_pattern``), trained alone, then
    merged back into the weights (peft ``merge_and_unload``).

Both train the model in place and return it.  Where the JAX package folds
a ``PRNGKey`` per step and per adapter, the port takes explicit
``torch.Generator`` objects: the draws differ, the distributions do not.
``make_finetune_fn`` builds the ``finetune_fn(module, names)`` closure that
``dwain.decompose`` calls after every accepted site.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from typing import Any, Callable, Iterator, Optional

import torch

from . import engine, nn as pnn
from .utils import common

__all__ = [
    "LoRALinear",
    "finetune_full",
    "finetune_lora",
    "make_finetune_fn",
    "merge_lora",
]

logger = logging.getLogger(__name__)

LossFn = Callable[[Any, torch.Tensor], torch.Tensor]

# the training loop's host reads of the loss, one every this many steps
LOG_EVERY = 10


def _linear_schedule(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule's value at ``count``."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def _linear_warmup_schedule(lr: float, num_steps: int, warmup: int = 10) -> Callable[[int], float]:
    """The learning rate of the update at step ``count`` (0-based):
    optax.join_schedules of a linear warmup from 0 over ``warmup`` steps
    and a linear decay to 0 over ``max(num_steps - warmup, 1)``
    (transformers.get_linear_schedule_with_warmup)."""
    decay = max(num_steps - warmup, 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return _linear_schedule(0.0, lr, warmup, count)
        return _linear_schedule(lr, 0.0, decay, count - warmup)

    return schedule


def _trainable_parameters(
    model: torch.nn.Module, names: list[str]
) -> list[torch.nn.Parameter]:
    """The parameters named, or held by the modules named, each once."""
    by_name = dict(model.named_parameters())
    out: dict[int, torch.nn.Parameter] = {}
    for name in names:
        params = [by_name[name]] if name in by_name else pnn.get_submodule(model, name).parameters()
        for p in params:
            out[id(p)] = p
    return list(out.values())


def _run_training(
    model: torch.nn.Module,
    trainable_names: list[str],
    ft_iterator: Iterator[Any],
    loss_fn: LossFn,
    apply_fn: engine.ApplyFn,
    num_steps: int,
    lr: float,
    generator: Optional[torch.Generator],
) -> torch.nn.Module:
    """AdamW on the named parameters only, the warmup schedule set per step.
    With a ``generator`` the model trains in train mode, the global RNG
    (torch's dropout layers) seeded from it for the run; without one, in
    eval mode.  Modes and ``requires_grad`` flags are restored after."""
    params = _trainable_parameters(model, trainable_names)
    chosen = {id(p) for p in params}
    flags = [(p, p.requires_grad) for p in model.parameters()]
    modes = [(m, m.training) for m in model.modules()]
    schedule = _linear_warmup_schedule(lr, num_steps)
    device = params[0].device if params else torch.device("cpu")
    rng = contextlib.nullcontext()
    if generator is not None:
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        cuda = [torch.cuda.current_device() if device.index is None else device.index] \
            if device.type == "cuda" else []
        rng = torch.random.fork_rng(devices=cuda)
    try:
        for p, _ in flags:
            p.requires_grad_(id(p) in chosen)
        model.train(generator is not None)
        opt = torch.optim.AdamW(params, lr=schedule(0), weight_decay=0.01)
        with rng:
            if generator is not None:
                torch.manual_seed(seed)
            for i in range(num_steps):
                batch = common.to_device(next(ft_iterator), device)
                for group in opt.param_groups:
                    group["lr"] = schedule(i)
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(batch, apply_fn(model, batch))
                loss.backward()
                opt.step()
                # host-sync only at the log interval: reading the loss each
                # step would serialize the host with the device
                if i % LOG_EVERY == 0:
                    logger.info(f"Step: {i}/{num_steps}, loss: {float(loss.detach()):.5f}")
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
            p.grad = None
        for m, mode in modes:
            m.training = mode
    return model


def finetune_full(
    *,
    model: torch.nn.Module,
    ft_iterator: Iterator[Any],
    decomposed_modules: list[str],
    loss_fn: LossFn,
    apply_fn: engine.ApplyFn = engine.default_apply,
    num_last_modules_to_finetune: int = 8,
    num_steps: int = 100,
    lr: float = 1e-4,
    generator: Optional[torch.Generator] = None,
) -> torch.nn.Module:
    """Reference finetune_full (dwain_wrapper_module.py:92-147): the last
    ``num_last_modules_to_finetune`` decomposed modules train, in train
    mode (``generator``, by default one seeded 0, stands in for the JAX
    package's ``PRNGKey(0)``)."""
    if len(decomposed_modules) == 0 or num_last_modules_to_finetune <= 0:
        logger.info("Skipping full fine-tuning - nothing selected")
        return model
    start = time.perf_counter()
    # NB lst[-0:] == whole list: the <= 0 guard above is load-bearing
    to_ft = decomposed_modules[-num_last_modules_to_finetune:]
    for name in to_ft:
        logger.info(f"full fine-tuning - training {name}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = _run_training(model, to_ft, ft_iterator, loss_fn, apply_fn, num_steps, lr, generator)
    logger.info(f"Full fine-tuning took {time.perf_counter() - start:.2f} seconds")
    return model


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


class LoRALinear(torch.nn.Module):
    """A Linear with a low-rank residual adapter:
    ``y = base(x) + scale * (dropout(x) @ Aᵀ) @ Bᵀ``.

    peft's layout, init (A uniform in ±1/sqrt(in), B zeros, scale =
    alpha / r) and merge (W <- W + scale * B @ A, reference merge_and_unload
    at dwain_wrapper_module.py:261).  A (r, in) and B (out, r) are kept in
    f32 and cast to x's dtype; dropout draws from the adapter's own
    ``generator`` in train mode."""

    def __init__(
        self,
        base: torch.nn.Linear,
        lora_a: torch.Tensor,
        lora_b: torch.Tensor,
        scale: float,
        dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.base = base
        self.lora_a = torch.nn.Parameter(lora_a.to(torch.float32))
        self.lora_b = torch.nn.Parameter(lora_b.to(torch.float32))
        self.scale = scale
        self.dropout = dropout
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        xd = x
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
            xd = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        delta = (xd @ self.lora_a.to(x.dtype).t()) @ self.lora_b.to(x.dtype).t()
        return y + self.scale * delta

    @staticmethod
    def attach(
        generator: torch.Generator,
        base: torch.nn.Linear,
        r: int,
        alpha: float,
        dropout: float = 0.05,
    ) -> "LoRALinear":
        """An adapter on ``base``: A drawn from ``generator`` (on its
        device), B zeros; the dropout generator, on the base's device, is
        seeded from the next draw of ``generator``."""
        bound = 1.0 / math.sqrt(base.in_features)
        gen_device = generator.device
        lora_a = torch.empty(r, base.in_features, dtype=torch.float32, device=gen_device)
        lora_a.uniform_(-bound, bound, generator=generator)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=gen_device))
        device = base.weight.device
        return LoRALinear(
            base,
            lora_a.to(device),
            torch.zeros(base.out_features, r, dtype=torch.float32, device=device),
            scale=alpha / r,
            dropout=dropout,
            generator=torch.Generator(device=device).manual_seed(seed),
        )

    @torch.no_grad()
    def merge(self) -> torch.nn.Linear:
        """The base Linear with the adapter added to its weight in f32 and
        cast to the weight's dtype (in place)."""
        w = self.base.weight
        delta = (self.lora_b @ self.lora_a) * self.scale  # (out, in)
        w.copy_((w.to(torch.float32) + delta).to(w.dtype))
        return self.base


def merge_lora(model: torch.nn.Module) -> torch.nn.Module:
    """Merge and remove every LoRALinear in the model (in place)."""
    for name, m in list(model.named_modules()):
        if isinstance(m, LoRALinear):
            pnn.replace_submodule(model, name, m.merge())
    return model


def finetune_lora(
    *,
    model: torch.nn.Module,
    ft_iterator: Iterator[Any],
    decomposed_modules: list[str],
    loss_fn: LossFn,
    apply_fn: engine.ApplyFn = engine.default_apply,
    num_last_modules_to_finetune: int = 8,
    num_steps: int = 100,
    lr: float = 1e-4,
    min_rank_to_finetune: int = 32,
    use_rank_pattern: bool = False,
    lora_r: int = 16,
    lora_alpha: float = 8.0,
    lora_dropout: float = 0.05,
    generator: Optional[torch.Generator] = None,
) -> torch.nn.Module:
    """Reference finetune_lora (dwain_wrapper_module.py:150-265): adapters on
    the factor pairs of the last N decomposed modules whose rank is at least
    ``min_rank_to_finetune``, merged back after training.  Adapter i draws
    its init and dropout from a generator seeded ``seed + i`` (``seed`` one
    draw of ``generator``, by default one seeded 0), as the JAX package
    folds adapter i's id into its key."""
    if len(decomposed_modules) == 0 or num_last_modules_to_finetune <= 0:
        logger.info("Skipping lora fine-tuning - nothing selected")
        return model  # NB lst[-0:] == whole list; the guard is load-bearing
    start = time.perf_counter()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))

    to_ft = decomposed_modules[-num_last_modules_to_finetune:]
    targets: list[tuple[str, int]] = []  # (factor module name, rank)
    for module_name in to_ft:
        first, second = f"{module_name}.0", f"{module_name}.1"
        rank = pnn.get_submodule(model, first).out_features
        if rank >= min_rank_to_finetune:
            targets.extend([(first, rank), (second, rank)])
            logger.info(f"{module_name} fine-tuning - {rank=}")
        else:
            logger.info(f"{module_name} skipping - {rank=} {min_rank_to_finetune=}")

    if not targets:
        logger.info("Skipping lora fine-tuning - no modules of sufficient rank")
        return model

    for rng_id, (name, rank) in enumerate(targets):
        r = rank // 16 if use_rank_pattern else lora_r
        alpha = rank // 32 if use_rank_pattern else lora_alpha
        adapter_gen = torch.Generator().manual_seed(seed + rng_id)
        base = pnn.get_submodule(model, name)
        pnn.replace_submodule(
            model, name, LoRALinear.attach(adapter_gen, base, r, alpha, lora_dropout)
        )

    # train only the adapters
    names = [f"{n}.lora_a" for n, _ in targets] + [f"{n}.lora_b" for n, _ in targets]
    train_gen = torch.Generator().manual_seed(seed + len(targets))
    try:
        _run_training(model, names, ft_iterator, loss_fn, apply_fn, num_steps, lr, train_gen)
    finally:
        merge_lora(model)
    logger.info(f"Lora fine-tuning took {time.perf_counter() - start:.2f} seconds")
    return model


def make_finetune_fn(
    mode: str,
    ft_iterator: Iterator[Any],
    loss_fn: LossFn,
    **kwargs: Any,
) -> Callable[[torch.nn.Module, list[str]], torch.nn.Module]:
    """The ``finetune_fn(module, decomposed_names)`` closure that
    ``dwain.decompose`` expects, for mode "full", "lora" or "none"
    (reference run_decompose_dwain.py:101-133)."""
    if mode == "full":
        def fn(module: torch.nn.Module, names: list[str]) -> torch.nn.Module:
            return finetune_full(model=module, ft_iterator=ft_iterator,
                                 decomposed_modules=names, loss_fn=loss_fn, **kwargs)
    elif mode == "lora":
        def fn(module: torch.nn.Module, names: list[str]) -> torch.nn.Module:
            return finetune_lora(model=module, ft_iterator=ft_iterator,
                                 decomposed_modules=names, loss_fn=loss_fn, **kwargs)
    elif mode == "none":
        def fn(module: torch.nn.Module, names: list[str]) -> torch.nn.Module:
            return module
    else:
        raise ValueError(f"Unknown finetune mode {mode!r}")
    return fn
