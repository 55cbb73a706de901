"""Config schemas and factories of the vision trainer.

Counterpart of ``apps/trainer_vision/configurator.py``: the five schemas
with the same field names, defaults and ``Literal`` values, validated
without pydantic by the LLM trainer's ``_Schema`` (an unknown key, a
missing field or a mistyped value raises a ``ValueError`` naming it), and
the factories: ``parse_duration`` ("Nep" / "Nba"), the learning-rate
schedules (optax's ``warmup_cosine_decay_schedule`` and the fixed one
after a linear warmup, as functions of the step), the optimizers (SGD,
Adam, AdamW with torch's weight decay 0.01) with their gradient clipping,
and ``bf16_compute``: bf16 compute over f32 masters.

As in the LLM configurator, options the port does not have yet are
refused with ``NotImplementedError``: ``mesh_dp`` other than None or 1
(the port of ``parallel/``) and ``use_pallas_gram: false`` (on the card
every bf16 Gram of width >= 512 takes the SYRK kernel).
``steps_per_dispatch`` is accepted: the drivers run that many steps
between looks at the losses and the checkpoint, as the JAX trainer's
compiled chunks do.  ``device`` is the port's own field: the card unless
it says ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from typing import Callable, Iterable, Literal, Optional

import torch

from ..trainer_llm.configurator import _Schema

__all__ = [
    "DecomposeDWAINConfig",
    "DecomposeFALORConfig",
    "DecomposeLOCKDConfig",
    "FinetuneConfig",
    "bf16_compute",
    "clip_gradients",
    "get_lr_schedule",
    "get_optimizer",
    "parse_duration",
]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(kw_only=True)
class _VersionConfig(_Schema):
    ptdeco_trainer_version: Optional[str] = None
    ptdeco_tpu_version: Optional[str] = None
    device: Literal["cuda", "cpu"] = "cuda"


@dataclasses.dataclass(kw_only=True)
class _DataConfig(_Schema):
    imagenet_root_dir: str
    trn_imagenet_classes_fname: str
    val_imagenet_classes_fname: str
    batch_size: int
    normalization: Literal["zero_to_one", "negative_one_to_one", "imagenet", "identity"]
    input_h_w: list[int]
    # the optional train-time rotation (a coin flip, +-30 degrees)
    use_rotation: bool = False

    def __post_init__(self) -> None:
        super().__post_init__()
        if len(self.input_h_w) != 2:
            raise ValueError(f"{type(self).__name__}: field 'input_h_w': {self.input_h_w!r} "
                             "is not a pair")
        self.input_h_w = tuple(self.input_h_w)


@dataclasses.dataclass(kw_only=True)
class _TrainConfig(_Schema):
    finetune_only_decomposed: bool = True
    lr: float
    lr_t_warmup: str
    lr_scheduler: Literal["cosine", "fixed"]
    max_duration: str
    optimizer: Literal["SGD", "Adam", "AdamW"]
    precision: Optional[Literal["fp32", "bf16"]] = None
    alg_gradient_clipping_type: Optional[Literal["norm", "value"]] = None
    alg_gradient_clipping_threshold: Optional[float] = None
    # single device only (see the module docstring)
    mesh_dp: Optional[int] = None
    # mirror the per-layer scalars into tensorboard event files
    tensorboard: bool = False
    # autoresume every this many steps; 0 disables
    save_interval_steps: int = 0


@dataclasses.dataclass(kw_only=True)
class DecomposeLOCKDConfig(_TrainConfig, _DataConfig, _VersionConfig):
    task: Literal["decompose_lockd"]
    decompose_model_name: str
    decompose_model_checkpoint_path: Optional[str] = None
    proportion_threshold: float
    blacklisted_modules: list[str]
    lmbda: float
    nsr_threshold: float
    # steps between looks at the losses and the checkpoint
    steps_per_dispatch: int = 8


@dataclasses.dataclass(kw_only=True)
class DecomposeFALORConfig(_DataConfig, _VersionConfig):
    task: Literal["decompose_falor"]
    decompose_model_name: str
    decompose_model_checkpoint_path: Optional[str] = None
    proportion_threshold: float
    blacklisted_modules: list[str]
    kl_final_threshold: float
    nsr_final_threshold: float
    num_data_steps: int
    num_metric_steps: int
    use_float64: bool
    decomposition_checkpoint_dir: Optional[str] = "decompose_ckpt"


@dataclasses.dataclass(kw_only=True)
class DecomposeDWAINConfig(_DataConfig, _VersionConfig):
    task: Literal["decompose_dwain"]
    decompose_model_name: str
    decompose_model_checkpoint_path: Optional[str] = None

    num_data_steps: int
    num_metric_steps: int
    trade_off_factor: float
    reduction_factor: float
    max_accepted_ppl_diff: float
    nsr_final_threshold: float
    min_rank: int
    decompose_in_float64: bool
    # None and True: the SYRK kernel takes every bf16 Gram on the card
    use_pallas_gram: Optional[bool] = None
    eigh_method: str = "auto"
    decomposition_checkpoint_dir: Optional[str] = "decompose_ckpt"
    precomputing_covariance_num_splits: Optional[int] = None
    blacklisted_modules: list[str]

    finetuning_run: bool
    finetuning_lr: float
    finetuning_optimizer: Literal["SGD", "Adam", "AdamW"]
    finetuning_reverting: bool
    finetuning_batch_norms_in_eval: bool
    finetuning_num_steps: int
    finetuning_num_log_steps: int
    finetuning_num_last_finetuned_modules: int

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.use_pallas_gram is False:
            raise NotImplementedError(
                "use_pallas_gram=False: the port takes the SYRK kernel for every bf16 Gram "
                "on the card; the switch is deferred (ROADMAP.md Queue 1 preamble)"
            )


@dataclasses.dataclass(kw_only=True)
class FinetuneConfig(_TrainConfig, _DataConfig, _VersionConfig):
    task: Literal["finetune"]
    decompose_model_name: str
    decompose_model_checkpoint_path: Optional[str] = None
    decompose_config: str
    decompose_state_dict: str
    proportion_threshold: float = 1.0
    blacklisted_modules: list[str]
    # the student trains in train mode (BatchNorm on batch statistics,
    # running statistics updated); True keeps it on its running statistics
    finetune_eval_mode: bool = False
    # steps between looks at the loss and the checkpoint
    steps_per_dispatch: int = 8


# -- factories -----------------------------------------------------------------


def parse_duration(duration: str, steps_per_epoch: int) -> int:
    """'10ep' / '500ba' -> number of steps."""
    m = re.fullmatch(r"(\d+)(ep|ba)", duration)
    if not m:
        raise ValueError(f"Bad duration {duration!r}")
    n, unit = int(m.group(1)), m.group(2)
    return n * steps_per_epoch if unit == "ep" else n


def get_lr_schedule(config: _TrainConfig, num_steps: int,
                    steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of the update at step ``count`` (0-based), equal to
    the JAX trainer's optax schedule: a linear warmup from 0 over the
    warmup steps, then a cosine decay to 0 at ``max(num_steps, warmup +
    1)`` ("cosine"), or the configured rate ("fixed")."""
    warmup = parse_duration(config.lr_t_warmup, steps_per_epoch)
    lr = config.lr

    def ramp(count: int) -> float:
        return lr * count / warmup

    if config.lr_scheduler == "cosine":
        logger.info(f"Using cosine lr schedule, warmup={warmup}")
        decay = max(num_steps, warmup + 1) - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return ramp(count)
            t = min(count - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return cosine
    logger.info(f"Using fixed lr schedule, warmup={warmup}")
    return lambda count: ramp(count) if count < warmup else lr


def get_optimizer(config: _TrainConfig, params: Iterable[torch.nn.Parameter],
                  lr: float) -> torch.optim.Optimizer:
    """SGD, Adam, or AdamW with torch's default weight decay 0.01 (the JAX
    trainer sets optax's to it); ``clip_gradients`` applies the configured
    clipping before each step."""
    logger.info(f"Using optimizer {config.optimizer}")
    if config.optimizer == "Adam":
        return torch.optim.Adam(params, lr=lr)
    if config.optimizer == "AdamW":
        return torch.optim.AdamW(params, lr=lr, weight_decay=0.01)
    if config.optimizer == "SGD":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"Unknown optimizer {config.optimizer}")


def clip_gradients(config: _TrainConfig, params: list[torch.nn.Parameter]) -> None:
    """optax's ``clip_by_global_norm`` or ``clip`` by value, in place."""
    kind, threshold = config.alg_gradient_clipping_type, config.alg_gradient_clipping_threshold
    if kind is None:
        return
    if threshold is None:
        raise ValueError(f"alg_gradient_clipping_type={kind!r} needs a threshold")
    if kind == "norm":
        torch.nn.utils.clip_grad_norm_(params, threshold)
    else:
        torch.nn.utils.clip_grad_value_(params, threshold)


def bf16_compute(model: torch.nn.Module, masters: dict[str, torch.nn.Parameter],
                 precision: Optional[str]) -> Callable[[], dict[str, torch.Tensor]]:
    """Mixed precision as ``precision: bf16`` sets it (the JAX trainer casts
    every f32 leaf for the forward and keeps f32 masters in the optimizer):
    in place, the ``masters`` are f32 and every other floating parameter
    and buffer bf16, but for BatchNorm layers, which stay f32 (their
    running statistics are updated in f32 as the JAX trainer's are).
    Returns a function giving the tensors a forward substitutes for the
    masters (``torch.func.functional_call``): bf16 copies, BatchNorm's
    f32 parameters as they are.  For fp32 / None nothing is cast and the
    masters are returned as they are."""
    if precision != "bf16":
        return lambda: masters
    ids = {id(p) for p in masters.values()}
    keep = {id(t) for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for t in (*m.parameters(recurse=False), *m.buffers(recurse=False))}
    with torch.no_grad():
        for p in masters.values():
            p.data = p.data.to(torch.float32)
        for t in (*model.parameters(), *model.buffers()):
            if id(t) not in ids and id(t) not in keep and t.is_floating_point():
                t.data = t.data.to(torch.bfloat16)
    cast = {n for n, p in masters.items() if id(p) not in keep}
    return lambda: {n: p.to(torch.bfloat16) if n in cast else p for n, p in masters.items()}
