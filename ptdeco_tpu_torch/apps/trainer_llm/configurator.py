"""Config schemas of the LLM trainer, as dataclasses.

Counterpart of ``apps/trainer_llm/configurator.py``: the same field names,
defaults and ``Literal`` values, validated without pydantic.
``from_dict`` raises a ``ValueError`` that names the key for an unknown key
(pydantic's ``extra="forbid"``) and for a missing required field; every
field is checked against its annotation (an int is accepted for a float,
an integral float for an int); ``decomposed_model_dtype`` must match
``DTYPES_PATTERN``.

Options the port does not have yet are accepted at their single-device
values and refused otherwise with ``NotImplementedError``: the mesh keys
(``parallel/``, ROADMAP.md Queue 1 item 7) and ``use_pallas_gram=False``
(on the card every bf16 Gram of width >= 512 takes the SYRK kernel; the
switch is one of the options the ROADMAP.md Queue 1 preamble defers).
``device`` is the port's own field: the card unless it says ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import re
import types
import typing
from typing import Any, Literal, Optional, Union

__all__ = ["DTYPES_PATTERN", "DecomposeDWAINConfig", "FinetuneConfig", "GenerateConfig"]

DTYPES_PATTERN = r"^float32$|^bfloat16$|^float16$"

_MESH_TODO = "the port of parallel/ (ROADMAP.md Queue 1 item 7)"


def _coerce(owner: str, name: str, value: Any, tp: Any) -> Any:
    """``value`` checked against the annotation ``tp`` (and an int made a
    float, an integral float an int); raises ValueError naming the field."""
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if tp is Any:
        return value
    if origin in (Union, types.UnionType):
        for arm in args:
            try:
                return _coerce(owner, name, value, arm)
            except ValueError:
                continue
    elif origin is Literal:
        if value in args:
            return value
    elif origin is list:
        if isinstance(value, (list, tuple)):
            return [_coerce(owner, name, v, args[0]) for v in value]
    elif origin is dict:
        if isinstance(value, dict):
            return dict(value)
    elif tp is type(None):
        if value is None:
            return None
    elif tp is bool:
        if isinstance(value, bool):
            return value
    elif tp is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
    elif tp is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
    elif tp is str:
        if isinstance(value, str):
            return value
    raise ValueError(f"{owner}: field {name!r}: {value!r} is not a valid {tp}")


class _Schema:
    """Annotation checks on construction; ``from_dict`` for raw mappings."""

    def __post_init__(self) -> None:
        owner = type(self).__name__
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            setattr(self, f.name, _coerce(owner, f.name, getattr(self, f.name), hints[f.name]))
        dtype = getattr(self, "decomposed_model_dtype", None)
        if dtype is not None and not re.match(DTYPES_PATTERN, dtype):
            raise ValueError(
                f"{owner}: field 'decomposed_model_dtype': {dtype!r} does not match "
                f"{DTYPES_PATTERN!r}"
            )
        self._check_single_device()

    def _check_single_device(self) -> None:
        for key in ("mesh_tp", "mesh_sp", "mesh_ep", "mesh_pp"):
            if getattr(self, key, 1) != 1:
                raise NotImplementedError(f"{key}={getattr(self, key)} needs {_MESH_TODO}")
        for key in ("mesh_dp", "pp_microbatches"):
            if getattr(self, key, None) not in (None, 1):
                raise NotImplementedError(f"{key}={getattr(self, key)} needs {_MESH_TODO}")

    @classmethod
    def from_dict(cls, raw: dict[str, Any]):
        owner = cls.__name__
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - set(fields))
        if unknown:
            raise ValueError(f"{owner}: extra fields not permitted: {unknown}")
        missing = sorted(
            n for n, f in fields.items()
            if n not in raw and f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        )
        if missing:
            raise ValueError(f"{owner}: missing required fields: {missing}")
        return cls(**raw)


@dataclasses.dataclass(kw_only=True)
class _VersionConfig(_Schema):
    ptdeco_trainer_llm_version: Optional[str] = None
    ptdeco_tpu_version: Optional[str] = None
    device: Literal["cuda", "cpu"] = "cuda"


@dataclasses.dataclass(kw_only=True)
class DecomposeDWAINConfig(_VersionConfig):
    task: Literal["decompose_dwain"]

    # Model specification
    decomposed_model_name: str
    # local HF snapshot dir (config.json + weights); None = random init
    decomposed_model_checkpoint_path: Optional[str] = None
    decomposed_model_revision: str = "main"
    decomposed_model_custom_builder_path: Optional[str] = None
    decomposed_model_custom_builder_config: Optional[dict[str, Any]] = None
    decomposed_model_dtype: str
    # per-block torch.utils.checkpoint (HF gradient checkpointing)
    decomposed_model_enable_gradient_checkpointing: bool = False

    # Tokenizer and data handling params
    decomposition_data_name: Union[str, list[str]]
    decomposition_data_separator: str
    decomposition_data_max_length: int
    decomposition_data_batch_size: int

    perplexity_data_name: str
    perplexity_data_separator: str
    perplexity_data_max_length: int
    perplexity_data_batch_size: int

    # Decomposition params
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
    # per-site resume state; a relative path resolves under the output dir
    decomposition_checkpoint_dir: Optional[str] = "decompose_ckpt"
    precomputing_covariance_num_splits: Optional[int] = None
    blacklisted_modules: list[str]

    # Finetuning params
    finetuning_run: bool
    finetuning_use_lora: bool
    finetuning_lora_min_rank: int = 32
    finetuning_lr: float = 0.0001
    finetuning_num_steps: int = 100
    finetuning_num_last_finetuned_modules: int = 8
    finetuning_use_rank_pattern: bool = False

    # lm_eval evaluation params
    lm_eval_initial: bool = False
    lm_eval_tasks: Optional[list[str]] = None

    # Mesh: single device only (see the module docstring)
    mesh_dp: Optional[int] = None
    mesh_tp: int = 1
    mesh_sp: int = 1

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.use_pallas_gram is False:
            raise NotImplementedError(
                "use_pallas_gram=False: the port takes the SYRK kernel for every bf16 Gram "
                "on the card; the switch is deferred (ROADMAP.md Queue 1 preamble)"
            )


@dataclasses.dataclass(kw_only=True)
class GenerateConfig(_VersionConfig):
    """Serve a (decomposed) causal LM: batched KV-cache generation from a
    prompts file or inline prompts."""

    task: Literal["generate"]

    decomposed_model_name: str
    decomposed_model_checkpoint_path: Optional[str] = None
    decomposed_model_revision: str = "main"
    decomposed_model_custom_builder_path: Optional[str] = None
    decomposed_model_custom_builder_config: Optional[dict[str, Any]] = None
    decomposed_model_dtype: str
    # None = serve the original model (a baseline)
    decompose_config: Optional[str] = None
    decompose_state_dict: Optional[str] = None

    # one of: a .jsonl file ({"text": ...} rows), a plain-text file (one
    # prompt per line), or inline prompts
    prompts_file: Optional[str] = None
    prompts: Optional[list[str]] = None

    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: Optional[float] = None  # nucleus sampling (with temperature > 0)
    top_k: Optional[int] = None  # top-k sampling (with temperature > 0)
    min_p: Optional[float] = None  # drop tokens below min_p * max prob
    repetition_penalty: Optional[float] = None  # HF processor semantics
    num_beams: int = 1  # > 1: deterministic beam search (temperature 0)
    length_penalty: float = 1.0  # beam ranking: score / len**penalty
    quantize_int8: bool = False  # weight-only int8 serving form
    # speculative decoding: serve the original model with the decomposed
    # artifact (decompose_config / state_dict) as the draft; the output is
    # exactly the original's greedy continuation.  Needs temperature 0 and
    # num_beams 1
    speculative: bool = False
    speculative_k: int = 4  # draft tokens per round
    # time the speculative loop against plain decode on the device first,
    # once, and serve plain decode if drafting does not pay
    speculative_auto_gate: bool = True
    batch_size: int = 8
    max_prompt_length: Optional[int] = None
    stop_at_eos: bool = True
    seed: int = 0


@dataclasses.dataclass(kw_only=True)
class FinetuneConfig(_VersionConfig):
    task: Literal["finetune"]

    decomposed_model_name: str
    decomposed_model_checkpoint_path: Optional[str] = None
    decomposed_model_revision: str = "main"
    decomposed_model_custom_builder_path: Optional[str] = None
    decomposed_model_custom_builder_config: Optional[dict[str, Any]] = None
    decomposed_model_dtype: str
    decomposed_model_enable_gradient_checkpointing: bool = False
    decompose_config: str
    decompose_state_dict: str

    perplexity_data_name: str
    perplexity_data_separator: str
    perplexity_data_max_length: int
    perplexity_data_batch_size: int

    train_data_name: str
    train_data_separator: str
    train_data_max_length: int
    train_data_batch_size: int
    train_data_n_samples: int

    test_data_name: str
    test_data_separator: str
    test_data_max_length: int
    test_data_batch_size: int
    test_data_n_samples: int

    num_train_epochs: int
    finetune_only_decomposed: bool = True
    eval_steps: int = 100
    logging_steps: int = 10
    early_stopping_patience: int = 3
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    lr_scheduler_type: Literal["linear_with_warmup", "cosine_with_warmup"] = (
        "linear_with_warmup"
    )
    num_warmup_steps: int = 10
    gradient_accumulation_steps: int = 1
    lora_r: int = 16
    lora_alpha: int = 8
    lora_dropout: float = 0.05

    lm_eval_initial: bool = False
    lm_eval_tasks: Optional[list[str]] = None

    # Mesh: single device only (see the module docstring)
    mesh_dp: Optional[int] = None
    mesh_tp: int = 1
    mesh_ep: int = 1
    mesh_pp: int = 1
    pp_microbatches: Optional[int] = None
