"""Vision model builder and model statistics.

Counterpart of ``apps/trainer_vision/builder.py`` for the families the
port has: ``_ZOO`` names ResNet-18/34/50/101, ConvNeXt-Tiny / -Small /
-V2-Tiny, SwinV2-Tiny / -Small, Swin-Tiny and EfficientFormerV2-S0 / -S1
under the JAX trainer's (timm-style) names; any other name of the JAX
zoo raises ``NotImplementedError`` naming the ROADMAP.md item it waits
for.  ``make_model`` builds on ``device`` (``channels_last`` on the
card) with seeded weights, then loads a ``.pt`` or ``.safetensors``
state dict in the model's own layout, as the JAX trainer's artifacts and
its ``utils.state_dict`` export hold it; a checkpoint in a layout the JAX
builder translates (timm / official Swin and EfficientFormer names) and
a checkpoint directory (an HF snapshot) are refused by name: their
translators and ``build_from_hf_snapshot`` are not ported yet.

Statistics: where the JAX trainer reads XLA's cost analysis, ``gflops``
counts the forward's matrix products and convolutions with
``FlopCounterMode`` on the meta device (the LLM trainer's
``get_giga_flops``), so XLA's elementwise operations are left out;
``get_fpops_dict`` counts every Linear's and Conv2d's MACs analytically
(fvcore's count), as the JAX builder does.  ``mparams`` counts
parameters only; the JAX count also takes in Swin's float tables
(relative coordinates, shift masks), which are buffers here.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import pathlib
from typing import Any, Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ... import engine, models, utils

__all__ = [
    "get_decomposeable_model_stats",
    "get_fpops_dict",
    "get_model_stats",
    "infer_num_classes",
    "log_decomposeable_inventory",
    "log_state_dict_keys_stats",
    "make_model",
    "register_model",
    "validate_module_names",
]

logger = logging.getLogger(__name__)

_ZOO: dict[str, Callable[..., torch.nn.Module]] = {
    "resnet18": models.resnet18,
    "resnet34": models.resnet34,
    "resnet50": models.resnet50,
    "resnet101": models.resnet101,
    "convnext_tiny": models.convnext_tiny,
    "convnext_small": models.convnext_small,
    "convnextv2_tiny": models.convnextv2_tiny,
    "swinv2_tiny_patch4_window7_224": models.swinv2_tiny,
    "swinv2_small_patch4_window7_224": models.swinv2_small,
    "swin_tiny_patch4_window7_224": models.swin_tiny,
    "efficientformerv2_s0": models.efficientformerv2_s0,
    "efficientformerv2_s1": models.efficientformerv2_s1,
}

# the JAX trainer's other names, by the ROADMAP.md item they wait for
_NOT_PORTED = {
    name: "ROADMAP.md Queue 1 item 8 (the vision zoo's long tail)"
    for name in ("regnety_004", "mobilenetv2_100", "mobilenetv2_tiny", "efficientnet_b0",
                 "vit_tiny_patch16_224", "deit_small_distilled_patch16_224", "dinov2_small",
                 "vit_small_patch16_224", "vit_base_patch16_224", "swinv2_cr_tiny_ns_224",
                 "swinv2_cr_small_ns_224")
}


def register_model(name: str, factory: Callable[..., torch.nn.Module]) -> None:
    """``factory(num_classes=..., [image_size=...,] device=..., generator=...)``."""
    _ZOO[name] = factory


def _needs_translation(model_name: str, sd: dict[str, Any]) -> Optional[str]:
    """The JAX builder's translator a checkpoint would need, if any."""
    if model_name.startswith("efficientformerv2_") and any(
            k.startswith(("stem.conv1.", "patch_embed.0.")) for k in sd):
        return "translate_timm_efficientformerv2_state_dict"
    if model_name.startswith(("swinv2_", "swin_")) and any(
            "cpb_mlp" in k or "q_bias" in k for k in sd):
        return "translate_official_state_dict"
    return None


def make_model(
    model_name: str,
    num_classes: int = 1000,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    input_h_w: Optional[tuple[int, int]] = None,
    device: Any = "cuda",
) -> torch.nn.Module:
    """The named model on ``device`` in eval mode, weights from ``seed``
    or the checkpoint.  Swin and EfficientFormer are built at the
    (square) input size, as their windows and bias tables are static."""
    for prefix in ("ptdeco_tpu_torch.", "ptdeco_tpu."):
        model_name = model_name.removeprefix(prefix)
    if checkpoint_path is not None and pathlib.Path(checkpoint_path).is_dir():
        raise NotImplementedError(
            f"{checkpoint_path} is a directory (an HF snapshot): build_from_hf_snapshot "
            "waits for ROADMAP.md Queue 1 item 8")
    if model_name in _NOT_PORTED:
        raise NotImplementedError(f"{model_name!r} is not ported yet: {_NOT_PORTED[model_name]}")
    if model_name not in _ZOO:
        raise ValueError(f"Unknown model {model_name!r}; known: {sorted(_ZOO)}")
    factory = _ZOO[model_name]
    kwargs: dict[str, Any] = {"num_classes": num_classes}
    if input_h_w is not None and "image_size" in inspect.signature(factory).parameters:
        h, w = input_h_w
        if h != w:
            raise ValueError(f"{model_name} requires square inputs, got {input_h_w}")
        kwargs["image_size"] = h
    sd = None
    if checkpoint_path is not None:
        if checkpoint_path.endswith(".safetensors"):
            sd = utils.load_state_dict_safetensors(checkpoint_path)
        else:
            sd = utils.load_state_dict_pt(checkpoint_path)
        translator = _needs_translation(model_name, sd)
        if translator is not None:
            raise NotImplementedError(
                f"{checkpoint_path} is in a layout the JAX builder translates ({translator}); "
                "the translators wait for ROADMAP.md Queue 1 item 8")
    dev = torch.device(device)
    model = factory(**kwargs, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    if sd is not None:
        log_state_dict_keys_stats("make_model:", model, sd)
        utils.load_state_dict(model, sd, strict=False)
        logger.info(f"Loaded weights from {checkpoint_path}")
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    log_decomposeable_inventory(model)
    return model.eval()


def log_decomposeable_inventory(model: torch.nn.Module) -> None:
    names = engine.get_decomposeable_submodule_names(model)
    msgs = [f"There are {len(names)} modules that can be decomposed:"]
    msgs += [f"  {i}. {n}" for i, n in enumerate(names, 1)]
    logger.info("\n".join(msgs))


def _meta_call(model: torch.nn.Module, b_h_w_c: tuple[int, int, int, int],
               counter: Any = None) -> torch.Tensor:
    """A forward on the meta device with the model's tensors swapped for
    meta ones: shapes only, nothing computed or allocated."""
    b, h, w, c = b_h_w_c
    meta = {name: torch.empty_like(t, device="meta")
            for name, t in [*model.named_parameters(), *model.named_buffers()]}
    x = torch.empty((b, c, h, w), device="meta", dtype=utils.get_default_dtype(model))
    with torch.no_grad(), counter or contextlib.nullcontext():
        return torch.func.functional_call(model, meta, (x,))


def infer_num_classes(model: torch.nn.Module, input_h_w: tuple[int, int]) -> int:
    """The class count of a built model, from its output's shape."""
    return int(_meta_call(model, (1, *input_h_w, 3)).shape[-1])


def get_model_stats(model: torch.nn.Module, b_h_w_c: tuple[int, int, int, int]) -> dict[str, float]:
    """mparams, gflops a sample and kmapps (kilo-MACs a pixel, FLOPs = 2 MACs)."""
    counter = FlopCounterMode(display=False)
    _meta_call(model, b_h_w_c, counter)
    flops = counter.get_total_flops() / b_h_w_c[0]
    return {
        "mparams": utils.get_num_params(model) / 1e6,
        "gflops": flops / 1e9,
        "kmapps": flops / 2.0 / (b_h_w_c[1] * b_h_w_c[2]) / 1.0e3,
    }


def _module_macs(m: torch.nn.Module, in_shape: tuple, out_shape: tuple) -> float:
    """fvcore's MAC count of a Linear or a Conv2d."""
    if isinstance(m, torch.nn.Linear):
        rows = 1.0
        for d in in_shape[:-1]:
            rows *= d
        return rows * m.in_features * m.out_features
    n, _, oh, ow = out_shape
    kh, kw = m.kernel_size
    return n * oh * ow * m.out_channels * m.in_channels * kh * kw / m.groups


def get_fpops_dict(model: torch.nn.Module, b_h_w_c: tuple[int, int, int, int],
                   units: str = "gflops") -> dict[str, float]:
    """Forward fpops of every module, fvcore's ``by_module``: each Linear's
    and Conv2d's MACs from its shapes in one meta forward, summed into
    every ancestor ('' is the whole model)."""
    macs: dict[str, float] = {}
    handles = []
    for name, m in model.named_modules():
        if name and isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            def hook(mod, args, out, name=name):
                macs[name] = macs.get(name, 0.0) + _module_macs(
                    mod, tuple(args[0].shape), tuple(out.shape)) / b_h_w_c[0]
            handles.append(m.register_forward_hook(hook))
    try:
        _meta_call(model, b_h_w_c)
    finally:
        for hd in handles:
            hd.remove()
    per_module = {name: 0.0 for name, _ in model.named_modules()}
    for leaf, v in macs.items():
        parts = leaf.split(".")
        per_module[""] += v
        for i in range(1, len(parts) + 1):
            key = ".".join(parts[:i])
            per_module[key] = per_module.get(key, 0.0) + v
    if units.lower() == "gflops":
        factor = 2.0 / 1.0e9
    elif units.lower() == "kmapps":
        factor = 1.0 / (b_h_w_c[1] * b_h_w_c[2]) / 1024.0
    else:
        raise ValueError(f"Unknown {units=}")
    return {k: v * factor for k, v in per_module.items()}


def get_decomposeable_model_stats(model: torch.nn.Module,
                                  b_h_w_c: tuple[int, int, int, int]) -> dict[str, float]:
    """GFLOPs and Mparams of the decomposeable modules."""
    fpops = get_fpops_dict(model, b_h_w_c, units="gflops")
    gflops, params = 0.0, 0
    for name, m in model.named_modules():
        if name and engine.is_decomposeable_module(m):
            gflops += fpops.get(name, 0.0)
            params += utils.get_num_params(m)
    return {"gflops_decomposeable": gflops, "mparams_decomposeable": params / 1.0e6}


def log_state_dict_keys_stats(log_prefix: str, model: torch.nn.Module,
                              state_dict: dict[str, Any]) -> int:
    """The overlap of a model's keys and a loaded state dict's."""
    model_keys = set(model.state_dict().keys())
    loaded_keys = set(state_dict.keys())
    n_common = len(model_keys & loaded_keys)
    logger.info(f"{log_prefix} num_model_sd_keys={len(model_keys)}, "
                f"num_loaded_sd_keys={len(loaded_keys)}, num_common_sd_keys={n_common}")
    return n_common


def validate_module_names(model: torch.nn.Module, names: Optional[list[str]]) -> None:
    """Fail fast on a blacklist entry that names no module."""
    if names is None:
        return
    known = {name for name, _ in model.named_modules()}
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(f"Unknown module names: {unknown}")
