"""decompose_config (de)serialization over ``torch.nn`` modules.

The JSON format is the frozen contract of ``ptdeco_tpu/utils/modconfig.py``
(and of the torch reference it mirrors): the same keys in the same order,
tuples emitted as lists, so ``decompose_config.json`` files are byte for
byte the same from either package.  Conv2d is torch's NCHW module.
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Optional

import torch

from .. import nn as pnn
from . import common

__all__ = [
    "get_module_config",
    "build_module_from_config",
    "apply_decompose_config",
    "MODCONFIG_META_KEY",
]

logger = logging.getLogger(__name__)

MODCONFIG_META_KEY = "__meta__"


def _listify(v: Any) -> Any:
    if isinstance(v, tuple):
        return [int(x) for x in v]
    return v


def get_module_config(m: torch.nn.Module) -> dict[str, Any]:
    if isinstance(m, torch.nn.Sequential):
        return {
            "type": "Sequential",
            "modules": {k: get_module_config(v) for k, v in m.named_children()},
        }
    if isinstance(m, torch.nn.Conv2d):
        return {
            "type": "Conv2d",
            "in_channels": m.in_channels,
            "out_channels": m.out_channels,
            "kernel_size": _listify(m.kernel_size),
            "bias": m.bias is not None,
            "groups": m.groups,
            "padding": _listify(m.padding),
            "padding_mode": m.padding_mode,
            "stride": _listify(m.stride),
            "dilation": _listify(m.dilation),
        }
    if isinstance(m, torch.nn.Linear):
        return {
            "type": "Linear",
            "in_features": m.in_features,
            "out_features": m.out_features,
            "bias": m.bias is not None,
        }
    raise ValueError(f"get_module_config not implemented for {type(m)}")


def _pairify(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return v  # an int, or a str padding like "same"


def build_module_from_config(
    config: dict[str, Any],
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
) -> torch.nn.Module:
    """A zero-filled module of the configured structure."""
    type_ = config.get("type")
    if type_ == "Sequential":
        return torch.nn.Sequential(
            collections.OrderedDict(
                (k, build_module_from_config(v, dtype, device))
                for k, v in config["modules"].items()
            )
        )
    if type_ == "Conv2d":
        m = torch.nn.Conv2d(
            config["in_channels"],
            config["out_channels"],
            kernel_size=_pairify(config["kernel_size"]),
            stride=_pairify(config["stride"]),
            padding=_pairify(config["padding"]),
            dilation=_pairify(config["dilation"]),
            groups=config["groups"],
            bias=config["bias"],
            padding_mode=config.get("padding_mode", "zeros"),
            device=device,
            dtype=dtype,
        )
    elif type_ == "Linear":
        m = torch.nn.Linear(
            config["in_features"],
            config["out_features"],
            bias=config["bias"],
            device=device,
            dtype=dtype,
        )
    else:
        raise ValueError(f"{type_=} not supported")
    with torch.no_grad():
        for p in m.parameters():
            p.zero_()
    return m


def apply_decompose_config(
    module: torch.nn.Module,
    decompose_config: dict[str, Any],
    dtype: Optional[torch.dtype] = None,
) -> torch.nn.Module:
    """Replace, in place, each configured site by a freshly built
    zero-filled module (load a state dict afterwards to fill it), on the
    replaced module's device and, unless ``dtype`` is given, in its dtype."""
    decomposed_counter: collections.Counter[str] = collections.Counter()
    for submodule_name, new_submodule_config in decompose_config.items():
        old = module.get_submodule(submodule_name)
        use_dtype = dtype if dtype is not None else common.get_default_dtype(old)
        device = next(old.parameters()).device
        new = build_module_from_config(new_submodule_config, use_dtype, device)
        pnn.replace_submodule(module, submodule_name, new)
        decomposed_counter[common.get_type_name(old)] += 1
    for submodule_type_name, count in decomposed_counter.items():
        logger.info(f"Decomposed {count} instances of {submodule_type_name}")
    return module
