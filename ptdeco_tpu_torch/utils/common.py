"""General helpers (PyTorch counterparts of ``ptdeco_tpu/utils/common.py``)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "to_device",
    "get_num_params",
    "get_type_name",
    "split_module_parent_child_name",
    "get_default_dtype",
]


def to_device(o: Any, device: Any) -> Any:
    """Move a tensor (or numpy array), or a dict of them, to ``device``.
    Other dict values pass through unchanged."""

    def put(v: Any) -> Any:
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return v

    if isinstance(o, dict):
        return {k: put(v) for k, v in o.items()}
    return put(o)


def get_num_params(module: torch.nn.Module) -> int:
    """Floating-point parameter count; ``parameters()`` yields a shared
    (tied) parameter once."""
    return int(sum(p.numel() for p in module.parameters() if torch.is_floating_point(p)))


def get_type_name(o: Any) -> str:
    to = type(o)
    return to.__module__ + "." + to.__name__


def split_module_parent_child_name(target: str) -> tuple[str, str]:
    *parent, name = target.rsplit(".", 1)
    return parent[0] if parent else "", name


def get_default_dtype(module: torch.nn.Module) -> torch.dtype:
    for p in module.parameters():
        if torch.is_floating_point(p):
            return p.dtype
    return torch.float32
