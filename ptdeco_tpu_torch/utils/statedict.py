"""Torch-format state dicts and their on-disk formats.

The artifact is the reference's ``decompose_state_dict.pt``: torch layouts
and torch naming (``{site}.0.weight`` ...), which ``torch.nn`` modules
already have, so no layout conversion is needed here.  ``safetensors`` is
optional: it is imported only inside its own save/load functions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "state_dict",
    "load_state_dict",
    "load_numpy_state_dict",
    "save_state_dict_pt",
    "load_state_dict_pt",
    "save_state_dict_safetensors",
    "load_state_dict_safetensors",
]


def state_dict(root: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Flat ``{dotted_name: tensor}`` copy on the CPU."""
    return {k: v.detach().cpu() for k, v in root.state_dict().items()}


def load_state_dict(
    root: torch.nn.Module, sd: dict[str, torch.Tensor], strict: bool = True
) -> torch.nn.Module:
    """Copy ``sd`` into the module in place (casting to each parameter's
    dtype and device).  With strict=True every parameter must be present and
    every key consumed."""
    root.load_state_dict(sd, strict=strict)
    return root


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16, as the JAX package exports it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def load_numpy_state_dict(
    root: torch.nn.Module, sd: dict[str, np.ndarray], strict: bool = True
) -> torch.nn.Module:
    """Load parameters given as numpy arrays in torch layout and HF names,
    e.g. ``ptdeco_tpu.utils.state_dict(model)`` of the JAX twin."""
    return load_state_dict(root, {k: _from_numpy(v) for k, v in sd.items()}, strict)


def save_state_dict_pt(sd: dict[str, Any], path: str) -> None:
    """``torch.save`` of CPU tensors; numpy values are converted."""
    out = {}
    for k, v in sd.items():
        t = _from_numpy(v) if isinstance(v, np.ndarray) else v.detach().cpu()
        out[k] = t.contiguous()
    torch.save(out, path)


def load_state_dict_pt(path: str) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_state_dict_safetensors(sd: dict[str, torch.Tensor], path: str) -> None:
    from safetensors.torch import save_file

    save_file({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)


def load_state_dict_safetensors(path: str) -> dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return load_file(path)
