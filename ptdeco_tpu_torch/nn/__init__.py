"""Thin module-surgery helpers over ``torch.nn`` (counterparts of
``ptdeco_tpu/nn/module.py``).  Unlike the JAX package's pure pytree
functions, ``replace_submodule`` changes the model in place."""

from __future__ import annotations

from typing import Iterator

import torch

__all__ = [
    "get_submodule",
    "replace_submodule",
    "named_modules",
    "FusedLowRankLinear",
    "fuse_factor_pairs",
    "unfuse_factor_pairs",
]


def get_submodule(root: torch.nn.Module, name: str) -> torch.nn.Module:
    return root.get_submodule(name) if name else root


def replace_submodule(
    root: torch.nn.Module, name: str, new: torch.nn.Module
) -> torch.nn.Module:
    """Set the submodule at dotted ``name`` to ``new`` (in place); returns
    ``root`` for chaining."""
    parent_name, _, child = name.rpartition(".")
    setattr(get_submodule(root, parent_name), child, new)
    return root


def named_modules(root: torch.nn.Module) -> Iterator[tuple[str, torch.nn.Module]]:
    """``(dotted_name, module)`` in registration order, root first as ''."""
    return root.named_modules()


from .fuse import FusedLowRankLinear, fuse_factor_pairs, unfuse_factor_pairs  # noqa: E402
