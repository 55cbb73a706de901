"""Decomposition engine of the dwain policy, in PyTorch.

Counterpart of ``ptdeco_tpu/engine.py``.  It computes what the JAX engine
computes, in eager PyTorch:

  * **Site discovery**: Linear, or 1x1 Conv2d with groups == 1, that fires
    on a forward pass.
  * **Gram accumulation**: a forward pre-hook on the site captures its input
    x and accumulates ``E[y yᵀ]`` of the bias-free site output
    ``y = x @ Wᵀ``.  bf16 activations with d >= 512 on the card compute y in
    bf16 and take the SYRK kernel; every other site computes y and its Gram
    with f32 matmuls (``ops.gram.should_use_syrk``).
  * **Eigendecomposition**: damped ``eigh`` in float64, where the Gram lives
    (the card has native f64); ascending order, top eigenvectors last.
  * **Rank candidates**: the candidate weight ``(u_k u_kᵀ) W`` is swapped
    into the site's parameter for the deco forward and swapped back for the
    orig forward; candidates are scored over fresh metric batches drawn
    candidate-major, the reference's iterator order.
  * **Factors**: ``W ≈ W2 @ W1`` with ``W1 = u_kᵀ W`` (r, in) and
    ``W2 = u_k`` (out, r), as a ``Sequential`` pair, the bias on the second.

The JAX engine's XLA machinery (scan chunking, dispatch counting, the
Gram-defer budget, shape-shared compiled ladders) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from . import nn as pnn
from .ops.gram import should_use_syrk, syrk_gram
from .utils import common, modconfig

logger = logging.getLogger(__name__)

EIGEN_DAMPEN_FACTOR = 0.01  # reference dwain/decomposition.py:14

ApplyFn = Callable[[torch.nn.Module, Any], torch.Tensor]


def default_apply(root: torch.nn.Module, batch: Any) -> torch.Tensor:
    return root(batch)


# ---------------------------------------------------------------------------
# Site discovery
# ---------------------------------------------------------------------------


def is_decomposeable_module(module: Any) -> bool:
    """Linear, or 1x1 Conv2d with groups==1 (reference dwain:540-546)."""
    if isinstance(module, torch.nn.Linear):
        return True
    if isinstance(module, torch.nn.Conv2d):
        return module.kernel_size == (1, 1) and module.groups == 1
    return False


def get_decomposeable_submodule_names(
    root: torch.nn.Module, blacklisted_module_names: Optional[list[str]] = None
) -> list[str]:
    blacklist = set(blacklisted_module_names or [])
    res = []
    for name, mod in pnn.named_modules(root):
        if name and is_decomposeable_module(mod):
            if name in blacklist:
                logger.info(f"Skipping blacklisted module {name}")
            else:
                res.append(name)
    return res


@dataclasses.dataclass(frozen=True)
class Site:
    name: str
    kind: str  # "linear" | "conv2d1x1"
    in_features: int
    out_features: int
    has_bias: bool
    dtype: torch.dtype

    @property
    def full_rank(self) -> int:
        return min(self.in_features, self.out_features)


def get_site(root: torch.nn.Module, name: str) -> Site:
    m = pnn.get_submodule(root, name)
    if isinstance(m, torch.nn.Linear):
        return Site(name, "linear", m.in_features, m.out_features, m.bias is not None, m.weight.dtype)
    if is_decomposeable_module(m):
        return Site(
            name, "conv2d1x1", m.in_channels, m.out_channels, m.bias is not None, m.weight.dtype
        )
    raise ValueError(f"Cannot decompose {name}={m!r}")


def get_site_weight2d(root: torch.nn.Module, site: Site) -> torch.Tensor:
    """The (out, in) matrix of a site (a 1x1 conv's kernel squeezed)."""
    w = pnn.get_submodule(root, site.name).weight.detach()
    return w.reshape(site.out_features, site.in_features)


def _site_rows(site: Site, x: torch.Tensor) -> torch.Tensor:
    """The site input as (rows, in_features); NCHW channels moved last."""
    if site.kind == "conv2d1x1":
        x = x.movedim(1, -1)
    return x.reshape(-1, x.shape[-1])


def fired_site_names(
    root: torch.nn.Module,
    site_names: list[str],
    example_batch: Any,
    apply_fn: ApplyFn = default_apply,
) -> list[str]:
    """The subset of ``site_names`` whose modules fire on a forward pass of
    ``example_batch`` (a module that never runs cannot be calibrated)."""
    fired: set[str] = set()
    handles = [
        pnn.get_submodule(root, n).register_forward_pre_hook(
            lambda mod, args, n=n: fired.add(n)
        )
        for n in site_names
    ]
    try:
        with torch.no_grad():
            apply_fn(root, example_batch)
    finally:
        for h in handles:
            h.remove()
    return [n for n in site_names if n in fired]


# ---------------------------------------------------------------------------
# Gram accumulation
# ---------------------------------------------------------------------------


def _site_gram(site: Site, weight2d: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``Yᵀ Y`` (f32) of the bias-free site output y = x @ Wᵀ."""
    w = weight2d.to(x2.dtype)
    if should_use_syrk(x2.dtype, site.out_features, x2.is_cuda):
        # y in the activation dtype, as the forward computes it; the kernel
        # accumulates the Gram in f32
        return syrk_gram(x2 @ w.t())
    y = x2.to(torch.float32) @ w.to(torch.float32).t()
    return y.t() @ y


def compute_output_grams(
    root: torch.nn.Module,
    site_names: list[str],
    data_iterator: Iterator[Any],
    num_data_steps: int,
    apply_fn: ApplyFn = default_apply,
    device: Any = "cuda",
) -> dict[str, torch.Tensor]:
    """Run ``num_data_steps`` calibration batches and return per-site
    ``E[y yᵀ]`` (f32, on ``device``), already divided by the step count."""
    sites = {n: get_site(root, n) for n in site_names}
    grams = {
        n: torch.zeros((s.out_features, s.out_features), dtype=torch.float32, device=device)
        for n, s in sites.items()
    }

    def make_hook(name: str):
        site = sites[name]

        def hook(mod: torch.nn.Module, args: tuple) -> None:
            x2 = _site_rows(site, args[0])
            w = mod.weight.detach().reshape(site.out_features, site.in_features)
            grams[name] += _site_gram(site, w, x2) / x2.shape[0]

        return hook

    handles = [
        pnn.get_submodule(root, n).register_forward_pre_hook(make_hook(n))
        for n in site_names
    ]
    try:
        with torch.no_grad():
            for _ in range(num_data_steps):
                apply_fn(root, common.to_device(next(data_iterator), device))
    finally:
        for h in handles:
            h.remove()
    return {n: g / num_data_steps for n, g in grams.items()}


# ---------------------------------------------------------------------------
# Eigendecomposition
# ---------------------------------------------------------------------------


def eigenvectors_from_gram(
    gram: torch.Tensor,
    *,
    in_float64: bool = True,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """Eigenvectors of E[y yᵀ] damped by ``EIGEN_DAMPEN_FACTOR`` times its
    mean diagonal, in ascending eigenvalue order: the top-k are the LAST k
    columns.  It runs on the Gram's device.  With ``in_float64`` and
    ``0 < top_k <= d/4`` only the top ``top_k`` eigenvectors are returned,
    (d, top_k), as the JAX package's subset solve does."""
    g = gram.to(torch.float64 if in_float64 else torch.float32)
    d = g.shape[-1]
    damp = EIGEN_DAMPEN_FACTOR * torch.mean(torch.diagonal(g))
    _, u = torch.linalg.eigh(g + damp * torch.eye(d, dtype=g.dtype, device=g.device))
    if in_float64 and top_k is not None and 0 < top_k <= d // 4:
        return u[:, d - top_k :]
    return u


# ---------------------------------------------------------------------------
# Candidates and factors
# ---------------------------------------------------------------------------


def compose_deco_kernel(
    weight2d: torch.Tensor, u: torch.Tensor, rank: int
) -> torch.Tensor:
    """Candidate weight ``(u_k u_kᵀ) W`` keeping the top-``rank`` eigvecs, in
    f32 and cast back to the weight's dtype (the JAX ``K @ (u_k u_kᵀ)`` in
    torch's (out, in) layout)."""
    uk = u[:, u.shape[1] - rank :].to(torch.float32)
    proj = uk @ uk.t()
    return (proj @ weight2d.to(torch.float32)).to(weight2d.dtype)


def build_factors(
    weight2d: torch.Tensor, u: torch.Tensor, rank: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Factors at the accepted rank: ``W1 = u_kᵀ W`` (rank, in) and
    ``W2 = u_k`` (out, rank), so that ``y = (x @ W1ᵀ) @ W2ᵀ (+ b)``."""
    uk = u[:, u.shape[1] - rank :].to(torch.float32)
    w1 = uk.t() @ weight2d.to(torch.float32)
    return w1.to(weight2d.dtype).contiguous(), uk.to(weight2d.dtype).contiguous()


def build_decomposed_module(
    root: torch.nn.Module, site: Site, w1: torch.Tensor, w2: torch.Tensor
) -> torch.nn.Sequential:
    """Sequential factor pair in the reference's layout: the first factor
    bias-free, the original bias on the second.  A strided 1x1 conv keeps
    its stride/padding/dilation on the FIRST factor (the reference drops
    them, which breaks strided downsamples)."""
    m = pnn.get_submodule(root, site.name)
    rank = w1.shape[0]
    if site.kind == "linear":
        first = torch.nn.Linear(site.in_features, rank, bias=False, device="meta")
        second = torch.nn.Linear(rank, site.out_features, bias=site.has_bias, device="meta")
    else:
        first = torch.nn.Conv2d(
            site.in_features, rank, 1, stride=m.stride, padding=m.padding,
            dilation=m.dilation, padding_mode=m.padding_mode, bias=False, device="meta",
        )
        second = torch.nn.Conv2d(rank, site.out_features, 1, bias=site.has_bias, device="meta")
        w1, w2 = w1[:, :, None, None], w2[:, :, None, None]
    first.weight = torch.nn.Parameter(w1)
    second.weight = torch.nn.Parameter(w2)
    if site.has_bias:
        second.bias = torch.nn.Parameter(m.bias.detach().clone())
    return torch.nn.Sequential(first, second)


class CandidateEvaluator:
    """Scores rank candidates of one site: for each candidate, fresh metric
    batches (drawn candidate-major, the reference's exact iterator order,
    dwain:435-448), a deco forward with the candidate weight swapped into
    the site and an orig forward with the weight restored.  Returns the raw
    per-(candidate, batch) metrics as a (C, M, K) float32 array."""

    def __init__(self, site: Site, apply_fn: ApplyFn, metric_fn, device: Any = "cuda") -> None:
        self.site = site
        self.apply_fn = apply_fn
        self.metric_fn = metric_fn
        self.device = device

    @torch.no_grad()
    def __call__(
        self,
        root: torch.nn.Module,
        weight2d: torch.Tensor,
        u: torch.Tensor,
        ranks: list[int],
        metric_iterator: Iterator[Any],
        num_metric_steps: int,
    ) -> np.ndarray:
        c, m = len(ranks), num_metric_steps
        if c == 0 or m == 0:
            return np.zeros((c, m, 0), np.float32)
        all_batches = [[next(metric_iterator) for _ in range(m)] for _ in range(c)]
        param = pnn.get_submodule(root, self.site.name).weight
        orig = param.data
        rows = []
        for rank, cand_batches in zip(ranks, all_batches):
            deco = compose_deco_kernel(weight2d, u, rank).reshape(orig.shape)
            per_batch = []
            for batch in cand_batches:
                batch = common.to_device(batch, self.device)
                param.data = deco
                try:
                    y_deco = self.apply_fn(root, batch)
                finally:
                    param.data = orig
                y_orig = self.apply_fn(root, batch)
                per_batch.append(self.metric_fn(batch, y_deco, y_orig))
            rows.append(torch.stack(per_batch))
        return torch.stack(rows).to(torch.float32).cpu().numpy()


# ---------------------------------------------------------------------------
# Parameter-count bookkeeping (reference dwain:319-330, :569-577)
# ---------------------------------------------------------------------------


def get_params_for_proportion(
    proportion: float, in_features: int, out_features: int
) -> int:
    baseline = in_features * out_features
    original_rank = min(in_features, out_features)
    proposed = (in_features + out_features) * proportion * original_rank
    if proposed < baseline:
        return int(proposed)
    return baseline


def is_num_params_reduced(
    proportion: float, in_features: int, out_features: int
) -> bool:
    baseline = in_features * out_features
    original_rank = min(in_features, out_features)
    proposed = (in_features + out_features) * proportion * original_rank
    return proposed < baseline


def add_meta_to_module_config(
    module_config: dict[str, Any], module_deco_results: dict[str, Any]
) -> None:
    meta = {k: v for k, v in module_deco_results.items() if k != "decomposed_module"}
    module_config[modconfig.MODCONFIG_META_KEY] = meta
