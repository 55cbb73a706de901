"""DWAIN: iterative whole-model low-rank decomposition, in PyTorch.

Counterpart of ``ptdeco_tpu/dwain/decomposition.py`` (reference
``ptdeco.dwain.decompose_in_place``): sites are processed in reversed
discovery order; each gets a per-site Gram over fresh calibration batches,
a damped float64 eigh, and a geometric rank ladder scored by paired
deco/orig forwards (NSR and perplexity deltas).  An accepted site is
replaced in place by its factor pair, so later sites are calibrated and
scored on the decomposed model, as in the reference.  Acceptance rules,
bookkeeping, meta fields and the decompose_config format match the JAX
package.

Not ported yet (they raise ``NotImplementedError``): interleaved recovery
fine-tuning (``finetune_fn``), precomputing eigenbases in splits, resumable
checkpoints, and eigh methods other than ``"exact"``.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .. import engine, nn as pnn, utils

__all__ = ["decompose", "is_decomposeable_module"]

logger = logging.getLogger(__name__)

is_decomposeable_module = engine.is_decomposeable_module

LossFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _make_metric_fn(loss_fn: LossFn):
    """Per-batch metrics [nsr, exp(loss_deco), exp(loss_orig)] (reference
    _compute_metrics, dwain:247-278): NSR over dims (0, 1)."""

    def metric_fn(batch: Any, y_deco: torch.Tensor, y_orig: torch.Tensor) -> torch.Tensor:
        loss_deco = loss_fn(batch, y_deco)
        loss_orig = loss_fn(batch, y_orig)
        nsr = utils.calc_per_channel_noise_to_signal_ratio(
            x=y_deco, y=y_orig, non_channel_dim=(0, 1)
        )
        return torch.stack([nsr, torch.exp(loss_deco), torch.exp(loss_orig)]).to(torch.float32)

    return metric_fn


def _site_top_k(site: engine.Site, reduction_factor: float) -> int:
    """Largest rank the ladder ever evaluates: the only eigenvectors a dwain
    walk consumes (reference dwain:407-429)."""
    return max(1, int(site.full_rank * reduction_factor))


def _rank_ladder(
    site: engine.Site,
    num_params: int,
    min_rank: int,
    trade_off_factor: float,
    reduction_factor: float,
) -> list[tuple[int, int, float]]:
    """(rank, drop, ppl_threshold) per candidate, with the reference's
    drop == 0 skip (dwain:407-421)."""
    if not 0.0 < reduction_factor < 1.0:
        raise ValueError(
            f"{reduction_factor=} must be in (0, 1): at >=1 the rank ladder "
            "never descends (reference default: 0.5)"
        )
    dim_in, dim_out, full_rank = site.in_features, site.out_features, site.full_rank
    ladder = []
    rank_new = full_rank
    while rank_new > min_rank:
        rank_new = int(rank_new * reduction_factor)
        previous_params = engine.get_params_for_proportion(1.0, dim_in, dim_out)
        current_params = engine.get_params_for_proportion(rank_new / full_rank, dim_in, dim_out)
        drop = previous_params - current_params
        if drop == 0:
            logger.info(f"    {rank_new=} does not lead to params drop, skipping")
            continue
        ladder.append((rank_new, drop, drop / num_params * trade_off_factor))
    return ladder


def _process_module(
    *,
    root: torch.nn.Module,
    site: engine.Site,
    data_iterator: Iterator[Any],
    metric_iterator: Iterator[Any],
    metric_fn,
    apply_fn: engine.ApplyFn,
    nsr_final_threshold: float,
    num_data_steps: int,
    num_metric_steps: int,
    num_params: int,
    min_rank: int,
    trade_off_factor: float,
    reduction_factor: float,
    max_accepted_ppl_diff: float,
    decompose_in_float64: bool,
    device: Any,
) -> dict[str, Any]:
    dim_in, dim_out, full_rank = site.in_features, site.out_features, site.full_rank
    nothing = {
        "proportion": 1.0,
        "nsr_final": 0.0,
        "ppl_final": 0.0,
        "drop_in_params": 0,
        "decomposed_module": None,
    }
    if full_rank == 1:
        logger.info(f"Processing {site.name}: module has rank 1, not decomposing")
        return nothing
    logger.info(f"Processing {site.name}: {site.kind} in={dim_in} out={dim_out} {site.dtype}")

    weight2d = engine.get_site_weight2d(root, site)
    grams = engine.compute_output_grams(
        root, [site.name], data_iterator, num_data_steps, apply_fn, device
    )
    u = engine.eigenvectors_from_gram(
        grams[site.name],
        in_float64=decompose_in_float64,
        top_k=_site_top_k(site, reduction_factor),
    )
    u_dev = u.to(torch.float32)

    ladder = _rank_ladder(site, num_params, min_rank, trade_off_factor, reduction_factor)
    evaluator = engine.CandidateEvaluator(site, apply_fn, metric_fn, device)
    raw = evaluator(
        root, weight2d, u_dev, [r for r, _, _ in ladder], metric_iterator, num_metric_steps
    )  # (C, M, 3): [nsr, ppl_deco, ppl_orig] per batch

    rank_best = full_rank
    nsr_best, ppl_deco_best = 0.0, 0.0
    for i, ((rank_new, drop, ppl_diff_threshold), row) in enumerate(zip(ladder, raw), start=1):
        nsr_new = float(np.mean(row[:, 0]))
        ppl_deco_new = float(np.mean(row[:, 1]))
        ppl_diff_new = float(np.mean((row[:, 1] - row[:, 2]) / row[:, 2]))
        # acceptance rules: reference dwain:460-470
        msg = f"    {i=} rank {rank_new}/{full_rank} {nsr_new=:.6f} {ppl_diff_new=:.6f}"
        if ppl_diff_new >= ppl_diff_threshold:
            logger.info(f"{msg} REJECTED: ppl_diff >= {ppl_diff_threshold=:.4f}")
        elif ppl_diff_new >= max_accepted_ppl_diff:
            logger.info(f"{msg} REJECTED: ppl_diff >= {max_accepted_ppl_diff=:.4f}")
        elif nsr_new >= nsr_final_threshold:
            logger.info(f"{msg} REJECTED: nsr >= {nsr_final_threshold=:.4f}")
        else:
            rank_best, nsr_best, ppl_deco_best = rank_new, nsr_new, ppl_deco_new
            logger.info(f"{msg} ACCEPTED")

    proportion = rank_best / full_rank
    if (
        not ladder
        or rank_best == full_rank
        or not engine.is_num_params_reduced(proportion, dim_in, dim_out)
    ):
        logger.info(f"Processing {site.name}: skipping module decomposition")
        return nothing

    w1, w2 = engine.build_factors(weight2d, u_dev, rank_best)
    new_module = engine.build_decomposed_module(root, site, w1, w2)
    drop_in_params = engine.get_params_for_proportion(
        1.0, dim_in, dim_out
    ) - engine.get_params_for_proportion(proportion, dim_in, dim_out)
    return {
        "proportion": proportion,
        "nsr_final": nsr_best,
        "ppl_final": ppl_deco_best,
        "drop_in_params": drop_in_params,
        "decomposed_module": new_module,
    }


def decompose(
    *,
    module: torch.nn.Module,
    data_iterator: Iterator[Any],
    loss_fn: LossFn,
    num_data_steps: int,
    metric_iterator: Iterator[Any],
    num_metric_steps: int,
    nsr_final_threshold: float,
    finetune_fn: Optional[Callable] = None,
    blacklisted_module_names: Optional[list[str]] = None,
    min_rank: int = 32,
    trade_off_factor: float = 0.5,
    reduction_factor: float = 0.5,
    max_accepted_ppl_diff: float = 0.1,
    decompose_in_float64: bool = True,
    precomputing_covariance_num_splits: Optional[int] = None,
    apply_fn: engine.ApplyFn = engine.default_apply,
    checkpoint_dir: Optional[str] = None,
    eigh_method: str = "exact",
    device: Any = "cuda",
) -> tuple[torch.nn.Module, dict[str, Any]]:
    """Whole-model iterative decomposition on ``device``.

    The module is moved to ``device`` and changed in place; batches from both
    iterators (dicts of tensors or numpy arrays) are moved there as they are
    drawn.  ``loss_fn(batch, logits) -> scalar`` mirrors the reference's
    ``loss_fn(input_dict, output)``.  Returns ``(module, decompose_config)``
    with the reference JSON format and a ``__meta__`` entry per layer."""
    if finetune_fn is not None:
        raise NotImplementedError("interleaved recovery fine-tuning is not ported yet")
    if precomputing_covariance_num_splits:
        raise NotImplementedError("precomputing covariances in splits is not ported yet")
    if checkpoint_dir is not None:
        raise NotImplementedError("resumable decomposition checkpoints are not ported yet")
    if eigh_method != "exact":
        raise NotImplementedError(f"{eigh_method=}: only 'exact' is ported yet")

    start_time = time.perf_counter()
    module.to(device)
    num_params = utils.get_num_params(module)
    current_params = num_params

    modules_to_decompose = engine.get_decomposeable_submodule_names(
        module, blacklisted_module_names
    )
    # drop sites that never fire on a forward; the probe batch is pushed back
    # so the calibration stream is unchanged
    probe_batch = next(data_iterator)
    fired = set(
        engine.fired_site_names(
            module, modules_to_decompose, utils.to_device(probe_batch, device), apply_fn
        )
    )
    data_iterator = itertools.chain([probe_batch], data_iterator)
    modules_to_decompose = [m for m in modules_to_decompose if m in fired]
    n = len(modules_to_decompose)
    logger.info(f"There are {n} linear modules that can be decomposed")

    metric_fn = _make_metric_fn(loss_fn)
    decompose_config: dict[str, Any] = {}
    n_decomposed = 0
    for i, submodule_name in enumerate(reversed(modules_to_decompose), start=1):
        logger.info(f"PROCESSING {submodule_name} MODULE {i} OUT OF {n}")
        result = _process_module(
            root=module,
            site=engine.get_site(module, submodule_name),
            data_iterator=data_iterator,
            metric_iterator=metric_iterator,
            metric_fn=metric_fn,
            apply_fn=apply_fn,
            nsr_final_threshold=nsr_final_threshold,
            num_data_steps=num_data_steps,
            num_metric_steps=num_metric_steps,
            num_params=num_params,
            min_rank=min_rank,
            trade_off_factor=trade_off_factor,
            reduction_factor=reduction_factor,
            max_accepted_ppl_diff=max_accepted_ppl_diff,
            decompose_in_float64=decompose_in_float64,
            device=device,
        )
        current_params -= result["drop_in_params"]
        logger.info(f"CURRENT PARAMS IN M: {current_params / 1e6}")
        pair = result["decomposed_module"]
        if pair is None:
            logger.info(f"{submodule_name} not decomposed")
            continue
        pnn.replace_submodule(module, submodule_name, pair)
        module_config = utils.get_module_config(pair)
        engine.add_meta_to_module_config(module_config, result)
        decompose_config[submodule_name] = module_config
        n_decomposed += 1
        logger.info(f"{submodule_name} decomposed with proportion={result['proportion']:.4f}")

    logger.info(f"Decomposed {n_decomposed} out of {n} modules")
    logger.info(f"Decomposition took {time.perf_counter() - start_time:.1f} seconds")
    return module, decompose_config
