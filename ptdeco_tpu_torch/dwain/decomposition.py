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

Options, as in the JAX package: ``finetune_fn(module, names)`` after every
accepted site (interleaved recovery fine-tuning, ``finetune.py``);
``precomputing_covariance_num_splits`` (the Grams of a split of sites
accumulated in one forward per batch, on the original model, then the
eighs pipelined on a worker thread in walk order, on their own CUDA stream
on the card); ``checkpoint_dir`` (per-site resume); ``eigh_method``
"exact", "randomized" (``engine.randomized_topk_eigenvectors``) or "auto".
"distributed" needs ``parallel/`` (ROADMAP.md Queue 1 item 7) and raises
``NotImplementedError``.  The JAX package's ``use_pallas_gram``,
``defer_substitution``, ``shared_metric_threshold`` and
``use_indexed_ladder`` shape XLA programs and recompiles and have no
counterpart here.

The one departure from the JAX package's resume layout: accepted pairs are
saved as ``{site}.pt`` (``utils.save_state_dict_pt``), not safetensors,
since ``safetensors`` is not a dependency of the port.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import logging
import os
import pathlib
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .. import engine, nn as pnn, utils

__all__ = ["decompose", "is_decomposeable_module"]

logger = logging.getLogger(__name__)

is_decomposeable_module = engine.is_decomposeable_module

LossFn = Callable[[Any, torch.Tensor], torch.Tensor]
FinetuneFn = Callable[[torch.nn.Module, list[str]], torch.nn.Module]


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


# Under "auto", a site whose output Gram is at least this wide takes the
# randomized EVD.  The JAX package keys its choice on the full rank (>= 4096,
# its crossover for a host LAPACK eigh); on an H100 the exact f64 eigh of the
# whole Gram costs what the Gram's width sets, and the randomized EVD won
# from a 3072-wide Gram on, and lost at 2560 and below (tools/eigh_crossover.py,
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6)
AUTO_RANDOMIZED_EIGH_MIN_DIM = 3072

_EIGH_METHODS = ("auto", "exact", "randomized", "distributed")


def _check_eigh_method(eigh_method: str) -> None:
    if eigh_method not in _EIGH_METHODS:
        raise ValueError(f"{eigh_method=} not in {_EIGH_METHODS}")
    if eigh_method == "distributed":
        raise NotImplementedError(
            "eigh_method='distributed' needs the port of parallel/ "
            "(ROADMAP.md Queue 1 item 7); use 'exact', 'randomized' or 'auto'"
        )


def _resolve_eigh_method(site: engine.Site, eigh_method: str) -> str:
    """exact: damped f64 eigh of the full Gram (reference numerics,
    dwain:155-163).  randomized: subspace sketch in f32 and an f64 eigh of
    its (m, m) projection.  auto: randomized for an output Gram of
    ``AUTO_RANDOMIZED_EIGH_MIN_DIM`` or more."""
    _check_eigh_method(eigh_method)
    if eigh_method == "auto":
        return "randomized" if site.out_features >= AUTO_RANDOMIZED_EIGH_MIN_DIM else "exact"
    return eigh_method


def _site_eigenvectors(
    gram: torch.Tensor,
    site: engine.Site,
    eigh_method: str,
    reduction_factor: float,
    decompose_in_float64: bool,
) -> torch.Tensor:
    top_k = _site_top_k(site, reduction_factor)
    if _resolve_eigh_method(site, eigh_method) == "randomized":
        return engine.randomized_topk_eigenvectors(gram, top_k)
    # the ladder never evaluates above full_rank * reduction: the f64 path
    # keeps only the consumed eigenvectors
    return engine.eigenvectors_from_gram(gram, in_float64=decompose_in_float64, top_k=top_k)


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
    u_matrix: Optional[torch.Tensor] = None,
    eigh_method: str = "exact",
) -> dict[str, Any]:
    """Rank search of one site; ``u_matrix`` is its precomputed eigenbasis,
    or None to calibrate the site here."""
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
    if u_matrix is None:
        grams, _ = engine.compute_output_grams(
            root, [site.name], data_iterator, num_data_steps, apply_fn, device
        )
        u_matrix = _site_eigenvectors(
            grams[site.name], site, eigh_method, reduction_factor, decompose_in_float64
        )
    else:
        logger.info(f"Using pre-computed u_matrix, dtype={u_matrix.dtype}")
    u_dev = u_matrix.to(device=weight2d.device, dtype=torch.float32)

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


class _AsyncUProvider:
    """Pipelined eigendecomposition: each site's eigh job runs on one worker
    thread, in the order submitted (walk order), while the walk goes on
    with its calibration and metric forwards.  On the card the worker runs
    each job on its own CUDA stream, which first waits for an event
    recorded when the job was submitted (the Grams are final there), and
    synchronizes that stream before the job counts as done; a tensor
    result is marked as used by the walk's stream (``record_stream``) so
    that the allocator does not hand its memory back to the worker's
    stream early.  ``job_s`` sums the worker's time in jobs and ``wait_s``
    the walk's time blocked in ``pop``: the overlap is their difference."""

    def __init__(self, device: Any) -> None:
        self._ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._jobs: dict[str, Any] = {}
        self._finalize: dict[str, Callable[[Any], Any]] = {}
        device = torch.device(device)
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.job_s = 0.0
        self.wait_s = 0.0

    def _run(self, job: Callable[[], Any], ready: Optional[torch.cuda.Event]) -> Any:
        start = time.perf_counter()
        if self._stream is None:
            out = job()
        else:
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(ready)
                out = job()
            self._stream.synchronize()
        self.job_s += time.perf_counter() - start
        return out

    def submit(
        self, name: str, job: Callable[[], Any], finalize: Optional[Callable[[Any], Any]] = None
    ) -> None:
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            # on the walk's stream, after the job's inputs
            ready.record(torch.cuda.current_stream(self._stream.device))
        self._jobs[name] = self._ex.submit(self._run, job, ready)
        if finalize is not None:
            self._finalize[name] = finalize

    def put(self, name: str, value: Any) -> None:
        """An entry computed already (the f32 eigh on the walk's stream)."""
        self._jobs[name] = value

    def pop(self, name: str, default: Any = None) -> Any:
        job = self._jobs.pop(name, None)
        if job is None:
            return default
        res = job
        if isinstance(job, concurrent.futures.Future):
            start = time.perf_counter()
            res = job.result()
            self.wait_s += time.perf_counter() - start
            if self._stream is not None and isinstance(res, torch.Tensor):
                res.record_stream(torch.cuda.current_stream(res.device))
        fin = self._finalize.pop(name, None)
        return fin(res) if fin is not None else res

    def __len__(self) -> int:
        return len(self._jobs)

    def shutdown(self) -> None:
        self._ex.shutdown(wait=True)


def _precompute_u_in_splits(
    *,
    root: torch.nn.Module,
    modules_to_decompose: list[str],
    num_splits: int,
    num_data_steps: int,
    data_iterator: Iterator[Any],
    apply_fn: engine.ApplyFn,
    decompose_in_float64: bool,
    device: Any,
    eigh_method: str = "exact",
    reduction_factor: float = 0.5,
) -> _AsyncUProvider:
    """Eigenbases of every site, in memory-bounded splits (reference
    dwain:580-674): one forward per batch accumulates the Grams of all the
    sites of a split; the eighs are then pipelined in walk order."""
    provider = _AsyncUProvider(device)
    jobs: dict[str, tuple[Callable[[], Any], Optional[Callable[[Any], Any]]]] = {}
    # ceil-divide so that every module is covered (the reference's floor
    # division drops trailing modules, dwain:589-607)
    num_splits = max(1, min(num_splits, len(modules_to_decompose)))
    chunk_size = -(-len(modules_to_decompose) // num_splits)
    for index in range(num_splits):
        sublist = modules_to_decompose[index * chunk_size : (index + 1) * chunk_size]
        if not sublist:
            continue
        logger.info(f"Pre-computing covariance matrices for {len(sublist)} modules")
        grams, _ = engine.compute_output_grams(
            root, sublist, data_iterator, num_data_steps, apply_fn, device
        )
        for name in sublist:
            site = engine.get_site(root, name)
            top_k = _site_top_k(site, reduction_factor)
            if _resolve_eigh_method(site, eigh_method) == "randomized":
                q, b = engine.sketch_for_randomized_eigh(grams[name], top_k)
                jobs[name] = (
                    lambda b=b: torch.linalg.eigh(b)[1],
                    lambda v, q=q, k=top_k: engine.finish_randomized_eigh(q, v, k),
                )
            elif decompose_in_float64:
                jobs[name] = (
                    lambda g=grams[name], k=top_k: engine.eigenvectors_from_gram(
                        g, in_float64=True, top_k=k
                    ),
                    None,
                )
            else:
                provider.put(name, engine.eigenvectors_from_gram(grams[name], in_float64=False))
        del grams
    # submit in WALK order (reversed discovery): the first site the walk
    # needs is the first eigh computed
    for name in reversed(modules_to_decompose):
        if name in jobs:
            provider.submit(name, *jobs[name])
    if len(provider) != len(modules_to_decompose):
        raise RuntimeError("precompute left sites without an eigenbasis")
    return provider


class _Checkpointer:
    """Per-site resume state of a decomposition run.

    Every processed site is appended to ``progress.jsonl`` (``{"site",
    "config"}``, fsynced) and an accepted pair is saved as ``{site}.pt``; a
    run restarted with the same ``checkpoint_dir`` replays the recorded
    sites and goes on.  ``fingerprint.txt`` holds the run's
    hyperparameters: a run with others raises ``ValueError``."""

    def __init__(self, directory: Optional[str], fingerprint: str = "") -> None:
        self.dir = pathlib.Path(directory) if directory else None
        self.processed: dict[str, Optional[dict[str, Any]]] = {}
        if self.dir is None:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        fp_file = self.dir / "fingerprint.txt"
        if fp_file.exists():
            recorded = fp_file.read_text().strip()
            if fingerprint and recorded != fingerprint:
                raise ValueError(
                    f"Checkpoint dir {self.dir} was written by a run with different "
                    f"decomposition hyperparameters (fingerprint {recorded!r} != "
                    f"{fingerprint!r}); replaying it would mix configurations: delete "
                    "the directory or point checkpoint_dir elsewhere"
                )
        elif fingerprint:
            fp_file.write_text(fingerprint)
        progress = self.dir / "progress.jsonl"
        if progress.exists():
            for line in progress.read_text().splitlines():
                rec = json.loads(line)
                self.processed[rec["site"]] = rec.get("config")
            logger.info(
                f"Resuming decomposition: {len(self.processed)} sites already "
                f"processed in {self.dir}"
            )

    def load_pair(
        self, root: torch.nn.Module, name: str
    ) -> tuple[Optional[torch.nn.Module], Optional[dict[str, Any]]]:
        """Replay a completed site: (pair or None, config or None)."""
        config_entry = self.processed[name]
        if config_entry is None:
            return None, None
        old = pnn.get_submodule(root, name)
        new = utils.build_module_from_config(
            config_entry, dtype=utils.get_default_dtype(old), device=next(old.parameters()).device
        )
        sd = utils.load_state_dict_pt(str(self.dir / f"{name}.pt"))
        return utils.load_state_dict(new, sd), config_entry

    def record(
        self,
        pair: Optional[torch.nn.Module],
        name: str,
        config_entry: Optional[dict[str, Any]],
    ) -> None:
        if self.dir is None:
            return
        if config_entry is not None and pair is not None:
            utils.save_state_dict_pt(utils.state_dict(pair), str(self.dir / f"{name}.pt"))
        with open(self.dir / "progress.jsonl", "a") as f:
            f.write(json.dumps({"site": name, "config": config_entry}) + "\n")
            f.flush()
            os.fsync(f.fileno())


def _param_versions(module: torch.nn.Module) -> list[tuple[torch.Tensor, int]]:
    """Each parameter with its version counter, which every in-place update
    (an optimizer step, a LoRA merge) bumps."""
    return [(p, p._version) for p in module.parameters()]


def _changed(module: torch.nn.Module, before: list[tuple[torch.Tensor, int]]) -> bool:
    """Did a fine-tune touch ``module`` since ``before``: a parameter
    replaced or updated in place.  (The JAX package compares leaf identity,
    which in-place torch updates keep.)"""
    now = list(module.parameters())
    return len(now) != len(before) or any(
        p is not q or p._version != v for p, (q, v) in zip(now, before)
    )


def decompose(
    *,
    module: torch.nn.Module,
    data_iterator: Iterator[Any],
    loss_fn: LossFn,
    num_data_steps: int,
    metric_iterator: Iterator[Any],
    num_metric_steps: int,
    nsr_final_threshold: float,
    finetune_fn: Optional[FinetuneFn] = None,
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
    ``loss_fn(input_dict, output)``.  ``finetune_fn(module, names)`` runs
    after every accepted site with the names decomposed so far, and the
    module it returns goes on.  Returns ``(module, decompose_config)`` with
    the reference JSON format and a ``__meta__`` entry per layer."""
    _check_eigh_method(eigh_method)
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

    fingerprint = json.dumps(
        {
            "nsr": nsr_final_threshold,
            "min_rank": min_rank,
            "trade_off": trade_off_factor,
            "reduction": reduction_factor,
            "max_ppl_diff": max_accepted_ppl_diff,
            "f64": decompose_in_float64,
            "data_steps": num_data_steps,
            "metric_steps": num_metric_steps,
            "sites": modules_to_decompose,
            "eigh_method": eigh_method,
            "precompute_splits": precomputing_covariance_num_splits,
        },
        sort_keys=True,
    )
    ckpt = _Checkpointer(checkpoint_dir, fingerprint)
    # sites the checkpoint replays need no covariance precompute
    pending_sites = [m for m in modules_to_decompose if m not in ckpt.processed]
    u_dict: Any = {}
    if precomputing_covariance_num_splits is not None and precomputing_covariance_num_splits > 0 \
            and pending_sites:
        u_dict = _precompute_u_in_splits(
            root=module,
            modules_to_decompose=pending_sites,
            num_splits=precomputing_covariance_num_splits,
            num_data_steps=num_data_steps,
            data_iterator=data_iterator,
            apply_fn=apply_fn,
            decompose_in_float64=decompose_in_float64,
            device=device,
            eigh_method=eigh_method,
            reduction_factor=reduction_factor,
        )

    metric_fn = _make_metric_fn(loss_fn)
    decompose_config: dict[str, Any] = {}
    decomposed_submodules: list[str] = []
    try:
        for i, submodule_name in enumerate(reversed(modules_to_decompose), start=1):
            logger.info(f"PROCESSING {submodule_name} MODULE {i} OUT OF {n}")
            if submodule_name in ckpt.processed:
                pair, config_entry = ckpt.load_pair(module, submodule_name)
                if config_entry is not None and pair is not None:
                    pnn.replace_submodule(module, submodule_name, pair)
                    decomposed_submodules.append(submodule_name)
                    decompose_config[submodule_name] = config_entry
                    meta = config_entry.get(utils.MODCONFIG_META_KEY, {})
                    current_params -= meta.get("drop_in_params", 0)
                logger.info(f"{submodule_name} restored from checkpoint")
                continue
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
                u_matrix=u_dict.pop(submodule_name, None),
                eigh_method=eigh_method,
            )
            current_params -= result["drop_in_params"]
            logger.info(f"CURRENT PARAMS IN M: {current_params / 1e6}")
            new_module = result["decomposed_module"]
            if new_module is None:
                ckpt.record(None, submodule_name, None)
                logger.info(f"{submodule_name} not decomposed")
                continue
            pnn.replace_submodule(module, submodule_name, new_module)
            decomposed_submodules.append(submodule_name)
            if finetune_fn is not None:
                earlier = decomposed_submodules[:-1] if ckpt.dir is not None else []
                before = {p: _param_versions(pnn.get_submodule(module, p)) for p in earlier}
                module = finetune_fn(module, decomposed_submodules)
                # interleaved fine-tuning also retrains EARLIER pairs (the
                # last-N window): re-record exactly those it changed, so a
                # resumed run replays the fine-tuned weights
                for prev_name in earlier:
                    pair_now = pnn.get_submodule(module, prev_name)
                    if _changed(pair_now, before[prev_name]):
                        ckpt.record(pair_now, prev_name, decompose_config[prev_name])
            pair = pnn.get_submodule(module, submodule_name)
            module_config = utils.get_module_config(pair)
            engine.add_meta_to_module_config(module_config, result)
            decompose_config[submodule_name] = module_config
            ckpt.record(pair, submodule_name, module_config)
            logger.info(f"{submodule_name} decomposed with proportion={result['proportion']:.4f}")
    finally:
        if isinstance(u_dict, _AsyncUProvider):
            u_dict.shutdown()
            # the overlap's two sides, also as the record's fields
            logger.info(
                f"Pipelined eigh: {u_dict.job_s:.3f} s in jobs, the walk blocked "
                f"{u_dict.wait_s:.3f} s",
                extra={"eigh_job_s": u_dict.job_s, "eigh_wait_s": u_dict.wait_s},
            )

    logger.info(f"Decomposed {len(decompose_config)} out of {n} modules")
    logger.info(f"Decomposition took {time.perf_counter() - start_time:.1f} seconds")
    return module, decompose_config
