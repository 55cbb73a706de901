"""FALOR ("Features Are LOw-Rank") one-shot decomposition, in PyTorch.

Counterpart of ``ptdeco_tpu/falor/decomposition.py`` (reference
``ptdeco.falor.decompose_in_place``): one pass per site in discovery
order, each scored against the ORIGINAL model (phase 1 never changes it):
the site's output Gram over fresh calibration batches, optionally
mean-centred, damped and eigendecomposed, then a binary rank search under
the NSR and symmetric-KL thresholds.  Phase 2 swaps in the factor pairs of
the sites whose proportion is below ``proportion_threshold``.

As in the JAX package, two documented reference bugs are fixed: the
damping goes on the covariance actually decomposed
(``engine.eigenvectors_from_gram``), and the factors are rebuilt at
``rank_best`` (the reference reuses the last tried candidate's).  The
per-site ``nsr_final``/``kl_final`` still report the last candidate tried.

The model is put in eval mode (the JAX package's forwards never update
BatchNorm statistics).  ``checkpoint_dir`` resumes phase 1 from
``falor_phase1.jsonl``; its one departure from the JAX package's layout is
that pairs are saved as ``{site}.pt``, as the port's dwain checkpointer
does, since ``safetensors`` is not a dependency of the port.  The JAX
package's ``use_pallas_gram``, ``shared_metric_threshold`` and
``use_indexed_ladder`` shape XLA programs and have no counterpart here.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import pathlib
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from .. import engine, nn as pnn, utils

__all__ = ["decompose", "is_decomposeable_module"]

logger = logging.getLogger(__name__)

is_decomposeable_module = engine.is_decomposeable_module


def _metric_fn(batch: Any, y_deco: torch.Tensor, y_orig: torch.Tensor) -> torch.Tensor:
    """[nsr, kl] of one batch (reference falor:211-233): NSR over dim 0,
    symmetric KL on the logits."""
    nsr = utils.calc_per_channel_noise_to_signal_ratio(x=y_deco, y=y_orig, non_channel_dim=(0,))
    kl = utils.calc_kl_loss(y_deco, y_orig)
    return torch.stack([nsr, kl]).to(torch.float32)


def _process_module(
    *,
    root: torch.nn.Module,
    site: engine.Site,
    data_iterator: Iterator[Any],
    apply_fn: engine.ApplyFn,
    nsr_final_threshold: float,
    kl_final_threshold: float,
    num_data_steps: int,
    num_metric_steps: int,
    use_float64: bool,
    use_mean: bool,
    use_damping: bool,
    device: Any,
) -> dict[str, Any]:
    msg_prefix = f"Processing {site.name}:"
    dim_in, dim_out, full_rank = site.in_features, site.out_features, site.full_rank
    if full_rank == 1:
        logger.info(f"{msg_prefix} Module has rank 1, not decomposing")
        return {"proportion": 1.0, "nsr_final": 0.0, "kl_final": 0.0, "decomposed_module": None}
    logger.info(f"{msg_prefix} {site.kind} in={dim_in} out={dim_out}")

    weight2d = engine.get_site_weight2d(root, site)
    grams, means = engine.compute_output_grams(
        root, [site.name], data_iterator, num_data_steps, apply_fn, device,
        accumulate_mean=use_mean,
    )
    start = time.perf_counter()
    u = engine.eigenvectors_from_gram(
        grams[site.name], mean=means[site.name] if use_mean else None,
        use_damping=use_damping, in_float64=use_float64,
    )
    if u.is_cuda:
        torch.cuda.synchronize(u.device)
    eigh_s = time.perf_counter() - start
    logger.info(f"{msg_prefix} eigh of {dim_out} took {eigh_s:.4f} s",
                extra={"falor_site": site.name, "eigh_s": eigh_s})
    u_dev = u.to(device=weight2d.device, dtype=torch.float32)

    # binary rank search (reference falor:340-375), one candidate at a time
    evaluator = engine.CandidateEvaluator(site, apply_fn, _metric_fn, device)
    rank_best, rank_width = full_rank, full_rank // 2
    nsr_best = kl_best = nsr_new = kl_new = 0.0
    i = 1
    while rank_width > 0:
        rank_new = rank_best - rank_width
        raw = evaluator(root, weight2d, u_dev, [rank_new], data_iterator, num_metric_steps)
        nsr_new = float(np.mean(raw[0, :, 0]))
        kl_new = float(np.mean(raw[0, :, 1]))
        if nsr_new < nsr_final_threshold and kl_new < kl_final_threshold:
            rank_best, nsr_best, kl_best = rank_new, nsr_new, kl_new
        logger.info(
            f"{msg_prefix} {i=} {rank_width=} {rank_new=} {nsr_new=:.6f} {kl_new=:.6f} "
            f"{rank_best=} {nsr_best=:.6f} {kl_best=:.6f}"
        )
        rank_width //= 2
        i += 1

    proportion = rank_best / full_rank
    logger.info(f"{msg_prefix} iter=FINAL rank={rank_best} {proportion=:.4f} "
                f"nsr={nsr_best:.6f} kl={kl_new:.6f}")
    new_module: Optional[torch.nn.Module] = None
    if full_rank != rank_best and engine.is_num_params_reduced(proportion, dim_in, dim_out):
        w1, w2 = engine.build_factors(weight2d, u, rank_best)
        new_module = engine.build_decomposed_module(root, site, w1, w2)
    else:
        logger.info(f"{msg_prefix} {proportion=:.4f} leads to num param increase, "
                    "not decomposing")
    return {"proportion": proportion, "nsr_final": nsr_new, "kl_final": kl_new,
            "decomposed_module": new_module}


class _Phase1Log:
    """Per-site resume of phase 1: ``falor_phase1.jsonl`` lines (fsynced),
    each accepted pair as ``{site}.pt``, and ``fingerprint.txt`` holding the
    run's hyperparameters (a run with others raises ``ValueError``)."""

    def __init__(self, directory: Optional[str], fingerprint: str) -> None:
        self.dir = pathlib.Path(directory) if directory else None
        self.done: dict[str, dict[str, Any]] = {}
        if self.dir is None:
            return
        fp_file = self.dir / "fingerprint.txt"
        if fp_file.exists() and fp_file.read_text().strip() != fingerprint:
            raise ValueError(
                f"Checkpoint dir {self.dir} was written with different falor "
                "hyperparameters; delete it or use another checkpoint_dir"
            )
        self.dir.mkdir(parents=True, exist_ok=True)
        if not fp_file.exists():
            fp_file.write_text(fingerprint)
        path = self.dir / "falor_phase1.jsonl"
        if path.exists():
            for line in path.read_text().splitlines():
                rec = json.loads(line)
                self.done[rec["site"]] = rec
            logger.info(f"Resuming falor: {len(self.done)} sites already scored")

    def replay(self, root: torch.nn.Module, name: str) -> dict[str, Any]:
        rec = self.done[name]
        result = {k: rec[k] for k in ("proportion", "nsr_final", "kl_final")}
        result["decomposed_module"] = None
        if rec.get("pair_config") is not None:
            old = pnn.get_submodule(root, name)
            pair = utils.build_module_from_config(
                rec["pair_config"], dtype=utils.get_default_dtype(old),
                device=next(old.parameters()).device,
            )
            sd = utils.load_state_dict_pt(str(self.dir / f"{name}.pt"))
            result["decomposed_module"] = utils.load_state_dict(pair, sd)
        return result

    def record(self, name: str, result: dict[str, Any]) -> None:
        if self.dir is None:
            return
        pair, pair_config = result["decomposed_module"], None
        if pair is not None:
            pair_config = utils.get_module_config(pair)
            utils.save_state_dict_pt(utils.state_dict(pair), str(self.dir / f"{name}.pt"))
        with open(self.dir / "falor_phase1.jsonl", "a") as f:
            f.write(json.dumps({"site": name, "proportion": result["proportion"],
                                "nsr_final": result["nsr_final"],
                                "kl_final": result["kl_final"],
                                "pair_config": pair_config}) + "\n")
            f.flush()
            os.fsync(f.fileno())


def decompose(
    *,
    module: torch.nn.Module,
    data_iterator: Iterator[Any],
    proportion_threshold: float,
    nsr_final_threshold: float,
    kl_final_threshold: float,
    num_data_steps: int,
    num_metric_steps: int,
    use_float64: bool = True,
    use_mean: bool = False,
    use_damping: bool = True,
    blacklisted_module_names: Optional[list[str]] = None,
    apply_fn: engine.ApplyFn = engine.default_apply,
    checkpoint_dir: Optional[str] = None,
    device: Any = "cuda",
) -> tuple[torch.nn.Module, dict[str, Any]]:
    """Two-phase one-shot decomposition on ``device`` (reference
    falor:424-511): phase 1 scores every decomposeable site that fires
    against the original model; phase 2 replaces, in place, those with
    ``proportion < proportion_threshold``.  Batches are moved to ``device``
    as they are drawn.  Returns ``(module, decompose_config)``."""
    start_time = time.perf_counter()
    module.to(device).eval()
    blacklist = set(blacklisted_module_names or [])
    names = engine.get_decomposeable_submodule_names(module)
    # drop sites that never fire on a forward; the probe batch is pushed
    # back so the stream is unchanged
    probe_batch = next(data_iterator)
    fired = set(engine.fired_site_names(
        module, names, utils.to_device(probe_batch, device), apply_fn))
    data_iterator = itertools.chain([probe_batch], data_iterator)
    for m in names:
        if m not in fired:
            logger.info(f"Skipping {m}: never fires on a forward pass")
    names = [m for m in names if m in fired]
    n = len(names)

    fingerprint = json.dumps(
        {"nsr": nsr_final_threshold, "kl": kl_final_threshold, "f64": use_float64,
         "mean": use_mean, "damping": use_damping, "data_steps": num_data_steps,
         "metric_steps": num_metric_steps},
        sort_keys=True,
    )
    log = _Phase1Log(checkpoint_dir, fingerprint)

    results: dict[str, dict[str, Any]] = {}
    for i, name in enumerate(names, start=1):
        msg_prefix = f"Processing {name}: module {i} of {n}"
        if name in blacklist:
            logger.info(f"{msg_prefix}, skipped as blacklisted")
            continue
        if name in log.done:
            results[name] = log.replay(module, name)
            logger.info(f"{msg_prefix}, restored from checkpoint")
            continue
        logger.info(msg_prefix)
        results[name] = _process_module(
            root=module, site=engine.get_site(module, name), data_iterator=data_iterator,
            apply_fn=apply_fn, nsr_final_threshold=nsr_final_threshold,
            kl_final_threshold=kl_final_threshold, num_data_steps=num_data_steps,
            num_metric_steps=num_metric_steps, use_float64=use_float64, use_mean=use_mean,
            use_damping=use_damping, device=device,
        )
        log.record(name, results[name])

    # phase 2: replace (reference falor:475-503)
    decompose_config: dict[str, Any] = {}
    counter: collections.Counter[str] = collections.Counter()
    for name in names:
        if name in blacklist:
            logger.info(f"Decomposing {name}: SKIPPED blacklisted module")
            continue
        result = results[name]
        new_module, proportion = result["decomposed_module"], result["proportion"]
        if new_module is None:
            logger.info(f"Decomposing {name}: SKIPPED {proportion=:.4f} leads to num "
                        "param increase")
        elif proportion < proportion_threshold:
            counter[utils.get_type_name(pnn.get_submodule(module, name))] += 1
            pnn.replace_submodule(module, name, new_module)
            module_config = utils.get_module_config(new_module)
            engine.add_meta_to_module_config(module_config, result)
            decompose_config[name] = module_config
            logger.info(f"Decomposing {name}: finished {proportion=:.3f}")
        else:
            logger.info(f"Decomposing {name}: SKIPPED, {proportion=:.3f} above "
                        f"{proportion_threshold=:.3f}")
    for type_name, count in counter.items():
        logger.info(f"Decomposed {count} instances of {type_name}")
    logger.info(f"Total decomposable modules {n}")
    logger.info(f"Decomposition took {time.perf_counter() - start_time:.1f} seconds")
    return module, decompose_config
