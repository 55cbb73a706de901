"""LLM metrics: masked perplexity, parameter count, forward FLOPs, task
accuracies.

Counterpart of ``apps/trainer_llm/metrics.py``.  FLOPs: where the JAX
trainer reads XLA's cost analysis of the compiled forward, the port counts
with ``torch.utils.flop_counter.FlopCounterMode``.  The counter sees only
aten operators, so a kernel launched through ``ctypes`` (flash attention,
a fused pair's low-rank product) would drop out of a count taken on the
card.  ``get_giga_flops`` therefore runs the forward on the ``meta``
device, with the model's parameters swapped for meta tensors: every layer
takes its plain route, nothing is computed or allocated, and the count is
the same on the card and on the CPU.  It counts matrix products only
(XLA also counts elementwise operations), so its absolute numbers are a
little lower than the JAX trainer's; for a llama model the products are
nearly all of it, and the fractions agree.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Iterable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ... import utils

__all__ = ["calc_perplexity", "get_params_m", "get_giga_flops", "calc_lm_eval_metrics"]

logger = logging.getLogger(__name__)


def calc_perplexity(
    model: torch.nn.Module,
    dataloader: Iterable[dict[str, Any]],
    max_batches: Optional[int] = None,
) -> float:
    """exp(total masked NLL / total tokens) over the loader."""
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    nll, ntok = 0.0, 0.0
    with torch.no_grad():
        for i, batch in enumerate(dataloader):
            if max_batches is not None and i >= max_batches:
                break
            batch = utils.to_device(batch, device)
            logits = model(batch)
            labels = batch["input_ids"][:, 1:]
            mask = batch["attention_mask"][:, 1:].to(torch.float32)
            logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
            ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
            nll += float(-torch.sum(ll * mask))
            ntok += float(torch.sum(mask))
    if ntok == 0:
        raise ValueError(
            "calc_perplexity saw zero tokens: empty dataloader "
            "(batch_size > nsamples, or max_batches=0?)"
        )
    ppl = math.exp(nll / ntok)
    logger.info(f"Perplexity = {ppl:.4f} over {ntok:.0f} tokens ({time.perf_counter() - t0:.1f}s)")
    return ppl


def get_params_m(model: torch.nn.Module) -> float:
    return utils.get_num_params(model) / 1.0e6


def get_giga_flops(model: torch.nn.Module, batch: dict[str, Any]) -> float:
    """Forward GFLOPs of ``model`` on ``batch``'s shapes, counted on the meta
    device (see the module docstring); a fused model is counted unfused
    only (the fused kernel takes no meta tensor)."""
    meta = {
        name: torch.empty_like(t, device="meta")
        for name, t in [*model.named_parameters(), *model.named_buffers()]
    }
    meta_batch = {
        k: torch.empty_like(torch.as_tensor(v), device="meta") for k, v in batch.items()
    }
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        torch.func.functional_call(model, meta, (meta_batch,))
    return counter.get_total_flops() / 1.0e9


def calc_lm_eval_metrics(
    model: torch.nn.Module, tokenizer: Any, tasks: list[str]
) -> Optional[dict[str, Any]]:
    """Task-suite evaluation.  Per task: a literal ``.jsonl`` path, or a
    named task with an offline snapshot (``lm_eval_adapter.
    resolve_offline_task``), runs the offline harness; other named tasks go
    to ``lm_eval.simple_evaluate`` when lm_eval is installed, else they are
    skipped with a warning."""
    from . import eval_harness, lm_eval_adapter

    results: dict[str, Any] = {}
    named: list[str] = []
    for task in tasks:
        if task.endswith(".jsonl"):
            rows = eval_harness.load_task(task)
            results[task] = eval_harness.evaluate_loglikelihood_task(model, tokenizer, rows)
            continue
        snapshot = lm_eval_adapter.resolve_offline_task(task)
        if snapshot is not None:
            logger.info(f"Evaluating {task} from offline snapshot {snapshot}")
            rows = eval_harness.load_task(str(snapshot))
            results[task] = eval_harness.evaluate_loglikelihood_task(model, tokenizer, rows)
        else:
            named.append(task)
    if named:
        try:
            import lm_eval
        except ImportError:
            logger.warning(f"lm_eval not installed and no offline snapshot for {named}; skipping")
        else:
            lm = lm_eval_adapter.make_lm_eval_model(model, tokenizer)
            ev = lm_eval.simple_evaluate(model=lm, tasks=named)
            if ev is not None:
                for task, res in ev.get("results", {}).items():
                    results[task] = res
    return results or None
