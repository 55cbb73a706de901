"""EleutherAI lm-evaluation-harness adapter for the port's CausalLM.

Counterpart of ``apps/trainer_llm/lm_eval_adapter.py``:

  * the scoring core (``score_pairs``, ``rolling_nll``): plain functions
    over token-id lists, one no-grad forward per padded batch on the
    model's device, usable without lm_eval;
  * ``make_lm_eval_model``: an ``lm_eval.api.model.LM`` subclass over that
    core, built only when ``lm_eval`` is importable;
  * offline named tasks: ``<tasks_dir>/<task>.jsonl`` snapshots, read as
    data files from ``$PTDECO_TPU_LM_EVAL_TASKS_DIR``, else from the
    repository's ``apps/trainer_llm/tasks/`` directory (found by path,
    never imported).
"""

from __future__ import annotations

import logging
import os
import pathlib
from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "DEFAULT_TASKS_DIR",
    "TASKS_DIR_ENV",
    "make_lm_eval_model",
    "resolve_offline_task",
    "rolling_nll",
    "score_pairs",
]

logger = logging.getLogger(__name__)

TASKS_DIR_ENV = "PTDECO_TPU_LM_EVAL_TASKS_DIR"
DEFAULT_TASKS_DIR = pathlib.Path(__file__).resolve().parents[3] / "apps" / "trainer_llm" / "tasks"


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _score_step(
    model: torch.nn.Module, ids: torch.Tensor, cont_mask: torch.Tensor, attn_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    logits = model({"input_ids": ids, "attention_mask": attn_mask})
    logits = logits[:, :-1].to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    targets = ids[:, 1:]
    tok_lp = torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = cont_mask[:, 1:]
    ll = torch.sum(tok_lp * mask, dim=-1)
    greedy = torch.argmax(logits, dim=-1) == targets
    is_greedy = torch.all(torch.where(mask > 0, greedy, True), dim=-1)
    return ll, is_greedy


def _pad_pow2(n: int, lo: int = 64) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def score_pairs(
    model: torch.nn.Module,
    pairs: Sequence[tuple[list[int], list[int]]],
    max_len: int = 2048,
    batch_size: int = 8,
) -> list[tuple[float, bool]]:
    """lm_eval ``loglikelihood`` semantics for (context_ids,
    continuation_ids) pairs: total continuation log-prob under teacher
    forcing, and whether the continuation is the greedy decode.  Sequences
    are truncated on the left to ``max_len``, keeping the continuation
    where possible (lm_eval's HFLM)."""
    device = _device(model)
    out: list[tuple[float, bool]] = [(0.0, False)] * len(pairs)
    order = sorted(range(len(pairs)), key=lambda i: -(len(pairs[i][0]) + len(pairs[i][1])))
    for start in range(0, len(order), batch_size):
        sel = order[start : start + batch_size]
        longest = max(len(pairs[i][0]) + len(pairs[i][1]) for i in sel)
        # clamp: _pad_pow2 may overshoot a max_len that is not a power of two
        pad_len = min(_pad_pow2(min(longest, max_len)), max_len)
        ids = np.zeros((batch_size, pad_len), np.int64)
        cont = np.zeros((batch_size, pad_len), np.float32)
        attn = np.zeros((batch_size, pad_len), np.int64)
        for bi, i in enumerate(sel):
            ctx, c = pairs[i]
            seq = (list(ctx) + list(c))[-pad_len:]
            cont_len = min(len(c), len(seq) - 1)  # at least one context token stays
            ids[bi, : len(seq)] = seq
            attn[bi, : len(seq)] = 1
            cont[bi, len(seq) - cont_len : len(seq)] = 1.0
        ll, greedy = _score_step(
            model, *(torch.from_numpy(a).to(device) for a in (ids, cont, attn))
        )
        ll, greedy = ll.cpu().numpy(), greedy.cpu().numpy()
        for bi, i in enumerate(sel):
            out[i] = (float(ll[bi]), bool(greedy[bi]))
    return out


def rolling_nll(
    model: torch.nn.Module, token_ids: list[int], prefix_token: int, max_len: int = 2048
) -> float:
    """lm_eval ``loglikelihood_rolling`` semantics: the total
    log-likelihood of a whole document, every token scored once, in windows
    of ``max_len`` each prefixed by the previous window's last token (or
    ``prefix_token`` for the first)."""
    total = 0.0
    pos = 0
    prev = prefix_token
    while pos < len(token_ids):
        window = token_ids[pos : pos + max_len - 1]
        ((ll, _),) = score_pairs(model, [([prev], window)], max_len=max_len, batch_size=1)
        total += ll
        prev = window[-1]
        pos += len(window)
    return total


def make_lm_eval_model(
    model: torch.nn.Module, tokenizer: Any, max_len: int = 2048, batch_size: int = 8
):
    """An ``lm_eval.api.model.LM`` over the model; raises ImportError when
    lm_eval is not installed."""
    from lm_eval.api.model import LM

    def _tok(s: str) -> list[int]:
        return tokenizer(s, add_special_tokens=False)["input_ids"]

    prefix_token = getattr(tokenizer, "bos_token_id", None)
    if prefix_token is None:  # explicit: bos_token_id == 0 is a valid id
        prefix_token = getattr(tokenizer, "eos_token_id", None)
    if prefix_token is None:
        prefix_token = 0

    class PtdecoTorchLM(LM):
        def loglikelihood(self, requests) -> list[tuple[float, bool]]:
            pairs = []
            for req in requests:
                context, continuation = req.args
                ctx_ids = _tok(context) if context else [prefix_token]
                pairs.append((ctx_ids, _tok(continuation)))
            return score_pairs(model, pairs, max_len, batch_size)

        def loglikelihood_rolling(self, requests) -> list[float]:
            return [rolling_nll(model, _tok(req.args[0]), prefix_token, max_len) for req in requests]

        def generate_until(self, requests) -> list[str]:
            outs = []
            for req in requests:
                context, gen_kwargs = req.args
                until = (gen_kwargs or {}).get("until", [])
                max_new = (gen_kwargs or {}).get("max_gen_toks", 128)
                ids = _tok(context)[-(max_len - max_new):]
                outs.append(_greedy_generate(model, tokenizer, ids, max_new, until, max_len))
            return outs

    return PtdecoTorchLM()


@torch.no_grad()
def _greedy_generate(
    model: torch.nn.Module, tokenizer: Any, ids: list[int], max_new: int, until: list[str],
    max_len: int,
) -> str:
    """Greedy decoding, one full forward per emitted token (for the few
    generate-style tasks; loglikelihood tasks dominate the suites)."""
    device = _device(model)
    out_ids: list[int] = []
    cur = list(ids)
    for _ in range(max_new):
        pad_len = min(_pad_pow2(min(len(cur), max_len)), max_len)
        arr = torch.zeros((1, pad_len), dtype=torch.int64)
        arr[0, : len(cur)] = torch.tensor(cur[-pad_len:])
        arr = arr.to(device)
        logits = model({"input_ids": arr, "attention_mask": torch.ones_like(arr)})
        nxt = int(torch.argmax(logits[0, len(cur) - 1].to(torch.float32)))
        out_ids.append(nxt)
        cur.append(nxt)
        text = tokenizer.decode(out_ids)
        if any(u in text for u in until):
            for u in until:
                if u in text:
                    text = text.split(u)[0]
            return text
    return tokenizer.decode(out_ids)


def resolve_offline_task(task: str) -> Optional[pathlib.Path]:
    """``<tasks_dir>/<task>.jsonl`` if it exists, else None."""
    tasks_dir = pathlib.Path(os.environ.get(TASKS_DIR_ENV, DEFAULT_TASKS_DIR))
    path = tasks_dir / f"{task}.jsonl"
    return path if path.exists() else None
