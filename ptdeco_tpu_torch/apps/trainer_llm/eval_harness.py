"""Offline zero-shot evaluation harness (lm_eval-style loglikelihood tasks).

Counterpart of ``apps/trainer_llm/eval_harness.py``: answer choices are
ranked by total continuation log-likelihood over local JSONL task files

    {"query": "...", "choices": ["...", "..."], "gold": 0}

and reported as acc (argmax loglik) and acc_norm (loglik over the
continuation's byte length, lm_eval's normalization).
"""

from __future__ import annotations

import json
import logging
import pathlib
from typing import Any, Sequence

import numpy as np
import torch

from .lm_eval_adapter import score_pairs

__all__ = ["load_task", "evaluate_loglikelihood_task"]

logger = logging.getLogger(__name__)


def load_task(path: str) -> list[dict[str, Any]]:
    return [json.loads(line) for line in pathlib.Path(path).read_text().splitlines() if line.strip()]


def evaluate_loglikelihood_task(
    model: torch.nn.Module,
    tokenizer: Any,
    rows: Sequence[dict[str, Any]],
    max_len: int = 256,
    batch_size: int = 8,
) -> dict[str, float]:
    """Accuracy of gold-choice ranking by continuation log-likelihood."""
    pairs: list[tuple[list[int], list[int]]] = []
    meta: list[tuple[int, int, int]] = []  # (row_idx, choice_idx, byte_len)
    for ri, row in enumerate(rows):
        q_ids = tokenizer(row["query"], add_special_tokens=False)["input_ids"]
        for ci, choice in enumerate(row["choices"]):
            c_ids = tokenizer(choice, add_special_tokens=False)["input_ids"]
            pairs.append((list(q_ids), list(c_ids)))
            meta.append((ri, ci, max(len(choice.encode()), 1)))

    results = score_pairs(model, pairs, max_len=max_len, batch_size=batch_size)
    scores = {(ri, ci): (ll, nbytes) for (ri, ci, nbytes), (ll, _) in zip(meta, results)}

    correct = correct_norm = 0
    for ri, row in enumerate(rows):
        lls = [scores[(ri, ci)] for ci in range(len(row["choices"]))]
        pred = int(np.argmax([s for s, _ in lls]))
        pred_norm = int(np.argmax([s / nb for s, nb in lls]))
        correct += pred == row["gold"]
        correct_norm += pred_norm == row["gold"]
    n = max(len(rows), 1)
    res = {"acc": correct / n, "acc_norm": correct_norm / n, "n": float(n)}
    logger.info(f"zero-shot eval: {res}")
    return res
