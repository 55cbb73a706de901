"""Top-1 accuracy over a pipeline (counterpart of
``apps/trainer_vision/metrics.py``)."""

from __future__ import annotations

import logging
import time
from typing import Any, Iterable, Optional

import torch

__all__ = ["calc_accuracy", "nchw"]

logger = logging.getLogger(__name__)


def nchw(inputs: Any, device: Any) -> torch.Tensor:
    """An NHWC numpy batch as the NCHW tensor the models take on
    ``device``: a permuted view, ``channels_last`` in memory."""
    return torch.as_tensor(inputs).to(device).permute(0, 3, 1, 2)


def calc_accuracy(model: torch.nn.Module, pipeline: Iterable[dict[str, Any]],
                  max_batches: Optional[int] = None) -> float:
    """The share of samples whose argmax logit is their one-hot target's,
    with the model in eval mode (its mode is restored after)."""
    p = next(model.parameters())
    t0 = time.perf_counter()
    correct, total = 0, 0
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for i, batch in enumerate(pipeline):
                if max_batches is not None and i >= max_batches:
                    break
                x = nchw(batch["inputs"], p.device)
                logits = model(x.to(p.dtype) if x.dtype != p.dtype else x)
                true = torch.as_tensor(batch["targets"]).to(p.device).argmax(dim=-1)
                correct += int((logits.argmax(dim=-1) == true).sum())
                total += int(true.shape[0])
    finally:
        model.train(training)
    acc = correct / max(total, 1)
    logger.info(f"accuracy={acc:.4f} over {total} samples ({time.perf_counter() - t0:.1f}s)")
    return acc
