"""Optional TensorBoard scalars (counterpart of
``apps/trainer_vision/tb_writer.py``): ``metrics.jsonl`` stays the primary
sink; with ``tensorboard: true`` the per-layer scalars also go to event
files when torch's ``SummaryWriter`` imports (it needs the tensorboard
package), and the writer is a no-op otherwise."""

from __future__ import annotations

import logging
import pathlib
from typing import Any, Mapping, Optional

__all__ = ["TBWriter"]

logger = logging.getLogger(__name__)


class TBWriter:
    def __init__(self, log_dir: pathlib.Path, enabled: bool) -> None:
        self._w: Optional[Any] = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir=str(log_dir))
            logger.info(f"TensorBoard events -> {log_dir}")
        except ImportError as e:
            logger.warning(f"tensorboard writer unavailable: {e}")

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        if self._w is None:
            return
        for tag, v in values.items():
            self._w.add_scalar(tag, v, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.flush()
            self._w.close()
