"""Training-stage checkpoints with autoresume.

Counterpart of ``ptdeco_tpu/utils/train_ckpt.py`` (orbax there): a
``torch.save`` of ``{"trainable", "opt_state", "step"}`` every
``save_interval_steps`` steps (a step that is a multiple of the
interval), the latest ``max_to_keep`` kept, and restore of the latest
one.  A snapshot is written to a temporary file and renamed into place,
so a run stopped mid-write leaves the previous snapshot whole.  With no
directory or an interval of 0 the checkpointer does nothing.  The values
are whatever the caller passes (a dict of tensors, an optimizer's
``state_dict()``); they come back on the CPU.
"""

from __future__ import annotations

import logging
import os
import pathlib
import re
from typing import Any, Optional

import torch

__all__ = ["TrainCheckpointer"]

logger = logging.getLogger(__name__)

_NAME = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointer:
    def __init__(self, directory: Optional[str], save_interval_steps: int = 0,
                 max_to_keep: int = 2) -> None:
        self.enabled = bool(directory) and save_interval_steps > 0
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.dir = pathlib.Path(directory).absolute() if self.enabled else None
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)

    def all_steps(self) -> list[int]:
        if self.dir is None:
            return []
        return sorted(int(m.group(1)) for p in self.dir.iterdir() if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _save(self, step: int, trainable: Any, opt_state: Any) -> None:
        path = self.dir / f"step_{step:09d}.pt"
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        torch.save({"trainable": trainable, "opt_state": opt_state, "step": step}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            (self.dir / f"step_{old:09d}.pt").unlink(missing_ok=True)

    def maybe_save(self, step: int, trainable: Any, opt_state: Any) -> None:
        """Save at a multiple of the interval (orbax's fixed-interval rule)."""
        if self.enabled and step % self.save_interval_steps == 0:
            self._save(step, trainable, opt_state)

    def maybe_save_chunk(self, start_step: int, n_steps: int, trainable: Any,
                         opt_state: Any) -> None:
        """The state after steps ``start_step .. start_step + n_steps - 1``,
        as a driver that runs ``steps_per_dispatch`` steps between looks
        sees it: saved at the chunk's last step if the chunk covered a
        multiple of the interval, so that a resume continues at the next
        step (the fixed-interval rule alone would never fire for an
        interval the chunk tails miss)."""
        if not self.enabled or n_steps <= 0:
            return
        last = start_step + n_steps - 1
        if (last // self.save_interval_steps) * self.save_interval_steps >= start_step:
            self._save(last, trainable, opt_state)

    def restore_or(self, trainable: Any, opt_state: Any) -> tuple[Any, Any, int]:
        """The latest snapshot's ``(trainable, opt_state, step + 1)``, or the
        arguments and 0 when there is none."""
        latest = self.latest_step()
        if latest is None:
            return trainable, opt_state, 0
        state = torch.load(self.dir / f"step_{latest:09d}.pt", map_location="cpu",
                           weights_only=True)
        logger.info(f"Autoresumed training from step {latest}")
        return state["trainable"], state["opt_state"], latest + 1
