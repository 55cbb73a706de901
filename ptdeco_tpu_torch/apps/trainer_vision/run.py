"""CLI entry of the port's vision trainer.

    python -m ptdeco_tpu_torch.apps.trainer_vision.run --config cfg.yaml --output-path out/ [--device cpu]

Counterpart of ``apps/trainer_vision/run.py``: logging set-up, the repro
bundle (``repro/config.yaml`` with version stamps and ``pip freeze``), and
the dispatch over the four tasks: ``decompose_dwain``, ``decompose_falor``,
``decompose_lockd`` and ``finetune``.  The config reads as the LLM
trainer's does (YAML where PyYAML imports, else JSON).  The task runs on
the card unless ``--device`` or the config's ``device`` says ``cpu``;
there is no fallback to the CPU.  The multi-process flags are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
import pathlib
import subprocess
import sys
from typing import Optional, Sequence

from ... import __version__
from ..trainer_llm.run import _has_yaml, load_config, parse_args, setup_logging
from . import run_decompose_dwain, run_decompose_falor, run_decompose_lockd, run_finetune

__all__ = ["TASKS", "TRAINER_VISION_VERSION", "copy_config", "main"]

logger = logging.getLogger(__name__)

TRAINER_VISION_VERSION = "0.1.0"

TASKS = {
    "decompose_lockd": run_decompose_lockd.main,
    "decompose_falor": run_decompose_falor.main,
    "decompose_dwain": run_decompose_dwain.main,
    "finetune": run_finetune.main,
}


def copy_config(config_path: pathlib.Path, output_path: pathlib.Path) -> None:
    """``repro/``: the config with version stamps, and ``pip freeze``
    (given 120 s)."""
    repro = output_path / "repro"
    repro.mkdir(exist_ok=True, parents=True)
    config = load_config(config_path)
    config["ptdeco_tpu_version"] = __version__
    config["ptdeco_trainer_version"] = TRAINER_VISION_VERSION
    with open(repro / "config.yaml", "w") as f:
        if _has_yaml():
            import yaml

            yaml.dump(config, f)
        else:
            json.dump(config, f, indent=2)
    try:
        freeze = subprocess.run([sys.executable, "-m", "pip", "freeze"], capture_output=True,
                                text=True, timeout=120).stdout
        (repro / "requirements_freeze.txt").write_text(freeze)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(f"pip freeze failed: {e}")


def main(argv: Optional[Sequence[str]] = None, train_pipeline=None, val_pipeline=None) -> int:
    """The CLI; ``train_pipeline`` / ``val_pipeline`` (in process only)
    replace the ImageNet folders."""
    setup_logging()
    args = parse_args(argv, "ptdeco_tpu_torch vision trainer")
    if (args.distributed or args.coordinator_address is not None
            or args.num_processes is not None or args.process_id is not None):
        raise NotImplementedError("--distributed and the coordinator flags need the port of "
                                  "parallel/ (ROADMAP.md Queue 1 item 7)")
    config = load_config(args.config)
    task = config.get("task")
    if task not in TASKS:
        raise ValueError(f"Unknown task {task!r}")
    args.output_path.mkdir(exist_ok=True, parents=True)
    copy_config(args.config, args.output_path)
    TASKS[task](config, args.output_path, train_pipeline, val_pipeline, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
