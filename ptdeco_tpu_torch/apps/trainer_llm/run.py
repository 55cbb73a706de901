"""CLI entry of the port's LLM trainer.

    python -m ptdeco_tpu_torch.apps.trainer_llm.run --config cfg.yaml --output-path out/ [--device cpu]

Counterpart of ``apps/trainer_llm/run.py``: logging set-up, the repro
bundle (``repro/config.yaml`` with version stamps, ``pip freeze``, the
custom builder file), the config copied as ``config_original.yaml``, and
the task dispatch: ``decompose_dwain``, ``finetune`` and ``generate``.
The config is read with ``yaml.safe_load`` where PyYAML is importable,
else as JSON (a JSON file is YAML, so both read the same mapping);
``repro/config.yaml`` is written the same way; a ``.json`` file always
reads as JSON (YAML 1.1 reads a float such as ``5e-05`` as a string).
The task runs on the card unless ``--device`` or the config's ``device``
says ``cpu``.  The multi-process flags are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import pathlib
import shutil
import subprocess
import sys
from typing import Any, Optional, Sequence

from ... import __version__
from . import run_decompose_dwain, run_finetune, run_generate

__all__ = ["TRAINER_LLM_VERSION", "copy_config", "main", "parse_args", "setup_logging"]

logger = logging.getLogger(__name__)

TRAINER_LLM_VERSION = "0.1.0"


def setup_logging() -> None:
    fmt = "%(asctime)s.%(msecs)03d500: %(levelname).1s %(name)s.py:%(lineno)d] %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt, datefmt="%m-%d %H:%M:%S")
    for module_name in (__name__, "ptdeco_tpu_torch"):
        logging.getLogger(module_name).setLevel(logging.INFO)


def _has_yaml() -> bool:
    return importlib.util.find_spec("yaml") is not None


def load_config(config_path: pathlib.Path) -> dict[str, Any]:
    with open(config_path) as f:
        if _has_yaml() and pathlib.Path(config_path).suffix != ".json":
            import yaml

            config = yaml.safe_load(f)
        else:
            config = json.load(f)
    if not isinstance(config, dict):
        raise ValueError(f"Config file is not a mapping: {config_path}")
    return config


def copy_config(config_path: pathlib.Path, output_path: pathlib.Path) -> None:
    """The repro bundle: the config with version stamps, ``pip freeze``
    (given 120 s), and the custom builder file the config names."""
    repro = output_path / "repro"
    repro.mkdir(exist_ok=True, parents=True)
    config = load_config(config_path)
    config["ptdeco_tpu_version"] = __version__
    config["ptdeco_trainer_llm_version"] = TRAINER_LLM_VERSION
    with open(repro / "config.yaml", "w") as f:
        if _has_yaml():
            import yaml

            yaml.dump(config, f)
        else:
            json.dump(config, f, indent=2)
    builder_path = config.get("decomposed_model_custom_builder_path")
    if builder_path:
        shutil.copy(builder_path, repro / pathlib.Path(builder_path).name)
    try:
        freeze = subprocess.run(
            [sys.executable, "-m", "pip", "freeze"], capture_output=True, text=True, timeout=120
        ).stdout
        (repro / "requirements_freeze.txt").write_text(freeze)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(f"pip freeze failed: {e}")


def parse_args(argv: Optional[Sequence[str]] = None,
               description: str = "ptdeco_tpu_torch LLM trainer") -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", required=True, type=pathlib.Path)
    parser.add_argument("--output-path", required=True, type=pathlib.Path)
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the task runs (default: the config's device, else cuda)")
    # multi-process bring-up: needs the port of parallel/
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--coordinator-address", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    setup_logging()
    args = parse_args(argv)
    if (
        args.distributed
        or args.coordinator_address is not None
        or args.num_processes is not None
        or args.process_id is not None
    ):
        raise NotImplementedError(
            "--distributed and the coordinator flags need the port of parallel/ "
            "(ROADMAP.md Queue 1 item 7)"
        )
    config = load_config(args.config)
    task = config.get("task")
    tasks = {"decompose_dwain": run_decompose_dwain.main, "finetune": run_finetune.main,
             "generate": run_generate.main}
    if task not in tasks:
        raise ValueError(f"Unknown task {task!r}")
    args.output_path.mkdir(exist_ok=True, parents=True)
    copy_config(args.config, args.output_path)
    original = args.output_path / "config_original.yaml"
    if args.config.resolve() != original.resolve():
        shutil.copy(args.config, original)

    tasks[task](config, args.output_path, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
