"""Read the family phases' model-level gates again.

    python3 tools/family_gates.py [--kernels] [--seeds 0 1] [--only NAME ...]
    (from the repo root, on a CUDA machine)

Runs ``chip_smoke.py``'s kernel lines (with ``--kernels``), then its
``family_serve`` phase of every family (``qwen2_1_5b`` and
``FAMILY_CONFIGS``, or the ``--only`` ones) at each seed with the gates
opened, so that no reading stops the run, and prints each phase's JSON line
as ``chip_smoke.py`` does.  The last line is one JSON object: for each
family, the larger reading of the seeds of each gate (serve: the fused
serve and the cached ``generate``; reference: the CPU f32 reference) beside
the gate ``chip_smoke.py`` holds, and their ratio.  A family that raises is
reported and the run goes on.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import traceback

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from ptdeco_tpu_torch.ops import _build  # noqa: E402

# gates no reading reaches
OPEN = {"serve": (1e9, 1e9), "reference": (1e9, 1e9)}


def readings(rec: dict) -> dict[str, tuple[float, float]]:
    """A phase's (max, RMS-relative) readings by gate."""
    def pair(*parts):
        return (max(rec[p]["max_abs_diff"] for p in parts),
                max(rec[p]["rms_rel_diff"] for p in parts))

    return {"serve": pair("serve", "generate"), "reference": pair("reference")}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", action="store_true", help="run the kernel lines first")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--only", nargs="+", help="these families only")
    args = parser.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    _build.build_all()
    if args.kernels:
        cs.kernel_checks(dev)
    names = args.only or ["qwen2_1_5b", *cs.FAMILY_CONFIGS]
    gates = {n: cs.FAMILY_GATES[n] for n in names if n in cs.FAMILY_GATES}
    largest: dict[str, dict[str, list[float]]] = {}
    for seed in args.seeds:
        for name in names:
            cs.FAMILY_GATES[name] = OPEN
            lines = []
            emit = cs.emit

            def kept(obj: dict) -> None:
                lines.append(obj)
                emit(obj)

            cs.emit = kept
            try:
                cs.family_serve(dev, name, seed)
            except Exception:
                print(f"FAILED {name} seed {seed}", flush=True)
                traceback.print_exc()
            finally:
                cs.emit = emit
            for rec in lines:
                if rec.get("phase") == name:
                    for gate, got in readings(rec).items():
                        best = largest.setdefault(name, {}).setdefault(gate, [0.0, 0.0])
                        best[:] = [max(b, g) for b, g in zip(best, got)]
            torch.cuda.empty_cache()
    cs.emit({"gates": {
        name: {gate: {"largest": got, "gate": gates.get(name, {}).get(gate),
                      "ratio": [g / r if r else None for g, r in zip(gates[name][gate], got)]
                      if name in gates else None}
               for gate, got in by_gate.items()}
        for name, by_gate in largest.items()}, "seeds": args.seeds})


if __name__ == "__main__":
    main()
