"""Read ``chip_smoke.py``'s model-level gates again.

    python3 tools/family_gates.py [--kernels] [--moe-kernels] [--seeds 0 1] [--only NAME ...]
    python3 tools/family_gates.py --whole [--seeds 0 1]
    (from the repo root, on a CUDA machine)

Every model-level gate of ``chip_smoke.py`` is a ``logits_agree`` call;
this tool opens them all (but the bit-equal ones, whose limit is 0), so
that no reading stops the run, and records each call's readings beside
the limit the call asked for.  By default it runs ``chip_smoke.py``'s
kernel lines (with ``--kernels``; the MoE serving path's with
``--moe-kernels``), then its ``family_serve`` phase of every
family (``qwen2_1_5b`` and ``FAMILY_CONFIGS``, or the ``--only`` ones) at
each seed; with ``--whole`` all of ``chip_smoke.main`` at each seed (slice
1's model, its trainer CLI and phi-2 included).  Each phase's JSON line is
printed as ``chip_smoke.py`` prints it.  The last line is one JSON object:
for each gate (the ``what`` of its call), the larger reading of the seeds
beside the limit and their ratio.  A family or seed that raises is
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

# a limit no reading reaches
OPEN = 1e9


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", action="store_true", help="run the kernel lines first")
    parser.add_argument("--moe-kernels", action="store_true",
                        help="run the MoE serving path's kernel lines first")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--only", nargs="+", help="these families only")
    parser.add_argument("--whole", action="store_true", help="all of chip_smoke.main a seed")
    args = parser.parse_args()
    largest: dict[str, dict] = {}
    agree = cs.logits_agree

    def recorded(a, b, max_abs, rms_rel, what):
        if max_abs == 0.0 and rms_rel == 0.0:  # bit-equal: held as it is
            return agree(a, b, max_abs, rms_rel, what)
        got = agree(a, b, OPEN, OPEN, what)
        rec = largest.setdefault(what, {"largest": [0.0, 0.0], "gate": [max_abs, rms_rel]})
        rec["largest"] = [max(r, g) for r, g in zip(rec["largest"], (
            got["max_abs_diff"], got["rms_rel_diff"]))]
        return {**got, "limit_max_abs": max_abs, "limit_rms_rel": rms_rel}

    cs.logits_agree = recorded
    for name in ("qwen2_1_5b", *cs.FAMILY_CONFIGS):
        # a family without gates yet gets placeholders, recorded as such
        cs.FAMILY_GATES.setdefault(name, {"serve": (0.0625, 1e-2), "reference": (0.0625, 1e-2)})
    if args.whole:
        for seed in args.seeds:
            sys.argv = ["chip_smoke.py", "--seed", str(seed)]
            try:
                cs.main()
            except Exception:
                print(f"FAILED chip_smoke.main seed {seed}", flush=True)
                traceback.print_exc()
            torch.cuda.empty_cache()
    else:
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(cs.nvidia_smi(), flush=True)
        _build.build_all()
        if args.kernels:
            cs.kernel_checks(dev)
        if args.moe_kernels:
            cs.moe_kernel_checks(dev, {k: [] for k in cs.KERNEL_INFO})
        names = args.only or ["qwen2_1_5b", *cs.FAMILY_CONFIGS]
        for seed in args.seeds:
            for name in names:
                try:
                    cs.family_serve(dev, name, seed)
                except Exception:
                    print(f"FAILED {name} seed {seed}", flush=True)
                    traceback.print_exc()
                torch.cuda.empty_cache()
    cs.emit({"gates": {what: {**rec, "ratio": [g / r if r else None for g, r in zip(
        rec["gate"], rec["largest"])]} for what, rec in largest.items()}, "seeds": args.seeds})


if __name__ == "__main__":
    main()
