"""Read ``chip_smoke.py``'s model-level gates again.

    python3 tools/family_gates.py [--kernels] [--moe-kernels] [--seeds 0 1] [--only NAME ...]
    python3 tools/family_gates.py --whole [--seeds 0 1]
    python3 tools/family_gates.py --only deepseek_v3 --seeds 0 --neutral KNOB [KNOB ...]
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
reported and the run goes on.  The near-tie gates of the MoE checks
(``Routing.gate``) are opened and recorded too, as "<what> near_ties".

``--neutral`` shows that a DeepSeek knob binds: each named knob in turn is
set to its neutral value on the card's tensors only (the correction bias
zeroed, the group limit lifted to one group, routed scaling 1.0, the latent
attention's scale multiplier 1.0), and the phases run again; the CPU f32
reference keeps the knob, so its ``_reference`` readings (logits, or the
near-tie share where the knob only moves the selection, which the
reference is forced to) must exceed their gates.  Readings are keyed
"<what> [<knob>]".
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


def _card_only(fn, attr: str, value):
    """``fn(mod, t, ...)`` with ``mod.<attr>`` at ``value`` while ``t`` lies
    on the card."""
    def patched(mod, t, *rest):
        if not t.is_cuda:
            return fn(mod, t, *rest)
        old = getattr(mod, attr)
        setattr(mod, attr, value)
        try:
            return fn(mod, t, *rest)
        finally:
            setattr(mod, attr, old)

    return patched


def neutral_patch(knob: str):
    """Set ``knob`` to its neutral value on card tensors; returns the undo."""
    tf = cs.models.transformer
    if knob == "mla_scale":
        own = tf.MLAttention.scale

        def scale(self):
            on_card = next(self.parameters()).is_cuda
            return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5 if on_card else own(self)

        tf.MLAttention.scale = scale
        return lambda: setattr(tf.MLAttention, "scale", own)
    name, attr, value = {"correction_bias": ("_moe_select", "gate_correction_bias", None),
                         "n_group": ("_moe_select", "n_group", 1),
                         "routed_scaling": ("moe_combine_weights", "routed_scaling", 1.0)}[knob]
    own = getattr(tf, name)
    setattr(tf, name, _card_only(own, attr, value))
    return lambda: setattr(tf, name, own)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", action="store_true", help="run the kernel lines first")
    parser.add_argument("--moe-kernels", action="store_true",
                        help="run the MoE serving path's kernel lines first")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--only", nargs="+", help="these families only")
    parser.add_argument("--whole", action="store_true", help="all of chip_smoke.main a seed")
    parser.add_argument("--neutral", nargs="+", default=[],
                        choices=["correction_bias", "n_group", "routed_scaling", "mla_scale"],
                        help="run the families once for each of these DeepSeek knobs at its "
                             "neutral value on the card")
    args = parser.parse_args()
    largest: dict[str, dict] = {}
    agree = cs.logits_agree
    near_tie_gate = cs.Routing.gate
    tag = {"knob": None}

    def record(what: str, limits: list, readings: list) -> None:
        key = f"{what} [{tag['knob']}]" if tag["knob"] else what
        rec = largest.setdefault(key, {"largest": [0.0] * len(limits), "gate": limits})
        rec["largest"] = [max(r, g) for r, g in zip(rec["largest"], readings)]

    def recorded(a, b, max_abs, rms_rel, what):
        if max_abs == 0.0 and rms_rel == 0.0:  # bit-equal: held as it is
            return agree(a, b, max_abs, rms_rel, what)
        got = agree(a, b, OPEN, OPEN, what)
        record(what, [max_abs, rms_rel], [got["max_abs_diff"], got["rms_rel_diff"]])
        return {**got, "limit_max_abs": max_abs, "limit_rms_rel": rms_rel}

    def near_ties(self, what, limit=cs.MAX_NEAR_TIE_SHARE):
        got = near_tie_gate(self, what, OPEN)
        record(f"{what} near_ties", [limit], [got["near_tie_share"]])
        return {**got, "limit_near_tie_share": limit}

    cs.logits_agree = recorded
    cs.Routing.gate = near_ties
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
        for knob in args.neutral or [None]:
            undo = neutral_patch(knob) if knob else None
            tag["knob"] = knob
            for seed in args.seeds:
                for name in names:
                    try:
                        cs.family_serve(dev, name, seed)
                    except Exception:
                        print(f"FAILED {name} seed {seed}", flush=True)
                        traceback.print_exc()
                    torch.cuda.empty_cache()
            if undo:
                undo()
    cs.emit({"gates": {what: {**rec, "ratio": [g / r if r else None for g, r in zip(
        rec["gate"], rec["largest"])]} for what, rec in largest.items()}, "seeds": args.seeds})


if __name__ == "__main__":
    main()
