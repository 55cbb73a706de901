"""Time the fused low-rank and SYRK Gram kernels of one checkout of the port.

    python3 tools/kernel_ab.py [--root DIR] [--tag NAME]      (on a CUDA machine)

Imports ``ptdeco_tpu_torch`` from DIR (default: this checkout), so two
checkouts can be compared in one run on one card: unpack the other
commit into a directory that ``.gitignore`` lists (``git archive``) and run
this script on each, in turns (A, B, B, A).  Each checkout builds its
kernels under its own ``build/``.  Prints one JSON line per shape: the
kernel's median time over 25 CUDA-event runs after 3 warm-up runs, inputs
warm in L2, called from Python (``eager_ms``) and replayed from a CUDA
graph (``ms``, device time), as ``chip_smoke.py`` times them; the device
time of its kernels from torch.profiler (``device_ms``); and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

# (n, d_in, r, d_out, bias): the served TinyLlama pairs at the forward's
# 1024 rows, `generate`'s decode step (4) and prefill (512), and a wide rank
LOWRANK_SHAPES = (
    (1024, 2048, 32, 5632, False), (1024, 5632, 32, 2048, False),
    (1024, 2048, 256, 5632, True), (1024, 2048, 44, 5632, True),
    (4, 2048, 32, 5632, False), (4, 5632, 32, 2048, False),
    (512, 2048, 32, 5632, False), (512, 5632, 32, 2048, False),
)
SYRK_SHAPES = ((1024, 5632), (1024, 2048))  # (N, d), bf16


def time_ms(fn, reps: int = 25, warmup: int = 3, graph: bool = False) -> float:
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            fn()
        fn = captured.replay
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_ms(fn, reps: int = 25) -> float:
    """Device time of the kernels ``fn`` launches, per call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages())
    return us / reps / 1e3


def times(fn) -> dict:
    return {"eager_ms": time_ms(fn), "device_ms": device_ms(fn), "ms": time_ms(fn, graph=True)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA device")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from ptdeco_tpu_torch import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    for n, d_in, r, d_out, with_bias in LOWRANK_SHAPES:
        x = torch.randn(n, d_in, device=dev, generator=g).to(bf)
        # the factors as a fused pair holds them: views of the Linear weights
        k1 = (torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5).to(bf).t()
        k2 = (torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5).to(bf).t()
        b = torch.randn(d_out, device=dev, generator=g).to(bf) if with_bias else None
        t = times(lambda: ops.lowrank_matmul(x, k1, k2, b))
        print(json.dumps({"tag": args.tag, "kernel": "lowrank_matmul", "n": n, "d_in": d_in,
                          "r": r, "d_out": d_out, "bias": with_bias, **t, "card": card}),
              flush=True)
    for n, d in SYRK_SHAPES:
        y = torch.randn(n, d, device=dev, generator=g).to(bf)
        t = times(lambda: ops.syrk_gram(y))
        print(json.dumps({"tag": args.tag, "kernel": "syrk_gram", "N": n, "d": d, **t,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
