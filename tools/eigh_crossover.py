"""Time a site's exact eigh against the randomized top-k EVD on one GPU.

    python3 tools/eigh_crossover.py [--reps 3] [--out FILE]

For a site of full rank F whose output Gram is D x D, ``dwain.decompose``
needs the top F/2 eigenvectors (reduction_factor 0.5).  "exact" is the
damped f64 eigh of the whole Gram (``engine.eigenvectors_from_gram``),
"randomized" the f32 subspace sketch with an f64 eigh of its (F/2 + 64)
square projection (``engine.randomized_topk_eigenvectors``); both run on
the card, as the port's walk runs them.  Each (F, D) pair prints one JSON
line with the median seconds of each (CUDA-synchronized wall time, after
one warm-up), then the card's name and power limit.  The pairs are the
square sites (q/o/down projections, D = F) from 1024 to 8192 and the MLP
up-projections of TinyLlama-1.1B and Llama-2-7B widths (D = 2.75 F).
``decomposition.AUTO_RANDOMIZED_EIGH_MIN_DIM`` is set from these lines.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from ptdeco_tpu_torch import engine  # noqa: E402

SITES = ((1024, 1024), (2048, 2048), (2560, 2560), (3072, 3072), (4096, 4096), (5632, 5632), (8192, 8192),
         (2048, 5632), (4096, 11008))


def seconds(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", help="also append the lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("eigh_crossover.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lines = []
    for full_rank, d in SITES:
        gen = torch.Generator(device=dev).manual_seed(d)
        a = torch.randn(d + 64, d, device=dev, generator=gen)
        g = a.t() @ a
        del a
        top_k = full_rank // 2
        exact = seconds(lambda: engine.eigenvectors_from_gram(g, in_float64=True, top_k=top_k),
                        args.reps)
        rand = seconds(lambda: engine.randomized_topk_eigenvectors(g, top_k), args.reps)
        rec = {"full_rank": full_rank, "gram_dim": d, "top_k": top_k, "exact_s": exact,
               "randomized_s": rand, "faster": "randomized" if rand < exact else "exact"}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
        del g
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines + [smi]) + "\n")


if __name__ == "__main__":
    main()
