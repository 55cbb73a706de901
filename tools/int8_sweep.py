"""Time the int8 grouped kernel's routes and decode tiles at the MoE shapes.

    python3 tools/int8_sweep.py [--ctas-per-sm 2,4,8] [--batch-tiles 128,256]
                                [--shapes decode|all]
                                                           (on a CUDA machine)

For each of ``chip_smoke.py``'s int8 shapes (Mixtral-8x7B width, 8 experts:
decode steps of 8 and 16 rows, 512 rows, the prefill's 4096 rows; gate/up
4096 -> 14336 and down 14336 -> 4096) holds ``grouped_matmul_int8`` against
its plain version, then times it by CUDA-graph replay (median of 25 after 3
warm-up runs, inputs warm in L2): a shape on the decode route under each
split target (CTAs an SM), a shape on the batch route under each tile of
group rows
(default: the one the wrapper chooses).  Beside them the dequantize route
(the grids dequantized to bf16, then the bf16 grouped kernel, as
``MoEMLP._grouped`` does), timed by CUDA events, since it allocates its
copies each call.  Prints one JSON line per timing with the byte and
operation bound (H100 SXM peaks) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
DIM, HIDDEN = 4096, 14336
# (tokens routed top-2 over 8 experts, K, N, group-size seed, what): the
# shapes and seeds of chip_smoke.py's int8 kernel lines
SHAPES = (
    (4, DIM, HIDDEN, 200 + 4 + DIM, "decode gate/up, batch 4"),
    (4, HIDDEN, DIM, 200 + 4 + HIDDEN, "decode down, batch 4"),
    (8, DIM, HIDDEN, 200 + 8 + DIM, "decode gate/up, batch 8"),
    (256, DIM, HIDDEN, 200 + 256 + DIM, "256 tokens gate/up"),
    (2048, DIM, HIDDEN, 200 + 2048 + DIM, "prefill gate/up"),
    (2048, HIDDEN, DIM, 200 + 2048 + HIDDEN, "prefill down"),
)


def routed_group_sizes(n_tokens: int, seed: int, n_experts: int = 8, top_k: int = 2):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(n_experts, 4.0))
    ids = [rng.choice(n_experts, top_k, replace=False, p=p) for _ in range(n_tokens)]
    return np.bincount(np.concatenate(ids), minlength=n_experts).astype(np.int32)


def time_ms(fn, reps: int = 25, warmup: int = 3, graph: bool = True) -> float:
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ctas-per-sm", default="4")
    ap.add_argument("--batch-tiles", default="")
    ap.add_argument("--shapes", choices=["decode", "all"], default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("int8_sweep.py needs a CUDA device")
    from ptdeco_tpu_torch import ops
    from ptdeco_tpu_torch.ops import gmm_int8

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    targets = [int(v) for v in args.ctas_per_sm.split(",")]
    tiles = [int(v) for v in args.batch_tiles.split(",") if v]
    chosen = gmm_int8.batch_rows
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    for n_tok, k, n, seed, what in SHAPES:
        sizes = routed_group_sizes(n_tok, seed)
        m, e, routed = int(sizes.sum()), len(sizes), int((sizes > 0).sum())
        route = gmm_int8.kernel_route(m, k, n, e)
        if args.shapes == "decode" and route != "decode":
            continue
        gs = torch.from_numpy(sizes).to(dev)
        xg = torch.randn(m, k, device=dev, generator=g).to(bf)
        w_q = [torch.randint(-127, 128, (n, k), device=dev, generator=g, dtype=torch.int8)
               for _ in sizes]
        scales = [(0.5 + 0.5 * torch.rand(n, device=dev, generator=g)) / (127 * k ** 0.5)
                  for _ in sizes]
        ref = ops.grouped_matmul_int8_plain(xg, w_q, scales, gs).float()
        tol = 2.0 ** -6 * ref.abs() + 2.0 ** -9 * ref.square().mean().sqrt()
        flops = 2 * m * k * n
        nbytes = 2 * m * k + routed * n * k + 4 * routed * n + 2 * m * n
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3

        def dequant_route():
            deq = [w.to(bf) * s.to(bf)[:, None] for w, s in zip(w_q, scales)]
            return ops.grouped_matmul(xg, deq, gs)

        rec = {"what": what, "M": m, "K": k, "N": n, "group_sizes": sizes.tolist(),
               "route": route, "bound_ms": bound_ms, "card": card}
        # the dequantize route allocates its copies each call: timed by events
        print(json.dumps({**rec, "dequant_route_ms": time_ms(dequant_route, graph=False)}),
              flush=True)
        if route == "decode":
            variants = [(c, None) for c in targets]
        else:
            variants = [(None, bn) for bn in tiles or [chosen(m, e)]]
        for per_sm, bn in variants:
            if per_sm is not None:
                gmm_int8.DECODE_CTAS_PER_SM = per_sm
            else:
                gmm_int8.batch_rows = lambda m, e, bn=bn: bn
            fn = lambda: ops.grouped_matmul_int8(xg, w_q, scales, gs)  # noqa: E731
            out = fn().float()
            torch.cuda.synchronize()
            err = float(torch.where(out == ref, 0.0, (out - ref).abs() / tol).max())
            ks = (gmm_int8.decode_split(m, k, n, e, gmm_int8._sm_count(0))
                  if route == "decode" else None)
            ms = time_ms(fn)
            print(json.dumps({**rec, "ctas_per_sm": per_sm, "split": ks, "bn": bn,
                              "err_to_tol": err, "ms": ms, "share_of_bound": bound_ms / ms}),
                  flush=True)
        del xg, w_q, scales, ref, tol
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
