"""Time the hand-written kernels of one checkout of the port.

    python3 tools/kernel_ab.py [--root DIR] [--tag NAME]      (on a CUDA machine)

Imports ``ptdeco_tpu_torch`` from DIR (default: this checkout), so two
checkouts can be compared in one run on one card: unpack the other
commit into a directory that ``.gitignore`` lists (``git archive``) and run
this script on each, in turns (A, B, B, A).  Each checkout builds its
kernels under its own ``build/``.  Prints one JSON line per shape: the
kernel's median time over 25 CUDA-event runs after 3 warm-up runs, inputs
warm in L2, called from Python (``eager_ms``) and replayed from a CUDA
graph (``ms``, device time), as ``chip_smoke.py`` times them; the device
time of its kernels from torch.profiler (``device_ms``); for flash
attention and the bf16 grouped matmul the one PyTorch call that computes
the same function, replayed from a graph (``library_ms``; for the f32
low-rank shapes ``addmm``, cuBLAS in full f32); for the int8
grouped matmul (at the decode steps' 8 and 16 rows, 512 rows and the
prefill's 4096) the dequantize route beside it, by events
(``dequant_route_ms``); for SYRK ``y.t() @ y`` as ``library_ms`` and the
largest error against the f32 Gram relative to its largest entry
(``max_rel_err``); the grouped kernels' route where the checkout names one
(``path``); and the card's name and power limit.  ``--only NAME`` (repeatable) times one kernel's
shapes.
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

# (n, d_in, r, d_out, bias, dtype): the served TinyLlama pairs at the
# forward's 1024 rows, `generate`'s decode step (4) and prefill (512), and a
# wide rank, in bf16; then the f32 path at chip_smoke.py's f32 shapes:
# bench.py's MLP pairs (rank 32 and 256), a decode step's 8 rows, and
# ConvNeXt-Tiny's stage-1 and stage-4 pairs
LOWRANK_SHAPES = (
    (1024, 2048, 32, 5632, False, "bf16"), (1024, 5632, 32, 2048, False, "bf16"),
    (1024, 2048, 256, 5632, True, "bf16"), (1024, 2048, 44, 5632, True, "bf16"),
    (4, 2048, 32, 5632, False, "bf16"), (4, 5632, 32, 2048, False, "bf16"),
    (512, 2048, 32, 5632, False, "bf16"), (512, 5632, 32, 2048, False, "bf16"),
    (256, 2048, 32, 2048, True, "f32"), (256, 2048, 256, 2048, True, "f32"),
    (8, 2048, 32, 5632, True, "f32"), (200704, 96, 24, 384, True, "f32"),
    (3136, 3072, 192, 768, True, "f32"),
)
# (N, d), bf16: TinyLlama's Grams, then ResNet-50's conv sites at batch 64
# (layer2/3/4 conv3, layer2's downsample over its 56 x 56 input pixels) and
# 200704 rows at d 256
SYRK_SHAPES = ((1024, 5632), (1024, 2048), (50176, 512), (12544, 1024), (3136, 2048),
               (200704, 512), (200704, 256))
# (b, h, h_kv, s, head_dim): the TinyLlama decompose forward and the
# Mixtral-width prefill of 4 x 512
FLASH_SHAPES = ((1, 32, 4, 1024, 64), (4, 32, 8, 512, 128))
# (tokens routed top-2 over 8 experts, K, N, group-size seed): chip_smoke.py's
# Mixtral-width prefill (4 x 512 tokens) and decode (batch 8) shapes
GROUPED_SHAPES = ((2048, 4096, 14336, 100 + 2048 + 4096),
                  (2048, 14336, 4096, 100 + 2048 + 14336),
                  (8, 4096, 14336, 100 + 8 + 4096), (8, 14336, 4096, 100 + 8 + 14336))
GMM_INT8_SHAPES = ((4, 4096, 14336, 200 + 4 + 4096), (4, 14336, 4096, 200 + 4 + 14336),
                   (8, 4096, 14336, 200 + 8 + 4096), (256, 4096, 14336, 200 + 256 + 4096),
                   (2048, 4096, 14336, 200 + 2048 + 4096),
                   (2048, 14336, 4096, 200 + 2048 + 14336))


def routed_group_sizes(n_tokens: int, seed: int, n_experts: int = 8, top_k: int = 2):
    """chip_smoke.py's group sizes: ``n_tokens`` tokens each routed to
    ``top_k`` distinct experts, with uneven expert popularity."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(n_experts, 4.0))
    ids = [rng.choice(n_experts, top_k, replace=False, p=p) for _ in range(n_tokens)]
    return np.bincount(np.concatenate(ids), minlength=n_experts).astype(np.int32)


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


def times(fn, library=None) -> dict:
    out = {"eager_ms": time_ms(fn), "device_ms": device_ms(fn), "ms": time_ms(fn, graph=True)}
    if library is not None:
        try:
            out["library_ms"] = time_ms(library, graph=True)
        except RuntimeError as exc:  # a call that cannot be captured
            out["library_ms"], out["library_error"] = None, str(exc)[:200]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--only", action="append",
                    choices=["lowrank_matmul", "syrk_gram", "flash_attention", "grouped_matmul",
                             "gmm_int8"])
    args = ap.parse_args()
    want = set(args.only or ["lowrank_matmul", "syrk_gram", "flash_attention", "grouped_matmul",
                             "gmm_int8"])
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references in full f32
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from ptdeco_tpu_torch import ops
    from ptdeco_tpu_torch.ops import gmm, gmm_int8

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    for n, d_in, r, d_out, with_bias, dt in LOWRANK_SHAPES if "lowrank_matmul" in want else ():
        dtype = {"bf16": bf, "f32": torch.float32}[dt]
        x = torch.randn(n, d_in, device=dev, generator=g).to(dtype)
        # the factors as a fused pair holds them: views of the Linear weights
        k1 = (torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5).to(dtype).t()
        k2 = (torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5).to(dtype).t()
        b = torch.randn(d_out, device=dev, generator=g).to(dtype) if with_bias else None
        library = (lambda: torch.addmm(b, x @ k1, k2)) if dt == "f32" else None
        t = times(lambda: ops.lowrank_matmul(x, k1, k2, b), library)
        print(json.dumps({"tag": args.tag, "kernel": "lowrank_matmul", "n": n, "d_in": d_in,
                          "r": r, "d_out": d_out, "bias": with_bias, "dtype": dt, **t,
                          "card": card}), flush=True)
        del x, k1, k2, b
        torch.cuda.empty_cache()
    for n, d in SYRK_SHAPES if "syrk_gram" in want else ():
        y = torch.randn(n, d, device=dev, generator=g).to(bf)
        ref = y.float().t() @ y.float()  # f32 products, no TF32
        err = float((ops.syrk_gram(y) - ref).abs().max() / ref.abs().max())
        del ref
        t = times(lambda: ops.syrk_gram(y), lambda: y.t() @ y)
        print(json.dumps({"tag": args.tag, "kernel": "syrk_gram", "N": n, "d": d, **t,
                          "max_rel_err": err, "card": card}), flush=True)
        del y
        torch.cuda.empty_cache()
    for b, h, h_kv, s, hd in FLASH_SHAPES if "flash_attention" in want else ():
        q = torch.randn(b, h, s, hd, device=dev, generator=g).to(bf)
        k = torch.randn(b, h_kv, s, hd, device=dev, generator=g).to(bf)
        v = torch.randn(b, h_kv, s, hd, device=dev, generator=g).to(bf)
        scale = hd ** -0.5
        t = times(lambda: ops.flash_attention(q, k, v, scale),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      q, k, v, is_causal=True, scale=scale, enable_gqa=True))
        print(json.dumps({"tag": args.tag, "kernel": "flash_attention", "b": b, "h": h,
                          "h_kv": h_kv, "s": s, "head_dim": hd, **t, "card": card}), flush=True)
        del q, k, v
    for n_tok, k, n, seed in GROUPED_SHAPES if "grouped_matmul" in want else ():
        sizes = routed_group_sizes(n_tok, seed)
        m = int(sizes.sum())
        lhs = torch.randn(m, k, device=dev, generator=g).to(bf)
        weights = [(torch.randn(n, k, device=dev, generator=g) / k ** 0.5).to(bf) for _ in sizes]
        gs = torch.from_numpy(sizes).to(dev)
        stack = torch.stack(weights).transpose(1, 2)
        offs = torch.cumsum(gs, 0).to(torch.int32)
        t = times(lambda: ops.grouped_matmul(lhs, weights, gs),
                  lambda: torch._grouped_mm(lhs, stack, offs=offs))
        path = gmm.kernel_route(m, k, n, len(sizes)) if hasattr(gmm, "kernel_route") else None
        print(json.dumps({"tag": args.tag, "kernel": "grouped_matmul", "M": m, "K": k, "N": n,
                          "group_sizes": sizes.tolist(), "path": path, **t, "card": card}),
              flush=True)
        del lhs, weights, stack
        torch.cuda.empty_cache()
    for n_tok, k, n, seed in GMM_INT8_SHAPES if "gmm_int8" in want else ():
        sizes = routed_group_sizes(n_tok, seed)
        m = int(sizes.sum())
        gs = torch.from_numpy(sizes).to(dev)
        xg = torch.randn(m, k, device=dev, generator=g).to(bf)
        w_q = [torch.randint(-127, 128, (n, k), device=dev, generator=g, dtype=torch.int8)
               for _ in sizes]
        scales = [(0.5 + 0.5 * torch.rand(n, device=dev, generator=g)) / (127 * k ** 0.5)
                  for _ in sizes]
        def dequant_route():  # every grid dequantized, then the bf16 grouped kernel
            deq = [w.to(bf) * s.to(bf)[:, None] for w, s in zip(w_q, scales)]
            return ops.grouped_matmul(xg, deq, gs)

        t = times(lambda: ops.grouped_matmul_int8(xg, w_q, scales, gs))
        # the dequantize route allocates its copies each call: by events
        t["dequant_route_ms"] = time_ms(dequant_route)
        path = (gmm_int8.kernel_route(m, k, n, len(sizes))
                if hasattr(gmm_int8, "kernel_route") else None)
        print(json.dumps({"tag": args.tag, "kernel": "gmm_int8", "M": m, "K": k, "N": n,
                          "group_sizes": sizes.tolist(), "path": path, **t, "card": card}),
              flush=True)
        del xg, w_q, scales
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
