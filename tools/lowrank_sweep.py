"""Sweep the fused low-rank kernel's launch shape at the main path's shapes.

    python3 tools/lowrank_sweep.py [--f32]   (from the repo root, on a CUDA machine)

Calls the kernel's C entry point directly with every row tile, cluster size
and column-group count in a small grid, times each by CUDA-graph replay
(median of 25 after warm-up, inputs warm in L2) and prints one JSON line
per shape: the time of ``launch_shape``'s choice, the five fastest
choices, and how many clusters of each size fit on the card at once
(``cudaOccupancyMaxActiveClusters``).  ``--f32`` sweeps the f32 path
(``launch_shape_f32``) at its shapes instead: bench.py's MLP pairs, a
decode step and ConvNeXt-Tiny's f32 pairs.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from ptdeco_tpu_torch.ops import _build, lowrank  # noqa: E402
from tools.kernel_ab import time_ms  # noqa: E402

SHAPES = ((1024, 2048, 32, 5632), (1024, 5632, 32, 2048), (1024, 2048, 256, 5632),
          (512, 2048, 32, 5632), (512, 5632, 32, 2048), (4, 2048, 32, 5632),
          (4, 5632, 32, 2048))
F32_SHAPES = ((256, 2048, 32, 2048), (256, 2048, 256, 2048), (8, 2048, 32, 5632),
              (200704, 96, 24, 384), (3136, 3072, 192, 768))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lowrank_sweep.py needs a CUDA device")
    f32 = "--f32" in sys.argv[1:]
    if f32:
        symbol, occ_symbol, dtype, shapes = ("ptdeco_lowrank_matmul_f32",
                                             "ptdeco_lowrank_f32_max_clusters", torch.float32,
                                             F32_SHAPES)
        tiles, smem, chooser, unit = (lowrank.ROW_TILES_F32, lowrank.smem_bytes_f32,
                                      lowrank.launch_shape_f32, 16)
    else:
        symbol, occ_symbol, dtype, shapes = ("ptdeco_lowrank_matmul", "ptdeco_lowrank_max_clusters",
                                             torch.bfloat16, SHAPES)
        tiles, smem, chooser, unit = lowrank.ROW_TILES, lowrank.smem_bytes, lowrank.launch_shape, 8
    fn = _build.kernel_function("lowrank_matmul", symbol, lowrank._ARGTYPES)
    occ = _build.kernel_function("lowrank_matmul", occ_symbol, [ctypes.c_int] * 3)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    for n, d_in, r, d_out in shapes:
        x = torch.randn(n, d_in, device=dev, generator=g).to(dtype)
        w1 = (torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5).to(dtype)
        w2 = (torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5).to(dtype)
        out = torch.empty(n, d_out, device=dev, dtype=dtype)

        def run(bm, cluster, groups, cols):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), None, out.data_ptr(),
                    n, d_in, r, d_out, bm, cluster, groups, cols, stream)
            if rc != 0:
                raise RuntimeError(f"cudaError {rc}")

        results = []
        k_steps = max(1, -(-d_in // (32 if f32 else 64)))
        for bm in tiles:
            if bm > max(tiles[0], 2 * n) or smem(bm, r) > lowrank.MAX_SHARED_BYTES:
                continue
            for cluster in (1, 2, 4, 8):
                if cluster > k_steps:
                    continue
                for groups in (1, 2, 4, 8, 16):
                    cols = -(-d_out // (groups * cluster * unit)) * unit
                    if (groups - 1) * cluster * cols >= d_out:
                        continue  # an empty column group
                    ms = time_ms(lambda: run(bm, cluster, groups, cols), graph=True)
                    results.append({"bm": bm, "cluster": cluster, "groups": groups,
                                    "ctas": cluster * groups * -(-n // bm), "ms": ms})
        s = chooser(n, d_in, r, d_out)
        chosen = time_ms(lambda: run(s.bm, s.cluster, s.groups, s.cols_per_cta), graph=True)
        results.sort(key=lambda t: t["ms"])
        fits = {f"bm{bm}_c{c}": occ(r, bm, c) for bm in (tiles[0], tiles[-1]) for c in (1, 4, 8)}
        print(json.dumps({"n": n, "d_in": d_in, "r": r, "d_out": d_out, "dtype": str(dtype),
                          "chosen": s._asdict(), "chosen_ms": chosen, "best": results[:5],
                          "max_active_clusters": fits}), flush=True)


if __name__ == "__main__":
    main()
