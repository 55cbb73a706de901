"""Time the flash-attention kernel of one checkout against SDPA, short and long sequences.

    python3 tools/flash_probe.py ROOT TAG      (from the repo root, on a CUDA machine)

Imports ``ptdeco_tpu_torch`` from ROOT and prints, for each (b, h, h_kv,
s, head_dim) in ``SHAPES``, the kernel's and SDPA's CUDA-graph replay time
(``tools/kernel_ab.py:time_ms``) and the causal products' rate in TFLOP/s,
one JSON line each, tagged TAG.  Long sequences show the kernel's
steady-state rate; short ones its per-tile overhead.
"""

import json
import pathlib
import sys

import torch

SHAPES = ((1, 32, 8, 4096, 128), (1, 32, 4, 4096, 64), (4, 32, 8, 512, 128), (1, 32, 4, 1024, 64))


def main() -> None:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    from kernel_ab import time_ms
    from ptdeco_tpu_torch import ops

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    for b, h, h_kv, s, d in SHAPES:
        q = torch.randn(b, h, s, d, device=dev, generator=g).to(bf)
        k = torch.randn(b, h_kv, s, d, device=dev, generator=g).to(bf)
        v = torch.randn(b, h_kv, s, d, device=dev, generator=g).to(bf)
        scale = d ** -0.5
        ms = time_ms(lambda: ops.flash_attention(q, k, v, scale), graph=True)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), graph=True)
        flops = 4 * b * h * d * s * (s + 1) / 2
        print(json.dumps({"tag": tag, "b": b, "h": h, "h_kv": h_kv, "s": s, "head_dim": d,
                          "ms": ms, "tflops": flops / ms / 1e9, "sdpa_ms": sdpa,
                          "sdpa_tflops": flops / sdpa / 1e9}), flush=True)


if __name__ == "__main__":
    main()
