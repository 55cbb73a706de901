"""Time the SYRK kernel's two template instances against each other.

    python3 tools/syrk_paths.py        (on a CUDA machine, from the repo root)

``csrc/syrk_gram.cu`` sends a bf16 Gram that is one 4096-row chunk and not
split over blocks to the instance without chunking (``kLong`` false) and
every other Gram to the chunked one.  This script builds the source as it
is and a copy with the chunked instance forced for every Gram (under
``build/syrk_paths/``), and times both on the same inputs by CUDA-graph
replay, in turns (this, forced, forced, this, this, forced), with each
result's largest error against the f32 Gram relative to its largest
entry.  Prints the card's name and power limit, then one JSON line a shape.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (N, d): TinyLlama's Grams and short Grams up to one chunk, then a split one
SHAPES = ((1024, 5632), (1024, 2048), (3136, 2048), (4096, 4096), (50176, 512))
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("syrk_paths.py needs a CUDA device")
    import chip_smoke
    from ptdeco_tpu_torch.ops import _build, gram

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi(), flush=True)
    out_dir = ROOT / "build" / "syrk_paths"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "syrk_gram.cu").read_text()
    forced = src.replace("const bool long_rows = splits > 1 || n > kChunkSteps * kBK;",
                         "const bool long_rows = true;")
    if forced == src:
        sys.exit("syrk_paths.py: the instance choice in csrc/syrk_gram.cu has changed")
    fns = {}
    for name, text in (("this", src), ("forced", forced)):
        (out_dir / f"{name}.cu").write_text(text)
        lib = out_dir / f"lib{name}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(lib), str(out_dir / f"{name}.cu")], check=True, capture_output=True)
        fn = ctypes.CDLL(str(lib)).ptdeco_syrk_gram
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, d in SHAPES:
        y = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
        ref = y.float().t() @ y.float()
        rows = gram.split_rows(n, d)
        t = -(-d // 128)
        ws = torch.empty(max(1, -(-n // rows)) * t * (t + 1) // 2 * 128 * 128, device=dev)
        out = torch.empty(d, d, device=dev)
        rec = {"N": n, "d": d, "rows_per_split": rows}
        for name in ("this", "forced", "forced", "this", "this", "forced"):
            def call(fn=fns[name]):
                rc = fn(y.data_ptr(), out.data_ptr(), n, d, 1, rows, ws.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"syrk launch failed: cudaError {rc}")
            call()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max() / ref.abs().max())
            rec.setdefault(name, []).append(
                {"ms": chip_smoke.time_ms(call, graph=True), "max_rel_err": err})
        print(json.dumps(rec), flush=True)
        del y, ref, ws, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
