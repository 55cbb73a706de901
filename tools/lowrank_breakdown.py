"""Break the fused low-rank kernel's f32 path down by timing edited copies.

    python3 tools/lowrank_breakdown.py        (from the repo root, on a CUDA machine)

Each variant is a copy of ``csrc/lowrank_matmul.cu`` with a few lines
replaced (a phase's products or loads removed, the TF32 split done by
``cvt.rna`` instead of integer operations, one TF32 pass instead of three),
built under ``build/lowrank_breakdown/<variant>/`` and called through its C
entry point at ``chip_smoke.py``'s f32 shapes with ``launch_shape_f32``'s
grid.  Prints one JSON line per variant and shape: the CUDA-graph replay
median of 50 (``ms``, as ``chip_smoke.py`` times kernels, host submission
included), the kernel's device time from torch.profiler (``device_ms``),
the largest error relative to cuBLAS's f32 result (large for the variants
that drop work), and the card's name and power limit.  A variant's time is
what is left when its part is gone: phase 1's products cost about
``kernel`` minus ``no_phase1_math``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ptdeco_tpu_torch.ops import _build, lowrank  # noqa: E402
from tools.kernel_ab import device_ms, time_ms  # noqa: E402

SHAPES = ((256, 2048, 32, 2048), (256, 2048, 256, 2048), (8, 2048, 32, 5632),
          (200704, 96, 24, 384), (3136, 3072, 192, 768))

P1_MATH = ("      if (wk < WK) {\n        for (int kk = wk;", "      if (false) {\n        for (int kk = wk;")
P2_MATH = ("      if (kb * (kFK / 8) + kk >= k8s) break;", "      break;")
P1_ALL = ("  const int p1 = chunks * my_ks;", "  const int p1 = 0;")
P2_ALL = ("  const int wsteps = units > warp ? (units - warp + 7) / 8 * ks2 : 0;",
          "  const int wsteps = 0;")
VARIANTS = {
    "kernel": [],
    "no_phase1_math": [P1_MATH],
    "no_phase2_math": [P2_MATH],
    "no_math": [P1_MATH, P2_MATH],
    "phase1_only": [P2_ALL],
    "phase2_only": [P1_ALL],
    "phase1_loads_only": [P2_ALL, P1_MATH],
    "phase2_loads_only": [P1_ALL, P2_MATH],
    "one_pass_tf32": [("    mma_tf32(c[j], al, bh + 2 * j);\n    mma_tf32(c[j], ah, bl + 2 * j);\n", "")],
    "cvt_split": [(
        "  hi = (a + 0x1000u) & 0xffffe000u;\n"
        "  lo = __float_as_uint(__uint_as_float(a) - __uint_as_float(hi));",
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(__uint_as_float(a)));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(__uint_as_float(a) - '
        "__uint_as_float(hi)));")],
}


def build(name: str, edits: list[tuple[str, str]], out: pathlib.Path) -> subprocess.Popen:
    src = (_build.CSRC / "lowrank_matmul.cu").read_text()
    head, marker, f32 = src.partition("// ---- the f32 path")  # edit the f32 kernel only
    for old, new in edits:
        if f32.count(old) != 1:
            raise SystemExit(f"variant {name}: the f32 kernel no longer has {old!r} once")
        f32 = f32.replace(old, new)
    src = head + marker + f32
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    (d / "lowrank_matmul.cu").write_text(src)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                             str(d / "lib.so"), str(d / "lowrank_matmul.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lowrank_breakdown.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference in full f32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = ROOT / "build" / "lowrank_breakdown"
    procs = {name: build(name, edits, out) for name, edits in VARIANTS.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out / name / "lib.so")).ptdeco_lowrank_matmul_f32
        fn.argtypes, fn.restype = lowrank._ARGTYPES, ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    for n, d_in, r, d_out in SHAPES:
        x = torch.randn(n, d_in, device=dev, generator=g)
        w1 = torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5
        w2 = torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5
        b = torch.randn(d_out, device=dev, generator=g)
        ref = torch.addmm(b, x @ w1.t(), w2.t())
        s = lowrank.launch_shape_f32(n, d_in, r, d_out)
        y = torch.empty(n, d_out, device=dev)
        for name, fn in fns.items():
            def run(fn=fn):
                rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), b.data_ptr(), y.data_ptr(),
                        n, d_in, r, d_out, s.bm, s.cluster, s.groups, s.cols_per_cta,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            run()
            torch.cuda.synchronize()
            err = float((y - ref).abs().max() / ref.abs().max())
            print(json.dumps({"variant": name, "n": n, "d_in": d_in, "r": r, "d_out": d_out,
                              "launch": s._asdict(), "ms": time_ms(run, reps=50, graph=True),
                              "device_ms": device_ms(run, reps=50), "max_rel_err": err,
                              "card": card}), flush=True)
        del x, w1, w2, b, ref, y
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
