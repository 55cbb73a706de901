"""Sweep the tile shapes of the flash-attention and grouped-matmul kernels on the card.

    python3 tools/tile_sweep.py [--only KERNEL] [--reps N]   (from the repo root, on a CUDA machine)

For each variant in ``SWEEPS`` (the grouped kernel's 128-row prefill tile:
BN and ring stages; flash attention's K/V ring depth) copies
``ptdeco_tpu_torch/`` into ``build/tile_sweep/<name>/`` with one line of
the kernel's source set to that variant, builds every copy's kernel at
once (one ``nvcc`` each), then times the kernel's shapes in
``tools/kernel_ab.py`` in each copy, the copies in turns, ``--reps``
times.  Prints kernel_ab's JSON lines with the variant's name as the tag;
a variant that does not build is reported with the compiler's error lines
and skipped.  The chosen variant is the line as it stands in the source.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# kernel: (library, source, pattern of the line, the line's variants)
SWEEPS = {
    "grouped_matmul": (
        "grouped_matmul", "grouped_matmul.cu",
        r"using WgPrefill = WgTile<128, \d+, \d+>;",
        [f"using WgPrefill = WgTile<128, {bn}, {st}>;"
         for bn, st in ((256, 4), (256, 3), (128, 4), (128, 6))],
    ),
    "flash_attention": (
        "flash_attention_fwd", "flash_attention_fwd.cu",
        r"constexpr int kStages = \d+;", [f"constexpr int kStages = {n};" for n in (2, 3)],
    ),
}


def make_copy(kernel: str, line: str) -> tuple[str, pathlib.Path]:
    _, source, pattern, _ = SWEEPS[kernel]
    name = kernel + "_" + "_".join(re.findall(r"\d+", line))
    dst = ROOT / "build" / "tile_sweep" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "ptdeco_tpu_torch", dst / "ptdeco_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dst / "ptdeco_tpu_torch" / "csrc" / source
    text, n = re.subn(pattern, line, src.read_text())
    if n != 1:
        sys.exit(f"tile_sweep.py: no line matching {pattern!r} in {src}")
    src.write_text(text)
    return name, dst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(SWEEPS))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    copies = [(kernel, *make_copy(kernel, line))
              for kernel in ([args.only] if args.only else SWEEPS)
              for line in SWEEPS[kernel][3]]
    build = "from ptdeco_tpu_torch.ops import _build; _build.load_library({!r})"
    procs = [subprocess.Popen([sys.executable, "-c", build.format(SWEEPS[kernel][0])], cwd=d,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for kernel, _, d in copies]
    built = []
    for (kernel, name, d), proc in zip(copies, procs):
        out, _ = proc.communicate()
        if proc.returncode == 0:
            built.append((kernel, name, d))
        else:
            errors = [ln for ln in out.splitlines() if "error" in ln.lower()][:10]
            print(f"{name}: build failed: " + " | ".join(errors), flush=True)
    for _ in range(args.reps):
        for kernel, name, d in built:
            subprocess.run([sys.executable, str(ROOT / "tools" / "kernel_ab.py"), "--root", str(d),
                            "--tag", name, "--only", kernel], check=True)


if __name__ == "__main__":
    main()
