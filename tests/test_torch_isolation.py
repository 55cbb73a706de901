"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, so it runs where JAX is not installed."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "ptdeco_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py")
)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ptdeco_tpu'] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'ptdeco_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ptdeco_tpu\b(?!_torch)"
    r"|from\s+ptdeco_tpu\b(?!_torch))",
    re.MULTILINE,
)


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _FORBIDDEN.search(path.read_text()), path
