"""bito_tpu_torch stands alone: it imports without jax and without
bito_tpu, and builds nothing at import."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "bito_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in PACKAGE.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PACKAGE.rglob("*.py") if p.name != "__init__.py")

_PROBE = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import importlib
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "bito_tpu" or m.startswith("bito_tpu.")
             or m == "jax" and sys.modules[m] is not None)
assert not bad, bad
from bito_tpu_torch.treelike import _kernels
assert _kernels.library.cache_info().currsize == 0  # nothing loaded yet
print("ok", len({modules!r}))
"""


def test_imports_without_jax_or_bito_tpu():
    """Every module of the port imports in a fresh interpreter where jax
    cannot be imported, none of them loads bito_tpu, and no import loads
    the kernel library."""
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(MODULES))]


_FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import bito_tpu\b(?!_torch)|from bito_tpu\b(?!_torch)"
    r"|from \.\.\.? import bito_tpu\b)|torch\.compile", re.M)


@pytest.mark.parametrize("source", SOURCES)
def test_source_has_no_jax_bito_tpu_or_compile(source):
    """No source of the port imports jax or bito_tpu or calls
    torch.compile."""
    text = (ROOT / source).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


def test_kernel_library_path_names_the_source_hash():
    """The library's file name carries a hash of the sources, so an edit to
    a source builds anew."""
    from bito_tpu_torch.treelike import _kernels

    path = _kernels.library_path()
    assert path.parent == PACKAGE / "_build"
    assert re.fullmatch(r"libbito_paired_[0-9a-f]{16}\.so", path.name)
