"""bito_tpu_torch stands alone: it imports without jax and without
bito_tpu, and builds nothing at import (neither the CUDA kernels nor the
native library)."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "bito_tpu_torch"
# The port's sources, and its scripts at the root of the repository.
SCRIPTS = ("chip_smoke.py", "compare_first_design.py", "profile_main_path.py")
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in PACKAGE.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")
                 ) + list(SCRIPTS)
# Every module and package of the port (a package by its __init__.py).
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts[
        :-1 if p.name == "__init__.py" else None])
    for p in PACKAGE.rglob("*.py"))

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
from bito_tpu_torch import _native
assert _native.get_lib.cache_info().currsize == 0  # nor the native library
print("ok", len({modules!r}))
"""


def test_imports_without_jax_or_bito_tpu():
    """Every module of the port, the perf lab's, the native library's, the
    rooted instance's, the GP engine's and the NNI search's (parsimony/,
    tp/, nni/) included (and the package with its whole top-level API), imports in a fresh interpreter where
    jax cannot be imported, none of them loads bito_tpu, and no import
    loads the kernel library or the native one."""
    assert {"bito_tpu_torch.perflab", "bito_tpu_torch.perflab.__main__",
            "bito_tpu_torch.perflab.perf_lab", "bito_tpu_torch._native",
            "bito_tpu_torch.dag.subsplit_dag", "bito_tpu_torch.dag.graft",
            "bito_tpu_torch.treelike.rooted",
            "bito_tpu_torch.models.transforms",
            "bito_tpu_torch.perflab.perf_chunk_lab", "bito_tpu_torch.gp",
            "bito_tpu_torch.gp.engine", "bito_tpu_torch.gp.optimize",
            "bito_tpu_torch.api.gp", "bito_tpu_torch.dag.schedule",
            "bito_tpu_torch.dag.sampler", "bito_tpu_torch.dag.tidy",
            "bito_tpu_torch.dag.reference_order",
            "bito_tpu_torch.parsimony", "bito_tpu_torch.parsimony.sankoff",
            "bito_tpu_torch.tp", "bito_tpu_torch.tp.choice_map",
            "bito_tpu_torch.tp.engine", "bito_tpu_torch.tp.eval_engine",
            "bito_tpu_torch.tp.batch_scorer", "bito_tpu_torch.nni",
            "bito_tpu_torch.nni.engine", "bito_tpu_torch.nni.golden",
            "bito_tpu_torch.nni.search"} <= set(MODULES)
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
    """No source or script of the port (bitocore.cpp included) imports jax
    or bito_tpu or calls torch.compile."""
    text = (ROOT / source).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


def test_kernel_library_path_names_the_source_hash():
    """The library's file name carries a hash of the sources, so an edit to
    a source builds anew."""
    from bito_tpu_torch.treelike import _kernels

    path = _kernels.library_path()
    assert path.parent == PACKAGE / "_build"
    assert re.fullmatch(r"libbito_kernels_[0-9a-f]{16}\.so", path.name)
