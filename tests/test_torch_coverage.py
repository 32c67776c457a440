"""Every module of bito_tpu has a counterpart in bito_tpu_torch: the same
path, or one of the explicitly mapped exceptions below.  Likewise every
function of bito_tpu's package __init__, with one exception that has no
counterpart, and every function of the driver's entry points
(__graft_entry__.py at the root) in bito_tpu_torch/graft_entry.py."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "bito_tpu", ROOT / "bito_tpu_torch"

# bito_tpu module -> the port's modules that take its place.
MAPPED = {
    # The Pallas kernels' wrappers and host tapes: one module a kernel
    # family, the Hopper kernels' launchers beside their plain versions.
    "treelike/pallas_paired.py": ("treelike/paired.py",),
    "treelike/pallas_chunked.py": ("treelike/chunked.py",),
    "treelike/pallas_pruning.py": ("treelike/pernode.py",
                                   "treelike/prep.py"),
}
# Functions of bito_tpu/__init__.py without a counterpart, and why.
NO_COUNTERPART = {
    # XLA's persistent compilation cache: torch compiles no program a
    # shape, and the CUDA kernels are built once (treelike/_kernels.py).
    "_default_compilation_cache",
}


def _modules(package):
    return sorted(p.relative_to(package).as_posix()
                  for p in package.rglob("*.py"))


@pytest.mark.parametrize("module", _modules(JAX))
def test_module_has_a_counterpart(module):
    counterparts = MAPPED.get(module, (module,))
    missing = [m for m in counterparts if not (PORT / m).is_file()]
    assert not missing, f"bito_tpu/{module} has no counterpart: {missing}"


def test_mapped_exceptions_are_current():
    """Each mapped module still exists in bito_tpu and has no same-named
    module in the port (else the mapping would hide nothing)."""
    for module in MAPPED:
        assert (JAX / module).is_file(), module
        assert not (PORT / module).exists(), module


def _functions(path):
    return {node.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.FunctionDef)}


def test_package_functions_have_counterparts():
    jax_fns = _functions(JAX / "__init__.py")
    assert NO_COUNTERPART <= jax_fns
    assert jax_fns - NO_COUNTERPART <= _functions(PORT / "__init__.py")
    assert not NO_COUNTERPART & _functions(PORT / "__init__.py")


@pytest.mark.parametrize("function",
                         sorted(_functions(ROOT / "__graft_entry__.py")))
def test_graft_entry_functions_have_counterparts(function):
    assert function in _functions(PORT / "graft_entry.py")
