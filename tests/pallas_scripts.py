"""Running the Pallas kernels of bito_tpu's perf-lab scripts (scripts/) in
interpret mode on the CPU, for the tests that hold the port's perf lab
against them.

The scripts pass no interpret flag and keep some of their pallas_call
results inside a function, so a test loads a script by path and gives it
a `pl` whose pallas_call adds interpret=True and records what it builds.
Neither scripts/ nor bito_tpu/ is edited for this.

This module imports jax, pallas and numpy only (no torch), so that a
spawned worker process that runs a kernel starts fast.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
# What the scripts import from bito_tpu.  Each script puts a fixed checkout
# path first on sys.path before it imports them; imported here first, they
# come from this checkout, whatever that path holds.
SCRIPT_IMPORTS = ("bito_tpu", "bito_tpu.core.newick",
                  "bito_tpu.core.site_pattern", "bito_tpu.models.phylo_model",
                  "bito_tpu.treelike.engine", "bito_tpu.treelike.pallas_pruning",
                  "bito_tpu.treelike.pallas_chunked")


def bito_tpu_outside_checkout() -> list:
    """The imported bito_tpu modules whose files lie outside this
    checkout."""
    return [name for name, mod in list(sys.modules.items())
            if name.split(".")[0] == "bito_tpu"
            and getattr(mod, "__file__", None)
            and not pathlib.Path(mod.__file__).resolve().is_relative_to(ROOT)]


def load_script(name: str) -> types.ModuleType:
    """scripts/<name>.py loaded by path (scripts/ is not a package), with
    bito_tpu from this checkout; the script's own edit of sys.path is
    undone."""
    for module_name in SCRIPT_IMPORTS:
        importlib.import_module(module_name)
    spec = importlib.util.spec_from_file_location(f"script_{name}",
                                                  SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    saved = sys.path[:]
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    outside = bito_tpu_outside_checkout()
    if outside:
        raise ImportError(f"scripts/{name}.py imported {outside} from "
                          f"outside {ROOT}")
    return module


class _Pallas(types.ModuleType):
    """jax.experimental.pallas with its own pallas_call."""

    def __getattr__(self, name):
        return getattr(pl, name)


def interpret_pallas(script: types.ModuleType, monkeypatch,
                     stub: bool = False) -> list:
    """Give the script a `pl` whose pallas_call runs in interpret mode and
    records every callable it builds, in order, in the list returned.
    With stub, the script itself gets a callable that returns zeros of the
    output shape, so that its timing sweeps cost nothing, and the test
    calls the recorded one."""
    built = []

    def pallas_call(kernel, *, out_shape, **kw):
        call = pl.pallas_call(kernel, out_shape=out_shape,
                              **dict(kw, interpret=True))
        built.append(call)
        if not stub:
            return call
        return lambda *args: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    proxy = _Pallas("pallas_interpret")
    proxy.pallas_call = pallas_call
    monkeypatch.setattr(script, "pl", proxy)
    return built


def perf_lab_variant(args, static: dict, knobs) -> tuple:
    """(ll, grads) as numpy from scripts/perf_lab.py's variant kernel with
    `knobs`, or, for knobs None, from the shipping kernel
    (pallas_pruning.pallas_ll_and_gradients, the script's base), in
    interpret mode.  args: the kernels' positional arguments as numpy
    arrays.  Runs in a spawned process, so jax is set up here as
    tests/conftest.py sets it up."""
    import pytest

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    args = [jnp.asarray(a) for a in args]
    if knobs is None:
        from bito_tpu.treelike import pallas_pruning

        out = pallas_pruning.pallas_ll_and_gradients(*args, **static,
                                                     interpret=True)
    else:
        script = load_script("perf_lab")
        with pytest.MonkeyPatch.context() as mp:
            interpret_pallas(script, mp)
            out = script.variant_ll_and_gradients(*args, **static, **knobs)
    return tuple(np.asarray(x) for x in out)
