"""The perf lab's variant kernel (bito_tpu_torch/perflab/perf_lab.py)
against scripts/perf_lab.py's Pallas kernel (make_variant_kernel), run in
interpret mode on the CPU, on the 9-taxon case of test_torch_pernode.py.

The plain version of base, unroll, resk4, resk8 and loop_resk4 is the
per-node plain version, whatever the knobs: they change only where the
partials are rescaled.  Bounds as bench.py's guard: within 1e-5 relative
on log likelihoods and 5e-5 of the largest gradient.  nodot is not a
likelihood (most patterns' LL are -inf): its non-finite values must sit at
the same places with the same values, and its finite ones keep the same
bounds.  The unrolled variants compile for the trifurcating case's tape
(8 ops, 15 pre-ops); base and loop_resk4 run on both root shapes.

Lowering an unrolled kernel for interpret mode takes about 6 s of Python,
so the four unrolled variants run in four spawned processes, side by side,
while this process runs the loops (tests/pallas_scripts.py)."""
import functools
import importlib
import multiprocessing
import pathlib
import sys
import types
from concurrent.futures import ProcessPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_pruning
from bito_tpu_torch.perflab import perf_lab
from bito_tpu_torch.treelike import pernode

from pallas_scripts import (ROOT, bito_tpu_outside_checkout, load_script,
                            perf_lab_variant)
from torch_port_cases import (GTR, jax_engine, jax_params, make_case,
                              max_norm, max_rel, pernode_operands,
                              torch_engine)

B = 4
KNOBS = {"base": dict(unroll=False, resk=1, nodot=False), **perf_lab.VARIANTS}
# (variant, rooted) of the Pallas runs: the unrolled ones take seconds each
# to lower, the loops well under one.
UNROLLED = [("unroll", False), ("resk4", False), ("resk8", False),
            ("nodot", False)]
LOOPED = [("base", False), ("base", True), ("loop_resk4", False),
          ("loop_resk4", True)]


@functools.cache
def _case(rooted):
    """(the Pallas kernels' arguments as numpy and static options, the
    port's pernode operands) for 9 taxa x 150 patterns x 4 trees,
    GTR+Gamma4."""
    case = make_case(seed=31, num_taxa=9, num_sites=150, num_trees=B,
                     rooted=rooted)
    je = jax_engine(case, "gtr_gamma4")
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jax_params(GTR), B)
    sp = je.site_pattern
    args = (enc.post_ops, enc.pre_ops, enc.root,
            np.asarray(enc.edge_mask, np.float32),
            *(np.asarray(x) for x in pallas_pruning.prepare_inputs_grad(
                enc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights,
                eig, rates, props, clock, bl, je.pattern_pad)))
    static = dict(num_slots=enc.num_slots, category_count=4,
                  s_tile=je._pallas_s_tile())
    ops, extra = pernode_operands(torch_engine(case, "gtr_gamma4"), case, GTR)
    return args, static, dict(ops, **extra)


def _split_nonfinite(a, b):
    """Check that a and b are non-finite at the same places, with the same
    values there (equal infinities, NaN against NaN); return their finite
    values, (a's, b's), as float64 arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    fa, fb = np.isfinite(a), np.isfinite(b)
    assert (fa == fb).all()
    np.testing.assert_array_equal(a[~fa], b[~fb])
    return a[fa], b[fb]


def _pallas_args(name, rooted):
    return (*_case(rooted)[:2], None if name == "base" else KNOBS[name])


@pytest.fixture(scope="module")
def pallas():
    """{(variant, rooted): the Pallas kernel's (ll, grads)}: the unrolled
    variants in four spawned processes, the loops here meanwhile."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(UNROLLED), mp_context=ctx) as pool:
        # The workers import jax and bito_tpu while this process builds the
        # cases.
        for _ in UNROLLED:
            pool.submit(importlib.import_module,
                        "bito_tpu.treelike.pallas_pruning")
        futures = {key: pool.submit(perf_lab_variant, *_pallas_args(*key))
                   for key in UNROLLED}
        out = {key: perf_lab_variant(*_pallas_args(*key)) for key in LOOPED}
        out.update((key, f.result(timeout=300)) for key, f in futures.items())
    return out


@pytest.mark.parametrize("name,rooted", [
    ("base", False), ("base", True), ("loop_resk4", False),
    ("loop_resk4", True), ("unroll", False), ("resk4", False),
    ("resk8", False)])
def test_plain_matches_pallas_interpret(pallas, name, rooted):
    ll_pl, g_pl = pallas[name, rooted]
    ops = _case(rooted)[2]
    assert ops["post_ops"].shape[1] == 8
    assert ops["pre_ops"].shape[1] == (16 if rooted else 15)
    ll, g = perf_lab.variant_ll_and_gradients_ref(**ops, **KNOBS[name])
    assert ll.dtype == torch.float32 and g.shape == g_pl.shape
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5


def test_nodot_plain_matches_pallas_interpret(pallas):
    """nodot: equal non-finite positions, finite values within the bounds."""
    ll_pl, g_pl = pallas["nodot", False]
    ll, g = perf_lab.variant_ll_and_gradients_ref(**_case(False)[2],
                                                  **KNOBS["nodot"])
    assert not np.isfinite(ll_pl).all()  # not a likelihood
    ll_f, ll_pl_f = _split_nonfinite(ll.numpy(), ll_pl)
    if ll_f.size:
        assert max_rel(ll_f, ll_pl_f) < 1e-5
    g_f, g_pl_f = _split_nonfinite(g.numpy(), g_pl)
    if g_f.size and np.abs(g_pl_f).max() > 0:
        assert max_norm(g_f, g_pl_f) < 5e-5
    else:
        np.testing.assert_array_equal(g_f, g_pl_f)


@pytest.mark.parametrize("name", list(perf_lab.VARIANTS))
def test_wrapper_takes_the_plain_version_for_cpu_tensors(name):
    ops = _case(True)[2]
    before = perf_lab.variant_ll_and_gradients.launches
    got = perf_lab.variant_ll_and_gradients(**ops, **KNOBS[name])
    want = perf_lab.variant_ll_and_gradients_ref(**ops, **KNOBS[name])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert perf_lab.variant_ll_and_gradients.launches == before


def test_knobs_are_checked():
    ops = _case(False)[2]
    with pytest.raises(ValueError, match="resk"):
        perf_lab.variant_ll_and_gradients(**ops, unroll=True, resk=3,
                                          nodot=False)
    with pytest.raises(ValueError, match="unrolled"):
        perf_lab.variant_ll_and_gradients(**ops, unroll=False, resk=4,
                                          nodot=False)
    for unroll, resk in ((False, 1), (True, 4)):
        with pytest.raises(ValueError, match="nodot"):
            perf_lab.variant_ll_and_gradients(**ops, unroll=unroll, resk=resk,
                                              nodot=True)


def test_scripts_take_bito_tpu_from_this_checkout(monkeypatch, tmp_path):
    """The script puts a fixed checkout path first on sys.path; its
    bito_tpu imports still come from this checkout, and a bito_tpu module
    from anywhere else is caught."""
    script = load_script("perf_lab")
    assert pathlib.Path(script.pp.__file__).resolve().is_relative_to(ROOT)
    assert pathlib.Path(sys.modules["bito_tpu"].__file__).resolve(
        ).is_relative_to(ROOT)
    assert bito_tpu_outside_checkout() == []
    stray = types.ModuleType("bito_tpu.stray")
    stray.__file__ = str(tmp_path / "stray.py")
    monkeypatch.setitem(sys.modules, "bito_tpu.stray", stray)
    assert bito_tpu_outside_checkout() == ["bito_tpu.stray"]
    with pytest.raises(ImportError, match="bito_tpu.stray"):
        load_script("perf_lab")


def test_flagship_tapes_are_the_unrolled_lengths():
    """The CUDA kernel unrolls for the flagship's tape lengths only; the
    flagship's tapes have them, and its on-chip tape as many parent
    groups as the unrolled preorder walks."""
    ops = perf_lab.flagship_operands("cpu", batch=3)
    assert ops["post_ops"].shape == (3, perf_lab.UNROLL_M, 5)
    assert ops["pre_ops"].shape == (3, perf_lab.UNROLL_MP, 6)
    assert ops["P"].shape[2] == perf_lab.CATEGORIES
    assert ops["tips"].shape[-1] == 1024
    assert perf_lab.onchip_of(ops) is None  # the CPU needs no tape
    tape = pernode.onchip_tape(
        *(ops[k].numpy() for k in ("post_ops", "pre_ops", "root")), 27,
        ops["P"].shape[1] - 1, "cpu")
    assert tape.groups.shape == (3, perf_lab.UNROLL_GROUPS, 4)
    assert tape.post.shape[1] == perf_lab.UNROLL_M
    assert (tape.groups[..., 0] != pernode.PAD).all()


def test_variant_kernel_is_the_per_node_body():
    """csrc/variant_grad.cu defines no kernel of its own: it includes the
    per-node grad kernel's on-chip body and instantiates it with the
    knobs, and its loop is the shipping launcher."""
    src = (pathlib.Path(perf_lab.__file__).parent / "csrc"
           / "variant_grad.cu").read_text()
    assert "__global__" not in src
    assert '#include "../../treelike/csrc/pernode_onchip.cuh"' in src
    assert "pernode_onchip::launch<kC, kUnrollM, kUnrollGroups" in src
    assert "return bito_pernode_grad_onchip(" in src
