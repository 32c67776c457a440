"""The port's driver entry points (bito_tpu_torch/graft_entry.py) against
bito_tpu's (__graft_entry__.py, loaded by path as tests/test_dist.py
loads it), on the CPU in float64: `_toy_inputs` equal output for output
at two seeds; `entry()`'s forward within 1e-10 relative of bito_tpu's
jitted forward, on its own example_args and on bito_tpu's, and equal to
the port's scan tape; the on-chip LL body's schedule (emulated in
float64) over entry's rooted bifurcating trees; float32 within chip_smoke's
bound of float64; no card, no run; every rank's results held equal but
for each rank's own card; and `dryrun_multichip(1)` through the
launcher, which prints bito_tpu's line ending in OK.  The two-rank dryrun
runs in tests/test_torch_dist.py's two-rank job."""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bito_tpu_torch import graft_entry
from bito_tpu_torch.models.substitution import EigenDecomp
from bito_tpu_torch.treelike import paired, pruning

from torch_port_cases import emulate_ll, one_torch_thread

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENTRY_RTOL = 1e-10
BOUND = 5e-5  # chip_smoke.py's float32 bound
DRYRUN_TIMEOUT = 400  # seconds; about 20 alone, more beside busy workers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_reference", ROOT / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def cpu_entry():
    return graft_entry.entry(device="cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_toy_inputs_equal_bito_tpus(reference, seed):
    """The same encoding (every tape), branch lengths, tips, weights,
    rates and frequencies, bit for bit."""
    ref = reference._toy_inputs(seed=seed)
    out = graft_entry._toy_inputs(seed=seed)
    for field in ("post_ops", "pre_ops", "root", "edge_mask"):
        np.testing.assert_array_equal(getattr(out[0], field),
                                      np.asarray(getattr(ref[0], field)),
                                      err_msg=field)
    assert (out[0].num_slots, out[0].num_taxa) == (ref[0].num_slots,
                                                   ref[0].num_taxa)
    for name, x, y in zip(("bl", "tips", "weights", "rates6", "freqs"),
                          out[1:], ref[1:]):
        assert isinstance(x, np.ndarray) and x.dtype == np.float64, name
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
    tips = out[2]
    assert set(np.unique(tips)) == {0.25, 1.25}


def test_entry_forward_matches_bito_tpus(reference, cpu_entry):
    """The port's forward on its example_args, and on bito_tpu's (as
    numpy), within 1e-10 relative of bito_tpu's jitted forward; the nine
    arguments in bito_tpu's order, shapes and layouts."""
    jfn, jargs = reference.entry()
    ref = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = cpu_entry
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs]
    assert all(a.dtype == torch.float64 and a.device.type == "cpu"
               for a in args)
    out = fn(*args)
    assert out.shape == (4,) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=ENTRY_RTOL, atol=0)
    on_theirs = fn(*[np.array(a) for a in jargs])
    np.testing.assert_allclose(on_theirs.numpy(), ref, rtol=ENTRY_RTOL,
                               atol=0)


def test_entry_forward_equals_the_scan_tape(cpu_entry):
    """The paired tape with P mapped by edge (identity at the DUMMY edge)
    against the port's scan tape on bl in slot space, the same
    eigensystem and categories."""
    fn, args = cpu_entry
    bl, tips, weights, U, values, U_inv, pi, rates, props = args
    enc = graft_entry._toy_inputs()[0]
    B = bl.shape[0]

    def rows(x):
        return x.expand((B,) + tuple(x.shape))

    scan = pruning.log_likelihoods_impl(
        torch.as_tensor(enc.post_ops, dtype=torch.long),
        torch.as_tensor(enc.root, dtype=torch.long), tips, weights, bl,
        EigenDecomp(rows(U), rows(values), rows(U_inv), rows(pi)),
        rows(rates), rows(props), torch.ones(B, dtype=torch.float64),
        num_slots=enc.num_slots, pattern_pad=tips.shape[1],
        category_count=rates.shape[0])
    np.testing.assert_allclose(fn(*args).numpy(), scan.numpy(),
                               rtol=ENTRY_RTOL, atol=0)


def test_onchip_ll_body_takes_entrys_rooted_trees(cpu_entry):
    """Entry's trees have a bifurcating root, which the on-chip tapes had
    run only on the rooted instance's trees: the LL plan fits the
    on-chip body at 8 taxa, the tape's root op writes ROOT, and a float64
    emulation of the body's schedule (child codes, rows by liveness)
    gives the plain version's LLs."""
    fn, args = cpu_entry
    dst, tip, e, P, tips, pi, props, w = fn.operands(*args)
    src = graft_entry._paired_tapes(graft_entry._toy_inputs()[0],
                                    torch.device("cpu"))[2]
    tape = paired.onchip_tape(dst.numpy(), tip.numpy(), "cpu",
                              post_src=src.numpy(), post_e=e.numpy(),
                              edges=P.shape[1])
    M = dst.shape[1]
    assert ((dst == 2 * M).sum(dim=1) == 1).all()  # one root op a tree
    plan = paired.onchip_plan("ll", tape.ll_rows, M, P.shape[1], P.shape[2])
    assert plan is not None and plan.lanes == 4
    emulated = emulate_ll(dst, tape.child, tape.live_row, e, P, tips, pi,
                          props, w)
    np.testing.assert_allclose(emulated.numpy(), fn(*args).numpy(),
                               rtol=1e-12, atol=0)


def test_float32_forward_within_the_bound_of_float64(cpu_entry):
    """The tips of 1.25 grow the partials; with the per-op rescale the
    float32 forward (the plain version here) stays within chip_smoke's
    bound of float64 on the same inputs."""
    fn64, args = cpu_entry
    fn32, args32 = graft_entry.entry(device="cpu", dtype=torch.float32)
    out32 = fn32(*args32)
    assert out32.dtype == torch.float32
    ref = fn64(*[a.double() for a in args32])
    assert (ref - out32.double()).abs().max() / ref.abs().max() <= BOUND


def test_entry_points_default_to_the_card_and_refuse_without_one():
    """No card visible: entry() and dryrun_multichip() raise before any
    work, never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(1)


def test_same_results_take_each_ranks_own_card():
    """With a card a rank (NCCL), rank r runs on cuda:r: the ranks'
    results still agree.  A result that differs, or a rank on another
    kind of device, raises."""
    def rank(r, device, ll=-10.0):
        return {"rank": r, "size": 2, "device": device, "dtype": "float32",
                "backend": "nccl", "loss": ll, "cuda_ll": [ll, ll - 1.0],
                "nni_keys": ["01|10"], "launches": {"train": {"a": r}},
                "seconds": {"train": 0.5 + r}}

    graft_entry._same_results([rank(0, "cuda:0"), rank(1, "cuda:1")])
    with pytest.raises(RuntimeError, match="rank 1's loss differs"):
        graft_entry._same_results([rank(0, "cuda:0"),
                                   rank(1, "cuda:1", ll=-11.0)])
    with pytest.raises(RuntimeError, match="rank 1 ran on cpu"):
        graft_entry._same_results([rank(0, "cuda:0"), rank(1, "cpu")])


def test_dryrun_multichip_one_rank_on_the_cpu(tmp_path):
    """dryrun_multichip(1, device="cpu") starts one rank through the
    launcher (Gloo), runs the six programs in float64 and prints its
    rank's launches (none: the CPU runs the plain versions) and bito_tpu's
    line, which ends in OK."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("BITO_COORDINATOR", None)
    proc = subprocess.run(
        [sys.executable, "-c", "from bito_tpu_torch.graft_entry import "
         "dryrun_multichip; dryrun_multichip(1, device='cpu')"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert re.fullmatch(
        r"dryrun_multichip\(1\): loss=-?[0-9.]+ gp_marginal=-?[0-9.]+ "
        r"sharded_cuda_ll=-?[0-9.]+ vbpi_elbo=-?[0-9.]+ nni_iters=\d+ "
        r"nni_scored=[1-9]\d* codon_ll=-?[0-9.]+ OK", lines[-1]), lines[-1]
    assert lines[-2].startswith("dryrun_multichip(1): rank 0 of 1 (gloo, "
                                "cpu, float64): launches {")
    assert '"train": {}' in lines[-2] and '"vbpi": {}' in lines[-2]
