"""Trees past the paired grad body's on-chip limit, as the benchmark's
rbcL 500 configuration (portbench/configs/rbcl500_gtr_gamma4.json) makes
them, without a card: which body `paired.onchip_plan` gives the kernels
on the benchmark generator's trees at C = 4 (the grad body leaves the
chip between 144 and 150 taxa, the LL body stays on it at 500), the
engine in float64 against portbench's plain reference at 160 taxa on both
of its tapes, and the `global_launches` count of the global bodies'
launchers (the launch stood in for), which the benchmark's
`global_launches.evals` reads.  The kernels themselves run in
tests/test_torch_cuda.py."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.core.tree import Topology, Tree
from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                               PhyloModelSpecification)
from bito_tpu_torch.treelike import _kernels, chunked, paired, pernode
from bito_tpu_torch.treelike.encode import encode_trees
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine
from bito_tpu_torch.utils import timing
from portbench import inputs, reference
from portbench.reference import patterns
from torch_port_cases import one_torch_thread

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                     / "configs" / "rbcl500_gtr_gamma4.json").read_text())
C = 4


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _plans(num_taxa, num_trees=8, seed=26):
    """(LL plan, grad plan) of `onchip_plan` at C = 4 on the paired tape
    of the generator's random trees."""
    ts = inputs.random_trees(seed, num_taxa, num_trees)
    enc = encode_trees([Topology(p, num_taxa) for p in ts.parents])
    pe = paired.build_paired_encoding(enc)
    child = paired.child_tape(pe.post_dst, pe.tip_slot)
    _, ll_rows = paired.live_rows(pe.post_dst, child)
    grad_rows = paired.grad_rows_needed(pe.post_dst)
    M, N1 = pe.post_dst.shape[1], enc.edge_mask.shape[1] + 1
    return (paired.onchip_plan("ll", ll_rows, M, N1, C),
            paired.onchip_plan("grad", grad_rows, M, N1, C))


def test_the_configuration_keeps_the_published_shape():
    assert (CONFIG["taxa"], CONFIG["columns"]) == (500, 1428)
    assert CONFIG["reduced"] == []
    assert CONFIG["model"] == {"substitution": "GTR", "site": "gamma+4",
                               "clock": "none"}


@pytest.mark.parametrize("num_taxa,on_chip", [
    (27, True), (64, True), (144, True), (150, False), (160, False),
    (500, False)])
def test_the_grad_body_leaves_the_chip_past_144_taxa(num_taxa, on_chip):
    """The grad body keeps a shared-memory row an op, so past 144 taxa
    fewer than MIN_WARPS warps of patterns fit and the global body
    (csrc/paired_grad.cu) takes the tape; the LL body, which keeps only
    the live rows, stays on the chip, on the ring at 500 taxa."""
    ll_plan, grad_plan = _plans(num_taxa)
    assert (grad_plan is not None) == on_chip
    assert ll_plan is not None
    if num_taxa == 500:
        assert ll_plan.ring


def _engine(kernel, num_taxa=160, num_trees=3, columns=40, distinct=30,
            seed=7):
    config = dict(CONFIG, taxa=num_taxa, columns=columns,
                  distinct_columns=distinct, trees=num_trees,
                  topologies=num_trees)
    inp = inputs.make_inputs(config, seed, num_trees)
    spec = config["model"]
    eng = TreeLikelihoodEngine(
        SitePattern(inp.alignment, inp.names),
        PhyloModel(PhyloModelSpecification(spec["substitution"],
                                           spec["site"])),
        device="cpu", dtype=torch.float64)
    eng.kernel = kernel
    trees = [Tree(Topology(p, num_taxa), t)
             for p, t in zip(inp.trees.parents, inp.trees.lengths)]
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in config["params"].items()}
    return config, inp, eng, trees, params


@pytest.mark.parametrize("kernel", ["auto", "cuda"],
                         ids=["scan_tape", "paired_tape"])
def test_the_engine_matches_the_reference_at_160_taxa(kernel):
    """branch_eval_fn in float64 against portbench.reference.evaluate on
    trees past the hand-over: LL within 1e-12 relative, every branch
    gradient within 1e-10 of its tree's largest.  On the CPU auto takes
    the scan tape, and kernel "cuda" the paired tape's plain versions,
    which the card's global bodies are held to."""
    config, inp, eng, trees, params = _engine(kernel)
    bl = torch.as_tensor(inp.trees.lengths) * torch.exp(
        0.1 * torch.randn(inp.trees.lengths.shape,
                          generator=torch.Generator().manual_seed(3),
                          dtype=torch.float64))
    ll, grads = eng.branch_eval_fn(trees, params)(bl)
    tips, w = patterns.site_patterns(inp.alignment, inp.names, "nucleotide")
    ref_ll, ref_g = reference.evaluate(reference.model_of(config), tips, w,
                                       inp.trees.parents, bl)
    assert torch.allclose(ll, ref_ll, rtol=1e-12, atol=0)
    gap = (grads - ref_g).abs().amax(1) / ref_g.abs().amax(1)
    assert float(gap.max()) <= 1e-10
    assert np.all(ref_g[:, -1].numpy() == 0)


class _Library:
    """Stands in for the kernel library: every entry point returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


def _global_operands(B=3, M=8, T=5, S=16):
    kw = dict(dtype=torch.float32)
    ints = torch.zeros((B, M, 2), dtype=torch.int32)
    return dict(post_dst=torch.zeros((B, M), dtype=torch.int32),
                tip_slot=torch.zeros((B, T), dtype=torch.int32),
                post_src=ints, post_e=ints,
                P=torch.zeros((B, 2 * T - 1, C, 4, 4), **kw),
                dP=torch.zeros((B, 2 * T - 1, C, 4, 4), **kw),
                tips=torch.zeros((T, 4, S), **kw), pi=torch.zeros(4, **kw),
                props=torch.zeros(C, **kw), weights=torch.zeros(S, **kw))


def _launch_ll(o):
    return paired.paired_ll_global(o["post_dst"], o["tip_slot"], o["post_e"],
                                   o["P"], o["tips"], o["pi"], o["props"])


def _launch_grad(o):
    return paired.paired_grad_global(
        o["post_dst"], o["tip_slot"], o["post_src"], o["post_e"], o["P"],
        o["dP"], o["tips"], o["pi"], o["props"], o["weights"])


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("launch", [_launch_ll, _launch_grad],
                         ids=["ll", "grad"])
def test_global_launches_count_one_a_slice_inside_the_launch_span(
        monkeypatch, launch, slices):
    """Each paired global body's launcher adds the launches of
    launch_sliced (one a slice of trees) to `.launches` and to the
    `global_launches` count of the innermost open span, while a profiler
    session is active; outside one it records nothing."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(_kernels, "library", _Library)
    monkeypatch.setattr(paired, "launch_sliced",
                        lambda *args, **kw: slices)
    o = _global_operands()
    launcher = (paired.paired_ll_global if launch is _launch_ll
                else paired.paired_grad_global)
    before = launcher.launches
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("eval"):
            with timing.span("launch"):
                launch(o)
            with timing.span("finish"):
                pass
    assert launcher.launches == before + slices
    counts = {r.name: r.counts for r in timing.recorded()}
    assert counts == {"eval": {}, "launch": {"global_launches": slices},
                      "finish": {}}
    launch(o)
    assert launcher.launches == before + 2 * slices
    assert {r.name: r.counts for r in timing.recorded()} == counts


def test_the_chunked_and_per_node_global_launchers_count_too(monkeypatch):
    """The chunked and per-node global bodies' launchers count their
    launches as `global_launches` the same way."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(_kernels, "library", _Library)
    monkeypatch.setattr(paired, "launch_sliced", lambda *args, **kw: 2)
    o = _global_operands()
    B, T = o["tip_slot"].shape
    root = torch.zeros(B, dtype=torch.int32)
    calls = [
        lambda: chunked.chunked_ll_global(
            o["post_dst"], o["tip_slot"], o["post_e"], o["P"], o["tips"],
            o["pi"], o["props"]),
        lambda: chunked.chunked_grad_global(
            o["post_dst"], o["tip_slot"], o["post_e"], o["P"], o["dP"],
            o["tips"], o["pi"], o["props"], o["weights"]),
        lambda: pernode.pernode_ll_global(
            o["post_src"], root, o["P"], o["tips"], o["pi"], o["props"]),
        lambda: pernode.pernode_grad_global(
            o["post_src"], o["post_src"], root, o["P"], o["dP"], o["tips"],
            o["pi"], o["props"], o["weights"]),
    ]
    with profile(activities=[ProfilerActivity.CPU]):
        for call in calls:
            with timing.span("launch"):
                call()
    assert [r.counts for r in timing.recorded()] == [
        {"global_launches": 2}] * 4
