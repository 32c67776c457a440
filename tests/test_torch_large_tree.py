"""Trees past the paired grad body's on-chip limit, as the benchmark's
rbcL 500 configuration (portbench/configs/rbcl500_gtr_gamma4.json) makes
them, without a card: which body `paired.onchip_plan` gives the kernels
on the benchmark generator's trees at C = 4 (the grad body leaves the
chip between 144 and 150 taxa, the LL body stays on it at 500), the
engine in float64 against portbench's plain reference at 160 taxa on both
of its tapes, and the `global_launches` count of the global bodies'
launchers (the launch stood in for), which the benchmark's
`global_launches.evals` reads.

The checkpointed grad body (csrc/paired_grad_ckpt.cu), which takes those
trees at 1-8 categories: its schedule (paired.ckpt_schedule) run by its
plain version (paired.paired_grad_ckpt_ref) in float64 against the paired
tape's plain version on the generator's trees at 150 and 500 taxa (whose
roots trifurcate), a cherry comb and a caterpillar; the schedule's
invariants, followed entry by entry; its plan's warps; its build time;
the tapes that get a schedule; the wrapper's route to it and its
`checkpoint_launches` count, the card faked.  The kernels themselves run
in tests/test_torch_cuda.py."""
import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.core.tree import Topology, Tree
from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                               PhyloModelSpecification)
from bito_tpu_torch.treelike import _kernels, chunked, paired, pernode, prep
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


# -- the checkpointed grad body -----------------------------------------------

F64 = torch.float64


def _caterpillar(num_taxa, num_trees=2):
    """Rooted caterpillars over `num_taxa` taxa, ((t0,t1),t2),...: a tip
    beside every op, so nearly every op lies above the cuts.  Node
    num_taxa + k joins node num_taxa + k - 1 (t0 for k = 0... t1's
    cherry) and tip k + 1; branch lengths 0.05-0.2."""
    n = num_taxa
    parents = np.full(2 * n - 1, -1)
    parents[0] = parents[1] = n
    for k in range(1, n - 1):
        parents[n + k - 1] = parents[k + 1] = n + k
    rng = np.random.default_rng(num_taxa)
    return [Tree(Topology(parents, n), rng.uniform(0.05, 0.2, 2 * n - 1))
            for _ in range(num_trees)]


def _generator_trees(num_taxa, num_trees, seed=26):
    """The benchmark generator's random unrooted trees (trifurcating
    roots) as Trees, over its taxon names."""
    ts = inputs.random_trees(seed, num_taxa, num_trees)
    return [Tree(Topology(p, num_taxa), t)
            for p, t in zip(ts.parents, ts.lengths)]


TREES = {
    "generator_150": lambda: _generator_trees(150, 2),
    "generator_500": lambda: _generator_trees(500, 2),
    "cherry_comb_499": lambda: parse_newick_text(
        _synthetic.cherry_comb_newick(27, 249, 2)).trees,
    "caterpillar_500": lambda: _caterpillar(500),
}


def _f64_operands(name, columns=10):
    """The paired tape's LL+gradient operands in float64 on the CPU over
    the trees `name` of TREES and a random alignment of `columns` columns:
    (post_dst, tip_slot, post_src, post_e, edge_mask, P, dP, tips, pi,
    props, weights), and the trees."""
    trees = TREES[name]()
    names = _synthetic.taxon_names(trees[0].topology.num_taxa)
    aln = _synthetic.random_alignment(5, names, columns)
    eng = TreeLikelihoodEngine(
        SitePattern(aln, names),
        PhyloModel(PhyloModelSpecification("GTR", "gamma+4")),
        device="cpu", dtype=F64)
    params = {k: torch.tensor(v, dtype=F64)
              for k, v in CONFIG["params"].items()}
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props, F64)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, F64)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    return (dst, tip, src, e, mask.to(F64), P, dP,
            eng._kernel_tips.to(F64), pi, prop,
            eng._kernel_weights.to(F64)), trees


def _schedule(dst, tip, src, e, ops=paired.CKPT_OPS):
    child = paired.child_tape(dst.numpy(), tip.numpy())
    return paired.ckpt_schedule(dst.numpy(), child, e.numpy(), src.numpy(),
                                ops)


@pytest.mark.parametrize("name", list(TREES))
def test_the_checkpointed_schedule_gives_the_plain_versions_numbers(name):
    """paired_grad_ckpt_ref, the checkpointed body's schedule run as the
    kernel runs it, in float64 against paired_ll_and_gradients_ref on the
    same operands: LL and every gradient within 1e-12 (relative; the
    gradients of their tree's largest)."""
    ops, trees = _f64_operands(name)
    if name.startswith("generator"):  # unrooted: the root trifurcates
        assert all(list(t.topology.parents).count(
            t.topology.num_nodes - 1) == 3 for t in trees)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = ops
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(*ops)
    s = _schedule(dst, tip, src, e)
    rows = paired.paired_grad_ckpt_ref(torch.as_tensor(s.sched), s.rows,
                                       s.slots, P, dP, tips, pi, prop, w)
    ll, g = paired.finish_rows(*rows, mask, w)
    assert float(((ll - ll_ref).abs() / ll_ref.abs()).max()) <= 1e-12
    gap = (g - g_ref).abs().amax(1) / g_ref.abs().amax(1)
    assert float(gap.max()) <= 1e-12


def _follow(s, dst, child, b):
    """Follow tree b's schedule entry by entry, as labels: each row and
    tier slot holds ("P", op) or ("U", op) (a partial or an outside
    value).  Asserts that every operand is the value its entry needs, a
    tier slot read at least two entries after it was written (the kernel
    loads an entry's tier operands while the entry before it runs), every
    code within the rows and slots; returns the gradient rows written, in
    order, and the ops whose outside step ran."""
    M = dst.shape[1]
    rows, tier, written, grads, outs = {}, {}, {}, [], []

    def read(code, want, i):
        if code == paired.CKPT_PI:
            return want == ("U", "root")
        if paired.CKPT_TIER <= code < paired.CKPT_TIER + s.slots:
            return tier.get(code) == want and written[code] <= i - 2
        if 0 <= code < s.rows:
            return rows.get(code) == want
        return False

    def store(code, value, i):
        if code >= paired.CKPT_TIER:
            assert code < paired.CKPT_TIER + s.slots
            tier[code], written[code] = value, i
        elif code != paired.CKPT_NONE:
            assert 0 <= code < s.rows
            rows[code] = value

    for i, (fields, m) in enumerate(zip(s.sched[b], s.op[b])):
        kind = fields[0]
        if kind == paired.CKPT_NOP:
            assert m == -1
            continue
        for j in (0, 1):
            c = int(child[b, m, j])
            if c >= 0:
                assert read(int(fields[2 + j]), ("P", c), i), (i, m, j)
            else:  # a tip, or all ones: the child's own code
                assert fields[2 + j] == c
        if kind == paired.CKPT_OUT:
            up = ("U", "root") if dst[b, m] == 2 * M else ("U", int(m))
            assert read(int(fields[4]), up, i), (i, m)
            outs.append(int(m))
            grads += [int(fields[7]) >> (16 * j) & 0xFFFF for j in (0, 1)]
            for j in (0, 1):
                c = int(child[b, m, j])
                if c >= 0:
                    store(int(fields[5 + j]), ("U", c), i)
                else:
                    assert fields[5 + j] == paired.CKPT_NONE
        elif kind == paired.CKPT_POST:
            for j in (0, 1):
                store(int(fields[5 + j]), ("P", int(m)), i)
        else:
            assert kind == paired.CKPT_ROOT and dst[b, m] == 2 * M
    return grads, outs


@pytest.mark.parametrize("name", list(TREES))
def test_the_checkpointed_schedule_keeps_its_invariants(name):
    """On every tree: each op's outside step runs once and each gradient
    row (a node's, for every node but those of DUMMY children) is written
    once (these trees have no DUMMY child); every partial and outside
    value an entry reads is the one it
    needs, read from a tier slot only after it was written there (two
    entries back at least); every row within the schedule's rows, at most
    CKPT_OPS + 2, and every slot within its slots."""
    ops, _ = _f64_operands(name)
    dst, tip, src, e = (x.numpy() for x in ops[:4])
    child = paired.child_tape(dst, tip)
    s = paired.ckpt_schedule(dst, child, e, src)
    assert s.rows <= paired.CKPT_OPS + 2
    for b in range(dst.shape[0]):
        grads, outs = _follow(s, dst, child, b)
        valid = np.nonzero(dst[b] != 2 * dst.shape[1] + 1)[0]
        assert sorted(outs) == list(valid)
        assert sorted(grads) == sorted(src[b][valid].ravel().tolist())
        assert len(grads) == len(set(grads))


def test_the_schedule_takes_edges_and_rows_past_15_bits():
    """Edge numbers and gradient rows of 32768 or more set the sign bit of
    the schedule's packed fields (two 16-bit halves an int32): on the
    generator's 150-taxon trees with every edge and gradient row moved up
    by 40,000, the schedule keeps its invariants and its plain version
    gives the same LL rows bit for bit and the same gradient rows, moved
    up, nothing below them."""
    ops, _ = _f64_operands("generator_150")
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = ops
    off = 40_000
    s = _schedule(dst, tip, src, e)
    s_hi = _schedule(dst, tip, src + off, e + off)
    assert (s_hi.sched[..., 1] < 0).any() and (s_hi.sched[..., 7] < 0).any()
    child = paired.child_tape(dst.numpy(), tip.numpy())
    src_hi = src.numpy() + off
    for b in range(dst.shape[0]):
        grads, _ = _follow(s_hi, dst.numpy(), child, b)
        valid = np.nonzero(dst[b].numpy() != 2 * dst.shape[1] + 1)[0]
        assert sorted(grads) == sorted(src_hi[b][valid].ravel().tolist())

    def up(x):  # off rows of zeros below x's edges
        return torch.cat([x.new_zeros((x.shape[0], off) + x.shape[2:]), x],
                         dim=1)

    ll, g = paired.paired_grad_ckpt_ref(torch.as_tensor(s.sched), s.rows,
                                        s.slots, P, dP, tips, pi, prop, w)
    ll_hi, g_hi = paired.paired_grad_ckpt_ref(
        torch.as_tensor(s_hi.sched), s_hi.rows, s_hi.slots, up(P), up(dP),
        tips, pi, prop, w)
    assert torch.equal(ll_hi, ll)
    assert torch.equal(g_hi[:, off:], g) and not g_hi[:, :off].any()


@pytest.mark.parametrize("num_taxa", [150, 200, 320, 500])
def test_the_checkpointed_plan_holds_a_full_block_of_warps(num_taxa):
    """At 150-500 taxa and C = 4 the schedule's rows leave a block at
    least FULL_WARPS warps of patterns, beside the warps' rings (the
    on-chip grad body gets none past 144 taxa), and the plan's bytes fit
    one block."""
    ts = inputs.random_trees(26, num_taxa, 8)
    enc = encode_trees([Topology(p, num_taxa) for p in ts.parents])
    pe = paired.build_paired_encoding(enc)
    child = paired.child_tape(pe.post_dst, pe.tip_slot)
    s = paired.ckpt_schedule(pe.post_dst, child, pe.post_e, pe.post_src)
    plan = paired.ckpt_plan(s.rows, C)
    assert plan.cols * plan.lanes // paired.WARP >= paired.FULL_WARPS
    assert plan.smem <= paired.SMEM_BYTES


@pytest.mark.parametrize("num_taxa,scheduled", [
    (27, False), (64, False), (144, False), (150, True), (500, True)])
def test_only_tapes_past_the_on_chip_limit_get_a_schedule(num_taxa,
                                                          scheduled):
    """onchip_tape builds the checkpointed schedule where the on-chip grad
    body gets no plan at COMPILED_CATEGORIES categories: past 144 taxa,
    never at 27-144 (the DS1 tapes pay nothing), so at every count of 1-8
    that gets no plan; and never where the edges pass the schedule's 16
    bits."""
    ts = inputs.random_trees(26, num_taxa, 4)
    enc = encode_trees([Topology(p, num_taxa) for p in ts.parents])
    pe = paired.build_paired_encoding(enc)
    N1 = enc.num_slots + 1
    grad = dict(post_src=pe.post_src, post_e=pe.post_e)
    tape = paired.onchip_tape(pe.post_dst, pe.tip_slot, "cpu", **grad,
                              edges=N1)
    assert (tape.ckpt is not None) == scheduled
    assert (paired.onchip_plan("grad", tape.grad_rows, pe.M, N1,
                               paired.COMPILED_CATEGORIES) is None
            ) == scheduled
    for categories in range(1, paired.COMPILED_CATEGORIES + 1):
        if paired.onchip_plan("grad", tape.grad_rows, pe.M, N1,
                              categories) is None:
            assert tape.ckpt is not None
    assert paired.onchip_tape(
        pe.post_dst, pe.tip_slot, "cpu", **grad,
        edges=paired.CKPT_MAX_EDGES + 1).ckpt is None


def test_the_schedule_of_200_trees_of_500_taxa_builds_in_half_a_second():
    """The schedule of the benchmark's batch, 200 trees of 500 taxa, is
    built vectorised over the trees: under 0.5 s on the host."""
    ts = inputs.random_trees(2147490001, 500, 200)
    enc = encode_trees([Topology(p, 500) for p in ts.parents])
    pe = paired.build_paired_encoding(enc)
    child = paired.child_tape(pe.post_dst, pe.tip_slot)
    t0 = time.perf_counter()
    s = paired.ckpt_schedule(pe.post_dst, child, pe.post_e, pe.post_src)
    assert time.perf_counter() - t0 < 0.5
    assert s.sched.shape[0] == 200


class _Recording:
    """The kernel library's entry points, recorded by name; code 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("bito_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(name) or 0


def _fake_card(monkeypatch):
    """The paired wrapper on CPU tensors as on a card: the plain-version
    test, the device checks, the library, the stream and the device switch
    faked; returns the recording library."""
    lib = _Recording()
    monkeypatch.setattr(paired, "on_cpu", lambda t: False)
    monkeypatch.setattr(paired, "_check_cuda_tensors", lambda *a: None)
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(paired, "_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return lib


def _wrapper_operands(num_taxa, categories, edges=None):
    """The paired LL+gradient wrapper's operands in float32 on the engine's
    tapes of three generator trees, and their on-chip tape: with P and
    dP's edges padded to `edges` rows (identity and zero) where given."""
    trees = _generator_trees(num_taxa, 3)
    names = inputs.taxon_names(num_taxa)
    aln = _synthetic.random_alignment(5, names, 12)
    eng = TreeLikelihoodEngine(
        SitePattern(aln, names),
        PhyloModel(PhyloModelSpecification("GTR", f"gamma+{categories}")),
        device="cpu", dtype=torch.float32)
    params = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in CONFIG["params"].items()}
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    if edges is not None:
        pad = edges - P.shape[1]
        P = torch.cat([P, P[:, -1:].expand(-1, pad, -1, -1, -1)], dim=1)
        dP = torch.cat([dP, dP[:, -1:].expand(-1, pad, -1, -1, -1)], dim=1)
        mask = torch.cat([mask, mask.new_zeros((len(trees), pad))], dim=1)
    pe = paired.build_paired_encoding(enc)
    onchip = paired.onchip_tape(pe.post_dst, pe.tip_slot, "cpu",
                                post_src=pe.post_src, post_e=pe.post_e,
                                edges=P.shape[1])
    return (dst, tip, src, e, mask, P, dP, eng._kernel_tips, pi, prop,
            eng._kernel_weights), onchip


@pytest.mark.parametrize("num_taxa,categories,edges,entry", [
    (27, 4, None, "bito_paired_grad_onchip"),
    (150, 4, None, "bito_paired_grad_ckpt"),
    (500, 4, None, "bito_paired_grad_ckpt"),
    (500, 1, None, "bito_paired_grad_ckpt"),
    (500, 8, None, "bito_paired_grad_ckpt"),
    (500, 9, None, "bito_paired_grad"),
    (150, 4, paired.CKPT_MAX_EDGES + 1, "bito_paired_grad")])
def test_the_wrapper_takes_the_checkpointed_body_past_the_limit(
        monkeypatch, num_taxa, categories, edges, entry):
    """paired_ll_and_gradients on the engine's tapes in float32, the card
    faked: the on-chip body where it has a plan, else the checkpointed
    body at 1-8 categories, one launch counted on its launcher and as
    `checkpoint_launches` inside the `launch` span; the global body past
    8 categories, and where P's edges pass the schedule's 16 bits."""
    from torch.profiler import ProfilerActivity, profile

    ops, onchip = _wrapper_operands(num_taxa, categories, edges)
    fake_card = _fake_card(monkeypatch)
    before = paired.paired_grad_ckpt.launches
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("eval"):
            paired.paired_ll_and_gradients(*ops, onchip=onchip)
    assert fake_card.calls == [entry]
    ckpt = entry == "bito_paired_grad_ckpt"
    assert paired.paired_grad_ckpt.launches == before + ckpt
    counts = {r.name: r.counts for r in timing.recorded()}
    assert counts["launch"].get("checkpoint_launches", 0) == ckpt
    assert not counts["eval"] and not counts["finish"]


@pytest.mark.parametrize("batch", ["none", "another"])
def test_the_wrapper_refuses_a_tape_without_its_schedule(monkeypatch,
                                                         batch):
    """Past the on-chip limit at 1-8 categories the wrapper takes the
    checkpointed body alone: an on-chip tape that carries no schedule, or
    one of another batch, is refused before any launch, as a missing tape
    is."""
    ops, onchip = _wrapper_operands(500, 4)
    ckpt = None if batch == "none" else dataclasses.replace(
        onchip.ckpt, sched=onchip.ckpt.sched[:1])
    fake_card = _fake_card(monkeypatch)
    with pytest.raises(ValueError, match="checkpointed schedule"):
        paired.paired_ll_and_gradients(
            *ops, onchip=dataclasses.replace(onchip, ckpt=ckpt))
    assert fake_card.calls == []


@pytest.mark.parametrize("counts,expect", [
    ((1, 1), 1.0), ((2, 0), 1.0), ((0, 0), None), (None, None)])
def test_the_benchmarks_reader_of_checkpoint_launches(monkeypatch, counts,
                                                      expect):
    """portbench's checkpoint_launches.evals: the mean over the traced
    window's calls of the `checkpoint_launches` counted in each (1.0 where
    every call launches once), None where no call counts one or the
    program records nothing."""
    import collections
    import types

    from portbench import harness, program, trace

    Record = collections.namedtuple(
        "Record", "name id parent top start end counts")
    records = None if counts is None else [
        r for k, (t0, n) in enumerate(zip((10_000, 110_000), counts))
        for r in (Record("eval", 2 * k, None, 2 * k, t0 + 1_000,
                         t0 + 61_000, {}),
                  Record("launch", 2 * k + 1, 2 * k, 2 * k, t0 + 22_000,
                         t0 + 42_000,
                         {"checkpoint_launches": n} if n else {}))]
    monkeypatch.setattr(program, "recorded", lambda: records)
    monkeypatch.setattr(program, "_last", [None, None])
    offset = 5000.0  # us: the trace's clock ahead of the host's
    spans = [("call", offset + 10.5, offset + 71.5),
             ("call", offset + 110.5, offset + 171.5)]
    run = types.SimpleNamespace(trace=trace.Trace(
        offset, offset + 200.0, 2, [], trace.Spans(spans)))
    assert harness.reader("checkpoint_launches.evals")(run) == expect
