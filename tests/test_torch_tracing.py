"""The program's spans and counters (utils/timing.py `span`, `count`,
`recorded`) inside the engine's evaluation path, on the CPU: recorded only
inside a torch.profiler session, one `eval` a call with its layers as
children, the counters of host syncs and tape builds, one session's
records at a time, and their export into device_trace's Chrome trace on
the trace's own clock.  The engine runs in float64 on the paired route
(kernel "cuda": the wrappers' plain versions on the CPU)."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bito_tpu_torch import _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern, SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine
from bito_tpu_torch.utils import timing

from torch_port_cases import one_torch_thread

F64 = dict(device="cpu", dtype=torch.float64)
MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2])}
TAXA, TREES = 6, 3


def _engine(model: str, seed: int = 3):
    """(engine on the paired route, trees, params) at 6 taxa x 3 trees."""
    trees = parse_newick_text(
        _synthetic.random_trees_newick(seed, TAXA, TREES))
    names = trees.taxon_names
    if model == "mg94":
        sp = CodonSitePattern(_synthetic.codon_alignment(
            seed + 1, names, 40, 30), names)
        spec, params = PhyloModelSpecification("MG94"), MG94
    else:
        sp = SitePattern(_synthetic.random_alignment(seed + 1, names, 120),
                         names)
        spec = PhyloModelSpecification("GTR", "gamma+4")
        params = _synthetic.GTR_GAMMA4_PARAMS
    engine = TreeLikelihoodEngine(sp, PhyloModel(spec), **F64)
    engine.kernel = "cuda"
    return engine, trees.trees, params_from_numpy(params, **F64)


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _tops(records, name="eval"):
    return [r for r in records if r.parent is None and r.name == name]


def _under(records, top):
    """The records of `top`'s call, `top` left out."""
    return [r for r in records if r.top == top.id and r.id != top.id]


def _counted(records, top, counter):
    return sum(r.counts.get(counter, 0) for r in records
               if r.top == top.id)


def test_nothing_is_recorded_outside_a_profiler_session():
    with one_torch_thread():
        engine, trees, params = _engine("gtr")
        fn = engine.branch_eval_fn(trees, params)
        with _session():
            fn(engine.branch_length_matrix(trees, engine.encode(trees)))
        before = timing.recorded()
        bl = engine.branch_length_matrix(trees, engine.encode(trees))
        fn(bl)
        engine.log_likelihoods(trees, params)
        assert timing.recorded() == before
        assert timing.span("a") is timing.span("b")
        with timing.span("a"):
            timing.count("host_syncs")
        assert timing.recorded() == before


def test_one_branch_eval_call_records_an_eval_over_prep_launch_finish():
    with one_torch_thread():
        engine, trees, params = _engine("gtr")
        fn = engine.branch_eval_fn(trees, params)
        bl = engine.branch_length_matrix(trees, engine.encode(trees))
        with _session():
            fn(bl)
        records = timing.recorded()
    evals = _tops(records)
    assert len(evals) == 1 and len(records) >= 4
    top = evals[0]
    ids = {r.id: r for r in records}
    assert all(r.top == top.id for r in records)
    children = [r.name for r in records if r.parent == top.id]
    assert children == ["prep", "launch", "finish"]
    for r in _under(records, top):
        parent = ids[r.parent]
        assert parent.start <= r.start <= r.end <= parent.end
        assert r.top == parent.top == top.id


@pytest.mark.parametrize("model", ["gtr", "mg94"])
def test_a_closure_counts_the_same_host_syncs_every_call(model):
    """The GTR closure reads nothing from the device; the MG94 closure
    reads the largest q t and q, and copies q back (pruning.py,
    substitution.py), the same on every call."""
    with one_torch_thread():
        engine, trees, params = _engine(model)
        fn = engine.branch_eval_fn(trees, params)
        bl = engine.branch_length_matrix(trees, engine.encode(trees))
        with _session():
            for scale in (1.0, 0.5, 2.0):
                fn(bl * scale)
        records = timing.recorded()
    evals = _tops(records)
    syncs = [_counted(records, top, "host_syncs") for top in evals]
    assert len(evals) == 3
    assert syncs == ([0, 0, 0] if model == "gtr" else [3, 3, 3])
    assert all(r.name == "host_sync" for r in records
               if r.counts.get("host_syncs"))


def test_log_likelihoods_records_encode_ingredients_and_prep_every_call():
    with one_torch_thread():
        engine, trees, params = _engine("gtr")
        engine.log_likelihoods(trees, params)
        with _session():
            for _ in range(2):
                engine.log_likelihoods(trees, params)
        records = timing.recorded()
    evals = _tops(records)
    assert len(evals) == 2
    for top in evals:
        names = {r.name for r in _under(records, top)}
        assert {"encode", "ingredients", "prep", "launch",
                "finish"} <= names
        assert _counted(records, top, "tape_builds") == 0
        # GTR's two index copies, eigh's error code and the Gamma rates'
        # series length: the counts the card's sync debug mode warns of
        assert _counted(records, top, "host_syncs") == 4


def test_a_new_topology_batch_counts_tape_builds_and_a_repeated_one_none():
    """encode's cache miss and the paired tapes' build count one each."""
    with one_torch_thread():
        engine, trees, params = _engine("gtr")
        others = parse_newick_text(_synthetic.random_trees_newick(
            11, TAXA, TREES)).trees
        with _session():
            for batch in (trees, trees, others, others):
                engine.ll_and_branch_gradients(batch, params)
        records = timing.recorded()
    evals = _tops(records)
    builds = [_counted(records, top, "tape_builds") for top in evals]
    assert builds == [2, 0, 2, 0]
    built = [r.name for r in records if r.counts.get("tape_builds")]
    assert built == ["encode", "tapes"] * 2


def test_an_evaluation_inside_another_records_one_eval():
    """`eval` opens at the outermost evaluation alone: the LL closure
    over log_likelihoods, and ll_and_branch_gradients over the closure it
    binds (whose `bind` lies inside)."""
    with one_torch_thread():
        engine, trees, params = _engine("gtr")
        ll_fn = engine.ll_eval_fn(trees, params)
        bl = engine.branch_length_matrix(trees, engine.encode(trees))
        with _session():
            ll_fn(bl)
            engine.ll_and_branch_gradients(trees, params)
        records = timing.recorded()
    evals = _tops(records)
    assert len(evals) == 2
    assert [r.name for r in records if r.name == "eval"] == ["eval", "eval"]
    assert not any(r.name == "bind" for r in _under(records, evals[0]))
    assert [r.name for r in _under(records, evals[1])
            if r.parent == evals[1].id][:2] == ["encode", "bind"]


def test_a_second_session_drops_the_first_sessions_records():
    with one_torch_thread():
        engine, trees, params = _engine("gtr")
        fn = engine.branch_eval_fn(trees, params)
        bl = engine.branch_length_matrix(trees, engine.encode(trees))
        with _session():
            fn(bl)
            fn(bl)
        assert len(_tops(timing.recorded())) == 2
        with _session():
            assert timing.recorded() == []
        assert timing.recorded() == []
        with _session():
            fn(bl)
        assert len(_tops(timing.recorded())) == 1


def _trace_events(path):
    return json.loads((path / "trace.json").read_text())["traceEvents"]


def test_device_trace_writes_the_spans_on_the_traces_clock(tmp_path):
    """The spans appear as complete events of a process named
    bito_tpu_torch with their counts, and the CPU operators run inside
    `prep` lie inside its exported span within 50 us."""
    with one_torch_thread():
        engine, trees, params = _engine("mg94")
        fn = engine.branch_eval_fn(trees, params)
        bl = engine.branch_length_matrix(trees, engine.encode(trees))
        with timing.device_trace(str(tmp_path / "call")):
            fn(bl)
        eig, rates, props, clock = engine._model_ingredients(params, TREES)
        Q = engine._rate_Q(params)
        with timing.device_trace(str(tmp_path / "prep")):
            prep.prepare_inputs_grad_q(eig, rates, clock, bl,
                                       torch.float64, Q=Q)
    events = _trace_events(tmp_path / "call")
    spans = [e for e in events if e.get("cat") == "bito_tpu_torch"]
    assert {"eval", "prep", "host_sync", "launch",
            "finish"} <= {e["name"] for e in spans}
    assert all(e["ph"] == "X" and e["pid"] == timing.SPAN_PID for e in spans)
    assert {"ph": "M", "name": "process_name", "pid": timing.SPAN_PID,
            "tid": 0, "args": {"name": "bito_tpu_torch"}} in events
    assert sum(e["args"].get("host_syncs", 0) for e in spans) == 3
    (top,) = [e for e in spans if e["args"]["parent"] is None]
    assert all(e["args"]["top"] == top["args"]["id"] for e in spans)

    events = _trace_events(tmp_path / "prep")
    (span,) = [e for e in events if e.get("cat") == "bito_tpu_torch"
               and e["name"] == "prep"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("ph") == "X"]
    assert any(e["name"] == "aten::matmul" for e in ops)
    for e in ops:
        assert span["ts"] - 50 <= e["ts"]
        assert e["ts"] + e["dur"] <= span["ts"] + span["dur"] + 50
