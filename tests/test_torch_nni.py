"""The NNI search in the port (nni/engine.py, nni/golden.py, nni/search.py)
against bito_tpu's, on the CPU in float64.

Each engine runs a few iterations in both packages from the same
synthetic inputs (_synthetic.write_nni_inputs: a seed tree, its
credible set and an alignment simulated along a tree a few NNIs away),
driven as a user drives it: gp_instance, make_dag, make_tp_engine and
its take-first setters (make_gp_engine for GP scoring), make_nni_engine,
run_init, then run_main_loop and run_post_loop.  The accepted NNIs must be
the same, iteration by iteration, and every score within 1e-8; the
faithful search's batched scorer (float64 on the device) is held within
1e-7 relative, since a step of its Brent is decided by rounding in places
(test_torch_batch_scorer.py holds each candidate to 1e-10 where it is
not), and with the serial scorer the faithful search is bito_tpu's to the
bit.  The
copied modules (golden.py, search.py) are pinned by AST.  The port's two
departures from bito_tpu's engine are shown: an accepted NNI without a
candidate tree raises, and adjacent_source holds only the current
adjacent NNIs (bito_tpu's keeps every key it saw), which changes no
result."""
import functools
import pathlib

import pytest
import torch

from bito_tpu.api.gp import gp_instance as jax_gp
from bito_tpu.core.site_pattern import SitePattern as JaxSitePattern
from bito_tpu.nni.engine import NNIEngine as JaxNNIEngine
from bito_tpu.nni.search import nni_search as jax_nni_search
from bito_tpu_torch import _synthetic
from bito_tpu_torch.api import gp as api_gp
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.nni.engine import GPScoredNNIEngine, NNIEngine
from bito_tpu_torch.nni.golden import FaithfulNNIEngine
from bito_tpu_torch.nni.search import nni_search

from torch_port_cases import without_docstrings

ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = dict(device="cpu", dtype=torch.float64)
BOUND = 1e-8
ROUNDED_BOUND = 1e-7  # the batched scorer's (test_torch_batch_scorer.py)


def _close(got, want, faithful):
    """Scores within BOUND, or, for the faithful search's batched scorer,
    within ROUNDED_BOUND relative."""
    if faithful:
        return all(abs(got[k] - want[k]) <= ROUNDED_BOUND * abs(want[k])
                   for k in want)
    return all(abs(got[k] - want[k]) <= BOUND for k in want)


@pytest.mark.parametrize("module", ["nni/golden.py", "nni/search.py"])
def test_copied_module_code_is_identical(module):
    """Apart from docstrings, the copied modules are bito_tpu's code."""
    assert (without_docstrings(ROOT / "bito_tpu_torch" / module)
            == without_docstrings(ROOT / "bito_tpu" / module))


def _instances(paths):
    """bito_tpu's and the port's gp_instance with the inputs read and
    the DAG made."""
    out = []
    for inst in (jax_gp(""), api_gp.gp_instance(**F64)):
        inst.read_fasta_file(paths["alignment.fasta"])
        inst.read_newick_file(paths["seed.nwk"])
        inst.make_dag()
        out.append(inst)
    return out


def _engine(inst, scoring, port):
    """The NNI engine a user makes for `scoring`; "whole_tree" is the
    whole-tree engine with TP-likelihood scoring (make_nni_engine's
    tp_likelihood is the faithful search)."""
    if scoring == "gp_likelihood":
        inst.make_gp_engine()
        inst.take_first_branch_length()
        return inst.make_nni_engine(scoring)
    inst.make_tp_engine()
    inst.tp_engine_set_branch_lengths_by_taking_first()
    inst.tp_engine_set_choice_map_by_taking_first()
    if scoring != "whole_tree":
        return inst.make_nni_engine(scoring)
    if port:
        sp = SitePattern(inst.alignment, inst.tree_collection.taxon_names)
        return NNIEngine(inst.get_dag(), sp, inst.tree_collection.trees,
                         **F64)
    sp = JaxSitePattern(inst.alignment, inst.tree_collection.taxon_names)
    return JaxNNIEngine(inst.get_dag(), sp, inst.tree_collection.trees)


# scoring -> (taxa, columns, iterations)
RUNS = {"tp_likelihood": (8, 300, 4), "whole_tree": (7, 300, 3),
        "tp_parsimony": (8, 300, 4), "gp_likelihood": (6, 200, 3)}
KINDS = {"tp_likelihood": FaithfulNNIEngine, "whole_tree": NNIEngine,
         "tp_parsimony": NNIEngine, "gp_likelihood": GPScoredNNIEngine}


@pytest.mark.parametrize("scoring", list(RUNS))
def test_nni_engine_matches_bito_tpu(tmp_path, scoring):
    taxa, sites, iterations = RUNS[scoring]
    paths = _synthetic.write_nni_inputs(tmp_path, 0, taxa, sites)
    jinst, inst = _instances(paths)
    jeng, eng = _engine(jinst, scoring, False), _engine(inst, scoring, True)
    assert type(eng) is KINDS[scoring]
    assert scoring == "whole_tree" or inst.get_nni_engine() is eng
    if scoring == "tp_likelihood":
        assert eng.engine.device == torch.device("cpu")
    else:
        assert eng.device == torch.device("cpu")
        assert eng.tp.like_engine.device == torch.device("cpu")
    stale = 0  # iterations where bito_tpu's adjacent_source holds old keys
    for e in (jeng, eng):
        e.set_top_k_score_filtering_scheme(1)
        e.run_init()
    for it in range(iterations):
        accepted = [e.run_main_loop() for e in (jeng, eng)]
        assert accepted[0] == accepted[1]
        if not accepted[0]:
            break
        faithful = scoring == "tp_likelihood"
        got, want = eng.accepted_scores_this_iter, jeng.accepted_scores_this_iter
        assert list(got) == list(want), it
        assert _close(got, want, faithful)
        got, want = eng.scored_nnis(), jeng.scored_nnis()
        assert got.keys() == want.keys()
        assert _close(got, want, faithful)
        for e in (jeng, eng):
            e.run_post_loop()
        assert eng.adjacent_nni_count() == jeng.adjacent_nni_count()
        if scoring != "tp_likelihood":
            assert set(eng.adjacent_source) == set(eng.adjacent)
            stale += set(jeng.adjacent_source) != set(jeng.adjacent)
    assert it >= 2
    if scoring != "tp_likelihood":
        assert stale > 0, "bito_tpu's adjacent_source kept no old key"


def test_faithful_search_with_the_serial_scorer_is_bito_tpus(tmp_path):
    """With use_batched_scorer False, the faithful search (numpy, the
    copied modules) scores and accepts as bito_tpu's does, to the bit."""
    paths = _synthetic.write_nni_inputs(tmp_path, 0, 8, 300)
    engines = [_engine(inst, "tp_likelihood", port)
               for inst, port in zip(_instances(paths), (False, True))]
    for e in engines:
        e.engine.use_batched_scorer = False
        e.run_init()
    for _ in range(3):
        assert all(e.run_main_loop() for e in engines)
        assert engines[1].scored_nnis() == engines[0].scored_nnis()
        assert (engines[1].accepted_scores_this_iter
                == engines[0].accepted_scores_this_iter)
        for e in engines:
            e.run_post_loop()


def test_nni_search_matches_bito_tpu(tmp_path, monkeypatch):
    """nni_search (the copied harness) through the port's gp_instance, on
    the CPU: the same accepted NNIs and posterior tracking rows as
    bito_tpu's, scores within 1e-8."""
    monkeypatch.setattr(api_gp, "gp_instance",
                        functools.partial(api_gp.gp_instance, **F64))
    paths = _synthetic.write_nni_inputs(tmp_path, 5, 8, 300)
    args = (paths["alignment.fasta"], paths["seed.nwk"],
            paths["credible.nwk"], paths["pp.csv"], paths["pcsp_pp.csv"])
    jinst, jres = jax_nni_search(*args, iter_max=3)
    inst, res = nni_search(*args, iter_max=3)
    assert inst.device == torch.device("cpu")
    assert res.accepted_keys() == jres.accepted_keys()
    assert len(res.rows) == 3
    for got, want in zip(res.rows, jres.rows, strict=True):
        assert got.keys() == want.keys()
        assert abs(got.pop("score") - want.pop("score")) <= BOUND
        assert got == want


def test_accepted_nni_without_candidate_tree_raises(tmp_path, monkeypatch):
    """Where an accepted NNI has no candidate tree (no pre-NNI edge of it
    in the DAG), run_main_loop raises; bito_tpu appends None to the
    supporting trees there."""
    paths = _synthetic.write_nni_inputs(tmp_path, 0, 7, 150)
    _, inst = _instances(paths)
    eng = _engine(inst, "tp_parsimony", True)
    eng.run_init()
    eng.filter_score_adjacent_nnis()  # every adjacent NNI scored
    eng._candidate_trees.clear()
    monkeypatch.setattr(eng, "_candidate_tree", lambda nni: None)
    trees = len(eng.supporting_trees)
    with pytest.raises(RuntimeError, match="no candidate tree"):
        eng.run_main_loop()
    assert len(eng.supporting_trees) == trees
