"""Trajectory-faithful TP-likelihood NNI search (the DS1 golden run).

The port's copy of bito_tpu.nni.golden: numpy, its code bito_tpu's apart
from docstrings and comments (tests/test_torch_nni.py pins it by AST).
Candidate scoring goes through the eval engine's score_adjacent_nnis,
which runs the batched scorer in float64 on the engine's `device` (set
it on `search.engine`; the card where none is set).

Replays the reference's NNIEngine::Run with the TP-likelihood cutoff +
top-1 filtering schemes exactly as the golden-run harness configures them
(reference: test/nni_search.py init_engine_for_tp_search + Program.nni_search,
src/nni_engine.cpp:197-330, 721-1020), on top of the faithful per-edge-PV
eval engine (`bito_tpu.tp.eval_engine`).  The regression oracle is
data/ds1/test/run.811b735.csv: the accepted-NNI central-edge PCSP sequence
(and per-acceptance scores) of 200 iterations of search seeded with the
MrBayes top-1 tree.

Bookkeeping matches the reference defaults (src/nni_engine.hpp:564-576):
only NEW adjacent NNIs are rescored each iteration (scores persist with
whatever PV staleness they were computed under); ALL adjacent scored NNIs
compete in the top-1 evaluation; accepted NNIs are added via
SubsplitDAG::AddNodePair and the engine is updated incrementally.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.bitset import Subsplit, clade_cmp_key, popcount
from ..core.newick import parse_newick_file, read_fasta
from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..dag.subsplit_dag import LEFT, RIGHT, SubsplitDAG, build_dag
from ..tp.eval_engine import (FaithfulTPEvalEngine, NO_EDGE, NO_TREE,
                              neighbor_nni)

NNI = Tuple[Subsplit, Subsplit]


def nni_sort_key(nni: NNI):
    """std::set<NNIOperation> order (reference NNIOperation::Compare →
    Bitset::SubsplitCompare: taxon count, union, then full bitset)."""
    def subsplit_key(ss: Subsplit):
        return (popcount(ss.union),
                clade_cmp_key(ss.union, ss.n),
                clade_cmp_key(ss.clade0, ss.n) + clade_cmp_key(ss.clade1,
                                                               ss.n))

    return subsplit_key(nni[0]) + subsplit_key(nni[1])


@dataclass
class AcceptRecord:
    iteration: int
    pcsp: str                 # central-edge PCSP bitstring (golden field 2)
    score: float              # accepted NNI's score (golden field 3)
    parent: str
    child: str


class GoldenNNISearch:
    """The reference NNIEngine loop with TP-likelihood scoring, faithful
    to the DS1 golden-run configuration."""

    def __init__(self, dag: SubsplitDAG, site_pattern: SitePattern,
                 trees: Sequence[Tree], opt_max: int = 5,
                 include_rootsplits: bool = False):
        self.dag = dag
        self.engine = FaithfulTPEvalEngine(dag, site_pattern)
        self.engine.optimize_max_iter = opt_max
        self.include_rootsplits = include_rootsplits
        # Harness init (test/nni_search.py:624-651):
        self.engine.set_branch_lengths_by_taking_first(trees)
        self.engine.set_tree_source_by_taking_first(trees)
        # NNI sets; keys are (parent, child) Subsplit tuples.
        self.adjacent: Set[NNI] = set()
        self.new_adjacent: Set[NNI] = set()
        self.scored: Dict[NNI, float] = {}
        self.new_scored: Dict[NNI, float] = {}
        self.accepted: List[NNI] = []
        self.past_accepted: Set[NNI] = set()
        self.records: List[AcceptRecord] = []
        self._last_mods = None
        # Filter scheme over the scored set (reference
        # SetTopKScoreFilteringScheme / SetEvaluateViaMinScoreCutoff /
        # Set*DropFilteringScheme, src/nni_engine.cpp:370-445).
        self.filter: Tuple[str, float] = ("top_k", 1)
        # Re-label adjacent NNIs near DAG modifications as new so they are
        # rescored with fresh PVs (reference UpdateOutOfDateAdjacentNNIs,
        # nni_engine.cpp:933-984; the DS1 golden run was produced with this
        # behavior on -- verified empirically against run.811b735.csv).
        self.rescore_out_of_date = True
        # Rescore every adjacent NNI each iteration (reference
        # SetRescoreRejectedNNIs / rescore_rejected_nnis_).
        self.rescore_all = False

    # -- RunInit (reference nni_engine.cpp:217-228) ------------------------
    def run_init(self):
        self.sync_adjacent_nnis_with_dag()
        # FilterInit → PrepEvalEngine → TP Prep: InitializeChoiceMap +
        # InitializeScores (nni_evaluation_engine.cpp:1039-1043).
        self.engine.initialize_choice_map()
        self.engine.initialize()

    def _safe_add(self, parent: Subsplit, child: Subsplit):
        """Reference SafeAddOutputNNIsToAdjacentNNIs
        (nni_engine.cpp:846-877)."""
        if parent.is_uca() or child.is_leaf():
            return
        for swap_clade0 in (True, False):
            p2, c2 = neighbor_nni(parent, child, swap_clade0)
            if self.dag.contains_edge(p2, c2):
                continue
            nni = (p2, c2)
            if nni not in self.adjacent:
                self.adjacent.add(nni)
                self.new_adjacent.add(nni)

    def sync_adjacent_nnis_with_dag(self):
        """Reference SyncAdjacentNNIsWithDAG (nni_engine.cpp:766-792)."""
        self.adjacent.clear()
        self.new_adjacent.clear()
        dag = self.dag
        uca = Subsplit.uca(dag.taxon_count)
        for e in range(dag.edge_count()):
            pid = int(dag.edge_parent[e])
            cid = int(dag.edge_child[e])
            parent = uca if pid == dag.root_id else dag.nodes[pid]
            child = dag.nodes[cid]
            if parent.is_uca() or child.is_leaf():
                continue
            if self.include_rootsplits or not parent.is_rootsplit():
                self._safe_add(parent, child)

    # -- RunMainLoop (reference nni_engine.cpp:230-257) ---------------------
    def run_main_loop(self):
        # FilterPreScore → ScoreAdjacentNNIs over NNIs-to-rescore (the new
        # adjacent set; rescore_rejected_nnis_ defaults false).
        to_rescore = sorted(
            self.adjacent if self.rescore_all else self.new_adjacent,
            key=nni_sort_key)
        self.new_scored = {}
        if to_rescore:
            # One batched float64 program on the device for the whole
            # candidate set (the reference's hot loop,
            # src/nni_engine.cpp:230-257).
            scores = self.engine.score_adjacent_nnis(to_rescore)
            for nni, score in zip(to_rescore, scores):
                self.scored.pop(nni, None)
                self.scored[nni] = score
                self.new_scored[nni] = score
        # FilterPostScore + FilterEvaluate (min-score cutoff over ALL
        # scored NNIs; reevaluate_rejected_nnis_ defaults true).
        self.accepted = []
        if self.scored:
            kind, value = self.filter
            if kind == "top_k":
                ranked = sorted(self.scored.values(), reverse=True)
                cutoff = ranked[min(int(value), len(ranked)) - 1]
            elif kind == "cutoff":
                cutoff = value
            elif kind == "drop":
                cutoff = max(self.scored.values()) - value
            else:
                raise ValueError(kind)
            self.accepted = [nni for nni, s in self.scored.items()
                             if s >= cutoff]
        # (4) Add accepted NNIs to the DAG + engine update.
        if self.accepted:
            self._add_accepted_nnis_to_dag()
        return bool(self.accepted)

    def _find_nni_to_pre_nni(self) -> List[Tuple[NNI, NNI]]:
        """Reference AddAcceptedNNIsToDAG prep (nni_engine.cpp:721-745):
        pre-NNI = the in-DAG neighbor not in the adjacent set; when both
        clade swaps qualify the LAST (clade1 swap) wins."""
        out = []
        for nni in sorted(self.accepted, key=nni_sort_key):
            pre = None
            for cand in self.engine.find_all_nni_neighbors_in_dag(*nni):
                if cand is not None and cand not in self.adjacent:
                    pre = cand
            assert pre is not None, "NNI not found to be adjacent to DAG"
            out.append((nni, pre))
        return out

    def _add_accepted_nnis_to_dag(self):
        from ..dag.reference_order import add_node_pair_reference_ordered

        nni_to_pre_nni = self._find_nni_to_pre_nni()
        prev_edge_count = self.dag.edge_count()
        mods = None
        for nni, _ in nni_to_pre_nni:
            m = add_node_pair_reference_ordered(self.dag, nni[0], nni[1])
            mods = m if mods is None else _compose_mods(mods, m)
        self._last_mods = mods
        # FilterPostModification → GrowEvalEngineForDAG +
        # UpdateEvalEngineAfterModifyingDAG (nni_engine.cpp:459-468).
        self.engine.grow_and_reindex(mods)
        if getattr(self, "per_nni_update", False):
            # 811b735-era hypothesis: choice-map update + the per-NNI local
            # engine update (UpdateEngineAfterDAGAddNodePair).
            self.engine._update_choice_map_after_modifying_dag(
                nni_to_pre_nni, prev_edge_count, mods)
            for post, pre in nni_to_pre_nni:
                self.engine.update_engine_after_dag_add_node_pair(post, pre)
            self.engine.compute_scores(sorted(
                int(e) for e in mods.added_edge_ids))
        else:
            self.engine.update_after_modifying_dag(nni_to_pre_nni,
                                                   prev_edge_count, mods)

    # -- RunPostLoop (reference nni_engine.cpp:259-277, 897-1020) ----------
    def run_post_loop(self):
        dag = self.dag
        self.new_adjacent.clear()
        for nni in self.accepted:
            self.adjacent.discard(nni)
            self.scored.pop(nni, None)
        for e in self._last_mods.added_edge_ids:
            pid = int(dag.edge_parent[e])
            parent = (Subsplit.uca(dag.taxon_count)
                      if pid == dag.root_id else dag.nodes[pid])
            nni = (parent, dag.nodes[int(dag.edge_child[e])])
            self.adjacent.discard(nni)
            self.scored.pop(nni, None)
        for nni in self.accepted:
            e = dag.get_edge_id(nni[0], nni[1])
            for node in (int(dag.edge_parent[e]), int(dag.edge_child[e])):
                for adj in (dag.rootward, dag.leafward):
                    for side in (LEFT, RIGHT):
                        for other, adj_e in adj[node][side]:
                            pid = int(dag.edge_parent[adj_e])
                            parent = (Subsplit.uca(dag.taxon_count)
                                      if pid == dag.root_id
                                      else dag.nodes[pid])
                            child = dag.nodes[int(dag.edge_child[adj_e])]
                            self._safe_add(parent, child)
        if self.rescore_out_of_date:
            self._update_out_of_date_adjacent_nnis()
        self.past_accepted.update(self.accepted)
        self.accepted = []

    def _update_out_of_date_adjacent_nnis(self):
        """Reference UpdateOutOfDateAdjacentNNIs (nni_engine.cpp:933-984):
        adjacent NNIs whose nodes are newly added, or with new edges to
        potential grandparent/grandchild nodes, are re-labeled new."""
        dag = self.dag
        mods = self._last_mods
        updated = set(int(n) for n in mods.added_node_ids)
        for e in mods.added_edge_ids:
            updated.add(int(dag.edge_parent[e]))
            updated.add(int(dag.edge_child[e]))
        # Potential parent/child nodes of a subsplit, via clade maps
        # (reference FindParentNodeIdsViaMap / FindChildNodeIdsViaMap).
        by_clade0: Dict[int, List[int]] = {}
        by_clade1: Dict[int, List[int]] = {}
        by_union: Dict[int, List[int]] = {}
        for nid in range(dag.node_count_without_dag_root()):
            ss = dag.nodes[nid]
            by_clade0.setdefault(ss.clade0, []).append(nid)
            by_clade1.setdefault(ss.clade1, []).append(nid)
            by_union.setdefault(ss.union, []).append(nid)
        for nni in self.adjacent:
            if nni in self.new_adjacent:
                continue
            found = False
            for ss in nni:
                if found:
                    continue
                nid = dag.subsplit_to_id.get(ss.to_string())
                if nid is not None and nid in updated:
                    self.new_adjacent.add(nni)
                    continue
                neighbor_ids = (by_clade0.get(ss.union, [])
                                + by_clade1.get(ss.union, [])
                                + by_union.get(ss.clade0, [])
                                + by_union.get(ss.clade1, []))
                for cand in neighbor_ids:
                    if cand in updated:
                        self.new_adjacent.add(nni)
                        found = True
                        break

    # -- full run -----------------------------------------------------------
    def run(self, iter_max: int = 200, verbose: bool = False,
            on_iteration=None) -> List[AcceptRecord]:
        """The harness main loop (test/nni_search.py:1158-1295): score,
        accept top-1, record, stop when nothing is accepted."""
        from ..core.bitset import PCSP

        self.run_init()
        iter_count = 1
        while iter_count <= iter_max:
            any_accepted = self.run_main_loop()
            for nni in sorted(self.accepted, key=nni_sort_key):
                e = self.dag.get_edge_id(nni[0], nni[1])
                pcsp = PCSP.of_parent_child(nni[0], nni[1])
                self.records.append(AcceptRecord(
                    iteration=iter_count,
                    pcsp=pcsp.to_string(),
                    score=self.scored[nni],
                    parent=nni[0].to_string(),
                    child=nni[1].to_string(),
                ))
            if verbose and self.records:
                r = self.records[-1]
                print(f"iter {iter_count}: accepted {len(self.accepted)} "
                      f"score {r.score:.6f} pcsp {r.pcsp}")
            if on_iteration is not None:
                on_iteration(self, iter_count)
            if not any_accepted:
                break
            self.run_post_loop()
            iter_count += 1
        return self.records


def _compose_mods(first, second):
    """Compose two ModificationResults (reference
    ModificationResult::ComposeWith): reindexers chain, added ids remap."""
    from ..dag.subsplit_dag import ModificationResult

    node_reindexer = second.node_reindexer[first.node_reindexer]
    edge_reindexer = second.edge_reindexer[first.edge_reindexer]
    added_nodes = ([int(second.node_reindexer[i])
                    for i in first.added_node_ids]
                   + list(second.added_node_ids))
    added_edges = ([int(second.edge_reindexer[i])
                    for i in first.added_edge_ids]
                   + list(second.added_edge_ids))
    return ModificationResult(added_nodes, added_edges, node_reindexer,
                              edge_reindexer)


def load_golden_run(path: str) -> List[Tuple[str, Optional[float]]]:
    """Parse run.811b735.csv: lines of `hash pcsp_bits [score]`
    (reference Loader.load_nni_list, test/nni_search.py:327-340; the hash
    is the C++ std::hash of the NNI -- implementation-defined -- so the
    PCSP bitstring + score are the portable fidelity oracle)."""
    out = []
    with open(path) as fp:
        for line in fp:
            fields = line.strip().split()
            if not fields or fields[0].startswith("#"):
                continue
            score = float(fields[2]) if len(fields) > 2 else None
            out.append((fields[1], score))
    return out


def golden_nni_search(fasta_path: str, seed_newick_path: str,
                      iter_max: int = 200, opt_max: int = 5,
                      verbose: bool = False, on_iteration=None
                      ) -> GoldenNNISearch:
    """Build the DS1-style search from files and run it."""
    from ..dag.reference_order import build_dag_reference_ordered

    collection = parse_newick_file(seed_newick_path)
    alignment = read_fasta(fasta_path)
    sp = SitePattern(alignment, collection.taxon_names)
    dag = build_dag_reference_ordered(collection)
    search = GoldenNNISearch(dag, sp, collection.trees, opt_max=opt_max)
    search.run(iter_max=iter_max, verbose=verbose, on_iteration=on_iteration)
    return search

class _NNIView:
    """NNIOperation-shaped view of a (parent, child) Subsplit pair."""

    __slots__ = ("parent", "child")

    def __init__(self, nni: NNI):
        self.parent, self.child = nni

    def key(self) -> Tuple[str, str]:
        return (self.parent.to_string(), self.child.to_string())


class FaithfulNNIEngine:
    """NNIEngine-compatible facade over GoldenNNISearch: the product
    TP-likelihood search path.  Unlike the batched whole-tree engine
    (`nni/engine.py`), DAG growth here is incremental — AddNodePair with
    reindexers, PV carry-over, and local-only recompute (reference
    GPEngine::GrowPLVs/Reindex role, src/gp_engine.cpp:64-209) — so a long
    search never rebuilds or recompiles engine state."""

    def __init__(self, dag: SubsplitDAG, site_pattern: SitePattern,
                 supporting_trees: Sequence[Tree], opt_max: int = 5):
        self.search = GoldenNNISearch(dag, site_pattern, supporting_trees,
                                      opt_max=opt_max)
        self.iterations = 0
        self.accepted_scores_this_iter: Dict[Tuple[str, str], float] = {}
        self._initialized = False

    @property
    def dag(self) -> SubsplitDAG:
        return self.search.dag

    @property
    def engine(self) -> "FaithfulTPEvalEngine":
        return self.search.engine

    # -- filter schemes ----------------------------------------------------
    def set_top_k_score_filtering_scheme(self, k: int):
        self.search.filter = ("top_k", k)

    def set_filter_cutoff(self, cutoff: float):
        self.search.filter = ("cutoff", cutoff)

    def set_tp_likelihood_cutoff_filtering_scheme(self, cutoff: float):
        self.search.filter = ("cutoff", cutoff)

    def set_filter_drop_from_best(self, window: float):
        self.search.filter = ("drop", window)

    def set_tp_likelihood_drop_filtering_scheme(self, window: float):
        self.search.filter = ("drop", window)

    # -- loop --------------------------------------------------------------
    def run_init(self):
        self.search.run_init()
        self._initialized = True

    def run_main_loop(self, quiet: bool = True) -> bool:
        if not self._initialized:
            self.run_init()
        any_accepted = self.search.run_main_loop()
        self.iterations += 1
        self.accepted_scores_this_iter = {
            _NNIView(nni).key(): self.search.scored[nni]
            for nni in self.search.accepted
        }
        if not quiet:
            print(f"iter {self.iterations}: "
                  f"{len(self.search.adjacent)} adjacent, "
                  f"{len(self.search.accepted)} accepted")
        return any_accepted

    def run_post_loop(self):
        self.search.run_post_loop()

    def run(self, iter_max: int = 200, quiet: bool = True):
        self.run_init()
        it = 0
        while it < iter_max and self.adjacent_nni_count():
            if not self.run_main_loop(quiet=quiet):
                break
            self.run_post_loop()
            it += 1

    # -- accessors (reference src/nni_engine.hpp:118-213) ------------------
    def adjacent_nnis(self):
        return [_NNIView(n) for n in self.search.adjacent]

    def adjacent_nni_count(self) -> int:
        return len(self.search.adjacent)

    def accepted_nnis(self):
        return [_NNIView(n) for n in self.search.accepted]

    def accepted_nni_count(self) -> int:
        return len(self.search.accepted)

    def past_accepted_nnis(self):
        return [_NNIView(n) for n in self.search.past_accepted]

    def past_accepted_nni_count(self) -> int:
        return len(self.search.past_accepted)

    def scored_nnis(self) -> Dict[Tuple[str, str], float]:
        return {_NNIView(n).key(): s for n, s in self.search.scored.items()}

    def scored_nni_count(self) -> int:
        return len(self.search.scored)

    def iter_count(self) -> int:
        return self.iterations
