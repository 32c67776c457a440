"""NNI systematic search over the subsplit DAG (torch).

Port of bito_tpu.nni.engine (a rebuild of the reference NNIEngine,
src/nni_engine.cpp:197-330, src/nni_operation.hpp:25-90).  The loop
{enumerate adjacent NNIs -> score candidates -> filter -> add accepted to
DAG -> update sets} is preserved; candidate scoring runs as one batch over
all candidates' trees (TP likelihood or parsimony) on the engines'
device, replacing the reference's per-NNI graft/scratch-PLV evaluation.
On the card in float32, TP-likelihood scoring reaches the paired LL
kernel (treelike/engine.py's `auto` route at one rate category) and
parsimony scoring runs Sankoff's torch operations; the selected-branch
optimization before scoring is the scan tape's.  Every engine takes
`device` and `dtype` (the card in float32 unless the caller asks for
another) and hands them to the engines it builds.

Where the port differs from bito_tpu:
  - run_main_loop raises where an accepted NNI has no candidate tree
    (bito_tpu appends None to the supporting trees there);
  - sync_adjacent_nnis_with_dag clears `adjacent_source` with `adjacent`
    (bito_tpu keeps every key it ever saw; each current key is written
    again either way, so no result changes).

GPScoredNNIEngine.shard_patterns(group) shards its GP engine and every
grafted scoring engine an iteration builds over a torch.distributed
process group (GPEngine.shard_patterns); the DAG and the NNI sets stay
host state, the same on every rank.

DAG growth is a rebuild from the accumulated supporting trees rather than
the reference's incremental AddNodePair + reindexing
(src/subsplit_dag.hpp:525-565): host-side rebuild cost is trivial next to
device scoring at these scales, and every epoch yields a fresh
contiguously-indexed DAG for the levelized schedules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.bitset import PCSP, Subsplit
from ..core.tree import Tree
from ..core.site_pattern import SitePattern
from ..dag.subsplit_dag import SubsplitDAG, build_dag_from_topologies
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..tp.engine import TPEngine


@dataclass(frozen=True)
class NNIOperation:
    """A proposed parent/child subsplit pair (reference NNIOperation)."""

    parent: Subsplit
    child: Subsplit

    def key(self) -> Tuple[str, str]:
        return (self.parent.to_string(), self.child.to_string())


def neighboring_nnis(parent: Subsplit, child: Subsplit) -> List[NNIOperation]:
    """The two NNIs of a central edge: swap the sister clade with the
    child's left or right clade (reference NNIOperation::GetNeighboringNNI,
    src/nni_operation.hpp:70-82)."""
    n = parent.n
    if child.union == parent.clade0:
        sister = parent.clade1
    else:
        sister = parent.clade0
    L, R = child.clade0, child.clade1
    out = []
    for swapped, kept in ((L, R), (R, L)):
        # Swap sister <-> `swapped`: new child = (sister, kept), new parent
        # = (swapped, sister|kept).
        new_child = Subsplit.of_pair(sister, kept, n)
        new_parent = Subsplit.of_pair(swapped, sister | kept, n)
        out.append(NNIOperation(new_parent, new_child))
    return out


class NNIEngine:
    def __init__(self, dag: SubsplitDAG, site_pattern: SitePattern,
                 supporting_trees: Sequence[Tree],
                 scoring: str = "tp_likelihood", *, device=PRODUCT_DEVICE,
                 dtype=PRODUCT_DTYPE):
        assert scoring in ("tp_likelihood", "tp_parsimony")
        self.device, self.dtype = resolve(device, dtype)
        self.site_pattern = site_pattern
        self.scoring = scoring
        self.supporting_trees: List[Tree] = list(supporting_trees)
        self.dag = dag
        self.adjacent: Dict[Tuple[str, str], NNIOperation] = {}
        self.accepted: List[NNIOperation] = []
        self.rejected: Set[Tuple[str, str]] = set()       # this iteration
        self.past_rejected: Set[Tuple[str, str]] = set()  # cumulative
        self.scored: Dict[Tuple[str, str], float] = {}
        self._candidate_trees: Dict[Tuple[str, str], Tree] = {}
        # Filtering scheme
        self._filter = ("top_k", 1)
        self.iterations = 0
        self.accepted_this_iter: List[NNIOperation] = []
        # Reference defaults (src/nni_engine.hpp:564-566): only NEW adjacent
        # NNIs are rescored each iteration (TP scores don't go stale), but
        # ALL adjacent NNIs -- including previously rejected ones, with
        # their cached scores -- compete in the accept/reject evaluation.
        self._rescore_rejected = False
        self._reevaluate_rejected = True
        # Proposed-tree new-edge branch optimization before scoring
        # (reference TPEngine optimize_new_edges + optimization_max_iteration,
        # test/nni_search.py:29-33).
        self._optimize_new_edges = True
        self._optimization_iterations = 2
        self._filter_init_fn = None
        self._filter_pre_score_fn = None
        self._filter_post_score_fn = None
        self._filter_evaluate_fn = None
        self._rebuild_engines()

    # -- filter schemes (reference src/pybito.cpp:1019-1048) -------------
    def set_filter_cutoff(self, cutoff: float):
        self._filter = ("cutoff", cutoff)

    def set_filter_drop_from_best(self, window: float):
        self._filter = ("drop", window)

    def set_filter_top_k(self, k: int):
        self._filter = ("top_k", k)

    # -- engines -----------------------------------------------------------
    def _rebuild_engines(self):
        self.tp = TPEngine(self.dag, self.site_pattern, device=self.device,
                           dtype=self.dtype)
        self.tp.initialize_choice_map(self.supporting_trees)
        self.tp.set_branch_lengths_by_taking_first(self.supporting_trees)

    # -- adjacency ---------------------------------------------------------
    def sync_adjacent_nnis_with_dag(self):
        """Reference NNIEngine::SyncAdjacentNNIsWithDAG
        (src/nni_engine.cpp:766): both swaps of every central edge, minus
        pairs already in the DAG.  Previously rejected NNIs stay adjacent
        (they keep competing with cached scores) unless reevaluation of
        rejected NNIs is disabled."""
        dag = self.dag
        existing = set(dag.build_edge_indexer().keys())
        self.adjacent.clear()
        self.adjacent_source = {}
        for e in range(dag.edge_count()):
            p_id = int(dag.edge_parent[e])
            c_id = int(dag.edge_child[e])
            if p_id == dag.root_id or c_id < dag.taxon_count:
                continue
            parent = dag.nodes[p_id]
            child = dag.nodes[c_id]
            for nni in neighboring_nnis(parent, child):
                key = nni.key()
                pcsp = PCSP.of_parent_child(nni.parent, nni.child).to_string()
                if pcsp in existing:
                    continue
                if (not self._reevaluate_rejected
                        and key in self.past_rejected):
                    continue
                self.adjacent[key] = nni
                # Pre-NNI counterpart (the central edge this NNI swaps):
                # frozen-q scoring maps each new node to its pre-NNI
                # subsplit (reference FindNNINeighborInDAG +
                # CopyOverEdgeDataFromPreNNIToPostNNI).
                self.adjacent_source[key] = (parent, child)

    # -- candidate trees ---------------------------------------------------
    def _candidate_tree(self, nni: NNIOperation) -> Optional[Tree]:
        """Build the proposed top tree for an NNI: take the top tree of the
        pre-NNI central edge and swap the sister subtree with the
        appropriate child subtree (the reference's pre->post clade mapping,
        src/nni_operation.hpp:70-82, realized as host tree surgery).

        The pre-NNI central edge is found in O(1): the NNI swap is an
        involution, so the DAG edge it came from is one of the proposed
        NNI's own two neighboring NNIs — dict lookups against the DAG's
        subsplit/edge maps replace the former O(E) edge scan (reference
        uses the same constant-time clade maps, src/nni_operation.hpp:70-82
        + GetCentralEdgePCSP)."""
        dag = self.dag
        best_edge = None
        for pre in neighboring_nnis(nni.parent, nni.child):
            if dag.contains_edge(pre.parent, pre.child):
                e = dag.get_edge_id(pre.parent, pre.child)
                if best_edge is None or e < best_edge:
                    best_edge = e
        if best_edge is None:
            return None
        tree = self.tp.top_tree(best_edge)
        return _apply_nni_to_tree(tree, dag.nodes[int(dag.edge_parent[best_edge])],
                                  nni)

    # -- scoring -----------------------------------------------------------
    def _new_edge_nodes(self, tree: Tree, indexer=None) -> List[int]:
        """Node ids of the tree whose edge-PCSP is not yet in the DAG —
        the proposed NNI's new edges, whose branch lengths get optimized
        before scoring (reference optimize_new_edges +
        init_proposed_branch_lengths_with_dag, src/tp_engine.cpp:1423-1427,
        exercised by test/nni_search.py:20-33).  Pass `indexer` when
        calling per-tree in a loop — build_edge_indexer is O(E) string
        building and dominated the at-scale scoring pass otherwise."""
        if indexer is None:
            indexer = self.dag.build_edge_indexer()
        topo = tree.topology
        n = topo.num_taxa
        cl = topo.clades()
        ch = topo.children()
        ss = {v: Subsplit.leaf(v, n) for v in range(n)}
        for v in range(n, topo.num_nodes):
            kids = ch[v]
            ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
        out = []
        for v in range(topo.num_nodes - 1):
            parent = int(topo.parents[v])
            pcsp = PCSP.of_parent_child(ss[parent], ss[v]).to_string()
            if pcsp not in indexer:
                out.append(v)
        return out

    def score_adjacent_nnis(self) -> Dict[Tuple[str, str], float]:
        """Score the NNIs to rescore in one batched program: only the NEW
        adjacent ones by default — TP top-tree scores don't go stale — or
        every adjacent NNI when rescoring is enabled (reference
        GetNNIsToRescore, src/nni_engine.hpp:145-152).  Each proposed
        tree's new edges are branch-optimized before scoring."""
        keys, trees = [], []
        for key, nni in self.adjacent.items():
            if key in self.scored and not self._rescore_rejected:
                continue
            t = self._candidate_tree(nni)
            if t is None:
                continue
            keys.append(key)
            trees.append(t)
        if trees:
            if self.scoring != "tp_parsimony" and self._optimize_new_edges:
                indexer = self.dag.build_edge_indexer()
                selected = [self._new_edge_nodes(t, indexer)
                            for t in trees]
                bl = self.tp.like_engine.optimize_selected_branches(
                    trees, {}, selected,
                    iterations=self._optimization_iterations,
                    bucket=True,
                )
                for b, t in enumerate(trees):
                    t.branch_lengths = bl[b, : t.topology.num_nodes].copy()
            if self.scoring == "tp_parsimony":
                scores = self.tp.sankoff.run_sankoff(trees)
                scores = -scores  # lower parsimony is better; negate to rank
            else:
                scores = self.tp.like_engine.log_likelihoods(
                    trees, {}, bucket=True).cpu().numpy()
            self.scored.update(zip(keys, map(float, scores)))
            self._candidate_trees.update(zip(keys, trees))
        # The evaluation scope: cached scores of every adjacent NNI
        # (reference GetScoredNNIsToReevaluate, src/nni_engine.hpp:166-169).
        if self._reevaluate_rejected:
            return {k: self.scored[k] for k in self.adjacent
                    if k in self.scored}
        return {k: self.scored[k] for k in keys}

    def _filter_accept(self, scores: Dict[Tuple[str, str], float]
                       ) -> List[Tuple[str, str]]:
        if not scores:
            return []
        kind, arg = self._filter
        items = sorted(scores.items(), key=lambda kv: -kv[1])
        if kind == "cutoff":
            return [k for k, v in items if v > arg]
        if kind == "drop":
            best = items[0][1]
            return [k for k, v in items if v > best - arg]
        return [k for k, v in items[: int(arg)]]

    # -- main loop (reference NNIEngine::Run, src/nni_engine.cpp:197-277,
    # staged as RunInit / RunMainLoop / RunPostLoop) ----------------------
    def reset_nni_data(self):
        self.adjacent.clear()
        self.accepted.clear()
        self.rejected.clear()
        self.past_rejected.clear()
        self.scored.clear()
        self._candidate_trees.clear()
        self.accepted_this_iter = []
        self.iterations = 0

    def run_init(self):
        """Reference RunInit (src/nni_engine.cpp:217-228)."""
        self.reset_nni_data()
        self.sync_adjacent_nnis_with_dag()
        self.filter_init()

    def run_main_loop(self, quiet: bool = True) -> bool:
        """One iteration: graft/score/filter/add (reference RunMainLoop,
        src/nni_engine.cpp:230-257).  Returns True if any NNI accepted."""
        self.filter_pre_score()
        scores = self.filter_score_adjacent_nnis()
        self.filter_post_score()
        accepted_keys = self.filter_evaluate_adjacent_nnis(scores)
        if not quiet:
            print(f"iter {self.iterations}: {len(self.adjacent)} "
                  f"adjacent, {len(accepted_keys)} accepted")
        self.rejected = {k for k in scores if k not in accepted_keys}
        self.past_rejected |= self.rejected
        if not accepted_keys:
            self.accepted_this_iter = []
            return False
        self.accepted_this_iter = [self.adjacent[k] for k in accepted_keys]
        self.accepted_scores_this_iter = {k: scores[k] for k in accepted_keys}
        for key in accepted_keys:
            self.accepted.append(self.adjacent[key])
            # Lazy candidate-tree construction: scorers that don't need
            # the trees for scoring (GP per-PCSP) skip building them for
            # the ~thousand rejected candidates per pass.
            tree = self._candidate_trees.get(key)
            if tree is None:
                tree = self._candidate_tree(self.adjacent[key])
            if tree is None:
                raise RuntimeError(
                    f"accepted NNI {key} has no candidate tree: no pre-NNI "
                    "central edge of it is in the DAG")
            self.supporting_trees.append(tree)
            self.scored.pop(key, None)   # reference RemoveNNIScore
            self.past_rejected.discard(key)
        self.add_accepted_nnis_to_dag()
        return True

    def run_post_loop(self):
        """Reference RunPostLoop (src/nni_engine.cpp:259-277): refresh the
        adjacent set after DAG growth; this iteration's rejections are
        archived and cleared (reference UpdateRejectedNNIs,
        src/nni_engine.cpp:984-991)."""
        self.sync_adjacent_nnis_with_dag()
        self.rejected = set()
        self.iterations += 1

    def run(self, max_iter: int = 100, quiet: bool = True) -> int:
        self.run_init()
        while self.adjacent and self.iterations < max_iter:
            if not self.run_main_loop(quiet):
                break
            self.run_post_loop()
        return self.iterations

    # Filter pipeline hook points (reference customizable slots,
    # src/nni_engine.cpp:281-330); defaults are no-ops plus the scoring and
    # evaluation stages, and each can be replaced via set_filter_*_function.
    def filter_init(self):
        if self._filter_init_fn:
            self._filter_init_fn(self)

    def filter_pre_score(self):
        if self._filter_pre_score_fn:
            self._filter_pre_score_fn(self)

    def filter_score_adjacent_nnis(self):
        return self.score_adjacent_nnis()

    def filter_post_score(self):
        if self._filter_post_score_fn:
            self._filter_post_score_fn(self)

    def filter_evaluate_adjacent_nnis(self, scores=None):
        if scores is None:
            scores = {k: self.scored[k] for k in self.adjacent
                      if k in self.scored}
        if self._filter_evaluate_fn:
            return self._filter_evaluate_fn(self, scores)
        return self._filter_accept(scores)

    def set_filter_init_function(self, fn):
        self._filter_init_fn = fn

    def set_filter_pre_score_function(self, fn):
        self._filter_pre_score_fn = fn

    def set_filter_post_score_function(self, fn):
        self._filter_post_score_fn = fn

    def set_filter_evaluate_function(self, fn):
        self._filter_evaluate_fn = fn

    def add_accepted_nnis_to_dag(self):
        self._grow_dag()

    def _grow_dag(self):
        from contextlib import nullcontext

        ph = (self.timer.phase if getattr(self, "timer", None) is not None
              else (lambda name: nullcontext()))
        with ph("accept.dag_rebuild"):
            topologies = [t.topology for t in self.supporting_trees]
            self.dag = build_dag_from_topologies(
                topologies, self.dag.taxon_names
            )
        self._rebuild_engines()

    # -- state accessors (reference src/nni_engine.hpp:118-213) -----------
    def adjacent_nnis(self):
        return list(self.adjacent.values())

    def adjacent_nni_count(self) -> int:
        return len(self.adjacent)

    def accepted_nnis(self):
        return list(self.accepted_this_iter)

    def accepted_nni_count(self) -> int:
        return len(self.accepted_this_iter)

    def past_accepted_nnis(self):
        return list(self.accepted)

    def past_accepted_nni_count(self) -> int:
        return len(self.accepted)

    def rejected_nnis(self):
        return [self.adjacent[k] for k in self.rejected if k in self.adjacent]

    def rejected_nni_count(self) -> int:
        return len(self.rejected_nnis())

    def past_rejected_nni_count(self) -> int:
        return len(self.past_rejected)

    def scored_nnis(self):
        return dict(self.scored)

    def scored_nni_count(self) -> int:
        return len(self.scored)

    past_scored_nnis = scored_nnis

    def iter_count(self) -> int:
        return self.iterations

    # -- filtering scheme names (reference src/pybito.cpp:1019-1048) ------
    def set_top_k_score_filtering_scheme(self, k: int):
        self.set_filter_top_k(k)

    def set_tp_likelihood_cutoff_filtering_scheme(self, cutoff: float):
        assert self.scoring == "tp_likelihood"
        self.set_filter_cutoff(cutoff)

    def set_tp_likelihood_drop_filtering_scheme(self, window: float):
        assert self.scoring == "tp_likelihood"
        self.set_filter_drop_from_best(window)

    def set_tp_parsimony_cutoff_filtering_scheme(self, cutoff: float):
        assert self.scoring == "tp_parsimony"
        self.set_filter_cutoff(cutoff)

    def set_tp_parsimony_drop_filtering_scheme(self, window: float):
        assert self.scoring == "tp_parsimony"
        self.set_filter_drop_from_best(window)

    def set_no_filter(self, accept_all: bool = True):
        self.set_filter_cutoff(-np.inf if accept_all else np.inf)

    def set_rescore_rejected_nnis(self, rescore: bool):
        self._rescore_rejected = rescore

    def set_reevaluate_rejected_nnis(self, reevaluate: bool):
        self._reevaluate_rejected = reevaluate

    def set_optimize_new_edges(self, optimize: bool):
        self._optimize_new_edges = optimize

    def set_optimization_max_iteration(self, iterations: int):
        self._optimization_iterations = max(1, int(iterations))


def _three_clades(parent: Subsplit, child: Subsplit) -> Tuple[int, int, int]:
    sister = parent.clade0 if child.union == parent.clade1 else parent.clade1
    return (sister, child.clade0, child.clade1)


def _apply_nni_to_tree(tree: Tree, pre_parent: Subsplit, nni: NNIOperation
                       ) -> Tree:
    """Swap subtrees in `tree` to realize the proposed NNI: find the node
    with the parent's union clade, and rebuild its two-level structure so
    its children partition as (new_parent.clade0, new_parent.clade1) with
    the focal side split per new_child."""
    topo = tree.topology
    n = topo.num_taxa
    cl = topo.clades()
    ch = topo.children()
    union = nni.parent.union
    u = next(v for v in range(n, topo.num_nodes) if cl[v] == union)
    # Collect the three subtree roots: sister + child's two clades.
    new_parent, new_child = nni.parent, nni.child
    # The focal clade of the new parent is the one the new child splits.
    focal = new_child.union
    sister_clade = new_parent.clade0 if new_parent.clade1 == focal else new_parent.clade1
    want = {sister_clade, new_child.clade0, new_child.clade1}

    # Find the three subtree roots below u whose clades are `want`.
    roots: Dict[int, int] = {}

    def find(v):
        if cl[v] in want and cl[v] not in roots:
            roots[cl[v]] = v
            return
        for c in ch[v]:
            find(c)

    find(u)
    assert len(roots) == 3, (roots, want)
    # Rebuild: u -> (sister_subtree, focal_node -> (childL, childR)).
    children_new = {v: list(ch[v]) for v in range(topo.num_nodes)}
    # Reuse u's old focal child node id as the new internal node.
    old_kids = ch[u]
    spare = next(k for k in old_kids if k >= n)
    children_new[spare] = [roots[new_child.clade0], roots[new_child.clade1]]
    children_new[u] = [roots[sister_clade], spare]
    from ..core.tree import _renumber

    maxid = topo.num_nodes - 1
    ch_list = [children_new.get(i, []) for i in range(maxid + 1)]
    new_topo = _renumber(ch_list, n, topo.root)
    # Carry branch lengths by clade identity where possible.
    new_tree = Tree(new_topo, np.full(new_topo.num_nodes, 0.1))
    old_by_clade = {cl[v]: float(tree.branch_lengths[v])
                    for v in range(topo.num_nodes - 1)}
    new_cl = new_topo.clades()
    for v in range(new_topo.num_nodes - 1):
        if new_cl[v] in old_by_clade:
            new_tree.branch_lengths[v] = old_by_clade[new_cl[v]]
    return new_tree


class GPScoredNNIEngine(NNIEngine):
    """NNI search scored by per-PCSP GP likelihoods of grafted candidates
    (reference NNIEvalEngineViaGP, src/nni_evaluation_engine.hpp:4-9).

    Per iteration, every adjacent NNI is grafted into one DAG and a single
    wavefront populate+likelihood program scores all central edges at once;
    branch lengths carry over from the host engine by PCSP identity (the
    reference's spare-scratch reuse, src/gp_engine.hpp:151-159)."""

    def __init__(self, dag: SubsplitDAG, site_pattern: SitePattern,
                 supporting_trees: Sequence[Tree], *, device=PRODUCT_DEVICE,
                 dtype=PRODUCT_DTYPE):
        super().__init__(dag, site_pattern, supporting_trees,
                         scoring="tp_likelihood", device=device, dtype=dtype)
        from ..gp.engine import GPEngine

        # One capacity-bucket dict shared between the persistent engine
        # and the per-iteration grafted scoring engines, as in bito_tpu:
        # buckets only grow, so after the first iterations every engine
        # has the same index shapes.
        self._gp_caps: Dict[str, int] = {}
        self.group = None  # set by shard_patterns() for multi-process runs
        self.gp = GPEngine(site_pattern, self.dag, caps=self._gp_caps,
                           headroom=2, device=self.device, dtype=self.dtype)
        self.gp.estimate_branch_lengths(1e-3, 10)

    def shard_patterns(self, group=None):
        """Run every GP scoring program pattern-sharded over the ranks of
        `group` (the world where None), as bito_tpu/nni/engine.py:535-545
        runs them over a device mesh: the persistent GP engine now, and
        each iteration's grafted scoring engine as it is built.  The
        persistent engine keeps its branch lengths and q, and its PLVs and
        likelihoods, which sharding clears, are computed again from
        them."""
        from ..dist import mesh

        group = mesh.make_group() if group is None else group
        self.gp.shard_patterns(group)
        self.group = group
        self.gp.populate_plvs()
        self.gp.compute_likelihoods()

    def _rebuild_engines(self):
        from contextlib import nullcontext

        ph = (self.timer.phase if getattr(self, "timer", None) is not None
              else (lambda name: nullcontext()))
        with ph("accept.tp_rebuild"):
            super()._rebuild_engines()
        if hasattr(self, "gp"):
            # Incremental growth: the engine keeps its capacity buckets,
            # carries branch lengths by PCSP and PLVs by subsplit — no
            # per-acceptance reconstruction (reference GPEngine::GrowPLVs,
            # src/gp_engine.cpp:64-209).
            with ph("accept.gp_grow"):
                self.gp.grow(self.dag)
            with ph("accept.estimate_bl"):
                self.gp.estimate_branch_lengths(1e-3, 5)

    @staticmethod
    def _carry_branch_lengths(engine, old_bl: Dict[str, float]):
        """The capacity-sized branch lengths of `engine`, with each edge
        whose PCSP is in `old_bl` taking that value, as a tensor on the
        engine's device in its dtype."""
        bl = engine._host(engine._blc).copy()
        for e, key in enumerate(engine.dag.pretty_edges()):
            if key in old_bl:
                bl[e] = old_bl[key]
        engine._blc = engine._tensor(bl)

    def _carry_q(self, engine, keys):
        """Frozen-prior scoring (reference NNIEvalEngineViaGP: host q stays
        untouched, each candidate's new edges COPY q from their pre-NNI
        counterpart edge — src/nni_evaluation_engine.cpp:229-463 with
        CopyOverEdgeDataFromPreNNIToPostNNI — rather than renormalizing
        priors over the grafted DAG).  Measured round 5
        (tests/test_graft_semantics.py): renormalized all-at-once scoring
        REORDERS candidates vs the truth oracle under shipped priors;
        with frozen q the ranking matches.  New nodes map to their
        pre-NNI parent/child subsplits; new edges whose mapped PCSP does
        not exist in the host keep the grafted prior value."""
        host_q = dict(zip(self.gp.dag.pretty_edges(),
                          self.gp._host(self.gp._qc)))
        counterpart = {}
        for k in keys:
            nni = self.adjacent[k]
            src = getattr(self, "adjacent_source", {}).get(k)
            if src is None:
                continue
            counterpart[nni.parent.to_string()] = src[0]
            counterpart[nni.child.to_string()] = src[1]
        dag = engine.dag
        from ..core.bitset import PCSP, Subsplit

        uca = Subsplit.uca(dag.taxon_count)
        # capacity-sized (see _carry_branch_lengths)
        q = engine._host(engine._qc).copy()
        for e in range(dag.edge_count()):
            key = dag.pretty_edge(e)
            if key in host_q:
                q[e] = host_q[key]
                continue
            u = (uca if int(dag.edge_parent[e]) == dag.root_id
                 else dag.nodes[int(dag.edge_parent[e])])
            v = dag.nodes[int(dag.edge_child[e])]
            u2 = counterpart.get(u.to_string(), u)
            v2 = counterpart.get(v.to_string(), v)
            try:
                k2 = PCSP.of_parent_child(u2, v2).pretty()
            except ValueError:
                # Mapped endpoints do not form a valid PCSP (the swap
                # changed which parent clade the child divides); keep the
                # grafted prior for this edge.
                continue
            if k2 in host_q:
                q[e] = host_q[k2]
        engine._qc = engine._tensor(q)

    def score_adjacent_nnis(self) -> Dict[Tuple[str, str], float]:
        from contextlib import nullcontext

        from ..dag.graft import graft_node_pairs
        from ..gp.engine import GPEngine

        if not self.adjacent:
            return {}
        # Optional per-phase budget: set `self.timer` to an object whose
        # `phase(name)` is a context manager (chip_smoke.py's
        # SyncedPhases) to split an iteration into host rebuild and
        # device scoring.
        ph = (self.timer.phase if getattr(self, "timer", None) is not None
              else (lambda name: nullcontext()))
        keys = list(self.adjacent.keys())
        pairs = [(self.adjacent[k].parent, self.adjacent[k].child)
                 for k in keys]
        with ph("score.graft_rebuild"):
            grafted, central = graft_node_pairs(self.dag, pairs)
        with ph("score.engine_build"):
            engine = GPEngine(self.site_pattern, grafted,
                              caps=self._gp_caps, headroom=2,
                              device=self.device, dtype=self.dtype)
            if self.group is not None:
                engine.shard_patterns(self.group)
        with ph("score.carry"):
            self._carry_branch_lengths(
                engine,
                dict(zip(self.gp.dag.pretty_edges(),
                         self.gp._host(self.gp._blc))),
            )
            self._carry_q(engine, keys)
        with ph("score.device"):
            engine.populate_plvs()
            engine.compute_likelihoods()
            ll = engine.per_gpcsp_log_likelihoods()
        out = {k: float(ll[c]) for k, c in zip(keys, central)}
        self.scored.update(out)
        # Candidate trees (needed only for DAG growth of ACCEPTED NNIs)
        # are built lazily at acceptance time — run_main_loop falls back
        # to _candidate_tree for keys absent from _candidate_trees.
        # Building all of them here would extract a top tree from the
        # choice map for every candidate while top-k filtering accepts
        # one.  Every adjacent NNI has a pre-NNI source edge in the DAG by
        # construction, so no validity filtering is lost (and
        # run_main_loop raises where one has none).
        self._candidate_trees = {}
        return out


# GP-scored filtering scheme names (reference src/pybito.cpp:1019-1048).
def _set_gp_likelihood_cutoff_filtering_scheme(self, cutoff: float):
    self.set_filter_cutoff(cutoff)


def _set_gp_likelihood_drop_filtering_scheme(self, window: float):
    self.set_filter_drop_from_best(window)


GPScoredNNIEngine.set_gp_likelihood_cutoff_filtering_scheme = (
    _set_gp_likelihood_cutoff_filtering_scheme
)
GPScoredNNIEngine.set_gp_likelihood_drop_filtering_scheme = (
    _set_gp_likelihood_drop_filtering_scheme
)


# ---------------------------------------------------------------------------
# Remaining API-compat accessors (reference nni_engine/graft_dag bindings)
# ---------------------------------------------------------------------------
def _nni_compat(cls):
    def graft_adjacent_nnis_to_dag(self):
        """Build (and cache) the grafted DAG holding every adjacent NNI
        (reference GraftAdjacentNNIsToDAG)."""
        from ..dag.graft import graft_node_pairs

        pairs = [(n.parent, n.child) for n in self.adjacent.values()]
        self._graft_dag, self._graft_central = (
            graft_node_pairs(self.dag, pairs) if pairs else (self.dag, [])
        )
        return self._graft_dag

    def remove_all_graft_nnis_from_dag(self):
        self._graft_dag = None
        self._graft_central = []

    def get_host_dag(self):
        return self.dag

    def host_node_count(self):
        return self.dag.node_count_without_dag_root()

    def host_edge_count(self):
        return self.dag.edge_count()

    def graft_node_count(self):
        g = getattr(self, "_graft_dag", None)
        if g is None:
            return 0
        return g.node_count_without_dag_root() - self.host_node_count()

    def graft_edge_count(self):
        g = getattr(self, "_graft_dag", None)
        if g is None:
            return 0
        return g.edge_count() - self.host_edge_count()

    def get_score_by_nni(self, nni) -> float:
        return self.scored[nni.key()]

    def get_score_by_edge(self, edge_id: int) -> float:
        """Score keyed by a grafted central edge id."""
        g = getattr(self, "_graft_dag", None)
        assert g is not None, "Call graft_adjacent_nnis_to_dag first"
        for key, central in zip(self.adjacent.keys(), self._graft_central):
            if central == edge_id:
                return self.scored[key]
        raise KeyError(edge_id)

    def new_adjacent_nnis(self):
        """Adjacent NNIs not yet scored (reference new-NNI tracking)."""
        return [n for k, n in self.adjacent.items() if k not in self.scored]

    def new_adjacent_nni_count(self):
        return len(self.new_adjacent_nnis())

    def nnis_to_rescore(self):
        return self.new_adjacent_nnis()

    def nnis_to_reevaluate(self):
        return self.new_adjacent_nnis()

    def update_adjacent_nnis(self):
        self.sync_adjacent_nnis_with_dag()

    def update_accepted_nnis(self):
        pass  # accepted set maintained inline by run_main_loop

    def update_rejected_nnis(self):
        pass

    def update_scored_nnis(self):
        pass

    def prep_eval_engine(self):
        pass  # engines are rebuilt eagerly on DAG growth

    def set_include_rootsplits(self, include: bool = True):
        """Whether NNIs over rootsplit-adjacent edges are proposed
        (reference SetIncludeRootsplitNNIs)."""
        self._include_rootsplits = include

    # Branch-length policy toggles (reference option setters): our design
    # always carries host branch lengths by PCSP identity and optimizes new
    # edges on growth, so these record the user's intent.
    def set_init_proposed_branch_lengths_with_dag(self, value: bool = True):
        self._init_proposed_bl_with_dag = value

    def is_init_proposed_branch_lengths_with_dag(self):
        return getattr(self, "_init_proposed_bl_with_dag", True)

    def set_fix_proposed_branch_lengths_from_dag(self, value: bool = True):
        self._fix_proposed_bl_from_dag = value

    def is_fix_proposed_branch_lengths_from_dag(self):
        return getattr(self, "_fix_proposed_bl_from_dag", True)

    def set_optimize_new_edges(self, value: bool = True):
        self._optimize_new_edges = value

    def is_optimize_new_edges(self):
        return getattr(self, "_optimize_new_edges", False)

    def set_optimization_max_iteration(self, value: int):
        self._optimization_max_iteration = value

    def get_optimization_max_iteration(self):
        return getattr(self, "_optimization_max_iteration", 1000)

    def set_filter_score_loop_function(self, fn):
        self._filter_score_loop_fn = fn

    def set_filter_evaluate_loop_function(self, fn):
        self._filter_evaluate_loop_fn = fn

    def build_map_of_proposed_nnis_to_best_pre_nnis(self):
        """Proposed NNI -> the pre-NNI central pair it came from."""
        out = {}
        for key, nni in self.adjacent.items():
            dag = self.dag
            union = nni.parent.union
            for e in range(dag.edge_count()):
                p_id = int(dag.edge_parent[e])
                c_id = int(dag.edge_child[e])
                if p_id == dag.root_id or c_id < dag.taxon_count:
                    continue
                p_ss, c_ss = dag.nodes[p_id], dag.nodes[c_id]
                if p_ss.union != union:
                    continue
                if ({*_three_clades(p_ss, c_ss)}
                        == {*_three_clades(nni.parent, nni.child)}):
                    out[key] = (p_ss, c_ss)
                    break
        return out

    def build_map_of_proposed_nni_pcsps_to_best_pre_nni_pcsps(self):
        pairs = build_map_of_proposed_nnis_to_best_pre_nnis(self)
        return {
            PCSP.of_parent_child(self.adjacent[k].parent,
                                 self.adjacent[k].child).pretty():
            PCSP.of_parent_child(p, c).pretty()
            for k, (p, c) in pairs.items()
        }

    for name, fn in list(locals().items()):
        if callable(fn) and not name.startswith("_nni"):
            setattr(cls, name, fn)
    return cls


_nni_compat(NNIEngine)
