"""Trajectory-faithful TP likelihood eval engine over per-edge PVs.

The port's copy of bito_tpu.tp.eval_engine: numpy, its code bito_tpu's
apart from docstrings, comments and one method, score_adjacent_nnis
(tests/test_torch_batch_scorer.py pins it by AST).  That method runs the
batched scorer whenever use_batched_scorer is True, in float64 on the
engine's `device` (an attribute its owner sets, the card where none is
set), where bito_tpu's falls back to the serial scorer in silence
wherever x64 is off.

bito_tpu's module is the reference's TPEvalEngineViaLikelihood rebuilt 1:1
(reference: src/tp_evaluation_engine.cpp:109-1243, src/tp_engine.cpp:421-1250,
src/dag_branch_handler.cpp OptimizeBranchLength/BrentOptimization): six
partial vectors per DAG *edge* (P, PHatLeft, PHatRight, RHat, RLeft, RRight),
populated along the choice map, a serial Brent branch-length optimizer in
log space, the local 5-edge proposed-NNI scorer with its temp-PV workspace,
and the post-acceptance incremental update that refreshes (and optimizes)
only the new and choice-adjacent edges.

Why a serial host engine exists next to the batched TP engine
(`tp/engine.py`): the DS1 NNI golden run (reference
test/test_nni_search.py:19-35 against data/ds1/test/run.811b735.csv) pins
the exact accepted-NNI sequence of the reference's *serial* optimization
trajectory, including the staleness pattern of PVs that are only locally
refreshed after DAG growth.  Reproducing that trajectory requires replaying
the same operation order; this module is that replay, in f64 numpy (small
4xS kernels, host-bound bookkeeping).  The batched scorer
(`score_proposed_nnis_batched`) runs the same per-candidate program for
every candidate at once, on the device in float64, and is verified
against the serial path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.bitset import PCSP, Subsplit
from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..dag.subsplit_dag import LEFT, RIGHT, SubsplitDAG

# PLV types per edge (reference PLVType, src/pv_handler.hpp:26-33).
P, PHAT_LEFT, PHAT_RIGHT, RHAT, R_LEFT, R_RIGHT = range(6)
# EdgeAdjacent slots in the choice map (reference TPChoiceMap::EdgeChoice).
PARENT, SISTER, LEFT_CHILD, RIGHT_CHILD = range(4)
# NNIClade (reference NNIOperation::NNIClade).
PARENT_FOCAL, PARENT_SISTER, CHILD_LEFT, CHILD_RIGHT = range(4)
# NNIAdjacent slots for the 5 local edges of a proposed NNI
# (reference NNIAdjacentEnum order: Parent, Sister, Focal, LeftChild,
# RightChild -- see src/tp_engine.hpp NNIAdjacent).
A_PARENT, A_SISTER, A_FOCAL, A_LEFT, A_RIGHT = range(5)

NO_EDGE = -1
NO_TREE = 1 << 60  # reference NoId: compares as a huge tree id

# Reference DAGBranchHandler constants (src/dag_branch_handler.hpp:266-295).
DEFAULT_BL = 0.1
MIN_LOG_BL = -13.9
MAX_LOG_BL = 1.1
SIGNIFICANT_DIGITS = 10
BRENT_MAX_ITER = 1000
BL_DIFF_THRESHOLD = 1e-15

# JC69 eigensystem exactly as the reference hardcodes it
# (src/substitution_model.cpp:20-26).
JC69_V = np.array(
    [[1.0, 2.0, 0.0, 0.5],
     [1.0, -2.0, 0.5, 0.0],
     [1.0, 2.0, 0.0, -0.5],
     [1.0, -2.0, -0.5, 0.0]], dtype=np.float64)
JC69_VINV = np.array(
    [[0.25, 0.25, 0.25, 0.25],
     [0.125, -0.125, 0.125, -0.125],
     [0.0, 1.0, 0.0, -1.0],
     [1.0, 0.0, -1.0, 0.0]], dtype=np.float64)
JC69_EIGENVALUES = np.array([0.0, -4.0 / 3.0, -4.0 / 3.0, -4.0 / 3.0])
JC69_STATIONARY = np.array([0.25, 0.25, 0.25, 0.25])


def jc69_transition(branch_length: float) -> np.ndarray:
    """P(t) = V diag(exp(t*lambda)) V^-1 (reference
    SetTransitionMatrixToHaveBranchLength, tp_evaluation_engine.cpp:1223)."""
    return (JC69_V * np.exp(branch_length * JC69_EIGENVALUES)) @ JC69_VINV


def brent_minimize_scalar(f, guess: float, lo: float, hi: float,
                          significant_digits: int = SIGNIFICANT_DIGITS,
                          max_iter: int = BRENT_MAX_ITER) -> Tuple[float, float]:
    """Scalar port of the reference's Boost-adapted guess-init Brent
    (reference Optimization::BrentMinimize, src/optimization.hpp:70-188)."""
    tolerance = math.ldexp(1.0, 1 - significant_digits)
    golden = 0.3819659948348999  # float32 of the reference's 0.3819660f
    x = w = v = guess
    fx = fw = fv = f(x)
    delta = delta2 = 0.0
    count = max_iter
    while True:
        mid = (lo + hi) / 2.0
        fract1 = tolerance * abs(x) + tolerance / 4.0
        fract2 = 2.0 * fract1
        if abs(x - mid) <= (fract2 - (hi - lo) / 2.0):
            break
        use_bisection = True
        if abs(delta2) > fract1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            td = delta2
            delta2 = delta
            if (not (abs(p) >= abs(q * td / 2.0))
                    and not (p <= q * (lo - x))
                    and not (p >= q * (hi - x))):
                delta = p / q
                u = x + delta
                if ((u - lo) < fract2) or ((hi - u) < fract2):
                    delta = -abs(fract1) if (mid - x) < 0 else abs(fract1)
                use_bisection = False
        if use_bisection:
            delta2 = (lo - x) if x >= mid else (hi - x)
            delta = golden * delta2
        if abs(delta) >= fract1:
            u = x + delta
        else:
            u = x + abs(fract1) if delta > 0 else x - abs(fract1)
        fu = f(u)
        if fu <= fx:
            if u >= x:
                lo = x
            else:
                hi = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                lo = u
            else:
                hi = u
            if (fu <= fw) or (w == x):
                v, w = w, u
                fv, fw = fw, fu
            elif (fu <= fv) or (v == x) or (v == w):
                v, fv = u, fu
        count -= 1
        if count == 0:
            break
    return x, fx


def neighbor_nni(parent: Subsplit, child: Subsplit,
                 swap_clade0: bool) -> Tuple[Subsplit, Subsplit]:
    """Reference NNIOperation::GetNeighboringNNI (nni_operation.cpp:46-61):
    swap the sister clade with the child's clade0 (Left) or clade1."""
    n = parent.n
    if child.union == parent.clade0:
        sister = parent.clade1
    else:
        sister = parent.clade0
    x = sister
    y = child.clade0 if swap_clade0 else child.clade1
    z = child.clade1 if swap_clade0 else child.clade0
    return (Subsplit.of_pair(y, x | z, n), Subsplit.of_pair(x, z, n))


def nni_sister_clade(parent: Subsplit, child: Subsplit) -> int:
    return parent.clade1 if child.union == parent.clade0 else parent.clade0


def build_nni_clade_map(pre: Tuple[Subsplit, Subsplit],
                        post: Tuple[Subsplit, Subsplit]) -> List[int]:
    """clade_map[pre_nni_clade] = post_nni_clade (reference
    NNIOperation::BuildNNICladeMapFromPreNNIToNNI, nni_operation.cpp)."""
    def clades(nni):
        p, c = nni
        return {
            PARENT_SISTER: nni_sister_clade(p, c),
            CHILD_LEFT: c.clade0,
            CHILD_RIGHT: c.clade1,
        }

    pre_clades, post_clades = clades(pre), clades(post)
    mapped = {PARENT_SISTER: False, CHILD_LEFT: False, CHILD_RIGHT: False}
    out = [PARENT_FOCAL, -1, -1, -1]
    for pre_t in (PARENT_SISTER, CHILD_LEFT, CHILD_RIGHT):
        for post_t in (PARENT_SISTER, CHILD_LEFT, CHILD_RIGHT):
            if mapped[post_t]:
                continue
            if pre_clades[pre_t] == post_clades[post_t]:
                out[pre_t] = post_t
                mapped[post_t] = True
                break
        else:
            raise AssertionError("no clade mapping from pre to post NNI")
    return out


@dataclass
class LocalPVRefs:
    """The reference PVs a proposed-NNI scoring reads from the DAG
    (reference LocalPVIds subset actually consumed by the scorer)."""
    sister_p: np.ndarray
    leftchild_p: np.ndarray
    rightchild_p: np.ndarray
    parent_rhat: np.ndarray
    grandparent_rfocal: Optional[np.ndarray]


class _EdgeIndirectPV:
    """PV tensor with a logical-edge -> physical-row indirection.

    The reference grows its PV matrices in place and physically reindexes
    them after every DAG modification (Reindexer::ReindexInPlace over the
    mmapped store, src/reindexer.hpp).  At DS1 scale that is a ~170 MB copy
    per accepted NNI — it measured as 69% of the whole 200-iteration search
    (278 s of 405 s).  Here edge data rows never move: `pe[e]` maps the
    logical edge id (which the reference ordering reassigns on growth) to a
    stable physical row, and growth appends rows and rewrites only the
    int map.  Lookup cost is one integer index per access."""

    __slots__ = ("store", "pe")

    def __init__(self, store: np.ndarray, pe: np.ndarray):
        self.store = store
        self.pe = pe

    def __getitem__(self, key):
        if isinstance(key, tuple):
            t, e = key
            return self.store[t, self.pe[e]]
        # Non-tuple access would expose PHYSICAL row order (permuted after
        # the first growth) as if it were logical edge order — use dense()
        # for a logical-order materialization (advisor round-4 finding).
        raise TypeError(
            "_EdgeIndirectPV requires (pv_type, edge) indexing; use "
            "dense() for a logical-edge-order array")

    def __setitem__(self, key, val):
        if isinstance(key, tuple):
            t, e = key
            self.store[t, self.pe[e]] = val
        elif key == slice(None):
            self.store[:] = val  # whole-store reset; order-independent
        else:
            raise TypeError(
                "_EdgeIndirectPV requires (pv_type, edge) indexing or a "
                "full [:] reset")

    @property
    def shape(self):
        return (self.store.shape[0], len(self.pe)) + self.store.shape[2:]

    def dense(self) -> np.ndarray:
        """Materialize [6, E, 4, S] in logical edge order (checkpoints,
        tests)."""
        return np.ascontiguousarray(self.store[:, self.pe])

    def grow(self, edge_reindexer: np.ndarray, E_new: int):
        """Apply a ModificationResult edge reindexer: logical ids move,
        physical rows do not; new logical edges get fresh zeroed rows."""
        cap = self.store.shape[1]
        n_new = E_new - len(self.pe)
        if len(self.pe) + n_new > cap:
            new_cap = max(cap * 2, E_new, 16)
            grown = np.zeros(
                (self.store.shape[0], new_cap) + self.store.shape[2:],
                dtype=self.store.dtype)
            grown[:, :cap] = self.store
            self.store = grown
        pe_new = np.empty(E_new, dtype=np.int64)
        pe_new[edge_reindexer] = self.pe
        fresh = len(self.pe) + np.arange(n_new)
        mask = np.ones(E_new, dtype=bool)
        mask[edge_reindexer] = False
        assert int(mask.sum()) == n_new, (mask.sum(), n_new)
        pe_new[mask] = fresh
        self.store[:, fresh] = 0.0
        self.pe = pe_new


class FaithfulTPEvalEngine:
    """Per-edge-PV TP likelihood engine (reference TPEvalEngineViaLikelihood).

    State is edge-indexed numpy f64; `dag` is the live SubsplitDAG this
    engine tracks through AddNodePair mutations."""

    def __init__(self, dag: SubsplitDAG, site_pattern: SitePattern):
        self.dag = dag
        self.site_pattern = site_pattern
        self.weights = np.asarray(site_pattern.weights, dtype=np.float64)
        S = site_pattern.pattern_count
        E = dag.edge_count()
        self.pv = _EdgeIndirectPV(
            np.zeros((6, E, 4, S), dtype=np.float64),
            np.arange(E, dtype=np.int64))
        self.bl = np.full(E, DEFAULT_BL, dtype=np.float64)
        self.diff = np.zeros(E, dtype=np.float64)
        self.choice = np.full((E, 4), NO_EDGE, dtype=np.int64)
        self.tree_source = np.full(E, NO_TREE, dtype=np.int64)
        self.log_likelihoods = np.zeros((E, S), dtype=np.float64)
        self.top_tree_scores = np.full(E, -np.inf)
        self.tree_counter = 0
        self.input_tree_count = 0
        # Engine options (harness defaults, test/nni_search.py:29-33).
        self.optimize_max_iter = 5
        self.do_optimize_new_edges = True
        self.use_best_edge_map = True
        self.init_proposed_bls_with_dag = True
        self.fix_proposed_bls_from_dag = True
        # 811b735 forensic probe knobs (tests/test_golden_run.py and
        # scripts/probe_811b735.py): variant update paths after DAG growth.
        self.update_optimize_new_edges = True   # skip local re-optimization
        self.update_all_edges = False           # sweep ALL edges, not local
        # Candidate scoring runs as one batched float64 program on the
        # device; the serial path remains the oracle (tests compare the
        # two).
        self.use_batched_scorer = True

    # -- small DAG helpers -------------------------------------------------
    def _is_edge_root(self, e: int) -> bool:
        return int(self.dag.edge_parent[e]) == self.dag.root_id

    def _focal_side(self, e: int) -> bool:
        return bool(self.dag.edge_side[e])

    @staticmethod
    def _phat_type(side: bool) -> int:
        return PHAT_LEFT if side == LEFT else PHAT_RIGHT

    @staticmethod
    def _r_type(side: bool) -> int:
        return R_LEFT if side == LEFT else R_RIGHT

    # -- transition helpers --------------------------------------------------
    def _evolved(self, edge_for_bl: int, src: np.ndarray,
                 temp_bl: Optional[Dict[int, float]] = None) -> np.ndarray:
        """P(bl[edge]) @ src (reference SetToEvolvedPV)."""
        t = (temp_bl[edge_for_bl] if temp_bl is not None
             and edge_for_bl in temp_bl else self.bl[edge_for_bl])
        return jc69_transition(t) @ src

    def _per_pattern_log_likelihoods(self, bl: float, parent: np.ndarray,
                                     child: np.ndarray) -> np.ndarray:
        pm = jc69_transition(bl)
        return np.log(np.einsum("as,as->s", parent, pm @ child))

    def _edge_neg_ll_fn(self, parent: np.ndarray, child: np.ndarray):
        w = self.weights

        def f(log_bl: float) -> float:
            pm = jc69_transition(math.exp(log_bl))
            vals = np.einsum("as,as->s", parent, pm @ child)
            return -float(np.log(vals) @ w)

        return f

    def _optimize_branch_length(self, e: int, parent: np.ndarray,
                                child: np.ndarray,
                                check_branch_convergence: bool):
        """Reference DAGBranchHandler::OptimizeBranchLength +
        BrentOptimization (dag_branch_handler.cpp): guess-init Brent in log
        space with the reset-if-worse guard and per-edge difference
        bookkeeping."""
        if check_branch_convergence and self.diff[e] < BL_DIFF_THRESHOLD:
            return
        f = self._edge_neg_ll_fn(parent, child)
        cur_y = math.log(self.bl[e])
        cur_f = f(cur_y)
        y, fy = brent_minimize_scalar(f, cur_y, MIN_LOG_BL, MAX_LOG_BL)
        if fy > cur_f:
            new_bl = math.exp(cur_y)
        else:
            new_bl = math.exp(y)
        self.diff[e] = abs(math.exp(cur_y) - new_bl)
        self.bl[e] = new_bl

    # -- initialization ------------------------------------------------------
    def set_branch_lengths_by_taking_first(self, trees: Sequence[Tree],
                                           set_default: bool = True):
        """Reference TPEngine::SetBranchLengthsByTakingFirst
        (tp_engine.cpp:1398-1421): first observed length per edge; the
        rootsplit edge is not covered by the tree traversal and keeps the
        default."""
        if set_default:
            self.bl[:] = DEFAULT_BL
        seen = np.zeros(self.dag.edge_count(), dtype=bool)
        for tree in trees:
            for node, e in self._tree_edge_map(tree).items():
                if node == tree.topology.root:
                    continue  # rootsplit edge: not visited by the reference
                if not seen[e]:
                    self.bl[e] = float(tree.branch_lengths[node])
                    seen[e] = True

    def _tree_edge_map(self, tree: Tree) -> Dict[int, int]:
        """tree node -> DAG edge id of the edge above it (including leaf
        edges and the rootsplit edge keyed by the tree root)."""
        dag = self.dag
        topo = tree.topology
        n = topo.num_taxa
        cl = topo.clades()
        ch = topo.children()
        ss: Dict[int, Subsplit] = {v: Subsplit.leaf(v, n) for v in range(n)}
        for v in range(n, topo.num_nodes):
            kids = ch[v]
            ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
        out: Dict[int, int] = {}
        for v in range(topo.num_nodes):
            if v == topo.root:
                pid = dag.root_id
            else:
                p = int(topo.parents[v])
                pkey = ss[p].to_string()
                if pkey not in dag.subsplit_to_id:
                    continue
                pid = dag.subsplit_to_id[pkey]
            ckey = ss[v].to_string()
            if ckey not in dag.subsplit_to_id:
                continue
            cid = dag.subsplit_to_id[ckey]
            e = dag.edge_to_id.get((pid, cid))
            if e is not None:
                out[v] = e
        return out

    def set_tree_source_by_taking_first(self, trees: Sequence[Tree]):
        """Reference TPEngine::SetTreeSourceByTakingFirst
        (tp_engine.cpp:658-695): 1-based first-tree ids; uncovered edges get
        tree_id_max; rootsplit edges inherit the best (smallest) source of
        their child node's leafward edges."""
        dag = self.dag
        self.input_tree_count = len(trees)
        self.tree_counter = len(trees) + 1
        tree_id_max = len(trees) + 1
        self.tree_source[:] = tree_id_max
        for tree_id, tree in enumerate(trees):
            for node, e in self._tree_edge_map(tree).items():
                if node == tree.topology.root:
                    continue
                if self.tree_source[e] == tree_id_max:
                    self.tree_source[e] = tree_id + 1
        for rs in dag.rootsplit_ids():
            rs_edge = dag.edge_to_id[(dag.root_id, rs)]
            best = tree_id_max
            for side in (LEFT, RIGHT):
                for _, e in dag.leafward[rs][side]:
                    if self.tree_source[e] < best:
                        best = int(self.tree_source[e])
                        self.tree_source[rs_edge] = best

    def update_edge_choice_by_highest_priority_tree(self, e: int):
        """Reference TPEngine::UpdateEdgeChoiceByTakingHighestPriorityTree
        (tp_engine.cpp:593-656)."""
        dag = self.dag
        parent = int(dag.edge_parent[e])
        child = int(dag.edge_child[e])

        def best_edge(node: int, rootward: bool, side: bool
                      ) -> Tuple[int, int]:
            best_tree, best_e, has_first = NO_TREE, NO_EDGE, False
            neigh = (dag.rootward if rootward else dag.leafward)[node][side]
            for _, adj_e in neigh:
                t = int(self.tree_source[adj_e])
                if (best_tree > t) or not has_first:
                    best_tree, best_e, has_first = t, adj_e, True
            return best_e, best_tree

        # Parent: best across both rootward clades of the parent node.
        b_edge, b_tree = NO_EDGE, NO_TREE
        for side in (LEFT, RIGHT):
            c_edge, c_tree = best_edge(parent, True, side)
            if (b_edge == NO_EDGE) or (b_tree > c_tree):
                b_edge, b_tree = c_edge, c_tree
        self.choice[e, PARENT] = b_edge
        self.choice[e, SISTER] = best_edge(
            parent, False, not self._focal_side(e))[0]
        self.choice[e, LEFT_CHILD] = best_edge(child, False, LEFT)[0]
        self.choice[e, RIGHT_CHILD] = best_edge(child, False, RIGHT)[0]

    def initialize_choice_map(self):
        """Reference TPEngine::InitializeChoiceMap (tp_engine.cpp:421)."""
        for e in range(self.dag.edge_count()):
            self.update_edge_choice_by_highest_priority_tree(e)

    # -- PV population (reference tp_evaluation_engine.cpp:120-160, 804-920)
    def initialize(self):
        self.pv[:] = 0.0
        self._populate_leaf_pvs()
        self._populate_root_pvs()
        self.populate_pvs()

    def _populate_leaf_pvs(self):
        dag = self.dag
        tips = self.site_pattern.tip_partials()  # [taxa, S, 4]
        for taxon in range(dag.taxon_count):
            tip = np.ascontiguousarray(tips[taxon].T)  # [4, S]
            for side in (LEFT, RIGHT):
                for _, e in dag.rootward[taxon][side]:
                    self.pv[P, e] = tip

    def _populate_root_pvs(self, edge_ids: Optional[Sequence[int]] = None):
        dag = self.dag
        if edge_ids is None:
            edge_ids = [dag.edge_to_id[(dag.root_id, rs)]
                        for rs in dag.rootsplit_ids()]
        for e in edge_ids:
            self.pv[RHAT, e] = JC69_STATIONARY[:, None]

    def populate_pvs(self):
        for node in self.dag.rootward_node_trace(include_root=False):
            self._populate_rootward_pv_for_node(node)
        for node in self.dag.leafward_node_trace(include_root=True):
            self._populate_leafward_pv_for_node(node)

    def _populate_rootward_pv_for_node(self, node: int):
        for side in (LEFT, RIGHT):
            for _, e in self.dag.rootward[node][side]:
                self.populate_rootward_pv_for_edge(e)

    def _populate_leafward_pv_for_node(self, node: int):
        for side in (LEFT, RIGHT):
            for _, e in self.dag.leafward[node][side]:
                self.populate_leafward_pv_for_edge(e)

    def populate_rootward_pv_for_edge(self, e: int):
        """Reference PopulateRootwardPVForEdge
        (tp_evaluation_engine.cpp:814-836)."""
        lc, rc = self.choice[e, LEFT_CHILD], self.choice[e, RIGHT_CHILD]
        if lc != NO_EDGE:
            self.pv[PHAT_LEFT, e] = self._evolved(lc, self.pv[P, lc])
        if rc != NO_EDGE:
            self.pv[PHAT_RIGHT, e] = self._evolved(rc, self.pv[P, rc])
        if lc != NO_EDGE and rc != NO_EDGE:
            self.pv[P, e] = self.pv[PHAT_LEFT, e] * self.pv[PHAT_RIGHT, e]
        elif lc != NO_EDGE:
            self.pv[P, e] = self.pv[PHAT_LEFT, e]
        elif rc != NO_EDGE:
            self.pv[P, e] = self.pv[PHAT_RIGHT, e]

    def populate_leafward_pv_for_edge(self, e: int):
        """Reference PopulateLeafwardPVForEdge
        (tp_evaluation_engine.cpp:850-868)."""
        pe = self.choice[e, PARENT]
        if pe != NO_EDGE:
            rt = self._r_type(self._focal_side(e))
            self.pv[RHAT, e] = self._evolved(e, self.pv[rt, pe])
        self.pv[R_LEFT, e] = self.pv[RHAT, e] * self.pv[PHAT_RIGHT, e]
        self.pv[R_RIGHT, e] = self.pv[RHAT, e] * self.pv[PHAT_LEFT, e]

    # -- scoring -------------------------------------------------------------
    def primary_pv_ids(self, e: int) -> Tuple[np.ndarray, np.ndarray]:
        """(parent_rfocal, child_p) of an edge (reference
        GetPrimaryPVIdsOfEdge, tp_evaluation_engine.cpp:1042-1056)."""
        pe = self.choice[e, PARENT]
        if pe == NO_EDGE:
            dag = self.dag
            first_root = dag.edge_to_id[(dag.root_id, dag.rootsplit_ids()[0])]
            parent_rfocal = self.pv[RHAT, first_root]
        else:
            parent_rfocal = self.pv[self._r_type(self._focal_side(e)), pe]
        return parent_rfocal, self.pv[P, e]

    def compute_scores(self, edge_ids: Optional[Sequence[int]] = None):
        """Reference ComputeScores (tp_evaluation_engine.cpp:921-937)."""
        if edge_ids is None:
            edge_ids = range(self.dag.edge_count())
        for e in edge_ids:
            parent_rfocal, child_p = self.primary_pv_ids(e)
            self.log_likelihoods[e] = self._per_pattern_log_likelihoods(
                self.bl[e], parent_rfocal, child_p)
        self.top_tree_scores = self.log_likelihoods @ self.weights

    # -- proposed-NNI machinery ---------------------------------------------
    def find_all_nni_neighbors_in_dag(self, parent: Subsplit, child: Subsplit
                                      ) -> List[Optional[Tuple[Subsplit, Subsplit]]]:
        """Reference SubsplitDAG::FindAllNNINeighborsInDAG
        (subsplit_dag.cpp:575-593): [swap-with-clade0, swap-with-clade1]."""
        out: List[Optional[Tuple[Subsplit, Subsplit]]] = []
        for swap_clade0 in (True, False):
            p2, c2 = neighbor_nni(parent, child, swap_clade0)
            if self.dag.contains_edge(p2, c2):
                out.append((p2, c2))
            else:
                out.append(None)
        return out

    def find_highest_priority_neighbor_nni(self, parent: Subsplit,
                                           child: Subsplit
                                           ) -> Tuple[Subsplit, Subsplit]:
        """Reference TPEngine::FindHighestPriorityNeighborNNIInDAG
        (tp_engine.cpp:804-834): min tree_source, clade0 swap on ties."""
        best_tree, best = NO_TREE, None
        for pre in self.find_all_nni_neighbors_in_dag(parent, child):
            if pre is None:
                continue
            e = self.dag.get_edge_id(pre[0], pre[1])
            t = int(self.tree_source[e])
            if best is None or t < best_tree:
                best_tree, best = t, pre
        assert best is not None, "NNI has no neighbor in the DAG"
        return best

    def _remapped_pre_choice(self, pre: Tuple[Subsplit, Subsplit],
                             post: Tuple[Subsplit, Subsplit]) -> np.ndarray:
        """Pre-NNI edge choices remapped to post-NNI clade positions
        (reference RemapEdgeChoiceDataViaNNICladeMap on the pre edge's
        choice): out[post_slot] = pre_choice[pre_slot]."""
        pre_e = self.dag.get_edge_id(pre[0], pre[1])
        clade_map = build_nni_clade_map(pre, post)
        slot_of_clade = {PARENT_FOCAL: PARENT, PARENT_SISTER: SISTER,
                         CHILD_LEFT: LEFT_CHILD, CHILD_RIGHT: RIGHT_CHILD}
        out = self.choice[pre_e].copy()
        for pre_t, post_t in enumerate(clade_map):
            out[slot_of_clade[post_t]] = self.choice[
                pre_e, slot_of_clade[pre_t]]
        return out

    def _choice_node_ids(self, choice: np.ndarray) -> List[int]:
        """Reference TPChoiceMap::GetEdgeChoiceNodeIds: parent slot gives
        the edge's parent node, the rest give child nodes."""
        dag = self.dag
        out = []
        for slot in range(4):
            e = int(choice[slot])
            if e == NO_EDGE:
                out.append(-1)
            elif slot == PARENT:
                out.append(int(dag.edge_parent[e]))
            else:
                out.append(int(dag.edge_child[e]))
        return out

    def adjacent_pcsps_to_proposed_nni(self, post: Tuple[Subsplit, Subsplit],
                                       node_ids: List[int]) -> List[PCSP]:
        """Reference BuildAdjacentPCSPsToProposedNNI (tp_engine.cpp:1630):
        5-slot [parent, sister, focal, left, right] PCSPs of the post-NNI."""
        dag = self.dag
        post_parent, post_child = post

        def node_ss(nid: int) -> Subsplit:
            return (Subsplit.uca(dag.taxon_count) if nid == dag.root_id
                    else dag.nodes[nid])

        return [
            PCSP.of_parent_child(node_ss(node_ids[PARENT]), post_parent),
            PCSP.of_parent_child(post_parent, node_ss(node_ids[SISTER])),
            PCSP.of_parent_child(post_parent, post_child),
            PCSP.of_parent_child(post_child, node_ss(node_ids[LEFT_CHILD])),
            PCSP.of_parent_child(post_child, node_ss(node_ids[RIGHT_CHILD])),
        ]

    def build_best_edge_map(self, post_nnis,
                            prev_edge_count: Optional[int] = None,
                            edge_reindexer: Optional[np.ndarray] = None
                            ) -> Dict[str, int]:
        """Reference BuildMapOfProposedNNIPCSPsToBestPreNNIEdges
        (tp_engine.cpp:1064-1134), keyed by PCSP string."""
        dag = self.dag
        best_edge: Dict[str, int] = {}
        best_tree: Dict[str, int] = {}
        old_index_of: Optional[Dict[int, int]] = None
        if edge_reindexer is not None:
            old_index_of = {int(new): old
                            for old, new in enumerate(edge_reindexer)}

        def is_edge_old(e: int) -> bool:
            if prev_edge_count is None:
                return True
            return (old_index_of is not None and e in old_index_of
                    and old_index_of[e] < prev_edge_count)

        def assign(pcsp: PCSP, ref_e: int):
            key = pcsp.to_string()
            pid = dag.subsplit_to_id.get(pcsp.parent.to_string())
            cid = dag.subsplit_to_id.get(pcsp.child.to_string())
            if pcsp.parent.is_uca():
                pid = dag.root_id
            if pid is not None and cid is not None \
                    and (pid, cid) in dag.edge_to_id:
                e = dag.edge_to_id[(pid, cid)]
                if is_edge_old(e):
                    best_edge[key] = e
                    best_tree[key] = 0
            if key not in best_edge \
                    or best_tree[key] > int(self.tree_source[ref_e]):
                best_edge[key] = ref_e
                best_tree[key] = int(self.tree_source[ref_e])

        for post in post_nnis:
            pre = self.find_highest_priority_neighbor_nni(*post)
            pre_e = self.dag.get_edge_id(pre[0], pre[1])
            mapped = self._remapped_pre_choice(pre, post)
            node_ids = self._choice_node_ids(mapped)
            pcsps = self.adjacent_pcsps_to_proposed_nni(post, node_ids)
            ref_edges = [int(mapped[PARENT]), int(mapped[SISTER]), pre_e,
                         int(mapped[LEFT_CHILD]), int(mapped[RIGHT_CHILD])]
            for pcsp, ref_e in zip(pcsps, ref_edges):
                assign(pcsp, ref_e)
        return best_edge

    def _proposed_nni_inputs(self, post: Tuple[Subsplit, Subsplit],
                             best_edge_map: Optional[Dict[str, int]]):
        """Gather reference PVs, branch-length init, and optimize mask for
        one proposed NNI (reference GetProposedNNIInfo + the branch-length
        initialization in GetTopTreeScoreWithProposedNNI,
        tp_evaluation_engine.cpp:466-500, 643-723)."""
        dag = self.dag
        pre = self.find_highest_priority_neighbor_nni(*post)
        pre_e = dag.get_edge_id(pre[0], pre[1])
        mapped = self._remapped_pre_choice(pre, post)
        node_ids = self._choice_node_ids(mapped)
        adj_pcsps = self.adjacent_pcsps_to_proposed_nni(post, node_ids)
        # 5-slot reference edges [A_PARENT, A_SISTER, A_FOCAL, A_LEFT, A_RIGHT]
        ref_edges = [int(mapped[PARENT]), int(mapped[SISTER]), pre_e,
                     int(mapped[LEFT_CHILD]), int(mapped[RIGHT_CHILD])]
        slot_pcsps = [adj_pcsps[0], adj_pcsps[1], adj_pcsps[2],
                      adj_pcsps[3], adj_pcsps[4]]
        if best_edge_map is not None:
            ref_edges = [best_edge_map[p.to_string()] for p in slot_pcsps]
        # Adjacent edges already in the DAG.
        adj_edges = []
        for p in slot_pcsps:
            pid = (dag.root_id if p.parent.is_uca()
                   else dag.subsplit_to_id.get(p.parent.to_string()))
            cid = dag.subsplit_to_id.get(p.child.to_string())
            e = None
            if pid is not None and cid is not None:
                e = dag.edge_to_id.get((pid, cid))
            adj_edges.append(NO_EDGE if e is None else e)
        # Branch-length init (the reference iterates NNIAdjacentEnum; slots
        # are independent).  Slot order here: PARENT, SISTER, FOCAL, L, R.
        bl_init = np.full(5, DEFAULT_BL)
        do_opt = np.ones(5, dtype=bool)
        for t in range(5):
            if self.init_proposed_bls_with_dag or best_edge_map is not None:
                bl_init[t] = self.bl[ref_edges[t]]
                if adj_edges[t] != NO_EDGE:
                    bl_init[t] = self.bl[adj_edges[t]]
                    if self.fix_proposed_bls_from_dag:
                        do_opt[t] = False
        # Reference PVs (remapped): sister/leftchild/rightchild P follow the
        # clade remap; parent-side PVs stay with the pre edge's parent choice.
        pre_choice_parent = int(self.choice[pre_e, PARENT])
        parent_rhat = self.pv[RHAT, pre_choice_parent]
        grandparent_rfocal = None
        if not self._is_edge_root(pre_choice_parent):
            gp_choice_parent = int(self.choice[pre_choice_parent, PARENT])
            rt = self._r_type(self._focal_side(pre_choice_parent))
            grandparent_rfocal = self.pv[rt, gp_choice_parent]
        refs = LocalPVRefs(
            sister_p=self.pv[P, int(mapped[SISTER])],
            leftchild_p=self.pv[P, int(mapped[LEFT_CHILD])],
            rightchild_p=self.pv[P, int(mapped[RIGHT_CHILD])],
            parent_rhat=parent_rhat,
            grandparent_rfocal=grandparent_rfocal,
        )
        return refs, bl_init, do_opt, pre, adj_edges

    def score_proposed_nni(self, post: Tuple[Subsplit, Subsplit],
                           best_edge_map: Optional[Dict[str, int]] = None
                           ) -> float:
        """Reference GetTopTreeScoreWithProposedNNI
        (tp_evaluation_engine.cpp:466-643): local 5-edge workspace, rootward
        + leafward passes, optimize_max_iter rounds of serial Brent over
        (left, right, sister, central, parent), then the focal-edge
        likelihood."""
        if best_edge_map is None and self.use_best_edge_map:
            best_edge_map = self.build_best_edge_map([post])
        refs, bl, do_opt, pre, _ = self._proposed_nni_inputs(
            post, best_edge_map if self.use_best_edge_map else None)
        post_parent_is_rootsplit = post[0].is_rootsplit()
        w = self.weights
        diffs = np.zeros(5)

        t: Dict[str, np.ndarray] = {}

        def P_of(bl_val: float) -> np.ndarray:
            return jc69_transition(bl_val)

        def rootward_pass():
            t["child_phatleft"] = P_of(bl[A_LEFT]) @ refs.leftchild_p
            t["child_phatright"] = P_of(bl[A_RIGHT]) @ refs.rightchild_p
            t["child_p"] = t["child_phatleft"] * t["child_phatright"]
            t["parent_phatsister"] = P_of(bl[A_SISTER]) @ refs.sister_p
            t["parent_phatfocal"] = P_of(bl[A_FOCAL]) @ t["child_p"]
            t["parent_p"] = t["parent_phatfocal"] * t["parent_phatsister"]

        def leafward_pass():
            if refs.grandparent_rfocal is not None:
                t["parent_rhat"] = P_of(bl[A_PARENT]) @ refs.grandparent_rfocal
            else:
                t["parent_rhat"] = refs.parent_rhat.copy()
            t["parent_rfocal"] = t["parent_rhat"] * t["parent_phatsister"]
            t["parent_rsister"] = t["parent_rhat"] * t["parent_phatfocal"]
            t["child_rhat"] = P_of(bl[A_FOCAL]) @ t["parent_rfocal"]
            t["child_rleft"] = t["child_rhat"] * t["child_phatright"]
            t["child_rright"] = t["child_rhat"] * t["child_phatleft"]

        def brent_slot(slot: int, parent_pv: np.ndarray,
                       child_pv: np.ndarray, check_convergence: bool):
            if not do_opt[slot]:
                return
            if check_convergence and diffs[slot] < BL_DIFF_THRESHOLD:
                return
            def f(y):
                vals = np.einsum(
                    "as,as->s", parent_pv, P_of(math.exp(y)) @ child_pv)
                return -float(np.log(vals) @ w)
            cur_y = math.log(bl[slot])
            cur_f = f(cur_y)
            y, fy = brent_minimize_scalar(f, cur_y, MIN_LOG_BL, MAX_LOG_BL)
            new_bl = math.exp(cur_y) if fy > cur_f else math.exp(y)
            diffs[slot] = abs(math.exp(cur_y) - new_bl)
            bl[slot] = new_bl

        rootward_pass()
        leafward_pass()

        if self.do_optimize_new_edges:
            for it in range(self.optimize_max_iter):
                check = it > 0
                # OptimizeLeftChild (tp_evaluation_engine.cpp:571-579)
                t["child_rleft"] = t["child_rhat"] * t["child_phatright"]
                brent_slot(A_LEFT, t["child_rleft"], refs.leftchild_p, check)
                t["child_phatleft"] = P_of(bl[A_LEFT]) @ refs.leftchild_p
                t["child_p"] = t["child_phatleft"] * t["child_phatright"]
                # OptimizeRightChild (phat args swapped)
                t["child_rright"] = t["child_rhat"] * t["child_phatleft"]
                brent_slot(A_RIGHT, t["child_rright"], refs.rightchild_p,
                           check)
                t["child_phatright"] = P_of(bl[A_RIGHT]) @ refs.rightchild_p
                t["child_p"] = t["child_phatright"] * t["child_phatleft"]
                # OptimizeSister
                t["parent_rsister"] = t["parent_rhat"] * t["parent_phatfocal"]
                brent_slot(A_SISTER, t["parent_rsister"], refs.sister_p,
                           check)
                t["parent_phatsister"] = P_of(bl[A_SISTER]) @ refs.sister_p
                t["parent_p"] = t["parent_phatsister"] * t["parent_phatfocal"]
                # OptimizeCentral (is_not_child_edge=True)
                t["child_p"] = t["child_phatleft"] * t["child_phatright"]
                t["parent_rfocal"] = t["parent_rhat"] * t["parent_phatsister"]
                brent_slot(A_FOCAL, t["parent_rfocal"], t["child_p"], check)
                t["parent_phatfocal"] = P_of(bl[A_FOCAL]) @ t["child_p"]
                t["parent_p"] = t["parent_phatfocal"] * t["parent_phatsister"]
                # OptimizeParent (is_not_child_edge=True,
                # is_not_parent_edge=False) -- skipped for rootsplit parents.
                if not post_parent_is_rootsplit:
                    t["parent_p"] = (t["parent_phatfocal"]
                                     * t["parent_phatsister"])
                    if refs.grandparent_rfocal is not None:
                        brent_slot(A_PARENT, refs.grandparent_rfocal,
                                   t["parent_p"], check)
                rootward_pass()
                leafward_pass()

        vals = np.einsum("as,as->s", t["parent_rfocal"],
                         P_of(bl[A_FOCAL]) @ t["child_p"])
        return float(np.log(vals) @ w)

    def score_proposed_nnis_batched(self, posts, best_edge_map=None):
        """All proposed-NNI scores as one batched float64 program on the
        device (the reference's hot loop, src/nni_engine.cpp:230-257;
        program in tp/batch_scorer.py).  Matches the serial
        `score_proposed_nni` to float64 reassociation tolerance
        (tests/test_torch_batch_scorer.py)."""
        from .batch_scorer import score_proposed_nnis_batched

        if best_edge_map is None and self.use_best_edge_map:
            best_edge_map = self.build_best_edge_map(list(posts))
        return score_proposed_nnis_batched(self, list(posts), best_edge_map)

    def score_adjacent_nnis(self, nnis: Sequence[Tuple[Subsplit, Subsplit]]
                            ) -> List[float]:
        """Reference NNIEvalEngineViaTP::ScoreAdjacentNNIs
        (nni_evaluation_engine.cpp:1075-1087).  Uses the batched scorer
        (tp/batch_scorer.py) whenever `use_batched_scorer` is True, in
        float64 (the faithful path's precision contract) on the device
        that the engine's owner set as `device` (the card where none is
        set); set `use_batched_scorer = False` to run the serial oracle.
        This method is the port's one change to bito_tpu's module: where
        x64 is off, bito_tpu's falls back to the serial scorer without a
        word, and the port never does (a missing device raises)."""
        best_edge_map = (self.build_best_edge_map(nnis)
                         if self.use_best_edge_map else None)
        if self.use_batched_scorer and nnis:
            return [float(s) for s in
                    self.score_proposed_nnis_batched(nnis, best_edge_map)]
        return [self.score_proposed_nni(nni, best_edge_map) for nni in nnis]

    # -- growth + post-acceptance update (reference tp_engine.cpp:238-556,
    #    tp_evaluation_engine.cpp:237-460) ----------------------------------
    def grow_and_reindex(self, mods):
        """Reference TPEngine::GrowEdgeData + eval GrowEdgeData + PV
        reindexing after SubsplitDAG::AddNodePair (the ModificationResult
        carries old->new reindexers)."""
        E_new = self.dag.edge_count()
        self.pv.grow(np.asarray(mods.edge_reindexer, dtype=np.int64), E_new)
        self.bl = mods.reindex_edge_data(self.bl, E_new, DEFAULT_BL)
        self.diff = mods.reindex_edge_data(self.diff, E_new, 0.0)
        old_choice = self.choice
        remapped = np.where(old_choice >= 0,
                            mods.edge_reindexer[
                                np.clip(old_choice, 0, None)].astype(np.int64),
                            NO_EDGE)
        self.choice = np.full((E_new, 4), NO_EDGE, dtype=np.int64)
        self.choice[mods.edge_reindexer] = remapped
        self.tree_source = mods.reindex_edge_data(
            self.tree_source, E_new, NO_TREE)
        self.log_likelihoods = mods.reindex_edge_data(
            self.log_likelihoods, E_new, 0.0)
        self.top_tree_scores = mods.reindex_edge_data(
            self.top_tree_scores, E_new, -np.inf)
        self.tree_counter += 1  # reference TPEngine::GrowEdgeData

    def update_after_modifying_dag(self, nni_to_pre_nni, prev_edge_count: int,
                                   mods):
        """Reference TPEngine::UpdateAfterModifyingDAG: choice-map update then
        eval-engine update."""
        self._update_choice_map_after_modifying_dag(
            nni_to_pre_nni, prev_edge_count, mods)
        self._update_engine_after_modifying_dag(
            nni_to_pre_nni, prev_edge_count, mods)

    def _update_choice_map_after_modifying_dag(self, nni_to_pre_nni,
                                               prev_edge_count: int, mods):
        """Reference TPEngine::UpdateChoiceMapAfterModifyingDAG
        (tp_engine.cpp:427-551)."""
        dag = self.dag
        self.tree_counter += 1
        nni_tree_id = self.tree_counter
        max_tree_id = self.tree_counter + len(nni_to_pre_nni)
        new_edges = set(int(e) for e in mods.added_edge_ids)
        edges_to_init = set(new_edges)
        for e in new_edges:
            self.tree_source[e] = max_tree_id
            self.choice[e] = NO_EDGE
            self.bl[e] = DEFAULT_BL

        post_nnis = [post for post, _ in nni_to_pre_nni]
        best_pcsp_map = self.build_best_edge_map(
            post_nnis, prev_edge_count=prev_edge_count,
            edge_reindexer=mods.edge_reindexer)
        best_edge_map: Dict[int, int] = {}
        for key, pre_e in best_pcsp_map.items():
            post_e = self._edge_of_pcsp_string(key)
            assert post_e is not None, f"PCSP not found in DAG: {key}"
            best_edge_map[post_e] = pre_e
        for post_e, pre_e in best_edge_map.items():
            self.bl[post_e] = self.bl[pre_e]

        for post, pre in nni_to_pre_nni:
            post_e = dag.get_edge_id(post[0], post[1])
            edges_to_init.discard(post_e)
            mapped_choice = self._remapped_post_choice_from_pre(pre, post)
            for ce in [post_e] + [int(c) for c in mapped_choice]:
                if ce != NO_EDGE and self.tree_source[ce] > nni_tree_id:
                    self.tree_source[ce] = nni_tree_id
            self.choice[post_e] = mapped_choice
            nni_tree_id += 1
            self.tree_counter += 1

        for e in sorted(edges_to_init):
            self.update_edge_choice_by_highest_priority_tree(e)
            self.tree_source[e] = nni_tree_id
            nni_tree_id += 1
            self.tree_counter += 1

        for post, pre in nni_to_pre_nni:
            post_e = dag.get_edge_id(post[0], post[1])
            choice = self.choice[post_e]

            def update(choice_e: int, slot: int):
                if choice_e in new_edges:
                    self.choice[choice_e, slot] = post_e

            if self._focal_side(post_e) == LEFT:
                update(int(choice[PARENT]), LEFT_CHILD)
            else:
                update(int(choice[PARENT]), RIGHT_CHILD)
            update(int(choice[SISTER]), SISTER)
            update(int(choice[LEFT_CHILD]), PARENT)
            update(int(choice[RIGHT_CHILD]), PARENT)

    def _edge_of_pcsp_string(self, key: str) -> Optional[int]:
        """DAG edge id of a PCSP string (sister|focal|child0, bit i at
        string position i), or None."""
        dag = self.dag
        n = dag.taxon_count
        from ..core.bitset import bits_of_string
        s = bits_of_string(key[:n])
        f = bits_of_string(key[n:2 * n])
        c0 = bits_of_string(key[2 * n:])
        parent = (Subsplit.uca(n) if s == 0 and f == (1 << n) - 1
                  else Subsplit.of_pair(s, f, n))
        child = Subsplit.of_pair(c0, f & ~c0, n)
        pid = dag.root_id if parent.is_uca() \
            else dag.subsplit_to_id.get(parent.to_string())
        cid = dag.subsplit_to_id.get(child.to_string())
        if pid is None or cid is None:
            return None
        return dag.edge_to_id.get((pid, cid))

    def _remapped_post_choice_from_pre(self, pre, post) -> np.ndarray:
        """Reference GetRemappedEdgeChoiceFromPreNNIToPostNNI
        (tp_engine.cpp:964-992): remap pre choices to post clade positions,
        convert to nodes, then find the post edges to those nodes."""
        dag = self.dag
        post_e = dag.get_edge_id(post[0], post[1])
        post_parent_id = int(dag.edge_parent[post_e])
        post_child_id = int(dag.edge_child[post_e])
        mapped = self._remapped_pre_choice(pre, post)
        node_ids = self._choice_node_ids(mapped)

        def edge_of(pid: int, cid: int) -> int:
            if pid < 0 or cid < 0:
                return NO_EDGE
            return dag.edge_to_id.get((pid, cid), NO_EDGE)

        out = np.full(4, NO_EDGE, dtype=np.int64)
        out[PARENT] = edge_of(node_ids[PARENT], post_parent_id)
        out[SISTER] = edge_of(post_parent_id, node_ids[SISTER])
        out[LEFT_CHILD] = edge_of(post_child_id, node_ids[LEFT_CHILD])
        out[RIGHT_CHILD] = edge_of(post_child_id, node_ids[RIGHT_CHILD])
        return out

    def _update_engine_after_modifying_dag(self, nni_to_pre_nni,
                                           prev_edge_count: int, mods):
        """Reference TPEvalEngineViaLikelihood::UpdateEngineAfterModifyingDAG
        (tp_evaluation_engine.cpp:267-460)."""
        dag = self.dag
        self._populate_leaf_pvs()
        self._populate_root_pvs()

        new_edges = set(int(e) for e in mods.added_edge_ids)
        nni_edges = set()
        extra_edges = set(new_edges)
        update_edges = set(new_edges)
        for post, _ in nni_to_pre_nni:
            e = dag.get_edge_id(post[0], post[1])
            nni_edges.add(e)
            ch = self.choice[e]
            for x in (int(ch[RIGHT_CHILD]), int(ch[LEFT_CHILD]),
                      int(ch[SISTER]), e, int(ch[PARENT])):
                extra_edges.discard(x)
                update_edges.add(x)
        if self.update_all_edges:
            update_edges = set(range(dag.edge_count()))
        rootward_edges = sorted(update_edges,
                                key=lambda e: int(dag.edge_parent[e]))
        leafward_edges = sorted(update_edges,
                                key=lambda e: -int(dag.edge_child[e]))

        def rootward_pass():
            for e in rootward_edges:
                self.populate_rootward_pv_for_edge(e)

        def leafward_pass():
            for e in leafward_edges:
                self.populate_leafward_pv_for_edge(e)

        def optimize_edge(e: int, parent_e: int, is_not_child_edge: bool,
                          is_not_parent_edge: bool):
            """The OptimizeEdge lambda (tp_evaluation_engine.cpp:332-379)."""
            if e == NO_EDGE:
                return
            focal_side = self._focal_side(e)
            phat_focal = self._phat_type(focal_side)
            phat_sister = self._phat_type(not focal_side)
            r_focal = self._r_type(focal_side)
            if is_not_child_edge:
                self.pv[P, e] = (self.pv[PHAT_LEFT, e]
                                 * self.pv[PHAT_RIGHT, e])
            if is_not_parent_edge:
                if not self._is_edge_root(e):
                    self.pv[r_focal, parent_e] = (
                        self.pv[RHAT, parent_e]
                        * self.pv[phat_sister, parent_e])
                else:
                    self.pv[r_focal, parent_e] = self.pv[RHAT, parent_e]
            parent_rfocal, child_p = self.primary_pv_ids(e)
            if e in new_edges:
                self._optimize_branch_length(e, parent_rfocal, child_p,
                                             False)
            if is_not_parent_edge:
                self.pv[phat_focal, parent_e] = self._evolved(
                    e, self.pv[P, e])
                self.pv[P, parent_e] = (self.pv[PHAT_LEFT, parent_e]
                                        * self.pv[PHAT_RIGHT, parent_e])

        def nni_update_pvs():
            for e in sorted(nni_edges):
                self.populate_rootward_pv_for_edge(e)
                ch = self.choice[e]
                # NNIRootwardPass also refreshes the parent-edge P PVs
                # through the focal edge (tp_evaluation_engine.cpp:380-394).
                pe = int(ch[PARENT])
                se = int(ch[SISTER])
                if pe != NO_EDGE:
                    focal_side = self._focal_side(e)
                    if se != NO_EDGE:
                        self.pv[self._phat_type(not focal_side), pe] = (
                            self._evolved(se, self.pv[P, se]))
                    self.pv[self._phat_type(focal_side), pe] = (
                        self._evolved(e, self.pv[P, e]))
                    self.pv[P, pe] = (self.pv[PHAT_LEFT, pe]
                                      * self.pv[PHAT_RIGHT, pe])
                self._nni_leafward_pass(e)

        rootward_pass()
        leafward_pass()
        if self.do_optimize_new_edges and self.update_optimize_new_edges:
            for _ in range(self.optimize_max_iter):
                for e in sorted(nni_edges):
                    ch = self.choice[e]
                    optimize_edge(int(ch[LEFT_CHILD]), e, False, True)
                    optimize_edge(int(ch[RIGHT_CHILD]), e, False, True)
                    optimize_edge(int(ch[SISTER]), int(ch[PARENT]), False,
                                  True)
                    optimize_edge(e, int(ch[PARENT]), True, True)
                    pe = int(ch[PARENT])
                    if pe != NO_EDGE and not self._is_edge_root(pe):
                        optimize_edge(pe, int(self.choice[pe, PARENT]),
                                      True, False)
                for e in sorted(extra_edges):
                    pe = int(self.choice[e, PARENT])
                    if pe != NO_EDGE and not self._is_edge_root(pe):
                        optimize_edge(e, pe, True, True)
                nni_update_pvs()
        self.compute_scores(sorted(update_edges))

    def _nni_leafward_pass(self, e: int):
        """NNILeafwardPass (tp_evaluation_engine.cpp:395-411)."""
        ch = self.choice[e]
        pe = int(ch[PARENT])
        if pe != NO_EDGE:
            focal_side = self._focal_side(e)
            phat_sister = self._phat_type(not focal_side)
            phat_focal = self._phat_type(focal_side)
            r_focal = self._r_type(focal_side)
            r_sister = self._r_type(not focal_side)
            if not self._is_edge_root(pe):
                gp_e = int(self.choice[pe, PARENT])
                rt = self._r_type(self._focal_side(pe))
                self.pv[RHAT, pe] = self._evolved(pe, self.pv[rt, gp_e])
            self.pv[r_focal, pe] = (self.pv[RHAT, pe]
                                    * self.pv[phat_sister, pe])
            self.pv[r_sister, pe] = (self.pv[RHAT, pe]
                                     * self.pv[phat_focal, pe])
            self.pv[RHAT, e] = self._evolved(e, self.pv[r_focal, pe])
        self.pv[R_LEFT, e] = self.pv[RHAT, e] * self.pv[PHAT_RIGHT, e]
        self.pv[R_RIGHT, e] = self.pv[RHAT, e] * self.pv[PHAT_LEFT, e]

    # -- per-NNI post-acceptance update (reference
    #    UpdateEngineAfterDAGAddNodePair, tp_evaluation_engine.cpp:237-267,
    #    + CopyOverEdgeDataFromPreNNIToPostNNI, tp_engine.cpp:364-421) ------
    def branch_length_optimization_edge(self, e: int,
                                        check_branch_convergence: bool,
                                        update_only: bool = False):
        """Reference TPEvalEngineViaLikelihood::BranchLengthOptimization
        (edge form, tp_evaluation_engine.cpp:1003-1024)."""
        pe = int(self.choice[e, PARENT])
        if pe == NO_EDGE:
            return
        self.populate_rootward_pv_for_edge(e)
        self.populate_rootward_pv_for_edge(pe)
        self.populate_leafward_pv_for_edge(pe)
        if not update_only:
            parent_rfocal, child_p = self.primary_pv_ids(e)
            self._optimize_branch_length(e, parent_rfocal, child_p,
                                         check_branch_convergence)
        self.populate_leafward_pv_for_edge(e)

    def update_engine_after_dag_add_node_pair(self, post, pre):
        """The per-NNI incremental update: copy adjacent branch lengths from
        the pre-NNI neighborhood, refresh the five adjacent edges' PVs, and
        locally optimize them."""
        dag = self.dag
        self._copy_over_edge_data_pre_to_post(post, pre)
        focal = dag.get_edge_id(post[0], post[1])
        ch = self.choice[focal]
        adj = [int(ch[LEFT_CHILD]), int(ch[RIGHT_CHILD]), focal,
               int(ch[SISTER]), int(ch[PARENT])]
        for e in adj:
            if e != NO_EDGE:
                self.populate_rootward_pv_for_edge(e)
        for e in reversed(adj):
            if e != NO_EDGE:
                self.populate_leafward_pv_for_edge(e)
        if self.do_optimize_new_edges:
            for e in adj:
                if e != NO_EDGE:
                    self.branch_length_optimization_edge(e, False)

    def _copy_over_edge_data_pre_to_post(self, post, pre):
        """Reference TPEngine::CopyOverEdgeDataFromPreNNIToPostNNI
        (tp_engine.cpp:364-421): branch lengths of edges adjacent to the
        pre-NNI copy onto the corresponding post-NNI edges."""
        dag = self.dag
        pre_parent = dag.get_node_id(pre[0])
        pre_child = dag.get_node_id(pre[1])
        post_parent = dag.get_node_id(post[0])
        post_child = dag.get_node_id(post[1])
        pre_e = dag.edge_to_id[(pre_parent, pre_child)]
        post_e = dag.edge_to_id[(post_parent, post_child)]
        pre_side = self._focal_side(pre_e)

        def copy(src_e, dest_e):
            if src_e is not None and dest_e is not None:
                self.bl[dest_e] = self.bl[src_e]

        def copy_common(pre_node, post_node, rootward: bool, side: bool):
            adj = (dag.rootward if rootward else dag.leafward)
            for other, _e in adj[pre_node][side]:
                if rootward:
                    src = dag.edge_to_id.get((other, pre_node))
                    dest = dag.edge_to_id.get((other, post_node))
                else:
                    src = dag.edge_to_id.get((pre_node, other))
                    dest = dag.edge_to_id.get((post_node, other))
                copy(src, dest)

        copy(pre_e, post_e)
        copy_common(pre_parent, post_parent, True, LEFT)
        copy_common(pre_parent, post_parent, True, RIGHT)
        copy_common(pre_parent, post_child, False, not pre_side)
        if nni_sister_clade_eq_left(pre, post):
            post_left, post_right = post_parent, post_child
        else:
            post_left, post_right = post_child, post_parent
        copy_common(pre_child, post_left, False, LEFT)
        copy_common(pre_child, post_right, False, RIGHT)


def nni_sister_clade_eq_left(pre, post) -> bool:
    """pre sister clade == post child's left (clade0) clade (reference
    CopyOverEdgeDataFromPreNNIToPostNNI's swap test)."""
    return nni_sister_clade(pre[0], pre[1]) == post[1].clade0
