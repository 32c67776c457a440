"""GPInstance facade mirroring bito.gp_instance.

Counterpart of bito_tpu.api.gp (the reference GPInstance,
src/gp_instance.cpp:119-908, bound in src/pybito.cpp:700-990).  The
mmap-file constructor argument is accepted and ignored: PLVs live in
device memory.  The instance's engines run on `device` in `dtype` (the
card in float32 by default; the tests pass the CPU in float64), and tree
files are parsed by the native library.

The TP, NNI and parsimony engines (make_tp_engine, make_nni_engine,
make_parsimony_tree_engine) take the instance's device and dtype.  The
NNI engine of the default scoring, tp_likelihood, is the faithful search
(nni/golden.py's FaithfulNNIEngine): its per-edge PVs are host numpy, as
in bito_tpu, and its batched candidate scorer runs in float64 on the
instance's device whatever the instance's dtype.
"""
from __future__ import annotations

import csv as _csv
from typing import Dict, Optional

import numpy as np

from ..core.newick import parse_newick_file, parse_nexus_file, read_fasta
from ..core.site_pattern import SitePattern
from ..core.tree import Tree, TreeCollection
from ..dag.subsplit_dag import SubsplitDAG, build_dag
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..gp.engine import GPEngine


def _write_rows(path: str, rows):
    with open(path, "w", newline="") as f:
        w = _csv.writer(f)
        for row in rows:
            w.writerow(row)


class GPInstance:
    def __init__(self, mmap_file_path: str = "", name: str = "gp_instance",
                 *, device=PRODUCT_DEVICE, dtype=PRODUCT_DTYPE):
        self.device, self.dtype = resolve(device, dtype)
        self.name = name
        self.tree_collection: Optional[TreeCollection] = None
        self.alignment: Dict[str, str] = {}
        self.dag: Optional[SubsplitDAG] = None
        self.engine: Optional[GPEngine] = None
        self.likelihood_tree_engine = None
        self.tp_engine = None
        self.nni_engine = None
        self.parsimony_tree_engine = None

    # -- io ---------------------------------------------------------------
    def read_newick_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_newick_file(path, sort_taxa=sort_taxa)

    def read_nexus_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_nexus_file(path, sort_taxa=sort_taxa)

    def read_newick_file_gz(self, path: str, sort_taxa: bool = False):
        self.read_newick_file(path, sort_taxa)  # gzip is transparent

    def read_nexus_file_gz(self, path: str, sort_taxa: bool = False):
        self.read_nexus_file(path, sort_taxa)

    def read_fasta_file(self, path: str):
        self.alignment = read_fasta(path)

    def tree_count(self) -> int:
        return len(self.tree_collection) if self.tree_collection else 0

    # -- DAG and engines --------------------------------------------------
    def make_dag(self):
        assert self.tree_collection is not None, "Load trees first"
        self.dag = build_dag(self.tree_collection)

    def get_dag(self) -> SubsplitDAG:
        assert self.dag is not None, "DAG not available. Call make_dag."
        return self.dag

    def _site_pattern(self) -> SitePattern:
        return SitePattern(self.alignment, self.tree_collection.taxon_names)

    def make_gp_engine(self, rescaling_threshold: float = 1e-40,
                       use_gradients: bool = False):
        assert self.alignment, "Read a fasta file first"
        if self.dag is None:
            self.make_dag()
        self.engine = GPEngine(
            self._site_pattern(), self.dag,
            optimization_method=("brent_with_gradients" if use_gradients
                                 else "brent"),
            device=self.device, dtype=self.dtype)

    make_engine = make_gp_engine  # reference alias (older API)

    def get_gp_engine(self) -> GPEngine:
        assert self.engine is not None, "Call make_gp_engine first"
        return self.engine

    def make_likelihood_tree_engine(self):
        """Per-tree classical likelihood engine (reference
        likelihood_tree_engine, src/pybito.cpp), JC69 on the instance's
        device and dtype."""
        from ..models.phylo_model import PhyloModel, PhyloModelSpecification
        from ..treelike.engine import TreeLikelihoodEngine

        self.likelihood_tree_engine = TreeLikelihoodEngine(
            self._site_pattern(), PhyloModel(PhyloModelSpecification()),
            device=self.device, dtype=self.dtype)
        return self.likelihood_tree_engine

    def get_likelihood_tree_engine(self):
        if self.likelihood_tree_engine is None:
            self.make_likelihood_tree_engine()
        return self.likelihood_tree_engine

    def compute_tree_likelihood(self, tree=None) -> np.ndarray:
        """Classical likelihoods of the loaded trees (or a given tree) with
        GP branch lengths (reference compute_tree_likelihood)."""
        engine = self.get_likelihood_tree_engine()
        trees = ([tree] if tree is not None
                 else self.currently_loaded_trees_with_gp_branch_lengths().trees)
        return engine.log_likelihoods(trees, {}).detach().cpu().numpy()

    compute_likelihood = compute_tree_likelihood

    # -- TP, NNI and parsimony engines ---------------------------------------
    def make_tp_engine(self):
        from ..tp.engine import TPEngine

        if self.dag is None:
            self.make_dag()
        self.tp_engine = TPEngine(self.get_dag(), self._site_pattern(),
                                  device=self.device, dtype=self.dtype)
        return self.tp_engine

    def get_tp_engine(self):
        assert self.tp_engine is not None, "Call make_tp_engine first"
        return self.tp_engine

    def tp_engine_set_choice_map_by_taking_first(self):
        self.get_tp_engine().initialize_choice_map(self.tree_collection.trees)

    def tp_engine_set_branch_lengths_by_taking_first(self):
        self.get_tp_engine().set_branch_lengths_by_taking_first(
            self.tree_collection.trees)

    def make_nni_engine(self, scoring: str = "tp_likelihood"):
        """The NNI engine of `scoring`: "tp_likelihood" (the faithful
        search with incremental DAG growth and PV carry-over, reference
        NNIEvalEngineViaTP + GPEngine grow/reindex,
        src/gp_engine.cpp:64-209), "tp_parsimony" (the whole-tree engine
        scored by Sankoff) or "gp_likelihood" (scored by the GP engine on
        grafted DAGs)."""
        from ..nni.engine import GPScoredNNIEngine, NNIEngine
        from ..nni.golden import FaithfulNNIEngine

        if self.dag is None:
            self.make_dag()
        sp, trees = self._site_pattern(), self.tree_collection.trees
        kw = dict(device=self.device, dtype=self.dtype)
        if scoring == "gp_likelihood":
            self.nni_engine = GPScoredNNIEngine(self.get_dag(), sp, trees,
                                                **kw)
        elif scoring == "tp_likelihood":
            self.nni_engine = FaithfulNNIEngine(self.get_dag(), sp, trees)
            self.nni_engine.engine.device = self.device
        else:
            self.nni_engine = NNIEngine(self.get_dag(), sp, trees,
                                        scoring=scoring, **kw)
        return self.nni_engine

    def get_nni_engine(self):
        assert self.nni_engine is not None, "Call make_nni_engine first"
        return self.nni_engine

    def make_parsimony_tree_engine(self):
        from ..parsimony.sankoff import SankoffHandler

        self.parsimony_tree_engine = SankoffHandler(
            self._site_pattern(), device=self.device, dtype=self.dtype)
        return self.parsimony_tree_engine

    def get_parsimony_tree_engine(self):
        if self.parsimony_tree_engine is None:
            self.make_parsimony_tree_engine()
        return self.parsimony_tree_engine

    def compute_tree_parsimony(self, tree=None) -> np.ndarray:
        """Sankoff scores of the loaded trees (or a given tree)."""
        trees = [tree] if tree is not None else self.tree_collection.trees
        return self.get_parsimony_tree_engine().run_sankoff(trees)

    compute_parsimony = compute_tree_parsimony

    # -- workflows --------------------------------------------------------
    def populate_plvs(self):
        self.get_gp_engine().populate_plvs()

    def compute_likelihoods(self):
        self.get_gp_engine().compute_likelihoods()

    def compute_marginal_likelihood(self):
        self.get_gp_engine().compute_likelihoods()

    def estimate_branch_lengths(self, tol: float, max_iter: int,
                                quiet: bool = True):
        return self.get_gp_engine().estimate_branch_lengths(tol, max_iter,
                                                            quiet)

    def optimize_branch_lengths_once(self):
        self.get_gp_engine().optimize_branch_lengths_once()

    def estimate_sbn_parameters(self):
        self.get_gp_engine().estimate_sbn_parameters()

    def calculate_hybrid_marginals(self):
        """Reference GPInstance::CalculateHybridMarginals
        (src/gp_instance.cpp:408-417)."""
        self.get_gp_engine().calculate_hybrid_marginals()

    def get_hybrid_marginals(self) -> np.ndarray:
        return self.get_gp_engine().hybrid_marginal_log_likelihoods

    def hot_start_branch_lengths(self):
        self.get_gp_engine().hot_start_branch_lengths(self.tree_collection)

    def take_first_branch_length(self):
        self.get_gp_engine().take_first_branch_length(self.tree_collection)

    def set_rescaling(self, use_rescaling: bool):
        """The engine's per-site log-scale rescaling is exact and
        structural (folded into every wavefront op), so enabling it is
        already true; running without it has no faithful equivalent, and
        the request is refused."""
        if not use_rescaling:
            raise NotImplementedError(
                "the GP engine always applies exact per-site rescaling; "
                "running without rescaling is not supported")

    def use_gradient_optimization(self, use_gradients: bool = True):
        """Reference GPInstance::UseGradientOptimization
        (src/gp_instance.cpp:385-387): Brent vs Brent-with-gradient-fallback."""
        self.get_gp_engine().use_gradient_optimization(use_gradients)

    def set_optimization_method(self, method: str):
        """Reference GPInstance::SetOptimizationMethod: brent /
        brent_with_gradients / gradient_ascent / log_space_gradient_ascent /
        newton."""
        self.get_gp_engine().set_optimization_method(method)

    # -- accessors --------------------------------------------------------
    def get_branch_lengths(self) -> np.ndarray:
        return self.get_gp_engine().branch_lengths.detach().cpu().numpy()

    def set_branch_lengths(self, bl: np.ndarray):
        self.get_gp_engine().branch_lengths = np.asarray(bl)

    def get_sbn_parameters(self) -> np.ndarray:
        return self.get_gp_engine().q.detach().cpu().numpy()

    def get_log_marginal_likelihood(self) -> float:
        return self.get_gp_engine().log_marginal_likelihood()

    def get_per_gpcsp_log_likelihoods(self) -> np.ndarray:
        return self.get_gp_engine().per_gpcsp_log_likelihoods()

    get_per_pcsp_log_likelihoods = get_per_gpcsp_log_likelihoods

    def pretty_indexed_per_gpcsp_log_likelihoods(self):
        return list(zip(self.dag.pretty_edges(),
                        self.get_per_gpcsp_log_likelihoods()))

    def pretty_indexed_per_gpcsp_components_of_full_log_marginal(self):
        return list(zip(
            self.dag.pretty_edges(),
            self.get_gp_engine().per_gpcsp_components_of_full_log_marginal(),
        ))

    def build_edge_idx_to_pcsp_map(self) -> Dict[int, str]:
        return {e: self.dag.pretty_edge(e)
                for e in range(self.dag.edge_count())}

    # -- CSV exports (reference src/gp_instance.hpp:133-140) -------------
    def _edge_rows(self, values):
        return ([key, repr(float(val))]
                for key, val in zip(self.dag.pretty_edges(), values))

    def branch_lengths_to_csv(self, path: str):
        _write_rows(path, self._edge_rows(self.get_branch_lengths()))

    def per_gpcsp_log_likelihoods_to_csv(self, path: str):
        _write_rows(path,
                    self._edge_rows(self.get_per_gpcsp_log_likelihoods()))

    per_gpcsp_llhs_to_csv = per_gpcsp_log_likelihoods_to_csv

    def sbn_parameters_to_csv(self, path: str):
        _write_rows(path, self._edge_rows(self.get_sbn_parameters()))

    def sbn_prior_to_csv(self, path: str):
        _write_rows(path, self._edge_rows(self.get_gp_engine().sbn_prior))

    def export_trees_with_gp_branch_lengths(self, path: str):
        """Reference CurrentlyLoadedTreesWithGPBranchLengths -> newick."""
        coll = self.currently_loaded_trees_with_gp_branch_lengths()
        with open(path, "w") as f:
            f.write(coll.newick())

    def export_all_generated_trees(self, path: str):
        coll = self.generate_complete_rooted_tree_collection()
        with open(path, "w") as f:
            f.write(coll.newick())

    def subsplit_dag_to_dot(self, path: str, edge_labels: bool = False):
        with open(path, "w") as f:
            f.write(self.get_dag().to_dot(edge_labels))

    def dag_summary_statistics(self) -> Dict[str, int]:
        return {
            "node_count": self.get_dag().node_count_without_dag_root(),
            "edge_count": self.get_dag().edge_count(),
            "taxon_count": self.get_dag().taxon_count,
            "topology_count": int(self.get_dag().topology_count()),
        }

    def generate_complete_rooted_tree_collection(self) -> TreeCollection:
        """All topologies in the DAG, with the engine's GP branch lengths
        (reference GenerateCompleteRootedTreeCollection)."""
        topologies = self.get_dag().generate_all_topologies()
        return self._trees_with_gp_branch_lengths(topologies)

    def currently_loaded_trees_with_gp_branch_lengths(self) -> TreeCollection:
        topologies = [t.topology for t in self.tree_collection.trees]
        return self._trees_with_gp_branch_lengths(topologies)

    def _trees_with_gp_branch_lengths(self, topologies) -> TreeCollection:
        from ..core.bitset import PCSP, Subsplit

        indexer = self.dag.build_edge_indexer()
        bl_vec = self.get_branch_lengths()
        trees = []
        for topo in topologies:
            n = topo.num_taxa
            cl = topo.clades()
            ch = topo.children()
            ss = {v: Subsplit.leaf(v, n) for v in range(n)}
            for v in range(n, topo.num_nodes):
                kids = ch[v]
                ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
            bl = np.zeros(topo.num_nodes)
            for v in range(topo.num_nodes - 1):
                parent = int(topo.parents[v])
                pcsp = PCSP.of_parent_child(ss[parent], ss[v]).to_string()
                if pcsp in indexer:
                    bl[v] = bl_vec[indexer[pcsp]]
            trees.append(Tree(topo, bl))
        return TreeCollection(trees, list(self.tree_collection.taxon_names))

    # -- diagnostics --------------------------------------------------------
    def get_perpcsp_llh_surface(self, edge_id: int, scale_min: float = 0.01,
                                scale_max: float = 10.0,
                                steps: int = 41) -> np.ndarray:
        """Per-PCSP log-likelihood surface over scaled branch lengths
        (reference GetPerGPCSPLogLikelihoodSurfaces,
        src/gp_instance.hpp:105-116).  Returns [steps, 2]: (bl, llh)."""
        eng = self.get_gp_engine()
        saved = eng.branch_lengths.clone()
        base = float(saved[edge_id])
        scales = np.exp(np.linspace(np.log(scale_min), np.log(scale_max),
                                    steps))
        out = np.zeros((steps, 2))
        for i, s in enumerate(scales):
            bl = saved.detach().cpu().numpy().copy()
            bl[edge_id] = base * s
            eng.branch_lengths = bl
            eng.populate_plvs()
            eng.compute_likelihoods()
            out[i] = (base * s, eng.per_gpcsp_log_likelihoods()[edge_id])
        eng.branch_lengths = saved
        eng.populate_plvs()
        eng.compute_likelihoods()
        return out

    def per_gpcsp_llh_surfaces_to_csv(self, path: str, steps: int = 21):
        _write_rows(path, (
            [self.dag.pretty_edge(e), repr(bl), repr(llh)]
            for e in range(self.dag.edge_count())
            for bl, llh in self.get_perpcsp_llh_surface(e, steps=steps)))

    def perturb_and_track_optimization_values(self, edge_id: int,
                                              perturbation: float = 0.1,
                                              max_iter: int = 10):
        """Perturb one branch length and track re-optimization (reference
        PerturbAndTrackValuesFromOptimization diagnostics)."""
        eng = self.get_gp_engine()
        bl = eng.branch_lengths.detach().cpu().numpy().copy()
        bl[edge_id] = bl[edge_id] * (1.0 + perturbation)
        eng.branch_lengths = bl
        trace = []
        for _ in range(max_iter):
            eng.populate_plvs()
            eng.compute_likelihoods()
            trace.append({
                "branch_length": float(eng.branch_lengths[edge_id]),
                "marginal": eng.log_marginal_likelihood(),
            })
            eng.optimize_branch_lengths_once()
        return trace

    def print_dag(self):
        dag = self.get_dag()
        for i, ss in enumerate(dag.nodes):
            print(f"node {i}: {ss.pretty()}")
        for e in range(dag.edge_count()):
            print(f"edge {e}: {dag.pretty_edge(e)}")

    def print_status(self):
        print(f"{self.name}: trees={self.tree_count()} "
              f"dag={'yes' if self.dag else 'no'} "
              f"engine={'yes' if self.engine else 'no'}")


def gp_instance(mmap_file_path: str = "", *, device=PRODUCT_DEVICE,
                dtype=PRODUCT_DTYPE) -> GPInstance:
    return GPInstance(mmap_file_path, device=device, dtype=dtype)
