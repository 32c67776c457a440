"""Instance facades mirroring bito's Python API surface (torch engine).

Port of bito_tpu.api.instances' GenericSBNInstance and UnrootedSBNInstance
(reference: src/generic_sbn_instance.hpp:1-502,
src/unrooted_sbn_instance.{hpp,cpp}, bound in src/pybito.cpp:91-700).  A
bito user's workflow maps one-to-one:

    inst = unrooted_instance("name")          # on the card, float32
    inst.read_newick_file(path); inst.read_fasta_file(path)
    inst.process_loaded_trees(); inst.train_simple_average()
    inst.sample_trees(k)
    inst.prepare_for_phylo_likelihood(spec, thread_count)
    inst.log_likelihoods(); inst.phylo_gradients()
    inst.topology_gradients(log_f, use_vimco)

Underneath is the port's TreeLikelihoodEngine on the instance's device and
dtype (`unrooted_instance(name, device=..., dtype=...)`; the card in
float32 by default, bito_tpu_torch.device), so thread_count and beagle
flags are accepted and ignored.  Two differences from bito_tpu:

  - `_params_dict` hands the engine one shared 1-D row per model block
    when every tree's row of phylo_model_params is equal, and per-tree
    2-D rows otherwise.  The result is the same; the route is not: a
    shared model takes the engine's `auto` route (the paired kernels on
    the card), per-tree rows the scan tape.  bito_tpu always builds 2-D
    rows, so its VBPI step never reaches its kernels.
  - The device SBN backend (sbn/device.py) runs in float64 on the
    instance's device, the card included; there is no silent fall-back
    to the numpy backend, which is asked for by backend="numpy".

The rooted instance (tip dates, height transforms, model-parameter
gradients) is not ported yet.
"""
from __future__ import annotations

import csv as _csv
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import params_from_numpy
from ..core.newick import parse_newick_file, parse_nexus_file, read_fasta
from ..core.site_pattern import SitePattern
from ..core.tree import Topology, Tree, TreeCollection
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..models.phylo_model import PhyloModel, PhyloModelSpecification
from ..sbn import device as sbn_device
from ..sbn import gradients as sbn_gradients
from ..sbn import maps as sbn_maps
from ..sbn import probability as sbn_probability
from ..sbn.psp import PSPIndexer
from ..sbn.sampler import TopologySampler
from ..sbn.support import SBNSupport, build_support
from ..treelike import phylo_flags as phylo_flags_mod
from ..treelike.engine import TreeLikelihoodEngine

DOUBLE_MINIMUM = np.finfo(np.float64).min
SBN_BACKENDS = ("device", "numpy")


def _check_backend(backend: str) -> str:
    if backend not in SBN_BACKENDS:
        raise ValueError(f"backend must be one of {SBN_BACKENDS}, "
                         f"got {backend!r}")
    return backend


class PhyloGradient:
    """Mirror of bito.PhyloGradient (src/phylo_gradient.hpp): a log
    likelihood plus a string->vector gradient map."""

    def __init__(self, log_likelihood: float, gradient: Dict[str, np.ndarray]):
        self.log_likelihood_ = float(log_likelihood)
        self.gradient_ = gradient

    def log_likelihood(self) -> float:
        return self.log_likelihood_

    @property
    def gradient(self) -> Dict[str, np.ndarray]:
        return self.gradient_


class GenericSBNInstance:
    rooted: bool = False

    def __init__(self, name: str = "instance", *, device=PRODUCT_DEVICE,
                 dtype=PRODUCT_DTYPE):
        self.name = name
        self.device, self.dtype = resolve(device, dtype)
        self.tree_collection: Optional[TreeCollection] = None
        self.alignment: Dict[str, str] = {}
        self.sbn_support: Optional[SBNSupport] = None
        self.sbn_parameters: np.ndarray = np.zeros(0)
        self.psp_indexer: Optional[PSPIndexer] = None
        self.engine: Optional[TreeLikelihoodEngine] = None
        self.phylo_model: Optional[PhyloModel] = None
        self.phylo_model_params: Optional[np.ndarray] = None
        self.rescaling = True
        self.rng = np.random.default_rng(0)
        self._topology_counter = None
        self.phylo_flags: Optional[phylo_flags_mod.PhyloFlags] = None

    # -- io -------------------------------------------------------------
    def read_newick_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_newick_file(path, sort_taxa=sort_taxa)

    def read_nexus_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_nexus_file(path, sort_taxa=sort_taxa)

    def read_fasta_file(self, path: str):
        self.alignment = read_fasta(path)
        self._invalidate_engine()

    def read_newick_file_gz(self, path: str, sort_taxa: bool = False):
        self.read_newick_file(path, sort_taxa)  # gzip is transparent

    def read_nexus_file_gz(self, path: str, sort_taxa: bool = False):
        self.read_nexus_file(path, sort_taxa)

    def tree_count(self) -> int:
        return len(self.tree_collection) if self.tree_collection else 0

    def taxon_names(self) -> List[str]:
        return list(self.tree_collection.taxon_names)

    def print_status(self):
        """Reference GenericSBNInstance::PrintStatus."""
        print(f"{self.name}: {self.tree_count()} trees, "
              f"support size {self.sbn_support.size() if self.sbn_support else 0}")

    def resize_phylo_model_params(self):
        """Reference ResizePhyloModelParams: grow/shrink the per-tree model
        parameter matrix to the current tree count."""
        if self.phylo_model is None:
            return
        count = self.tree_count()
        base = (self.phylo_model_params[0]
                if self.phylo_model_params is not None
                and len(self.phylo_model_params)
                else self.phylo_model.default_param_vector())
        self.phylo_model_params = np.tile(base, (max(count, 1), 1))

    def set_rescaling(self, use_rescaling: bool):
        """Rescaling here is exact per-site scale bookkeeping, always on;
        accepted for API compatibility (reference SetRescaling)."""
        self.rescaling = use_rescaling

    # -- SBN support and training ---------------------------------------
    def process_loaded_trees(self):
        assert self.tree_collection is not None, "Load some trees first"
        if not self.rooted:
            # Unrooted instances operate on trifurcating-root trees (the
            # reference asserts this; we deroot bifurcating-rooted input,
            # fusing the two root edges).
            self.tree_collection.trees = [
                t.deroot() for t in self.tree_collection.trees
            ]
        counter = {}
        topo_by_key = {}
        for t in self.tree_collection.trees:
            k = t.topology.key()
            counter[k] = counter.get(k, 0) + 1
            topo_by_key[k] = t.topology
        self._topology_counter = {
            topo_by_key[k]: c for k, c in counter.items()
        }
        self.sbn_support = build_support(
            self._topology_counter, self.tree_collection.taxon_names,
            rooted=self.rooted,
        )
        self.sbn_parameters = np.ones(self.sbn_support.size())
        self.psp_indexer = PSPIndexer(self.sbn_support)

    def split_counters(self):
        """[rootsplit_support, subsplit_support] keyed by pretty strings
        (reference inst.split_counters(), src/pybito.cpp)."""
        counters = (
            sbn_maps.rooted_counters(self._topology_counter)
            if self.rooted
            else sbn_maps.unrooted_counters(self._topology_counter)
        )
        rs_counter, pcsp_counter, rs_bits, pcsp_bits = counters
        n = len(self.tree_collection.taxon_names)
        # Raw bitset-string keys, like the reference's ToString() maps
        # (src/sbn_maps.cpp StringPCSPMapOf): parent = 2n chars as stored in
        # the PCSP (sister|focal order), child = the stored n-char min clade.
        rootsplit = dict(rs_counter)
        subsplit: Dict[str, Dict[str, int]] = {}
        for k, v in pcsp_counter.items():
            parent = k[: 2 * n]
            child = k[2 * n:]
            subsplit.setdefault(parent, {})[child] = v
        return [rootsplit, subsplit]

    def make_indexer_representations(self):
        # Memoized per tree set: a VBPI step asks for the representations of
        # the same sampled trees several times (SBN probabilities, topology
        # gradients), and each computation walks every virtual rooting.
        # Hold strong references to the keyed objects alongside the id key:
        # without them CPython may free a replaced tree set and recycle its
        # ids for new topologies, silently matching a stale entry.
        refs = (self.sbn_support,) + tuple(
            t.topology for t in self.tree_collection.trees)
        key = tuple(id(r) for r in refs)
        cached = getattr(self, "_indexer_reps_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        reps = [
            self.sbn_support.indexer_representation_of(t.topology)
            for t in self.tree_collection.trees
        ]
        self._indexer_reps_cache = (key, reps, refs)
        return reps

    def make_psp_indexer_representations(self):
        return [
            self.psp_indexer.representation_of(t.topology)
            for t in self.tree_collection.trees
        ]

    def _representation_counter(self):
        reps, counts = [], []
        for topo, count in self._topology_counter.items():
            reps.append(self.sbn_support.indexer_representation_of(topo))
            counts.append(count)
        return reps, counts

    def train_simple_average(self):
        reps, counts = self._representation_counter()
        self.sbn_parameters = sbn_probability.simple_average(
            self.sbn_support, reps, counts
        )

    def calculate_sbn_probabilities(self) -> np.ndarray:
        norm = sbn_probability.normalize_in_log(
            self.sbn_parameters, self.sbn_support
        )
        return sbn_probability.probabilities_of_collection(
            self.sbn_support, norm, self.make_indexer_representations()
        )

    def normalized_sbn_parameters(self) -> np.ndarray:
        return np.exp(
            sbn_probability.normalize_in_log(self.sbn_parameters,
                                             self.sbn_support)
        )

    def pretty_indexer(self) -> List[str]:
        return self.sbn_support.pretty_indexer()

    def pretty_indexed_sbn_parameters(self):
        return list(zip(self.pretty_indexer(),
                        self.normalized_sbn_parameters()))

    def sbn_parameters_to_csv(self, path: str):
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            for key, val in self.pretty_indexed_sbn_parameters():
                w.writerow([key, repr(float(val))])

    def read_sbn_parameters_from_csv(self, path: str):
        with open(path, newline="") as f:
            pretty = {row[0]: float(row[1]) for row in _csv.reader(f) if row}
        self.set_sbn_parameters(pretty)

    def set_sbn_parameters(self, pretty_sbn_parameters: Dict[str, float],
                           warn_missing: bool = True):
        """Reference GenericSBNInstance::SetSBNParameters
        (src/generic_sbn_instance.hpp:115-148): linear-space input."""
        missing = 0
        out = np.empty(self.sbn_support.size())
        for i, key in enumerate(self.pretty_indexer()):
            v = pretty_sbn_parameters.get(key)
            if v is None:
                out[i] = DOUBLE_MINIMUM
                missing += 1
            elif v > 0:
                out[i] = np.log(v)
            elif v == 0:
                out[i] = DOUBLE_MINIMUM
            else:
                raise ValueError(
                    "Negative probability in set_sbn_parameters; expected "
                    "linear (not log) space"
                )
        if warn_missing and missing:
            print(f"Warning: {missing} SBN parameters in support but not "
                  f"specified; set to log-zero sentinel.")
        self.sbn_parameters = out

    # -- sampling --------------------------------------------------------
    def sample_topology(self) -> Topology:
        sampler = TopologySampler(self.sbn_support, self.rng)
        probs = self.normalized_sbn_parameters()
        return sampler.sample(probs, rooted=self.rooted)

    def sample_trees(self, count: int):
        assert self.sbn_support is not None
        sampler = TopologySampler(self.sbn_support, self.rng)
        probs = self.normalized_sbn_parameters()
        trees = []
        for _ in range(count):
            topo = sampler.sample(probs, rooted=self.rooted)
            trees.append(Tree(topo, np.zeros(topo.num_nodes)))
        self.tree_collection = TreeCollection(
            trees, self.tree_collection.taxon_names
        )

    # -- likelihood engine ----------------------------------------------
    def _invalidate_engine(self):
        self.engine = None

    # -- PhyloFlags (reference src/pybito.cpp:577-599) -------------------
    def init_phylo_flags(self):
        self.phylo_flags = phylo_flags_mod.PhyloFlags()

    def set_phylo_flag(self, flag_name: str, set_to: bool = True,
                       set_value: float = 1.0):
        if self.phylo_flags is None:
            self.init_phylo_flags()
        self.phylo_flags.set(flag_name, set_to, set_value)

    def set_phylo_defaults(self, use_defaults: bool = True):
        if self.phylo_flags is None:
            self.init_phylo_flags()
        self.phylo_flags.use_defaults = use_defaults

    def clear_phylo_flags(self):
        self.phylo_flags = None

    def _resolve_flags(self, flags, use_defaults: bool = True):
        return phylo_flags_mod.resolve(flags, self.phylo_flags, use_defaults)

    def prepare_for_phylo_likelihood(
        self, specification: PhyloModelSpecification, thread_count: int = 1,
        beagle_flags: Sequence[int] = (), use_tip_states: bool = True,
        tree_count_option: Optional[int] = None,
    ):
        assert self.alignment, "Read a fasta file first"
        assert self.tree_collection is not None, "Load trees first"
        self.phylo_model = PhyloModel(specification)
        sp = SitePattern(self.alignment, self.tree_collection.taxon_names)
        self.engine = TreeLikelihoodEngine(sp, self.phylo_model,
                                           device=self.device,
                                           dtype=self.dtype)
        count = tree_count_option or len(self.tree_collection)
        base = self.phylo_model.default_param_vector()
        self.phylo_model_params = np.tile(base, (count, 1))

    def get_phylo_model_params(self) -> np.ndarray:
        return self.phylo_model_params

    def get_phylo_model_param_block_map(self) -> Dict[str, np.ndarray]:
        """Zero-copy views into the per-tree parameter matrix (reference
        GetPhyloModelParamBlockMap)."""
        out = {}
        for key, (start, length) in self.phylo_model.blocks.items():
            out[key] = self.phylo_model_params[:, start:start + length]
        return out

    def _params_dict(self) -> Dict[str, torch.Tensor]:
        """The engine's parameter dict: one shared 1-D row per block when
        every tree's row is equal (the engine's kernels take it), per-tree
        2-D rows otherwise (the scan tape)."""
        count = len(self.tree_collection)
        mat = np.asarray(self.phylo_model_params)
        if mat.shape[0] != count:
            mat = np.tile(mat[:1], (count, 1))
        rows = mat[0] if (mat == mat[:1]).all() else mat
        return params_from_numpy(
            {key: rows[..., start:start + length]
             for key, (start, length) in self.phylo_model.blocks.items()},
            self.device, self.dtype)

    def log_likelihoods(self, phylo_flags=None, use_defaults: bool = True
                        ) -> np.ndarray:
        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        self._resolve_flags(phylo_flags, use_defaults)  # validates names
        return self.engine.log_likelihoods(
            self.tree_collection.trees, self._params_dict()).cpu().numpy()

    def phylo_gradients(self, phylo_flags=None, use_defaults: bool = True
                        ) -> List[PhyloGradient]:
        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        self._resolve_flags(phylo_flags, use_defaults)
        trees = self.tree_collection.trees
        ll, grads = self.engine.ll_and_branch_gradients(
            trees, self._params_dict()
        )
        # One copy to the host for both outputs.
        host = torch.cat([ll[:, None], grads], dim=1).cpu().numpy()
        out = []
        for b, t in enumerate(trees):
            n_edges = t.topology.num_nodes
            out.append(
                PhyloGradient(
                    host[b, 0],
                    {"branch_lengths": host[b, 1:1 + n_edges].copy()},
                )
            )
        return out


class UnrootedSBNInstance(GenericSBNInstance):
    rooted = False

    def train_expectation_maximization(self, alpha: float, max_iter: int,
                                       score_epsilon: float = 0.0,
                                       backend: str = "device"):
        """SBN-EM.  backend="device" runs the loop of sbn/device.py in
        float64 on the instance's device; backend="numpy" the vectorized
        host loop of sbn/probability.py."""
        reps, counts = self._representation_counter()
        if _check_backend(backend) == "device":
            self.sbn_parameters, score = sbn_device.expectation_maximization(
                self.sbn_support, reps, counts, alpha, max_iter,
                score_epsilon, device=self.device)
        else:
            self.sbn_parameters, score = (
                sbn_probability.expectation_maximization(
                    self.sbn_support, reps, counts, alpha, max_iter,
                    score_epsilon))
        return score

    def topology_gradients(self, log_f: np.ndarray, use_vimco: bool = True,
                           backend: str = "device") -> np.ndarray:
        """Reference UnrootedSBNInstance::TopologyGradients: backend
        "device" in float64 on the instance's device (sbn/device.py),
        "numpy" on the host (sbn/gradients.py)."""
        reps = self.make_indexer_representations()
        args = (self.sbn_support, self.sbn_parameters, reps,
                np.asarray(log_f))
        if _check_backend(backend) == "device":
            return sbn_device.topology_gradients(
                *args, use_vimco=use_vimco, device=self.device)
        return sbn_gradients.topology_gradients(*args, use_vimco=use_vimco)

    def split_lengths(self):
        result = [[] for _ in range(self.psp_indexer.after_rootsplits_index)]
        for t in self.tree_collection.trees:
            split_idx = self.psp_indexer.representation_of(t.topology)[0]
            for edge, idx in enumerate(split_idx):
                result[idx].append(float(t.branch_lengths[edge]))
        return result


def unrooted_instance(name: str = "instance", *, device=PRODUCT_DEVICE,
                      dtype=PRODUCT_DTYPE) -> UnrootedSBNInstance:
    return UnrootedSBNInstance(name, device=device, dtype=dtype)
