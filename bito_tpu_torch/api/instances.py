"""Instance facades mirroring bito's Python API surface (torch engine).

Port of bito_tpu.api.instances: GenericSBNInstance, UnrootedSBNInstance and
RootedSBNInstance (reference: src/generic_sbn_instance.hpp:1-502,
src/unrooted_sbn_instance.{hpp,cpp}, src/rooted_sbn_instance.{hpp,cpp},
bound in src/pybito.cpp:91-700).  A bito user's workflow maps one-to-one:

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
flags are accepted and ignored.  Three differences from bito_tpu:

  - `_params_dict` hands the engine one shared 1-D row per model block
    when every tree's row of phylo_model_params is equal, and per-tree
    2-D rows otherwise.  The result is the same; the route is not: a
    shared model takes the engine's `auto` route (the paired kernels on
    the card), per-tree rows the scan tape.  bito_tpu always builds 2-D
    rows, so its VBPI step never reaches its kernels (nor do its rooted
    likelihoods and gradients, which here take the paired kernels too).
  - The native library (bito_tpu_torch._native) parses tree files, counts
    an unrooted support and builds its indexer representations, the whole
    sampled tree set's in one call, as bito_tpu's does.  bito_tpu falls
    back to its Python code without a word when its library does not
    build; here a failed build raises, and the Python code runs only for
    an instance made with `native=False`.
  - The device SBN backend (sbn/device.py) runs in float64 on the
    instance's device, the card included; there is no silent fall-back
    to the numpy backend, which is asked for by backend="numpy".

The rooted instance's model-parameter gradients come from autodiff over
the scan tape, as bito_tpu's come from jax.jacfwd: one reverse pass with
a parameter row a tree; its Gamma shape goes through the implicitly
differentiated quantile of models/site.py.
"""
from __future__ import annotations

import csv as _csv
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import params_from_numpy
from ..core.newick import (parse_newick_file, parse_newick_text,
                           parse_nexus_file, parse_nexus_text, read_fasta,
                           read_text)
from ..core.site_pattern import SitePattern
from ..core.tree import Topology, Tree, TreeCollection
from ..dag.subsplit_dag import build_dag_from_topologies
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..models.phylo_model import PhyloModel, PhyloModelSpecification
from ..models.transforms import stick_breaking_forward, stick_breaking_inverse
from ..sbn import device as sbn_device
from ..sbn import gradients as sbn_gradients
from ..sbn import maps as sbn_maps
from ..sbn import probability as sbn_probability
from ..sbn.psp import PSPIndexer
from ..sbn.sampler import TopologySampler
from ..sbn.support import SBNSupport, build_support, support_of_bits
from ..treelike import phylo_flags as phylo_flags_mod
from ..treelike import pruning
from ..treelike import rooted as rooted_mod
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
                 dtype=PRODUCT_DTYPE, native: bool = True):
        self.name = name
        self.device, self.dtype = resolve(device, dtype)
        # Tree files, an unrooted support and its representations through
        # the native library; False takes the pure-Python code.
        self.native = native
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
        self.tree_collection = (
            parse_newick_file(path, sort_taxa=sort_taxa) if self.native
            else parse_newick_text(read_text(path), sort_taxa=sort_taxa))

    def read_nexus_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = (
            parse_nexus_file(path, sort_taxa=sort_taxa) if self.native
            else parse_nexus_text(read_text(path), sort_taxa=sort_taxa))

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
        names = self.tree_collection.taxon_names
        if self.native or self.rooted:
            self.sbn_support = build_support(self._topology_counter, names,
                                             rooted=self.rooted)
        else:
            self.sbn_support = support_of_bits(
                *sbn_maps.unrooted_counters(self._topology_counter)[2:],
                names, rooted=False)
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
        if self.native and not self.rooted:
            # One native call for the whole tree set.
            reps = self.sbn_support.native_indexer().unrooted_representations(
                [np.asarray(t.topology.parents, dtype=np.int32)
                 for t in self.tree_collection.trees],
                len(self.sbn_support.indexer))
        else:
            reps = [self._representation_of(t.topology)
                    for t in self.tree_collection.trees]
        self._indexer_reps_cache = (key, reps, refs)
        return reps

    def make_psp_indexer_representations(self):
        return [
            self.psp_indexer.representation_of(t.topology)
            for t in self.tree_collection.trees
        ]

    def _representation_of(self, topo: Topology):
        """One topology's indexer representation: the support's own (the
        native indexer for an unrooted one), or sbn/maps.py's for an
        unrooted instance made with native=False."""
        if self.native or self.rooted:
            return self.sbn_support.indexer_representation_of(topo)
        return sbn_maps.unrooted_representation(
            self.sbn_support.indexer, topo, len(self.sbn_support.indexer))

    def _representation_counter(self):
        reps, counts = [], []
        for topo, count in self._topology_counter.items():
            reps.append(self._representation_of(topo))
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


class RootedSBNInstance(GenericSBNInstance):
    """Rooted/time-tree instance (reference src/rooted_sbn_instance.{hpp,cpp},
    bound in src/pybito.cpp:240-430): tip dates, height/ratio gradient
    transforms, and model-parameter gradients by autodiff (replacing the
    reference's central finite differences, src/fat_beagle.cpp:422-508).

    Likelihoods and branch gradients go through the engine with the
    substitution lengths rate_i * time_i, on the route the model row takes
    (`_params_dict`): on the card the paired kernels, whose tapes take the
    bifurcating root as they take a trifurcating one."""

    rooted = True

    def __init__(self, name: str = "instance", *, device=PRODUCT_DEVICE,
                 dtype=PRODUCT_DTYPE, native: bool = True):
        super().__init__(name, device=device, dtype=dtype, native=native)
        self.tree_states: Optional[List[rooted_mod.RootedTreeState]] = None

    # -- tip dates -------------------------------------------------------
    def _init_states(self, dates_by_taxon: Dict[str, float],
                     initialize_time_trees: bool):
        names = self.tree_collection.taxon_names
        max_date = max(dates_by_taxon.values())
        # Reference semantics: date := max_date - date (most recent tip at 0).
        dates = [max_date - dates_by_taxon[t] for t in names]
        self.tree_states = []
        for tree in self.tree_collection.trees:
            state = rooted_mod.set_tip_dates(tree, dates)
            if initialize_time_trees:
                rooted_mod.initialize_time_tree_using_branch_lengths(state)
            self.tree_states.append(state)

    def parse_dates_from_taxon_names(self, initialize_time_trees: bool = False):
        pat = re.compile(r"^.+_(\d*\.?\d+(?:[eE][-+]?\d+)?)$")
        dates = {}
        for t in self.tree_collection.taxon_names:
            m = pat.match(t)
            assert m, f"Taxon {t!r} has no parseable date suffix"
            dates[t] = float(m.group(1))
        self._init_states(dates, initialize_time_trees)

    def set_dates_to_be_constant(self, initialize_time_trees: bool = False):
        self._init_states(
            {t: 0.0 for t in self.tree_collection.taxon_names},
            initialize_time_trees,
        )

    def parse_dates_from_csv(self, csv_path: str,
                             initialize_time_trees: bool = False):
        dates = {}
        with open(csv_path, newline="") as f:
            for row in _csv.reader(f):
                if row:
                    dates[row[0].strip('"')] = float(row[1])
        self._init_states(dates, initialize_time_trees)

    # -- likelihood with substitution-length branches --------------------
    def _subst_branch_lengths(self) -> torch.Tensor:
        """Per-tree substitution lengths rate_i * time_i as the engine's
        branch-length input [B, slots] (reference FatBeagle rooted
        semantics), on the engine's device and dtype."""
        enc = self.engine.encode(self.tree_collection.trees)
        bl = np.zeros((len(self.tree_collection.trees), enc.num_slots))
        for i, tree in enumerate(self.tree_collection.trees):
            N = tree.topology.num_nodes
            rates = (self.tree_states[i].rates if self.tree_states
                     else np.ones(N - 1))
            bl[i, : N - 1] = tree.branch_lengths[: N - 1] * rates
        return torch.as_tensor(bl, dtype=self.engine.dtype,
                               device=self.engine.device)

    def log_likelihoods(self, phylo_flags=None, use_defaults: bool = True,
                        include_log_det_jacobian: Optional[bool] = None
                        ) -> np.ndarray:
        """Rooted log likelihoods; by default includes the log-det Jacobian
        of the height transform (reference LogLikelihoodFlagOptions default;
        disable via the INCLUDE_LOG_DET_JACOBIAN_LIKELIHOOD flag)."""
        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        resolved = self._resolve_flags(phylo_flags, use_defaults)
        if include_log_det_jacobian is None:
            include_log_det_jacobian = resolved.is_set(
                phylo_flags_mod.INCLUDE_LOG_DET_JACOBIAN_LIKELIHOOD
            )
        ll = self.engine.log_likelihoods(
            self.tree_collection.trees, self._params_dict(),
            branch_lengths=self._subst_branch_lengths(),
        ).cpu().numpy()
        if include_log_det_jacobian and self.tree_states:
            ll = ll + self.log_det_jacobian_of_height_transform()
        return ll

    def log_det_jacobian_of_height_transform(self) -> np.ndarray:
        return np.array([
            rooted_mod.log_det_jacobian_height_transform(s)
            for s in self.tree_states
        ])

    def gradient_log_det_jacobian_of_height_transform(self) -> List[np.ndarray]:
        return [
            rooted_mod.gradient_log_det_jacobian(s) for s in self.tree_states
        ]

    def phylo_gradients(self, phylo_flags=None, use_defaults: bool = True
                        ) -> List[PhyloGradient]:
        """Gradient map per tree: branch_lengths (substitution space),
        ratios_root_height, clock_model and clock_model_rates, and the
        model-parameter gradients (substitution_model in stick-breaking
        space, site_model) by autodiff (_per_tree_jacobian).  Selection follows PhyloFlags: a
        bare call computes everything available; explicit selection flags
        restrict the map (reference PhyloGradientFlagOptions)."""
        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        flags = self._resolve_flags(phylo_flags, use_defaults)
        want_ratios = flags.is_set(phylo_flags_mod.RATIOS_ROOT_HEIGHT)
        want_subst = flags.is_set(phylo_flags_mod.SUBSTITUTION_MODEL)
        want_site = flags.is_set(phylo_flags_mod.SITE_MODEL)
        want_clock = flags.is_set(phylo_flags_mod.CLOCK_MODEL)
        include_jac = flags.is_set(
            phylo_flags_mod.INCLUDE_LOG_DET_JACOBIAN_GRADIENT
        )
        trees = self.tree_collection.trees
        bl = self._subst_branch_lengths()
        ll, grads = self.engine.ll_and_branch_gradients(
            trees, self._params_dict(), branch_lengths=bl
        )
        # One copy to the host for both outputs.
        host = torch.cat([ll[:, None], grads], dim=1).cpu().numpy()
        ll, grads = host[:, 0], host[:, 1:]
        model_grads = (
            self._model_param_gradients(bl, want_subst, want_site)
            if (want_subst or want_site) else {}
        )
        out = []
        for i, tree in enumerate(trees):
            n_edges = tree.topology.num_nodes
            gmap = {"branch_lengths": grads[i, :n_edges].copy()}
            if self.tree_states and want_ratios:
                gmap["ratios_root_height"] = (
                    rooted_mod.ratio_gradient_of_branch_gradient(
                        self.tree_states[i], grads[i, :n_edges],
                        include_log_det_jacobian=include_jac,
                    )
                )
            # Clock gradient (reference ClockGradient,
            # src/fat_beagle.cpp:375-399).
            if self.tree_states and want_clock:
                per_branch = (grads[i, : n_edges - 1]
                              * tree.branch_lengths[: n_edges - 1])
                gmap["clock_model"] = np.array([per_branch.sum()])
                gmap["clock_model_rates"] = per_branch
            for key, val in model_grads.items():
                gmap[key] = val[i]
            out.append(PhyloGradient(ll[i], gmap))
        return out

    @staticmethod
    def _per_tree_jacobian(f, y0: torch.Tensor, batch: int) -> torch.Tensor:
        """[B, K]: row b is d f(Y)[b] / d Y[b] at Y = y0 for every tree,
        where f maps one parameter row a tree, Y [B, K], to the trees' log
        likelihoods [B].  The trees of the scan tape share no arithmetic,
        so one reverse pass over sum(f(Y)) gives every row: the Jacobian of
        the shared y0 that bito_tpu takes with jax.jacfwd, at the cost of
        one postorder and one preorder (pruning.log_likelihoods_differentiable),
        where forward mode would take K passes."""
        rows = y0.detach().expand(batch, -1).clone().requires_grad_(True)
        with torch.enable_grad():
            (jac,) = torch.autograd.grad(f(rows).sum(), rows)
        return jac

    def _model_param_gradients(self, bl, want_subst: bool = True,
                               want_site: bool = True
                               ) -> Dict[str, np.ndarray]:
        """Autodiff gradients with respect to the substitution model's
        parameters (stick-breaking space; HKY's kappa itself) and the site
        model's shape, per tree [B, K], over the scan tape: bito_tpu takes
        them with jax.jacfwd over its own."""
        model = self.phylo_model
        spec = model.spec
        out: Dict[str, np.ndarray] = {}
        if spec.substitution == "JC69" and model.site.kind == "constant":
            return out
        engine = self.engine
        trees = self.tree_collection.trees
        enc = engine.encode(trees)
        post_ops, pre_ops, root, _mask = engine._scan_tapes(enc)
        params0 = self._params_dict()
        B = len(trees)
        kw = dict(dtype=engine.dtype, device=engine.device)

        def ll_with(params_dict):
            eig, rates, props, clock = engine._model_ingredients(
                params_dict, B
            )
            return pruning.log_likelihoods_differentiable(
                post_ops, pre_ops, root, engine.tip_partials, engine.weights,
                bl, eig, rates, props, clock,
                num_slots=enc.num_slots, pattern_pad=engine.pattern_pad,
            )

        def first_row(key):
            v = params0[key]
            return (v[0] if v.dim() == 2 else v).cpu().numpy()

        # Each differentiated block: (output key, its unconstrained values,
        # the map from their per-tree rows [B, k] into the parameter dict).
        blocks = []
        if want_subst and spec.substitution in ("GTR", "HKY"):
            rates0 = first_row("substitution_model_rates")
            y_freqs = stick_breaking_inverse(
                first_row("substitution_model_frequencies"))
            if spec.substitution == "GTR":
                def put_subst(p, y):
                    p["substitution_model_rates"] = stick_breaking_forward(
                        y[:, :5])
                    p["substitution_model_frequencies"] = (
                        stick_breaking_forward(y[:, 5:]))

                y_subst = np.concatenate([stick_breaking_inverse(rates0),
                                          y_freqs])
            else:
                def put_subst(p, y):
                    p["substitution_model_rates"] = torch.exp(y[:, :1])
                    p["substitution_model_frequencies"] = (
                        stick_breaking_forward(y[:, 1:]))

                y_subst = np.concatenate([np.log(rates0[:1]), y_freqs])
            blocks.append(("substitution_model", y_subst, put_subst))
        if want_site and model.site.kind in ("weibull", "gamma"):
            def put_site(p, y):
                p["site_model_parameters"] = y

            blocks.append(("site_model", first_row("site_model_parameters"),
                           put_site))
        if not blocks:
            return out
        ends = np.cumsum([len(y) for _, y, _ in blocks])
        starts = ends - [len(y) for _, y, _ in blocks]

        def f(y):
            p = dict(params0)
            for (_, _, put), a, b in zip(blocks, starts, ends):
                put(p, y[:, a:b])
            return ll_with(p)

        y0 = torch.as_tensor(np.concatenate([y for _, y, _ in blocks]), **kw)
        # A pattern-sharded engine's tape sums this rank's patterns only.
        jac = engine._all_reduce(
            self._per_tree_jacobian(f, y0, B)).cpu().numpy()
        for (key, _, _), a, b in zip(blocks, starts, ends):
            out[key] = jac[:, a:b]
        if "substitution_model" in out and spec.substitution == "HKY":
            # Reference reports d/d(kappa), not d/d(log kappa).
            out["substitution_model"][:, 0] /= rates0[0]
        return out

    def unconditional_subsplit_probabilities(self) -> Dict[str, float]:
        """Reference UnconditionalSubsplitProbabilities via the DAG path:
        probability of seeing each subsplit in an SBN sample."""
        dag = build_dag_from_topologies(
            [t.topology for t in self.tree_collection.trees],
            self.tree_collection.taxon_names,
        )
        # Map the instance's normalized SBN parameters onto DAG edges.
        norm = self.normalized_sbn_parameters()
        q = np.zeros(dag.edge_count())
        indexer = self.sbn_support.indexer
        for e in range(dag.edge_count()):
            key = dag.edge_pcsp(e).to_string()
            if key in indexer:
                q[e] = norm[indexer[key]]
            else:
                q[e] = 1.0  # leaf subsplit edges
        node_probs = dag.unconditional_node_probabilities(q)
        out = {}
        for i, ss in enumerate(dag.nodes):
            if i >= dag.taxon_count and i != dag.root_id:
                out[ss.to_string()] = float(node_probs[i])
        return out

    def unconditional_subsplit_probabilities_to_csv(self, path: str):
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            for key, val in self.unconditional_subsplit_probabilities().items():
                w.writerow([key, repr(val)])


def unrooted_instance(name: str = "instance", *, device=PRODUCT_DEVICE,
                      dtype=PRODUCT_DTYPE, native: bool = True
                      ) -> UnrootedSBNInstance:
    return UnrootedSBNInstance(name, device=device, dtype=dtype,
                               native=native)


def rooted_instance(name: str = "instance", *, device=PRODUCT_DEVICE,
                    dtype=PRODUCT_DTYPE, native: bool = True
                    ) -> RootedSBNInstance:
    return RootedSBNInstance(name, device=device, dtype=dtype, native=native)
