"""Tree-batch likelihood engine (torch).

Port of bito_tpu.treelike.engine.TreeLikelihoodEngine (reference:
src/engine.cpp:27-119 dispatches per-tree work to a pool of FatBeagles;
here one call evaluates the whole batch).  The public surface is the same:
`log_likelihoods`, `ll_and_branch_gradients`, `branch_eval_fn`,
`ll_eval_fn` and `optimize_selected_branches`, with parameter dicts whose
values are either shared (1-D) or per-tree rows (2-D, the reference's
phylo_model_params_ matrix).

The engine runs on the card in float32 unless the caller asks for another
device or dtype (bito_tpu_torch.device: PRODUCT_DEVICE, PRODUCT_DTYPE).

Kernel selection, `engine.kernel`:
  "auto"    — the hand-written CUDA paired kernels (treelike/paired.py) on
              a CUDA device in float32 with a shared model of 4 or 64
              states (MG94 codon models: their own A=64 kernels), at any
              count of rate categories, as bito_tpu's paired Pallas
              kernel takes any count (it pads categories with zero
              proportions); the scan tape otherwise.  At 64 states this
              differs from bito_tpu, whose auto takes the scan tape
              there (faster on its TPU); on the card auto takes the
              kernels.  The paired wrappers launch the on-chip bodies
              (past 32 categories K = ceil(C / 32) of them a lane, to
              128), or the global ones for a tree on which those would be
              the slower and past 128 categories (paired.onchip_plan); at
              64 states the A=64 kernels.  The global bodies and the A=64
              kernels run over slices of the batch where their scratch
              for all of it would not fit in the card's free memory
              (paired.tree_slices), and raise, with the bytes, where one
              tree's does not.
  "scan"    — always the scan tape (treelike/pruning.py).
  "cuda"    — always the paired kernels' wrappers: on a CUDA device the
              kernels, on the CPU their plain torch versions.
  "chunked" — always the chunked kernels' wrappers (treelike/chunked.py),
              with dP from the eigen derivative (prep.prepare_inputs_grad)
              as in bito_tpu's chunked route; 4-state models only (it
              raises for codon models, as bito_tpu's does), at any count
              of rate categories.  The wrappers launch the on-chip
              bodies (the grad kernel, where its own gets no plan, the
              paired grad body on its tape: at 17-32 categories and past
              32), or the global ones for a tree on which those would be
              the slower and past 128 categories (chunked.ll_plan for
              LL, chunked.onchip_plan then chunked.paired_plan for
              grad).
"cuda" and "chunked" raise for per-tree parameter rows, which the kernels
do not take.  (bito_tpu's forced kernels take them and silently use tree
0's model for the whole batch.)  The per-node kernels (treelike/pernode.py,
any count of categories at 4 and 64 states) have no route here, as
bito_tpu's have none.

The tape runs on the engine's device and dtype; the kernel operands are
float32 on a card and in the engine's dtype on the CPU.  A codon model
(MG94) shared by the batch takes uniformized transition matrices from its
padded rate matrix on every route (`_rate_Q`, as in bito_tpu); per-tree
rows take the eigen route.  The model
ingredients and the transition matrices are computed in float64 and cast
to those (_model_ingredients).  bito_tpu's TPU
launch policy (tree interleave, tile and VMEM sizing, category padding,
the MXU-sized chunk width) has no counterpart: the kernels take any
batch, pattern count and category count as they are, within the card's
memory.

`use_leveled` (False by default, as in bito_tpu) takes the levelized
tapes (encode.encode_trees_leveled, pruning.*_leveled_impl): a step is
one level of every tree, and the route is the scan tape's, whatever
`kernel` says, as bito_tpu's _use_pallas has it.  A shared codon model
takes the uniformized transition route there as on the scan tape
(bito_tpu's leveled impls take the eigen route).

`shard_patterns(group)` splits the site patterns over the ranks of a
torch.distributed process group (dist/): each rank keeps its slice of the
tips and weights, runs the same route on it (the kernel wrappers, or the
scan tape), and all-reduces each sum over patterns, so every public
method returns the whole alignment's value on every rank.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..dist.mesh import PatternSharded, check_same
from ..models.phylo_model import PhyloModel
from ..models.substitution import EigenDecomp
from ..utils import timing
from . import chunked, paired, prep, pruning
from .encode import (LeveledEncoding, TreeBatchEncoding, encode_trees,
                     encode_trees_leveled)

KERNELS = ("auto", "scan", "cuda", "chunked")


class TreeLikelihoodEngine(PatternSharded):
    """Batched likelihood/gradient evaluation for a fixed tree batch.

    The encoding is rebuilt when topologies change; branch lengths and model
    parameters are plain tensors on the engine's device."""

    def __init__(self, site_pattern: SitePattern, model: PhyloModel, *,
                 device=PRODUCT_DEVICE, dtype=PRODUCT_DTYPE):
        self.device, self.dtype = resolve(device, dtype)
        self.site_pattern = site_pattern
        self.model = model
        self.num_states = model.num_states
        S0 = site_pattern.pattern_count
        self.pattern_pad = pruning.pad_patterns(S0)
        # Padded pattern columns are all-ones "gaps" with weight zero.
        tips = np.ones((site_pattern.num_taxa, self.pattern_pad,
                        self.num_states))
        tips[:, :S0, :] = site_pattern.tip_partials()
        kw = dict(device=self.device, dtype=self.dtype)
        self.tip_partials = torch.as_tensor(tips, **kw)
        w = np.zeros(self.pattern_pad)
        w[:S0] = site_pattern.weights
        self.weights = torch.as_tensor(w, **kw)
        # The kernels' operands: the same padded tips as [T, A, S], float32
        # on a card; on the CPU, where the wrappers run their plain
        # versions, in the engine's dtype.
        self._operand_dtype = (prep.KERNEL_DTYPE if self.device.type == "cuda"
                               else self.dtype)
        self._kernel_tips = self.tip_partials.transpose(1, 2).to(
            self._operand_dtype).contiguous()
        self._kernel_weights = self.weights.to(self._operand_dtype)
        self._encoding: Optional[TreeBatchEncoding] = None
        self._encoding_key = None
        self._encoding_digest = None
        self._tapes: Dict[str, tuple] = {}
        self._leveled: Optional[LeveledEncoding] = None
        self._leveled_key = None
        self._leveled_tapes_cache: Optional[tuple] = None
        self.kernel = "auto"
        self.use_leveled = False

    # -- kernel selection --------------------------------------------------
    def _route(self, shared_model: bool) -> str:
        """"scan", "paired" or "chunked": which tape serves this call."""
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, "
                             f"got {self.kernel!r}")
        if self.use_leveled:
            return "scan"
        if self.kernel in ("cuda", "chunked") and not shared_model:
            raise ValueError(f"kernel={self.kernel!r} takes one model shared "
                             "by the batch; per-tree parameter rows need the "
                             "scan tape (kernel='auto' or 'scan')")
        if self.kernel == "chunked":
            if self.num_states != 4:
                raise ValueError("kernel='chunked' takes 4-state models "
                                 f"only, got {self.num_states} states")
            return "chunked"
        if self.kernel == "cuda":
            return "paired"
        if (self.kernel == "auto"
                and self.device.type == "cuda"
                and self.dtype == torch.float32
                and shared_model
                and self.num_states in paired.KERNEL_STATES):
            return "paired"
        return "scan"

    def _shared_model(self, params) -> bool:
        """The kernels take one model's pi and proportions for the whole
        batch; per-tree model rows run on the scan tape."""
        return all(torch.as_tensor(params[k]).dim() == 1
                   for k in self.model.blocks)

    def _rate_Q(self, params):
        """The shared model's padded rate matrix [A, A] in float64 for the
        uniformized transition route (codon models; None otherwise, and
        None for per-tree rows, which take the eigen route)."""
        if not self._shared_model(params):
            return None
        kw = dict(device=self.device, dtype=torch.float64)
        with timing.span("ingredients"):
            return self.model.rate_matrix(
                {k: torch.as_tensor(params[k], **kw)
                 for k in self.model.blocks}, **kw)

    # -- pattern sharding ------------------------------------------------
    def shard_patterns(self, group=None):
        """Shard the site-pattern axis over the ranks of `group`, a
        torch.distributed process group (the world where None): this rank
        keeps its slice of the tips and weights (`pattern_shard`), and
        every sum over patterns is all-reduced over the group, so each
        public method returns the whole alignment's value on every rank.
        Tree encodings, branch lengths and model parameters stay whole on
        every rank, as in bito_tpu (bito_tpu/treelike/engine.py:385-414).

        The pattern axis is padded to a multiple of the group's size times
        paired.PATTERN_MULTIPLE with all-ones tips of the model's
        num_states states and weight 0, then split into equal contiguous
        slices.  (bito_tpu pads with 4-state tips whatever the model.)
        The routes stay those of the unsharded engine: the same kernel
        wrappers or the scan tape on the slice, then one all_reduce a
        result (as paired.py's and chunked.py's *_sharded wrappers do).
        `pattern_pad` is the slice's width from here on.

        Every rank must pass the same trees, branch lengths and model
        parameters to each call: the all_reduce adds each rank's partial
        sums tree by tree.  The engine checks the topologies (`encode`:
        one all_gather of a hash of the batch's topology keys on every
        call, raising on every rank where they differ); the branch lengths
        and parameters are the caller's to keep equal, e.g. a VBPI trainer
        (vi.Burrito) made with the same seed on every rank."""
        shard = self._take_shard(self.pattern_pad, paired.PATTERN_MULTIPLE,
                                 group)
        self.tip_partials = shard.take(self.tip_partials, 1, fill=1.0)
        self.weights = shard.take(self.weights, 0, fill=0.0)
        self._kernel_tips = self.tip_partials.transpose(1, 2).to(
            self._operand_dtype).contiguous()
        self._kernel_weights = self.weights.to(self._operand_dtype)
        self.pattern_pad = shard.width

    # -- encoding cache -------------------------------------------------
    def encode(self, trees: Sequence[Tree]) -> TreeBatchEncoding:
        """The batch's encoding, cached by topology.  A pattern-sharded
        engine first checks that every rank of its group holds the same
        topologies (_check_topologies)."""
        with timing.span("encode"):
            key = tuple(t.topology.key() for t in trees)
            if key != self._encoding_key:
                timing.count("tape_builds")
                self._encoding = encode_trees([t.topology for t in trees])
                self._encoding_key = key
                self._encoding_digest = None
                self._tapes = {}
            if self.group is not None:
                self._check_topologies()
            return self._encoding

    def _check_topologies(self):
        """Raise on every rank of the group unless every rank's batch has
        the same topology keys, in order: a rank that sampled other trees
        would otherwise add its partial sums to another rank's trees.  It
        runs on every call, not once per new encoding, since whether a
        call brings a new encoding is a rank's own (a rank may draw the
        topologies it had while another does not), and a collective that
        one rank skips would leave the others waiting.  The hash is
        computed once per encoding."""
        if self._encoding_digest is None:
            digest = hashlib.blake2b(repr(self._encoding_key).encode(),
                                     digest_size=8).digest()
            self._encoding_digest = int.from_bytes(digest, "little") >> 1
        check_same(self._encoding_digest, self.group,
                   f"tree topologies ({len(self._encoding_key)} trees a "
                   "batch)")

    def encode_leveled(self, trees: Sequence[Tree]) -> LeveledEncoding:
        """The levelized encoding of the batch, cached by topology."""
        with timing.span("encode"):
            key = tuple(t.topology.key() for t in trees)
            if key != self._leveled_key:
                timing.count("tape_builds")
                self._leveled = encode_trees_leveled(
                    [t.topology for t in trees])
                self._leveled_key = key
                self._leveled_tapes_cache = None
            return self._leveled

    def _leveled_tapes(self, trees: Sequence[Tree]):
        """(post_levels, pre_levels, root, edge_mask, num_slots) on the
        device for the leveled impls, cached with the levelized encoding."""
        lev = self.encode_leveled(trees)
        if self._leveled_tapes_cache is None:
            with timing.span("tapes"):
                timing.count("tape_builds")
                dev = self.device
                self._leveled_tapes_cache = tuple(
                    torch.as_tensor(x, dtype=torch.long, device=dev)
                    for x in (lev.post_levels, lev.pre_levels, lev.root)) + (
                    torch.as_tensor(lev.edge_mask, dtype=self.dtype,
                                    device=dev),
                    lev.num_slots)
        return self._leveled_tapes_cache

    def _scan_tapes(self, enc: TreeBatchEncoding):
        """(post_ops, pre_ops, root, edge_mask) on the device, cached with
        the encoding."""
        if "scan" not in self._tapes:
            with timing.span("tapes"):
                timing.count("tape_builds")
                dev = self.device
                self._tapes["scan"] = (
                    torch.as_tensor(enc.post_ops, dtype=torch.long,
                                    device=dev),
                    torch.as_tensor(enc.pre_ops, dtype=torch.long,
                                    device=dev),
                    torch.as_tensor(enc.root, dtype=torch.long, device=dev),
                    torch.as_tensor(enc.edge_mask, dtype=self.dtype,
                                    device=dev),
                )
        return self._tapes["scan"]

    def _kernel_tapes(self, enc: TreeBatchEncoding, ints) -> tuple:
        """The int tapes as int32 on the device, then the edge mask in the
        operand dtype."""
        dev = self.device
        return tuple(torch.as_tensor(x, dtype=torch.int32, device=dev)
                     for x in ints) + (
            torch.as_tensor(enc.edge_mask, dtype=self._operand_dtype,
                            device=dev),)

    def _paired_tapes(self, enc: TreeBatchEncoding):
        """(post_dst, tip_slot, post_src, post_e, edge_mask) on the device,
        cached with the encoding."""
        if "paired" not in self._tapes:
            with timing.span("tapes"):
                timing.count("tape_builds")
                pe = paired.build_paired_encoding(enc)
                self._tapes["paired"] = self._kernel_tapes(
                    enc, (pe.post_dst, pe.tip_slot, pe.post_src, pe.post_e))
                # The on-chip bodies' tape, from the same host arrays (with
                # the checkpointed grad body's schedule where the tree is
                # past the on-chip grad body's limit); the CPU runs the
                # plain versions and the A=64 kernels read the paired
                # tapes, which need none.
                self._tapes["onchip"] = paired.onchip_tape(
                    pe.post_dst, pe.tip_slot, self.device,
                    post_src=pe.post_src, post_e=pe.post_e,
                    edges=enc.num_slots + 1) if (
                        self.device.type == "cuda"
                        and self.num_states == 4) else None
        return self._tapes["paired"]

    def _onchip_tape(self, enc: TreeBatchEncoding):
        """The paired kernels' on-chip tape (child codes and LL rows),
        cached with the encoding; None on the CPU and at 64 states."""
        self._paired_tapes(enc)
        return self._tapes["onchip"]

    def _chunked_tapes(self, enc: TreeBatchEncoding):
        """(post_dst, tip_slot, post_e, node_row, edge_mask) of the chunked
        schedule at width chunked.W on the device, cached with the
        encoding."""
        if "chunked" not in self._tapes:
            with timing.span("tapes"):
                timing.count("tape_builds")
                ce = chunked.build_chunked_encoding(enc, chunked.W)
                self._tapes["chunked"] = self._kernel_tapes(
                    enc, (ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
                # The on-chip bodies' tape, from the same host arrays; the
                # CPU runs the plain versions, which need none.
                self._tapes["chunked_onchip"] = chunked.onchip_tape(
                    ce.post_dst, ce.tip_slot, self.device) if (
                        self.device.type == "cuda") else None
        return self._tapes["chunked"]

    def _chunked_onchip_tape(self, enc: TreeBatchEncoding):
        """The chunked kernels' on-chip tape (child codes, LL rows by
        liveness, grad rows), cached with the encoding; None on the CPU."""
        self._chunked_tapes(enc)
        return self._tapes["chunked_onchip"]

    def branch_length_matrix(self, trees: Sequence[Tree],
                             enc: TreeBatchEncoding) -> torch.Tensor:
        bl = np.zeros((len(trees), enc.num_slots))
        for b, t in enumerate(trees):
            bl[b, : t.topology.num_nodes] = t.branch_lengths
        return torch.as_tensor(bl, dtype=self.dtype, device=self.device)

    def _model_ingredients(self, params, batch: int):
        """Per-tree model ingredients (eig fields [B, ...], rates/props
        [B, C], clock [B]).  `params` values may be shared (1-D) or carry a
        leading per-tree axis.

        They are float64 whatever the engine's dtype, and the transition
        matrices built from them are cast to it only after (prep, pruning):
        at a short branch or a slow rate category, P's off-diagonal entries
        of size t come from O(1) terms of U exp(Lambda t) U^-1 that cancel,
        which in float32 would leave them a relative error of about
        2^-24 / t (a strict clock's 0.0005-substitution branch: 1e-4)."""
        with timing.span("ingredients"):
            kw = dict(device=self.device, dtype=torch.float64)
            vals = {k: torch.as_tensor(params[k], **kw)
                    for k in self.model.blocks}
            if not all(v.dim() == 1 for v in vals.values()):
                # Per-tree rows: broadcast shared blocks, then one batched
                # evaluation of every ingredient.
                vals = {k: v.expand(batch, self.model.blocks[k][1])
                        if v.dim() == 1 else v for k, v in vals.items()}
            eig = self.model.eigen(vals, **kw)
            C, A = self.model.category_count, self.num_states

            def rows(x, tail):
                # One shared row, or already one per tree.
                return (x.expand((batch,) + tail) if x.dim() == len(tail)
                        else x)

            eig = EigenDecomp(rows(eig.U, (A, A)), rows(eig.values, (A,)),
                              rows(eig.U_inv, (A, A)), rows(eig.pi, (A,)))
            rates = rows(self.model.category_rates(vals, **kw), (C,))
            props = rows(self.model.category_proportions(vals, **kw), (C,))
            clock = rows(self.model.clock_rate(vals, **kw), ())
            return eig, rates, props, clock

    def _branch_lengths(self, trees, enc, branch_lengths):
        if branch_lengths is None:
            return self.branch_length_matrix(trees, enc)
        return torch.as_tensor(branch_lengths, dtype=self.dtype,
                               device=self.device)

    # -- public API ------------------------------------------------------
    def log_likelihoods(self, trees: Sequence[Tree], params,
                        branch_lengths=None, bucket: bool = False
                        ) -> torch.Tensor:
        """Per-tree log likelihoods [B].  `bucket` is bito_tpu's opt-in
        padding of the batch to a size bucket, which exists for XLA's
        compile cache; torch compiles no program a batch size, so the port
        takes the keyword and pads nothing (the rows are the same either
        way)."""
        with timing.span("eval", outermost=True):
            return self._log_likelihoods(trees, params, branch_lengths)

    def _log_likelihoods(self, trees, params, branch_lengths):
        enc = self.encode(trees)
        bl = self._branch_lengths(trees, enc, branch_lengths)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        route = self._route(self._shared_model(params))
        Q = self._rate_Q(params)
        if route == "scan" and self.use_leveled:
            post_levels, _pre, root, _mask, N = self._leveled_tapes(trees)
            with timing.span("launch"):
                ll = pruning.log_likelihoods_leveled_impl(
                    post_levels, root, self.tip_partials, self.weights, bl,
                    eig, rates, props, clock, Q, num_slots=N,
                    pattern_pad=self.pattern_pad,
                    category_count=self.model.category_count)
            with timing.span("finish"):
                return self._all_reduce(ll)
        if route == "scan":
            post_ops, _pre, root, _mask = self._scan_tapes(enc)
            with timing.span("launch"):
                ll = pruning.log_likelihoods_impl(
                    post_ops, root, self.tip_partials, self.weights, bl,
                    eig, rates, props, clock, Q,
                    num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
                    category_count=self.model.category_count)
            with timing.span("finish"):
                return self._all_reduce(ll)
        dt = self._operand_dtype
        pi, prop = prep.kernel_model(eig, props, dt)
        P = prep.prepare_inputs(eig, rates, clock, bl, dt, Q=Q)
        ops = (P, self._kernel_tips, pi, prop, self._kernel_weights)
        if route == "paired":
            post_dst, tip_slot, _src, post_e, _mask = self._paired_tapes(enc)
            tapes, onchip = (post_dst, tip_slot, post_e), self._onchip_tape(enc)
            wrapper = paired.paired_log_likelihoods
        else:
            post_dst, tip_slot, post_e, _row, _mask = self._chunked_tapes(enc)
            tapes = (post_dst, tip_slot, post_e)
            onchip = self._chunked_onchip_tape(enc)
            wrapper = chunked.chunked_log_likelihoods
        ll = wrapper(*tapes, *ops, onchip=onchip)
        with timing.span("finish"):
            return self._all_reduce(ll).to(self.dtype)

    def ll_and_branch_gradients(self, trees: Sequence[Tree], params,
                                branch_lengths=None):
        """(log likelihoods [B], d logL / d branch length [B, N])."""
        with timing.span("eval", outermost=True):
            enc = self.encode(trees)
            bl = self._branch_lengths(trees, enc, branch_lengths)
            return self.branch_eval_fn(trees, params)(bl)

    def branch_eval_fn(self, trees: Sequence[Tree], params):
        """A closure bl[B, N] -> (ll[B], grads[B, N]) bound to this tree
        batch, these model parameters and the engine's current kernel
        choice, with the tapes and model ingredients built once: the hot
        path of a VBPI inner loop or a branch-length sweep."""
        with timing.span("bind"):
            kernel = self._bind_branch_eval(trees, params)

        def fn(bl):
            with timing.span("eval", outermost=True):
                return kernel(bl)

        return fn

    def _bind_branch_eval(self, trees, params):
        """branch_eval_fn's closure without its `eval` span."""
        enc = self.encode(trees)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        route = self._route(self._shared_model(params))
        Q = self._rate_Q(params)
        if route == "scan":
            if self.use_leveled:
                post, pre, root, edge_mask, N = self._leveled_tapes(trees)
                impl = pruning.ll_and_branch_gradients_leveled_impl
            else:
                post, pre, root, edge_mask = self._scan_tapes(enc)
                N = enc.num_slots
                impl = pruning.ll_and_branch_gradients_impl

            def fn(bl):
                with timing.span("launch"):
                    ll, grads = impl(
                        post, pre, root, edge_mask, self.tip_partials,
                        self.weights, bl, eig, rates, props, clock, Q,
                        num_slots=N, pattern_pad=self.pattern_pad,
                        category_count=self.model.category_count)
                with timing.span("finish"):
                    return self._all_reduce(ll), self._all_reduce(grads)

            return fn

        dt = self._operand_dtype
        pi, prop = prep.kernel_model(eig, props, dt)
        tips, w = self._kernel_tips, self._kernel_weights
        if route == "paired":
            post_dst, tip_slot, post_src, post_e, mask = self._paired_tapes(enc)
            onchip = self._onchip_tape(enc)

            def kernel(bl):
                P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, dt,
                                                   Q=Q)
                return paired.paired_ll_and_gradients(post_dst, tip_slot, post_src, post_e, mask, P,
                               dP, tips, pi, prop, w, onchip=onchip)
        else:
            post_dst, tip_slot, post_e, node_row, mask = self._chunked_tapes(
                enc)
            onchip = self._chunked_onchip_tape(enc)

            def kernel(bl):
                P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl, dt)
                return chunked.chunked_ll_and_gradients(post_dst, tip_slot, post_e, node_row, mask, P,
                               dP, tips, pi, prop, w, onchip=onchip)

        def fn(bl):
            ll, grads = kernel(bl)
            with timing.span("finish"):
                return (self._all_reduce(ll).to(self.dtype),
                        self._all_reduce(grads).to(self.dtype))

        return fn

    def ll_eval_fn(self, trees: Sequence[Tree], params):
        """LL-only counterpart of branch_eval_fn: a closure bl[B, N] ->
        ll[B] through the same dispatch as log_likelihoods."""
        with timing.span("bind"):
            self.encode(trees)

        def fn(bl):
            return self.log_likelihoods(trees, params, branch_lengths=bl)

        return fn

    def optimize_selected_branches(
        self, trees: Sequence[Tree], params, selected_nodes:
        Sequence[Sequence[int]], iterations: int = 2, max_selected: int = 8,
        bucket: bool = False,
    ) -> np.ndarray:
        """Exact conditional Brent optimization of selected branches per
        tree (batched); returns the branch-length matrix [B, N] as a host
        array.  The classical-engine counterpart of the reference TPEngine's
        proposed-NNI new-edge optimization (src/tp_engine.cpp:1423-1427).
        Each tree's first `max_selected` nodes are optimized.  It runs on
        the scan tape (pruning.optimize_selected_branches_impl), as in
        bito_tpu, whatever `kernel` says.  `bucket` pads nothing, as in
        log_likelihoods: each lane's line search is its own, so a padded
        batch would give the same rows."""
        enc = self.encode(trees)
        bl = self.branch_length_matrix(trees, enc)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        K = min(max_selected,
                max((len(s) for s in selected_nodes), default=1)) or 1
        sel = np.full((len(trees), K), enc.num_slots, dtype=np.int64)
        mask = np.zeros((len(trees), K), dtype=bool)
        for i, nodes in enumerate(selected_nodes):
            nodes = list(nodes)[:K]
            sel[i, : len(nodes)] = nodes
            mask[i, : len(nodes)] = True
        post_ops, pre_ops, root, _mask = self._scan_tapes(enc)
        out = pruning.optimize_selected_branches_impl(
            post_ops, pre_ops, root, self.tip_partials, self.weights, bl,
            eig, rates, props, clock,
            torch.as_tensor(sel, device=self.device),
            torch.as_tensor(mask, device=self.device),
            num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
            category_count=self.model.category_count,
            iterations=iterations,
            reduce=self._all_reduce)
        with timing.span("host_sync"):
            timing.count("host_syncs")
            return out.cpu().numpy()
