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
              a CUDA device in float32 with a shared model of 4 states and
              at most paired.MAX_CATEGORIES rate categories; the scan tape
              otherwise.  The limit of 1-8 categories is the port's own:
              the kernels are compiled for those counts, where bito_tpu
              pads categories (zero proportions) so that its paired Pallas
              kernel takes any count.  The paired wrappers launch the on-chip
              bodies, or the global ones for a tree on which those would
              be the slower (paired.onchip_plan).
  "scan"    — always the scan tape (treelike/pruning.py).
  "cuda"    — always the paired kernels' wrappers: on a CUDA device the
              kernels, on the CPU their plain torch versions.
  "chunked" — always the chunked kernels' wrappers (treelike/chunked.py),
              with dP from the eigen derivative (prep.prepare_inputs_grad)
              as in bito_tpu's chunked route; 4-state models only.  The
              wrappers launch the on-chip bodies, or the global ones for
              a tree on which those would be the slower
              (chunked.ll_plan for LL, chunked.onchip_plan for grad).
"cuda" and "chunked" raise for per-tree parameter rows, which the kernels
do not take.  (bito_tpu's forced kernels take them and silently use tree
0's model for the whole batch.)  The per-node kernels (treelike/pernode.py)
have no route here, as bito_tpu's have none.

The tape runs on the engine's device and dtype; the kernel operands are
float32 on a card and in the engine's dtype on the CPU.  The model
ingredients and the transition matrices are computed in float64 and cast
to those (_model_ingredients).  bito_tpu's TPU
launch policy (tree interleave, tile and VMEM sizing, category padding,
the MXU-sized chunk width) has no counterpart: the kernels take any
batch, pattern count and category count up to paired.MAX_CATEGORIES as
they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..models.phylo_model import PhyloModel
from ..models.substitution import EigenDecomp
from . import chunked, paired, prep, pruning
from .encode import TreeBatchEncoding, encode_trees

KERNELS = ("auto", "scan", "cuda", "chunked")


class TreeLikelihoodEngine:
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
        self._tapes: Dict[str, tuple] = {}
        self.kernel = "auto"

    # -- kernel selection --------------------------------------------------
    def _route(self, shared_model: bool) -> str:
        """"scan", "paired" or "chunked": which tape serves this call."""
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, "
                             f"got {self.kernel!r}")
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
                and self.num_states == 4
                and self.model.category_count <= paired.MAX_CATEGORIES):
            return "paired"
        return "scan"

    def _shared_model(self, params) -> bool:
        """The kernels take one model's pi and proportions for the whole
        batch; per-tree model rows run on the scan tape."""
        return all(torch.as_tensor(params[k]).dim() == 1
                   for k in self.model.blocks)

    # -- encoding cache -------------------------------------------------
    def encode(self, trees: Sequence[Tree]) -> TreeBatchEncoding:
        key = tuple(t.topology.key() for t in trees)
        if key != self._encoding_key:
            self._encoding = encode_trees([t.topology for t in trees])
            self._encoding_key = key
            self._tapes = {}
        return self._encoding

    def _scan_tapes(self, enc: TreeBatchEncoding):
        """(post_ops, pre_ops, root, edge_mask) on the device, cached with
        the encoding."""
        if "scan" not in self._tapes:
            dev = self.device
            self._tapes["scan"] = (
                torch.as_tensor(enc.post_ops, dtype=torch.long, device=dev),
                torch.as_tensor(enc.pre_ops, dtype=torch.long, device=dev),
                torch.as_tensor(enc.root, dtype=torch.long, device=dev),
                torch.as_tensor(enc.edge_mask, dtype=self.dtype, device=dev),
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
            pe = paired.build_paired_encoding(enc)
            self._tapes["paired"] = self._kernel_tapes(
                enc, (pe.post_dst, pe.tip_slot, pe.post_src, pe.post_e))
            # The on-chip bodies' tape, from the same host arrays; the CPU
            # runs the plain versions, which need none.
            self._tapes["onchip"] = paired.onchip_tape(
                pe.post_dst, pe.tip_slot, self.device) if (
                    self.device.type == "cuda") else None
        return self._tapes["paired"]

    def _onchip_tape(self, enc: TreeBatchEncoding):
        """The paired kernels' on-chip tape (child codes and LL rows),
        cached with the encoding; None on the CPU."""
        self._paired_tapes(enc)
        return self._tapes["onchip"]

    def _chunked_tapes(self, enc: TreeBatchEncoding):
        """(post_dst, tip_slot, post_e, node_row, edge_mask) of the chunked
        schedule at width chunked.W on the device, cached with the
        encoding."""
        if "chunked" not in self._tapes:
            ce = chunked.build_chunked_encoding(enc, chunked.W)
            self._tapes["chunked"] = self._kernel_tapes(
                enc, (ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
            # The on-chip bodies' tape, from the same host arrays; the CPU
            # runs the plain versions, which need none.
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
        kw = dict(device=self.device, dtype=torch.float64)
        vals = {k: torch.as_tensor(params[k], **kw) for k in self.model.blocks}
        if not all(v.dim() == 1 for v in vals.values()):
            # Per-tree rows: broadcast shared blocks, then one batched
            # evaluation of every ingredient.
            vals = {k: v.expand(batch, self.model.blocks[k][1])
                    if v.dim() == 1 else v for k, v in vals.items()}
        eig = self.model.eigen(vals, **kw)
        C, A = self.model.category_count, self.num_states

        def rows(x, tail):
            # One shared row, or already one per tree.
            return x.expand((batch,) + tail) if x.dim() == len(tail) else x

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
        enc = self.encode(trees)
        bl = self._branch_lengths(trees, enc, branch_lengths)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        route = self._route(self._shared_model(params))
        if route == "scan":
            post_ops, _pre, root, _mask = self._scan_tapes(enc)
            return pruning.log_likelihoods_impl(
                post_ops, root, self.tip_partials, self.weights, bl,
                eig, rates, props, clock,
                num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
                category_count=self.model.category_count)
        dt = self._operand_dtype
        pi, prop = prep.kernel_model(eig, props, dt)
        P = prep.prepare_inputs(eig, rates, clock, bl, dt)
        tips, w = self._kernel_tips, self._kernel_weights
        if route == "paired":
            post_dst, tip_slot, _src, post_e, _mask = self._paired_tapes(enc)
            ll = paired.paired_log_likelihoods(
                post_dst, tip_slot, post_e, P, tips, pi, prop, w,
                onchip=self._onchip_tape(enc))
        else:
            post_dst, tip_slot, post_e, _row, _mask = self._chunked_tapes(enc)
            ll = chunked.chunked_log_likelihoods(
                post_dst, tip_slot, post_e, P, tips, pi, prop, w,
                onchip=self._chunked_onchip_tape(enc))
        return ll.to(self.dtype)

    def ll_and_branch_gradients(self, trees: Sequence[Tree], params,
                                branch_lengths=None):
        """(log likelihoods [B], d logL / d branch length [B, N])."""
        enc = self.encode(trees)
        bl = self._branch_lengths(trees, enc, branch_lengths)
        return self.branch_eval_fn(trees, params)(bl)

    def branch_eval_fn(self, trees: Sequence[Tree], params):
        """A closure bl[B, N] -> (ll[B], grads[B, N]) bound to this tree
        batch, these model parameters and the engine's current kernel
        choice, with the tapes and model ingredients built once: the hot
        path of a VBPI inner loop or a branch-length sweep."""
        enc = self.encode(trees)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        route = self._route(self._shared_model(params))
        if route == "scan":
            post_ops, pre_ops, root, edge_mask = self._scan_tapes(enc)

            def fn(bl):
                return pruning.ll_and_branch_gradients_impl(
                    post_ops, pre_ops, root, edge_mask, self.tip_partials,
                    self.weights, bl, eig, rates, props, clock,
                    num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
                    category_count=self.model.category_count)

            return fn

        dt = self._operand_dtype
        pi, prop = prep.kernel_model(eig, props, dt)
        tips, w = self._kernel_tips, self._kernel_weights
        if route == "paired":
            post_dst, tip_slot, post_src, post_e, mask = self._paired_tapes(enc)
            onchip = self._onchip_tape(enc)

            def kernel(bl):
                P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, dt)
                return paired.paired_ll_and_gradients(
                    post_dst, tip_slot, post_src, post_e, mask, P, dP, tips,
                    pi, prop, w, onchip=onchip)
        else:
            post_dst, tip_slot, post_e, node_row, mask = self._chunked_tapes(
                enc)
            onchip = self._chunked_onchip_tape(enc)

            def kernel(bl):
                P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl, dt)
                return chunked.chunked_ll_and_gradients(
                    post_dst, tip_slot, post_e, node_row, mask, P, dP, tips,
                    pi, prop, w, onchip=onchip)

        def fn(bl):
            ll, grads = kernel(bl)
            return ll.to(self.dtype), grads.to(self.dtype)

        return fn

    def ll_eval_fn(self, trees: Sequence[Tree], params):
        """LL-only counterpart of branch_eval_fn: a closure bl[B, N] ->
        ll[B] through the same dispatch as log_likelihoods."""
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
            iterations=iterations)
        return out.cpu().numpy()
