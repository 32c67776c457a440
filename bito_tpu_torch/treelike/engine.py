"""Tree-batch likelihood engine (torch).

Port of bito_tpu.treelike.engine.TreeLikelihoodEngine (reference:
src/engine.cpp:27-119 dispatches per-tree work to a pool of FatBeagles;
here one call evaluates the whole batch).  The public surface is the same:
`log_likelihoods`, `ll_and_branch_gradients`, `branch_eval_fn` and
`ll_eval_fn`, with parameter dicts whose values are either shared (1-D)
or per-tree rows (2-D, the reference's phylo_model_params_ matrix).

Kernel selection, `engine.kernel`:
  "auto" — the hand-written CUDA kernels (treelike/paired.py) on a CUDA
           device in float32 with a shared model of 4 states and at most
           paired.MAX_CATEGORIES rate categories, the conditions under
           which bito_tpu takes its Pallas kernels; the scan tape otherwise.
  "scan" — always the scan tape (treelike/pruning.py).
  "cuda" — always the paired kernels' wrappers: on a CUDA device the
           kernels, on the CPU their plain torch versions.  Raises for
           per-tree parameter rows, which the kernels do not take.

The tape runs on the engine's device and dtype; the kernel operands are
float32.  bito_tpu's TPU launch policy (tree interleave, tile and VMEM
sizing, category padding) has no counterpart: the kernels take any batch,
pattern count and category count up to paired.MAX_CATEGORIES as they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..device import resolve
from ..models.phylo_model import PhyloModel
from ..models.substitution import EigenDecomp
from . import paired, prep, pruning
from .encode import TreeBatchEncoding, encode_trees

KERNELS = ("auto", "scan", "cuda")


class TreeLikelihoodEngine:
    """Batched likelihood/gradient evaluation for a fixed tree batch.

    The encoding is rebuilt when topologies change; branch lengths and model
    parameters are plain tensors on the engine's device."""

    def __init__(self, site_pattern: SitePattern, model: PhyloModel, *,
                 device, dtype):
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
        # The kernels' operands: the same padded tips as [T, A, S], float32.
        self._kernel_tips = self.tip_partials.transpose(1, 2).to(
            prep.KERNEL_DTYPE).contiguous()
        self._kernel_weights = self.weights.to(prep.KERNEL_DTYPE)
        self._encoding: Optional[TreeBatchEncoding] = None
        self._encoding_key = None
        self._tapes: Dict[str, tuple] = {}
        self.kernel = "auto"

    # -- kernel selection --------------------------------------------------
    def _use_cuda(self, shared_model: bool) -> bool:
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, "
                             f"got {self.kernel!r}")
        if self.kernel == "cuda" and not shared_model:
            raise ValueError("kernel='cuda' takes one model shared by the "
                             "batch; per-tree parameter rows need the scan "
                             "tape (kernel='auto' or 'scan')")
        if self.kernel != "auto":
            return self.kernel == "cuda"
        return (self.device.type == "cuda"
                and self.dtype == torch.float32
                and shared_model
                and self.num_states == 4
                and self.model.category_count <= paired.MAX_CATEGORIES)

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

    def _paired_tapes(self, enc: TreeBatchEncoding):
        """(post_dst, tip_slot, post_src, post_e, edge_mask) int32/float32
        on the device, cached with the encoding."""
        if "paired" not in self._tapes:
            pe = paired.build_paired_encoding(enc)
            dev = self.device
            ints = (pe.post_dst, pe.tip_slot, pe.post_src, pe.post_e)
            self._tapes["paired"] = tuple(
                torch.as_tensor(x, dtype=torch.int32, device=dev)
                for x in ints) + (
                torch.as_tensor(enc.edge_mask, dtype=prep.KERNEL_DTYPE,
                                device=dev),)
        return self._tapes["paired"]

    def branch_length_matrix(self, trees: Sequence[Tree],
                             enc: TreeBatchEncoding) -> torch.Tensor:
        bl = np.zeros((len(trees), enc.num_slots))
        for b, t in enumerate(trees):
            bl[b, : t.topology.num_nodes] = t.branch_lengths
        return torch.as_tensor(bl, dtype=self.dtype, device=self.device)

    def _model_ingredients(self, params, batch: int):
        """Per-tree model ingredients (eig fields [B, ...], rates/props
        [B, C], clock [B]).  `params` values may be shared (1-D) or carry a
        leading per-tree axis."""
        kw = dict(device=self.device, dtype=self.dtype)
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
                        branch_lengths=None) -> torch.Tensor:
        enc = self.encode(trees)
        bl = self._branch_lengths(trees, enc, branch_lengths)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        if self._use_cuda(self._shared_model(params)):
            post_dst, tip_slot, _src, post_e, _mask = self._paired_tapes(enc)
            pi, prop = prep.kernel_model(eig, props)
            P = prep.prepare_inputs(eig, rates, clock, bl)
            ll = paired.paired_log_likelihoods(
                post_dst, tip_slot, post_e, P, self._kernel_tips, pi, prop,
                self._kernel_weights)
            return ll.to(self.dtype)
        post_ops, _pre, root, _mask = self._scan_tapes(enc)
        return pruning.log_likelihoods_impl(
            post_ops, root, self.tip_partials, self.weights, bl,
            eig, rates, props, clock,
            num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
            category_count=self.model.category_count)

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
        if self._use_cuda(self._shared_model(params)):
            post_dst, tip_slot, post_src, post_e, mask = self._paired_tapes(enc)
            pi, prop = prep.kernel_model(eig, props)
            tips, w = self._kernel_tips, self._kernel_weights

            def fn(bl):
                P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
                ll, grads = paired.paired_ll_and_gradients(
                    post_dst, tip_slot, post_src, post_e, mask, P, dP, tips,
                    pi, prop, w)
                return ll.to(self.dtype), grads.to(self.dtype)

            return fn

        post_ops, pre_ops, root, edge_mask = self._scan_tapes(enc)

        def fn(bl):
            return pruning.ll_and_branch_gradients_impl(
                post_ops, pre_ops, root, edge_mask, self.tip_partials,
                self.weights, bl, eig, rates, props, clock,
                num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
                category_count=self.model.category_count)

        return fn

    def ll_eval_fn(self, trees: Sequence[Tree], params):
        """LL-only counterpart of branch_eval_fn: a closure bl[B, N] ->
        ll[B] through the same dispatch as log_likelihoods."""
        self.encode(trees)

        def fn(bl):
            return self.log_likelihoods(trees, params, branch_lengths=bl)

        return fn
