"""Perf lab of the per-node grad kernel: what its products and its rescale
cost.

Counterpart of scripts/perf_lab.py.  Its TPU kernel, make_variant_kernel,
is a copy of pallas_pruning._grad_kernel with three knobs; here the knobs
are template parameters of the per-node grad kernel's own on-chip body
(treelike/csrc/pernode_onchip.cuh), launched through csrc/variant_grad.cu:
  - unroll: the walks run with trip counts fixed at compile time (the
    flagship's M = 26 post ops and 25 parent groups, from Mp = 51 pre ops;
    any other tape raises);
  - resk: with unroll, only every resk-th post op and parent group
    rescales (1, 4 or 8);
  - nodot: the transition products are skipped, so that P = dP = I in
    effect (unrolled, with resk 1, as the script's `nodot`).
The loop (`base` and `loop_resk4`) is the shipping body.  The kernel is
instantiated for the script's variants only (VARIANTS and the loop of
`base`); any other combination raises.
The operands are pernode's (treelike/pernode.py): post_ops, pre_ops, root
int32; P, dP [B, N+1, 4, 4, 4]; tips [T, 4, S]; pi [4]; props [4]; weights
[S]; edge_mask [B, N]; and optionally the on-chip tape
(pernode.onchip_tape), which the wrapper derives where it is not given.
The kernel takes GTR+Gamma4's four categories only.

The plain version: without nodot the knobs change only where the partials
are rescaled, so the results are pernode_ll_and_gradients_ref's up to
rounding; with nodot it is that plain version with P = dP = identity, with
the same guards (a scale or a denominator that is not positive counts as
1).  nodot is not a likelihood: the product of two tips that disagree is
0, so most patterns' log likelihoods are -inf.

    python -m bito_tpu_torch.perflab lab [base unroll resk4 resk8 nodot loop_resk4]

times the variants on the synthetic DS1 shape at B = 200 (the reference
data is not in the repository), each against `base`, the shipping
pernode_ll_and_gradients, as the script does (perf_lab.py:236-277).
"""
from __future__ import annotations

import sys

import torch

from . import card_line, cuda_ms, require_card
from .. import _synthetic
from ..convert import params_from_numpy
from ..core.newick import parse_newick_text
from ..core.site_pattern import SitePattern
from ..models.phylo_model import PhyloModel, PhyloModelSpecification
from ..treelike import _kernels, pernode, prep
from ..treelike.engine import TreeLikelihoodEngine
from ..treelike.paired import _check_cuda_operands

CATEGORIES = 4       # the kernel's instantiations (csrc/variant_grad.cu)
UNROLL_M = 26        # the flagship's postorder ops: 27 taxa, trifurcating root
UNROLL_MP = 51       # and its preorder ops, one per edge
UNROLL_GROUPS = 25   # and its parent groups, one per internal node
RESKS = (1, 4, 8)
BATCH = 200
# The script's command-line names (perf_lab.py:261-265).  loop_resk4 is the
# loop with a rescale on every op, as the script has it.
VARIANTS = {
    "unroll": dict(unroll=True, resk=1, nodot=False),
    "resk4": dict(unroll=True, resk=4, nodot=False),
    "resk8": dict(unroll=True, resk=8, nodot=False),
    "nodot": dict(unroll=True, resk=1, nodot=True),
    "loop_resk4": dict(unroll=False, resk=1, nodot=False),
}
NAMES = ("base", *VARIANTS)


def _check_knobs(unroll: bool, resk: int, nodot: bool) -> None:
    if resk not in RESKS:
        raise ValueError(f"resk must be one of {RESKS}, got {resk}")
    if resk != 1 and not unroll:
        raise ValueError("resk applies to the unrolled loops only")
    if nodot and (resk != 1 or not unroll):
        raise ValueError("nodot is compiled as the script runs it only: "
                         "unrolled, with resk 1")


def variant_ll_and_gradients_ref(post_ops, pre_ops, root, edge_mask, P, dP,
                                 tips, pi, props, weights, *, unroll: bool,
                                 resk: int, nodot: bool):
    """Plain torch version of the variant kernel: (ll [B], branch
    gradients [B, N])."""
    _check_knobs(unroll, resk, nodot)
    if nodot:
        P = dP = torch.eye(P.shape[-1], dtype=P.dtype,
                           device=P.device).expand(P.shape)
    return pernode.pernode_ll_and_gradients_ref(post_ops, pre_ops, root,
                                                edge_mask, P, dP, tips, pi,
                                                props, weights)


def variant_ll_and_gradients(post_ops, pre_ops, root, edge_mask, P, dP, tips,
                             pi, props, weights, *, unroll: bool, resk: int,
                             nodot: bool, onchip=None):
    """Per-tree (log likelihood [B], branch gradients [B, N]) through the
    variant kernel; `onchip` the tape's pernode.OnchipTape, derived here
    where it is not given."""
    _check_knobs(unroll, resk, nodot)
    if P.device.type == "cpu":
        return variant_ll_and_gradients_ref(
            post_ops, pre_ops, root, edge_mask, P, dP, tips, pi, props,
            weights, unroll=unroll, resk=resk, nodot=nodot)
    B, M, T, N1, C, A, S = pernode._check_shapes(post_ops, root, P, tips, pi,
                                                 props, weights)
    Mp = pre_ops.shape[1]
    if tuple(pre_ops.shape) != (B, Mp, 6) or tuple(dP.shape) != tuple(P.shape):
        raise ValueError("pre_ops or dP does not match post_ops and P")
    if tuple(edge_mask.shape) != (B, N1 - 1):
        raise ValueError(f"edge_mask has shape {tuple(edge_mask.shape)}, "
                         f"expected {(B, N1 - 1)}")
    if C != CATEGORIES:
        raise ValueError(f"the variant kernel takes {CATEGORIES} rate "
                         f"categories, got {C}")
    if unroll and (M, Mp) != (UNROLL_M, UNROLL_MP):
        raise ValueError(f"unroll is compiled for M={UNROLL_M}, "
                         f"Mp={UNROLL_MP} only, got M={M}, Mp={Mp}")
    _check_cuda_operands(
        dict(post_ops=post_ops, pre_ops=pre_ops, root=root),
        dict(P=P, dP=dP, tips=tips, pi=pi, props=props, weights=weights,
             edge_mask=edge_mask),
        C, A)
    if onchip is None:
        onchip = pernode.onchip_tape(
            *(x.cpu().numpy() for x in (post_ops, pre_ops, root)), T, N1 - 1,
            P.device)
    NG = onchip.groups.shape[1]
    if unroll and NG != UNROLL_GROUPS:
        raise ValueError(f"unroll is compiled for {UNROLL_GROUPS} parent "
                         f"groups only, got {NG}")
    plan = pernode.onchip_plan(onchip.rows, onchip.ints, N1, C, least=1)
    if plan is None:
        raise ValueError("no warp of patterns of the variant kernel fits in "
                         "shared memory beside the tree's matrices")
    pernode.check_onchip(onchip, B, tips, P, dP)
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.empty((B, N1, S), **kw)
    with torch.cuda.device(P.device):
        rc = _kernels.library().bito_variant_grad(
            onchip.post.data_ptr(), onchip.groups.data_ptr(),
            onchip.zero.data_ptr(), root.data_ptr(), P.data_ptr(),
            dP.data_ptr(), tips.data_ptr(), pi.data_ptr(), props.data_ptr(),
            weights.data_ptr(), ll_rows.data_ptr(), grad_rows.data_ptr(),
            B, M, Mp, NG, onchip.zero.shape[1], T, N1, C, S, onchip.rows,
            plan.cols, int(unroll), resk, int(nodot),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_variant_grad")
    variant_ll_and_gradients.launches += 1
    return pernode.finish_rows(ll_rows, grad_rows, edge_mask, weights)


variant_ll_and_gradients.launches = 0


def flagship_operands(device, batch: int = BATCH, seed: int = 0) -> dict:
    """pernode's float32 operands for the synthetic DS1 shape (27 taxa,
    1,024 padded patterns), GTR+Gamma4 with bench.py's parameters, and
    `batch` random unrooted trees, on `device`."""
    text, alignment = _synthetic.ds1_shaped(seed, batch)
    coll = parse_newick_text(text)
    eng = TreeLikelihoodEngine(
        SitePattern(alignment, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("GTR", "gamma+4")),
        device=device, dtype=torch.float32)
    params = params_from_numpy(_synthetic.GTR_GAMMA4_PARAMS, device,
                               torch.float32)
    enc = eng.encode(coll.trees)
    eig, rates, props, clock = eng._model_ingredients(params, batch)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     eng.branch_length_matrix(coll.trees, enc))
    post_ops, pre_ops, root = (
        torch.as_tensor(x, dtype=torch.int32, device=device)
        for x in (enc.post_ops, enc.pre_ops, enc.root))
    return dict(post_ops=post_ops, pre_ops=pre_ops, root=root,
                edge_mask=torch.as_tensor(enc.edge_mask, dtype=torch.float32,
                                          device=device),
                P=P, dP=dP, tips=eng._kernel_tips, pi=pi, props=prop,
                weights=eng._kernel_weights)


def variant_fn(name: str, ops: dict, onchip=None):
    """A call of variant `name` (one of NAMES) on `ops`, with the on-chip
    tape `onchip` where given."""
    if name == "base":
        return lambda: pernode.pernode_ll_and_gradients(**ops, onchip=onchip)
    return lambda: variant_ll_and_gradients(**ops, **VARIANTS[name],
                                            onchip=onchip)


def onchip_of(ops: dict):
    """The on-chip tape of pernode operands on the card (None on the
    CPU), derived once for every call of the variants."""
    P = ops["P"]
    if P.device.type == "cpu":
        return None
    return pernode.onchip_tape(
        *(ops[k].cpu().numpy() for k in ("post_ops", "pre_ops", "root")),
        ops["tips"].shape[0], P.shape[1] - 1, P.device)


def run_variants(names, ops: dict, reps: int = 20) -> dict:
    """Time each variant (CUDA-event mean over `reps` calls) and print it,
    with its parity against `base` where base ran first, as the script
    prints them.  Returns {name: (ms, ll, grads)}."""
    B = ops["post_ops"].shape[0]
    onchip = onchip_of(ops)
    out = {}
    for name in names:
        fn = variant_fn(name, ops, onchip)
        ll, g = fn()
        ms = cuda_ms(fn, reps)
        print(f"{name:28s} {ms:8.4f} ms  {B / ms * 1e3:9.1f} evals/s  "
              f"ll[0]={float(ll[0]):.4f}", flush=True)
        out[name] = (ms, ll, g)
        if "base" in out and name != "base" and not VARIANTS[name]["nodot"]:
            ll0, g0 = out["base"][1:]
            rel = ((ll - ll0) / ll0).abs().max().item()
            grel = ((g - g0).abs().max() / g0.abs().max()).item()
            print(f"    parity vs base: LL rel {rel:.2e} grad rel {grel:.2e}",
                  flush=True)
    return out


def main(argv=None) -> dict:
    names = list(argv or NAMES)
    for name in names:
        if name not in NAMES:
            raise ValueError(f"unknown variant {name!r}; one of {NAMES}")
    device = require_card()
    print(card_line(), flush=True)
    ops = flagship_operands(device)
    return run_variants(names, ops)


if __name__ == "__main__":
    main(sys.argv[1:])
