"""Chunk lab of the chunked LL kernel: what each part of its body costs.

Counterpart of scripts/perf_chunk_lab.py.  The script swaps its own bodies
(_init_tips_ablate, _ll_kernel_unroll, _chunk_post_ablate,
_chunk_evolve_ablate) into bito_tpu's chunked Pallas LL kernel
(pallas_chunked.py:481) and times the engine's LL call with each.  Here
the knobs are template parameters of the body that the port's chunked LL
kernel ships on the card, the on-chip LL body
(treelike/csrc/paired_ll_onchip.cuh) walking the chunked tape one grid op
at a time, launched through csrc/chunk_variant.cu.  The script's names,
and what each is on the card:
  - v0: the shipping body on the engine's chunked tape (chunked.W = 2);
  - w<W> (W = 2, 4, 8): the shipping body on
    chunked.build_chunked_encoding(enc, W).  W changes only the schedule
    and its padded (trash) ops, since the body runs one op at a time;
  - norescale: no rescale, the running log scale stays 0.  On the DS1
    shape's 26 ops this is still a likelihood in float32;
  - notips: each leaf reads as all ones instead of tips[t, :, s]: what the
    tips' loads cost.  Every LL row is then 0 up to rounding, since P's
    rows sum to 1 (in float32, up to its rounding) and the rescale is
    exact;
  - fixstore: op m's output row is m % R, and a child op c is read from
    row c % R, instead of the tape's rows by liveness: what the row
    lookups cost.  R (`fixstore_rows`) is the least row count, at or above
    the tape's live rows, for which m % R keeps every live output apart
    (12 rows against the tape's 10 at the flagship's W = 2), so it is
    still a likelihood;
  - nodot: P = I, the evolve skipped and the matrices not staged.  Not a
    likelihood: tips that disagree give -inf;
  - unroll: the op walk with its trip count fixed at compile time,
    unrolled over the flagship's chunked M = 28 grid ops; any other tape
    raises.  This is the meaning perf_lab.py gives the script's `unroll`;
  - preponly: times prep.prepare_inputs (float64 model ingredients, P cast
    to float32) and the engine's cached chunked tape, with no kernel;
  - fixedop: times the shipping kernel alone on operands built once,
    captured in a CUDA graph (perflab.graph_ms).
The kernel is instantiated for the knobs above only, each alone, at C = 4
categories with the matrices staged once per block; any other
combination raises.  The script's other names have no counterpart
(NO_COUNTERPART says why).

The plain version, `chunk_variant_ref`, is a float64 torch walk of the same
tape with the same knob, one op at a time over the whole batch, with the
rows by liveness (or fixstore's rows) of treelike/paired.py.  The wrapper
`chunk_variant` sends a CPU tensor to it and a CUDA tensor to the kernel,
and counts its launches in `chunk_variant.launches`.

    python -m bito_tpu_torch.perflab chunk [v0 w4 w8 norescale ...]

prints each variant's evals/s at B = 200 x 40 calls on the synthetic DS1
shape (the reference data is not in the repository), as the script does
(perf_chunk_lab.py:125-217), beside v0's.  It raises without a card.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import card_line, count_launch, cuda_ms, graph_ms, require_card
from .. import _synthetic
from ..convert import params_from_numpy
from ..core.newick import parse_newick_text
from ..core.site_pattern import SitePattern
from ..models.phylo_model import PhyloModel, PhyloModelSpecification
from ..treelike import _kernels, chunked, paired, prep
from ..treelike.engine import TreeLikelihoodEngine

CATEGORIES = 4   # the kernel's instantiations (csrc/chunk_variant.cu)
UNROLL_M = 28    # the flagship's chunked tape: 26 ops in 14 chunks of W = 2
BATCH = 200      # the script's batch and calls a sweep (perf_chunk_lab.py:125)
ITERS = 40
WIDTHS = (2, 4, 8)
# The kernel's variants, numbered as csrc/chunk_variant.cu's enum.
VARIANT_CODES = {"v0": 0, "norescale": 1, "notips": 2, "fixstore": 3,
                 "nodot": 4, "unroll": 5}
# The script's names: the knobs, the tapes of width W, and the two timings.
NAMES = ("v0", *(f"w{W}" for W in WIDTHS), "norescale", "notips",
         "fixstore", "nodot", "unroll", "preponly", "fixedop")
# The script's names that have no counterpart on the card, and why.
NO_COUNTERPART = {
    "nosplit": "the bf16 hi/lo planes of the operands are the v5e matrix "
               "unit's; the card's body evolves in float32 FMAs",
    "g<G>": "the G-way tree interleave of a grid step; here one tree is a "
            "block (blockIdx.y), and the card interleaves blocks itself",
    "noinit": "the on-chip body never fills its rows: every row is written "
              "before it is read, and tips are not copied into slots",
    "blockstore": "a chunk's ops run one after another on the card (one op "
                  "at a time), so there is no W-wide block to store",
}


def _check_shapes(post_dst, tip_slot, post_e, P, tips, pi, props):
    """chunked's shape checks of the LL operands (the kernel takes no
    weights): (B, M, T, N1, C, A, S)."""
    S = tips.shape[-1]
    return chunked._check_chunked(post_dst, tip_slot, post_e, P, tips, pi,
                                  props, tips.new_empty((S,)))


def _check_variant(variant: str) -> None:
    if variant not in VARIANT_CODES:
        raise ValueError(f"unknown variant {variant!r}; the kernel takes "
                         f"{tuple(VARIANT_CODES)}")


def consumers(child: np.ndarray) -> np.ndarray:
    """[B, M] int: the op that reads op m's output (-1 for none)."""
    B, M, _ = child.shape
    cons = np.full((B, M), -1, dtype=np.int64)
    for j in (0, 1):
        b, k = np.nonzero(child[:, :, j] >= 0)
        cons[b, child[b, k, j]] = k
    return cons


def fixstore_rows(post_dst: np.ndarray, child: np.ndarray,
                  least: int) -> int:
    """The least R >= `least` for which op m -> row m % R keeps every live
    output apart: no op that stores between op m and its consumer (which
    reads before it stores) takes m's row."""
    B, M = post_dst.shape
    stored = (post_dst != 2 * M + 1) & (post_dst != 2 * M)
    cons = consumers(child)
    m = np.arange(M)[None, :]
    for R in range(least, M + 1):
        clash = np.zeros((B, M), dtype=bool)
        for d in range(R, M, R):  # the later ops on m's row
            later = np.zeros((B, M), dtype=bool)
            later[:, : M - d] = stored[:, d:]
            clash |= later & (m + d < cons)
        if not clash.any():
            return R
    return M


def rows_of(post_dst: np.ndarray, tip_slot: np.ndarray,
            variant: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(child codes [B, M, 2], each op's output row [B, M], rows a pattern)
    as the body reads them: paired.py's child tape and rows by liveness,
    or fixstore's op m -> row m % R (fixstore_rows)."""
    child = paired.child_tape(post_dst, tip_slot)
    row, rows = paired.live_rows(post_dst, child)
    if variant == "fixstore":
        rows = fixstore_rows(post_dst, child, rows)
        row = np.broadcast_to(np.arange(post_dst.shape[1]) % rows,
                              post_dst.shape)
    return child, row, rows


def chunk_variant_ref(post_dst, tip_slot, post_e, P, tips, pi, props, *,
                      variant: str) -> torch.Tensor:
    """Plain torch version of the variant kernel in float64: per-pattern LL
    rows [B, S] (log of the root's site sum plus the running log scale)."""
    _check_variant(variant)
    dst = post_dst.cpu().numpy()
    child, row, rows = rows_of(dst, tip_slot.cpu().numpy(), variant)
    B, M = dst.shape
    T, A, S = tips.shape
    C = P.shape[2]
    kw = dict(device=P.device, dtype=torch.float64)
    P, tips = P.to(**kw), tips.to(**kw)
    pi, props = pi.to(**kw), props.to(**kw)
    child = torch.as_tensor(child, dtype=torch.long, device=P.device)
    row = torch.as_tensor(np.ascontiguousarray(row), dtype=torch.long,
                          device=P.device)
    e_all = post_e.long().to(P.device)
    buf = torch.zeros((B, rows, C, A, S), **kw)
    lsc = torch.zeros((B, S), **kw)
    ll_rows = torch.zeros((B, S), **kw)
    for m in range(M):
        # the trees whose op m runs (not a padded op)
        tb = torch.as_tensor(np.nonzero(dst[:, m] != 2 * M + 1)[0],
                             device=P.device)
        if tb.numel() == 0:
            continue
        ps = []
        for j in (0, 1):
            code = child[tb, m, j]
            p = torch.ones((tb.numel(), C, A, S), **kw)
            op = code >= 0
            p[op] = buf[tb[op], row[tb[op], code[op]]]
            tip = (code < 0) & (-1 - code < T)
            if variant != "notips":
                p[tip] = tips[-1 - code[tip]][:, None]
            if variant != "nodot":
                p = P[tb, e_all[tb, m, j]] @ p
            ps.append(p)
        prod = ps[0] * ps[1]
        if variant != "norescale":
            mx = prod.amax(dim=(1, 2))
            mx = torch.where(mx > 0, mx, torch.ones_like(mx))
            prod = prod / mx[:, None, None]
            lsc[tb] += torch.log(mx)
        at_root = torch.as_tensor(dst[tb.cpu().numpy(), m] == 2 * M,
                                  device=P.device)
        site = torch.einsum("c,a,ncas->ns", props, pi, prod[at_root])
        ll_rows[tb[at_root]] = torch.log(site) + lsc[tb[at_root]]
        kept = tb[~at_root]
        buf[kept, row[kept, m]] = prod[~at_root]
    return ll_rows


def launch_chunk_variant(post_dst, onchip, post_e, P, tips, pi, props,
                         plan: paired.OnchipPlan, out: torch.Tensor, *,
                         variant: str, rows: int) -> None:
    """Launch csrc/chunk_variant.cu into `out` [B, S] (no allocation, no
    synchronisation: graph_ms can capture it) with `rows` rows a pattern;
    operands checked by the caller."""
    B, M = post_dst.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    with torch.cuda.device(P.device):
        rc = _kernels.library().bito_chunk_variant(
            post_dst.data_ptr(), onchip.child.data_ptr(),
            onchip.live_row.data_ptr(), post_e.data_ptr(), P.data_ptr(),
            tips.data_ptr(), pi.data_ptr(), props.data_ptr(), out.data_ptr(),
            B, M, T, N1, C, S, rows, plan.cols, int(plan.ring),
            VARIANT_CODES[variant], torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_chunk_variant")
    count_launch(chunk_variant)


def variant_rows(variant: str, post_dst, onchip) -> int:
    """Rows a pattern of a variant: the tape's live rows, or fixstore's
    (fixstore_rows, from copies of the tapes on the host)."""
    if variant != "fixstore":
        return onchip.ll_rows
    return fixstore_rows(post_dst.cpu().numpy(), onchip.child.cpu().numpy(),
                         onchip.ll_rows)


def variant_plan(variant: str, rows: int, M: int, N1: int,
                 C: int) -> paired.OnchipPlan:
    """The launch plan of a variant with `rows` rows a pattern: the chunked
    LL wrapper's rule (chunked.ll_plan); the knobs are compiled for its
    staged plan only."""
    plan = chunked.ll_plan(rows, M, N1, C)
    if plan is None:
        raise ValueError("the tape takes the global chunked body, which has "
                         "no variants")
    if variant != "v0" and plan.ring:
        raise ValueError(f"{variant} is compiled with the matrices staged "
                         "once; this tape's plan is the ring")
    return plan


def chunk_variant(post_dst, tip_slot, post_e, P, tips, pi, props, *,
                  variant: str, onchip=None, rows: int | None = None
                  ) -> torch.Tensor:
    """Per-pattern LL rows [B, S] of the chunked tape through variant
    `variant` of the on-chip LL body (CUDA tensors), or its plain version
    (CPU tensors).  `onchip` is the tape's chunked.onchip_tape and `rows`
    the variant's rows a pattern (variant_rows), each derived here where
    it is not given."""
    _check_variant(variant)
    if P.device.type == "cpu":
        return chunk_variant_ref(post_dst, tip_slot, post_e, P, tips, pi,
                                 props, variant=variant)
    B, M, T, N1, C, A, S = _check_shapes(post_dst, tip_slot, post_e, P,
                                         tips, pi, props)
    paired._check_cuda_operands(
        dict(post_dst=post_dst, tip_slot=tip_slot, post_e=post_e),
        dict(P=P, tips=tips, pi=pi, props=props), C, A)
    if C > paired.ONCHIP_CATEGORIES:  # on-chip bodies: a category a lane
        raise ValueError(f"the chunk lab's bodies take 1.."
                         f"{paired.ONCHIP_CATEGORIES} rate categories, "
                         f"got {C}")
    if variant != "v0" and C != CATEGORIES:
        raise ValueError(f"the variants take {CATEGORIES} rate categories, "
                         f"got {C}")
    if variant == "unroll" and M != UNROLL_M:
        raise ValueError(f"unroll is compiled for M={UNROLL_M} grid ops "
                         f"only, got {M}")
    if onchip is None:
        onchip = chunked.onchip_tape(post_dst.cpu().numpy(),
                                     tip_slot.cpu().numpy(), P.device)
    paired._check_onchip(onchip, post_dst, tips, dict(P=P))
    if rows is None:
        rows = variant_rows(variant, post_dst, onchip)
    plan = variant_plan(variant, rows, M, N1, C)
    out = torch.empty((B, S), device=P.device, dtype=torch.float32)
    launch_chunk_variant(post_dst, onchip, post_e, P, tips, pi, props, plan,
                         out, variant=variant, rows=rows)
    return out


chunk_variant.launches = 0


def parse_name(name: str) -> tuple[str, int]:
    """(kernel variant, tape width) of one of the script's names: w<W> is
    v0 at width W; preponly and fixedop time v0's inputs and kernel."""
    if name not in NAMES:
        raise ValueError(f"unknown name {name!r}; one of {NAMES} (no "
                         f"counterpart: {tuple(NO_COUNTERPART)})")
    if name.startswith("w"):
        return "v0", int(name[1:])
    if name in ("preponly", "fixedop"):
        return "v0", chunked.W
    return name, chunked.W


class Flagship:
    """The chunk lab's workload on `device`: the synthetic DS1 shape (27
    taxa, 1,949 columns of 934 distinct), GTR+Gamma4 with bench.py's
    parameters, `batch` random unrooted trees, and the chunked tapes at
    each width, built once."""

    def __init__(self, device, batch: int = BATCH, seed: int = 0):
        text, alignment = _synthetic.ds1_shaped(seed, batch)
        coll = parse_newick_text(text)
        self.trees = coll.trees
        self.engine = TreeLikelihoodEngine(
            SitePattern(alignment, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("GTR", "gamma+4")),
            device=device, dtype=torch.float32)
        self.engine.kernel = "chunked"
        params = params_from_numpy(_synthetic.GTR_GAMMA4_PARAMS, device,
                                   torch.float32)
        self.params = params
        self.enc = self.engine.encode(self.trees)
        self.bl = self.engine.branch_length_matrix(self.trees, self.enc)
        self.eig, self.rates, props, self.clock = (
            self.engine._model_ingredients(params, batch))
        self.pi, self.props = prep.kernel_model(self.eig, props,
                                                self.engine._operand_dtype)
        self.tips = self.engine._kernel_tips
        self.weights = self.engine._kernel_weights
        self._tapes = {}

    def P(self, bl=None) -> torch.Tensor:
        return prep.prepare_inputs(self.eig, self.rates, self.clock,
                                   self.bl if bl is None else bl,
                                   self.engine._operand_dtype)

    def tapes(self, W: int):
        """(post_dst, tip_slot, post_e, onchip) at width W on the device;
        W = chunked.W is the engine's own cached tape."""
        if W not in self._tapes:
            if W == chunked.W:
                dst, tip, e, _row, _mask = self.engine._chunked_tapes(
                    self.enc)
                onchip = self.engine._chunked_onchip_tape(self.enc)
            else:
                ce = chunked.build_chunked_encoding(self.enc, W)
                dst, tip, e = (torch.as_tensor(x, dtype=torch.int32,
                                               device=self.bl.device)
                               for x in (ce.post_dst, ce.tip_slot, ce.post_e))
                onchip = (chunked.onchip_tape(ce.post_dst, ce.tip_slot,
                                              self.bl.device)
                          if self.bl.device.type == "cuda" else None)
            self._tapes[W] = (dst, tip, e, onchip)
        return self._tapes[W]

    def rows_fn(self, name: str):
        """bl -> LL rows [B, S] of variant `name` (not preponly or fixedop):
        P from bl, then the kernel, as the script's fn(bl)."""
        variant, W = parse_name(name)
        dst, tip, e, onchip = self.tapes(W)
        rows = (variant_rows(variant, dst, onchip) if onchip is not None
                else None)

        def fn(bl):
            return chunk_variant(dst, tip, e, self.P(bl), self.tips, self.pi,
                                 self.props, variant=variant, onchip=onchip,
                                 rows=rows)

        return fn


def sweep_ms(call, bl, iters: int = ITERS, repeats: int = 5) -> float:
    """The best of `repeats` sweeps of `iters` calls call(bl * (1 + 0.001
    k)), in milliseconds by CUDA events, after one sweep to warm up: the
    script's timing (perf_chunk_lab.py:205-214)."""
    scaled = [bl * (1.0 + 0.001 * k) for k in range(iters)]

    def sweep():
        for b in scaled:
            call(b)

    sweep()
    return min(cuda_ms(sweep, 1, warmup=0) for _ in range(repeats))


def fixedop_ms(flagship: Flagship, reps: int = ITERS) -> float:
    """Milliseconds of the shipping kernel alone (v0) on operands built
    once: `reps` launches captured in a CUDA graph (perflab.graph_ms)."""
    dst, _tip, e, onchip = flagship.tapes(chunked.W)
    P = flagship.P()
    plan = variant_plan("v0", onchip.ll_rows, dst.shape[1], P.shape[1],
                        P.shape[2])
    out = torch.empty((dst.shape[0], flagship.tips.shape[-1]),
                      device=P.device, dtype=torch.float32)
    return graph_ms(lambda: launch_chunk_variant(
        dst, onchip, e, P, flagship.tips, flagship.pi, flagship.props, plan,
        out, variant="v0", rows=onchip.ll_rows), reps, counter=chunk_variant)


def preponly_call(flagship: Flagship):
    """bl -> the inputs of one chunked LL call without its kernel: P from
    float64 model ingredients, cast to float32, and the cached tape."""
    def call(bl):
        flagship.engine._chunked_tapes(flagship.enc)
        return flagship.P(bl)

    return call


def run(names, flagship: Flagship, iters: int = ITERS,
        repeats: int = 5) -> dict:
    """Time each name as the script does and print it, with evals/s
    (batch x iters / best sweep) and, for the variants, the LL of tree 0
    and the largest LL difference from v0's where v0 ran first.  Returns
    {name: (ms a sweep, LL [B] or None)}."""
    B = flagship.bl.shape[0]
    w = flagship.weights
    # Warm the card up (clocks, caches, the kernel library) on v0 first.
    sweep_ms(flagship.rows_fn("v0"), flagship.bl, iters, 3)
    out = {}
    for name in names:
        if name == "fixedop":
            ms, ll = fixedop_ms(flagship, iters) * iters, None
        elif name == "preponly":
            ms, ll = sweep_ms(preponly_call(flagship), flagship.bl, iters,
                              repeats), None
        else:
            fn = flagship.rows_fn(name)
            ll = fn(flagship.bl) @ w
            ms = sweep_ms(fn, flagship.bl, iters, repeats)
        line = (f"{name:12s} best {ms:9.4f} ms  {B * iters / ms * 1e3:11.1f} "
                f"evals/s")
        if ll is not None:
            line += f"  ll[0]={float(ll[0]):.4f}"
            if "v0" in out and name != "v0":
                base = out["v0"][1]
                both = torch.isfinite(ll) & torch.isfinite(base)
                line += (f"  max |ll - v0| {float((ll - base)[both].abs().max()):.3e}"
                         if both.any() else "")
        if "v0" in out:
            line += f"  ({out['v0'][0] / ms:.3f}x v0)"
        print(line, flush=True)
        out[name] = (ms, ll)
    return out


def main(argv=None) -> dict:
    names = list(argv or NAMES)
    for name in names:
        parse_name(name)
    device = require_card()
    print(card_line(), flush=True)
    print(f"# chunk lab: B={BATCH} x {ITERS} calls a sweep, best of 5, "
          f"synthetic DS1 shape, GTR+Gamma4; no counterpart: "
          + "; ".join(f"{k} ({v})" for k, v in NO_COUNTERPART.items()),
          flush=True)
    return run(names, Flagship(device))


if __name__ == "__main__":
    main(sys.argv[1:])
