"""Shared inputs for the tests that hold bito_tpu_torch against bito_tpu.

Both packages get the same Newick text and alignment (bito_tpu_torch's
seeded _synthetic generator) and the same numpy parameters, and each
builds its own engine from them.
"""
from __future__ import annotations

import ast
import contextlib
import math
import pathlib
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import torch

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.core.site_pattern import SitePattern as JaxSitePattern
from bito_tpu.models.phylo_model import PhyloModel as JaxModel
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.treelike.engine import TreeLikelihoodEngine as JaxEngine
from bito_tpu_torch import TEST_DEVICE, TEST_DTYPE, _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import paired, prep
from bito_tpu_torch.treelike.encode import TreeBatchEncoding
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

GTR = _synthetic.GTR_GAMMA4_PARAMS

# name -> ((substitution, site), numpy parameters)
MODELS = {
    "gtr_gamma4": (("GTR", "gamma+4"), GTR),
    "jc69": (("JC69", "constant"), {}),
    "hky_weibull4": (("HKY", "weibull+4"), {
        "substitution_model_rates": np.array([2.5]),
        "substitution_model_frequencies": np.array([0.2, 0.3, 0.3, 0.2]),
        "site_model_parameters": np.array([1.3]),
    }),
}


@dataclass
class Case:
    text: str
    alignment: dict
    jax_trees: list
    torch_trees: list
    jax_pattern: JaxSitePattern
    torch_pattern: SitePattern


def make_case(seed: int, num_taxa: int = 8, num_sites: int = 150,
              num_trees: int = 4, rooted: bool = False) -> Case:
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees, rooted)
    jc, tc = jax_parse(text), parse_newick_text(text)
    aln = _synthetic.random_alignment(seed + 1, tc.taxon_names, num_sites)
    return Case(text, aln, jc.trees, tc.trees,
                JaxSitePattern(aln, jc.taxon_names),
                SitePattern(aln, tc.taxon_names))


@contextlib.contextmanager
def one_torch_thread():
    """torch on one intra-op thread inside the block.  The tests' small
    torch ops, run by the suite's six workers at once, are slowed many
    times over by their contending thread pools (28 s against 0.9 s for
    test_torch_categories.py's emulations beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def per_tree_rows(params: dict, batch: int, seed: int) -> dict:
    """Per-tree [B, k] parameter rows: each block perturbed and, where it
    is a simplex, renormalised."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, v in params.items():
        rows = v[None, :] * rng.uniform(0.8, 1.25, size=(batch, v.size))
        if key in ("substitution_model_rates",
                   "substitution_model_frequencies") and v.size > 1:
            rows = rows / rows.sum(axis=1, keepdims=True)
        out[key] = rows
    return out


def jax_engine(case: Case, model: str) -> JaxEngine:
    eng = JaxEngine(case.jax_pattern, JaxModel(JaxSpec(*MODELS[model][0])))
    eng.kernel = "scan"
    return eng


def torch_engine(case: Case, model: str, dtype=TEST_DTYPE,
                 device=TEST_DEVICE) -> TreeLikelihoodEngine:
    return TreeLikelihoodEngine(
        case.torch_pattern, PhyloModel(PhyloModelSpecification(*MODELS[model][0])),
        device=device, dtype=dtype)


def jax_params(params: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in params.items()}


def torch_params(params: dict, dtype=TEST_DTYPE, device=TEST_DEVICE) -> dict:
    return params_from_numpy(params, device, dtype)


def pernode_operands(te: TreeLikelihoodEngine, case: Case, params: dict,
                     dtype=torch.float32):
    """The per-node kernels' operands from the port's engine: (the LL
    kernel's keyword arguments, the grad kernel's extra ones)."""
    enc = te.encode(case.torch_trees)
    bl = te.branch_length_matrix(case.torch_trees, enc)
    eig, rates, props, clock = te._model_ingredients(torch_params(params),
                                                     len(case.torch_trees))
    pi, prop = prep.kernel_model(eig, props, dtype)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl, dtype)
    post_ops, pre_ops, root = (torch.as_tensor(x, dtype=torch.int32) for x in (
        enc.post_ops, enc.pre_ops, enc.root))
    ops = dict(post_ops=post_ops, root=root, P=P,
               tips=te._kernel_tips.to(dtype), pi=pi, props=prop,
               weights=te._kernel_weights.to(dtype))
    return ops, dict(pre_ops=pre_ops, dP=dP,
                     edge_mask=torch.as_tensor(enc.edge_mask, dtype=dtype))


def paired_launches() -> tuple:
    """The launch counts of the four paired bodies (on-chip and global, LL
    and grad)."""
    return tuple(f.launches for f in (
        paired.paired_ll_onchip, paired.paired_ll_global,
        paired.paired_grad_onchip, paired.paired_grad_global))


# ---------------------------------------------------------------------------
# The float64 emulation of the on-chip LL body (csrc/paired_ll_onchip.cu),
# which walks the paired, chunked and per-node tapes alike
# ---------------------------------------------------------------------------

def leaf_value(code, tips, C):
    """A child that is not an op's output: tip t in place, or all ones."""
    T, A, S = tips.shape
    if code < 0 and -1 - code < T:
        return tips[-1 - code][None].expand(C, A, S)
    return torch.ones((C, A, S), dtype=tips.dtype)


def rescale_pow2(x):
    """x scaled by 2^-e per pattern (the last axis), e the exponent that
    puts its largest entry in [0.5, 1) (0 where that entry is not
    positive), and e."""
    mx = x.amax(dim=tuple(range(x.dim() - 1)))
    e = torch.where(mx > 0, torch.frexp(mx).exponent, 0)
    return x * torch.pow(2.0, -e.to(x.dtype)), e


def emulate_postorder(b, dst, child, e, row, rows, P, tips, pi, props):
    """Tree b's postorder as the on-chip bodies run it, one op at a time:
    op m's output to rows[row(m)], a running log scale; returns the LL
    rows [S]."""
    M = dst.shape[1]
    C, A, S = P.shape[2], P.shape[3], tips.shape[-1]
    lsc = torch.zeros(S, dtype=torch.int64)  # the log scale in powers of 2
    ll = None
    for m in range(M):
        if dst[b, m] == 2 * M + 1:
            continue
        p = [rows[row(int(c))] if c >= 0 else leaf_value(int(c), tips, C)
             for c in child[b, m]]
        ev = [torch.einsum("cak,cks->cas", P[b, int(e[b, m, j])], p[j])
              for j in (0, 1)]
        prod, ex = rescale_pow2(ev[0] * ev[1])
        lsc = lsc + ex
        if dst[b, m] == 2 * M:
            site = torch.einsum("c,a,cas->s", props, pi, prod)
            ll = torch.log(site) + lsc.to(P.dtype) * math.log(2.0)
        else:
            rows[row(m)] = prod
    return ll


def emulate_ll(dst, child, live_row, e, P, tips, pi, props, weights):
    """Per-tree log likelihoods [B] as the on-chip LL body computes them
    over a tape of the paired layout (post_dst `dst`, child codes, rows by
    liveness, edges), in the operands' dtype."""
    B, M = dst.shape
    C, A, S = P.shape[2], P.shape[3], tips.shape[-1]
    peak = int(live_row.max()) + 1
    ll = torch.stack([
        emulate_postorder(b, dst, child, e,
                          lambda m, b=b: int(live_row[b, m]),
                          torch.zeros((peak, C, A, S), dtype=P.dtype), P,
                          tips, pi, props)
        for b in range(B)])
    return ll @ weights


def emulate_grad(dst, child, src, e, edge_mask, P, dP, tips, pi, props,
                 weights):
    """(log likelihoods [B], gradients [B, N]) as the on-chip grad body
    (csrc/paired_grad_onchip.cu) computes them over a paired tape: the
    postorder into row m per op, then the outside values over them in
    reverse, in the operands' dtype."""
    B, M = dst.shape
    N1, C, A = P.shape[1], P.shape[2], P.shape[3]
    S = tips.shape[-1]
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.zeros((B, N1, S), dtype=P.dtype)
    for b in range(B):
        rows = torch.zeros((M, C, A, S), dtype=P.dtype)
        ll_rows[b] = emulate_postorder(b, dst, child, e, lambda m: m, rows,
                                       P, tips, pi, props)
        for m in range(M - 1, -1, -1):
            if dst[b, m] == 2 * M + 1:
                continue
            up = (pi[None, :, None].expand(C, A, S) if dst[b, m] == 2 * M
                  else rows[m])
            cs = [int(c) for c in child[b, m]]
            p = [rows[c] if c >= 0 else leaf_value(c, tips, C) for c in cs]
            Pj = [P[b, int(e[b, m, j])] for j in (0, 1)]
            dPj = [dP[b, int(e[b, m, j])] for j in (0, 1)]
            ev = [torch.einsum("cak,cks->cas", Pj[j], p[j]) for j in (0, 1)]
            o, _ = rescale_pow2(
                torch.stack([up * ev[1], up * ev[0]]).flatten(0, 1))
            o = o.unflatten(0, (2, C))
            for j in (0, 1):
                dv = torch.einsum("cak,cks->cas", dPj[j], p[j])
                num = torch.einsum("c,cas->s", props, o[j] * dv)
                den = torch.einsum("c,cas->s", props, o[j] * ev[j])
                den = torch.where(den > 0, den, torch.ones_like(den))
                grad_rows[b, int(src[b, m, j])] = weights * num / den
                if cs[j] >= 0:  # the child op's outside value, in place
                    rows[cs[j]] = torch.einsum("cak,cas->cks", Pj[j], o[j])
    N = edge_mask.shape[1]
    return (ll_rows @ weights,
            grad_rows.sum(dim=-1)[:, :N] * edge_mask.to(P.dtype))


def emulate_lanes_chunked(dst, child, e, P, dP, tips, pi, props, weights):
    """(ll_rows [B, S], grad_rows [B, 2MW+1, S]) as the global lane bodies
    (csrc/paired_lanes.cuh, kChunked) compute them on the chunked tape:
    one grid op at a time over pair slots [2MW+3] (op g reads slots 2g and
    2g+1 where its child code names an op, a tip in place or ones
    otherwise, and writes slot dst[g]; 2MW the root, 2MW+1 the trash
    slot), a running power-of-two log scale, then the outside pass in
    reverse: the up value from slot dst[g] (pi at the root), gradient rows
    2g and 2g+1, and P^T o over slots 2g+j where an op's output was.  In
    the operands' dtype."""
    B, MW = dst.shape
    C, A, S = P.shape[2], P.shape[3], tips.shape[-1]
    root, trash = 2 * MW, 2 * MW + 1
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.zeros((B, 2 * MW + 1, S), dtype=P.dtype)
    for b in range(B):
        slots = torch.full((2 * MW + 3, C, A, S), float("nan"),
                           dtype=P.dtype)

        def child_of(g, j):
            code = int(child[b, g, j])
            return (slots[2 * g + j] if code >= 0
                    else leaf_value(code, tips, C))

        lsc = torch.zeros(S, dtype=torch.int64)
        for g in range(MW):
            if dst[b, g] == trash:
                continue
            ev = [torch.einsum("cak,cks->cas", P[b, int(e[b, g, j])],
                               child_of(g, j)) for j in (0, 1)]
            prod, ex = rescale_pow2(ev[0] * ev[1])
            lsc = lsc + ex
            if dst[b, g] == root:
                site = torch.einsum("c,a,cas->s", props, pi, prod)
            else:
                slots[int(dst[b, g])] = prod
        ll_rows[b] = torch.log(site) + lsc.to(P.dtype) * math.log(2.0)
        for g in range(MW - 1, -1, -1):
            if dst[b, g] == trash:
                continue
            up = (pi[None, :, None].expand(C, A, S) if dst[b, g] == root
                  else slots[int(dst[b, g])])
            p = [child_of(g, j) for j in (0, 1)]
            Pj = [P[b, int(e[b, g, j])] for j in (0, 1)]
            ev = [torch.einsum("cak,cks->cas", Pj[j], p[j]) for j in (0, 1)]
            o, _ = rescale_pow2(
                torch.stack([up * ev[1], up * ev[0]]).flatten(0, 1))
            o = o.unflatten(0, (2, C))
            for j in (0, 1):
                dv = torch.einsum("cak,cks->cas", dP[b, int(e[b, g, j])],
                                  p[j])
                num = torch.einsum("c,cas->s", props, o[j] * dv)
                den = torch.einsum("c,cas->s", props, o[j] * ev[j])
                den = torch.where(den > 0, den, torch.ones_like(den))
                grad_rows[b, 2 * g + j] = weights * num / den
            for j in (0, 1):
                if int(child[b, g, j]) >= 0:
                    slots[2 * g + j] = torch.einsum("cak,cas->cks", Pj[j],
                                                    o[j])
    return ll_rows, grad_rows


def emulate_lanes_pernode(post_ops, pre_ops, root, P, dP, tips, pi, props,
                          weights):
    """(ll_rows [B, S], grad_rows [B, N1, S]) as the per-node global lane
    bodies (csrc/pernode_lanes.cuh) compute them: post_ops in order into
    rows by internal node (a tip in place, the dummy N as ones, both
    evolved through the op's edge), a running power-of-two log scale, the
    root's row for the LL; then pre_ops in order with the up values in
    rows of their own: o = up[parent] (pi at the root) times both evolved
    siblings, rescaled, node dest's gradient row, up[dest] = P^T o for an
    internal dest.  In the operands' dtype."""
    B, N1, C, A = P.shape[:4]
    T, S = tips.shape[0], tips.shape[-1]
    N = N1 - 1
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.zeros((B, N1, S), dtype=P.dtype)
    ones = torch.ones((C, A, S), dtype=P.dtype)
    for b in range(B):
        rows = torch.full((N1 - T, C, A, S), float("nan"), dtype=P.dtype)
        ups = torch.full((N1 - T, C, A, S), float("nan"), dtype=P.dtype)

        def value(n):
            if n < T:
                return tips[n][None].expand(C, A, S)
            return ones if n == N else rows[n - T]

        def ev(e, n):
            return torch.einsum("cak,cks->cas", P[b, e], value(n))

        lsc = torch.zeros(S, dtype=torch.int64)
        for u, s1, e1, s2, e2 in post_ops[b].tolist():
            if u == N:
                continue
            prod, ex = rescale_pow2(ev(e1, s1) * ev(e2, s2))
            lsc = lsc + ex
            rows[u - T] = prod
        r = int(root[b])
        site = torch.einsum("c,a,cas->s", props, pi, rows[r - T])
        ll_rows[b] = torch.log(site) + lsc.to(P.dtype) * math.log(2.0)
        for c, v, s1, e1, s2, e2 in pre_ops[b].tolist():
            if c == N:
                continue
            up = pi[None, :, None].expand(C, A, S) if v == r else ups[v - T]
            o, _ = rescale_pow2(up * ev(e1, s1) * ev(e2, s2))
            p = value(c)
            num = torch.einsum("c,cas->s", props, o * torch.einsum(
                "cak,cks->cas", dP[b, c], p))
            den = torch.einsum("c,cas->s", props, o * ev(c, c))
            den = torch.where(den > 0, den, torch.ones_like(den))
            grad_rows[b, c] = weights * num / den
            if c >= T:
                ups[c - T] = torch.einsum("cak,cas->cks", P[b, c], o)
    return ll_rows, grad_rows


# ---------------------------------------------------------------------------
# The float64 emulation of the wide kernels (csrc/paired_lanes.cuh and
# csrc/pernode_lanes.cuh past 32 categories): K categories a lane of 32
# ---------------------------------------------------------------------------

WIDE_LANES = 32  # paired_lanes.cuh kWideLanes


class WideSlots:
    """The wide kernels' slots as one flat buffer of float4 entries [B,
    NS, Sp, K, 32] (Sp = S rounded up to a block's 4 patterns), read and
    written at the kernels' offsets (((b NS + j) Sp + s) K + k) 32 + g,
    every pattern column s, place k and lane g of slot j at once: values
    [Sp, K, 32, 4].  Lane g's k-th place holds category g + 32 k."""

    def __init__(self, B, NS, S, C, dtype):
        self.NS, self.K = NS, paired.lane_categories(C)
        self.Sp = -(-S // (paired.GLOBAL_THREADS // WIDE_LANES)) * (
            paired.GLOBAL_THREADS // WIDE_LANES)
        self.flat = torch.full((B * NS * self.Sp * self.K * WIDE_LANES, 4),
                               float("nan"), dtype=dtype)
        s = torch.arange(self.Sp)[:, None, None]
        k = torch.arange(self.K)[None, :, None]
        g = torch.arange(WIDE_LANES)[None, None, :]
        self._col = (s * self.K + k) * WIDE_LANES + g

    def _at(self, b, j):
        return ((b * self.NS + j) * self.Sp) * self.K * WIDE_LANES + self._col

    def __getitem__(self, bj):
        return self.flat[self._at(*bj)]

    def __setitem__(self, bj, value):
        self.flat[self._at(*bj)] = value


def _wide_model(P, dP, tips, props, K):
    """(matrices of tree b's edge e as [K, 32, 4, 4], zero past C; the
    proportions [K, 32], zero past C; the tips at each pattern column
    [T, Sp, 1, 1, 4], a column past S reading pattern S - 1)."""
    C, S = P.shape[2], tips.shape[-1]

    def lanes(x):
        out = torch.zeros((K * WIDE_LANES,) + x.shape[1:], dtype=x.dtype)
        out[:C] = x
        return out.unflatten(0, (K, WIDE_LANES))

    def mats(M, b, e):
        return lanes(M[b, int(e)])

    return mats, lanes(props), tips


def _wide_evolve(Pe, x):
    return torch.einsum("kgab,skgb->skga", Pe, x)


def _wide_evolve_t(Pe, o):
    return torch.einsum("kgba,skgb->skga", Pe, o)


def _wide_exponent(x):
    """The exponent of the group's largest entry per pattern column (0
    where it is not positive), as onchip::scale_exponent."""
    mx = x.flatten(1).amax(dim=1)
    return torch.where(mx > 0, torch.frexp(mx).exponent, 0)


def _pow2(e, dtype):
    return torch.pow(2.0, -e.to(dtype))[:, None, None, None]


def emulate_wide_paired(dst, tip, src, e, P, dP, tips, pi, props, weights,
                        chunked):
    """(ll_rows [B, S], grad_rows [B, NR, S]) as the wide kernels
    (csrc/paired_lanes.cuh wide_ll_kernel / wide_grad_kernel) compute
    them past 32 categories, in the operands' dtype: on the paired tape
    (chunked False: `tip` the tips' slots, gradient rows post_src `src`,
    NR = N1) or on the chunked tape (True: `tip` the child codes [B, MW,
    2], rows 2g + j, NR = 2MW + 1); the slots in the wide layout
    (WideSlots); each op in two passes over a lane's places, the first
    storing the products unscaled (postorder) or taking the largest o
    (outside pass), the second scaling in place or forming everything
    from the scaled o."""
    B, M = dst.shape
    N1, C = P.shape[1], P.shape[2]
    T, S = tips.shape[0], tips.shape[-1]
    root, trash = 2 * M, 2 * M + 1
    slots = WideSlots(B, 2 * M + 3, S, C, P.dtype)
    K, Sp = slots.K, slots.Sp
    mats, prop_k, _ = _wide_model(P, dP, tips, props, K)
    shape = (Sp, K, WIDE_LANES, 4)
    cols = torch.arange(Sp).clamp(max=S - 1)
    tip_cols = tips[:, :, cols].transpose(1, 2)[:, :, None, None, :]
    w = weights[cols]
    ones = torch.ones(shape, dtype=P.dtype)
    pi4 = pi.expand(shape)

    def child(b, m, j):
        if chunked:
            code = int(tip[b, m, j])
            if code < 0:
                return (tip_cols[-1 - code].expand(shape) if -1 - code < T
                        else ones)
        return slots[b, 2 * m + j]

    NR = 2 * M + 1 if chunked else N1
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.zeros((B, NR, S), dtype=P.dtype)
    for b in range(B):
        if not chunked:
            for t in range(T):
                slots[b, int(tip[b, t])] = tip_cols[t].expand(shape)
        lsc = torch.zeros(Sp, dtype=torch.int64)
        for m in range(M):
            d = int(dst[b, m])
            if d == trash:
                continue
            prod = (_wide_evolve(mats(P, b, e[b, m, 0]), child(b, m, 0))
                    * _wide_evolve(mats(P, b, e[b, m, 1]), child(b, m, 1)))
            slots[b, d] = prod
            ex = _wide_exponent(prod)
            p = slots[b, d] * _pow2(ex, P.dtype)
            lsc = lsc + ex
            if d == root:
                site = torch.einsum("kg,a,skga->s", prop_k, pi, p)
            else:
                slots[b, d] = p
        ll_rows[b] = (torch.log(site) + lsc.to(P.dtype) * math.log(2.0))[:S]
        for m in range(M - 1, -1, -1):
            d = int(dst[b, m])
            if d == trash:
                continue
            P0, P1 = mats(P, b, e[b, m, 0]), mats(P, b, e[b, m, 1])
            p0, p1 = child(b, m, 0), child(b, m, 1)
            ev0, ev1 = _wide_evolve(P0, p0), _wide_evolve(P1, p1)
            up = pi4 if d == root else slots[b, d]
            inv = _pow2(_wide_exponent(torch.stack([up * ev1, up * ev0],
                                                   1)), P.dtype)
            o0, o1 = up * ev1 * inv, up * ev0 * inv
            for j, (o, ev, pj, Pj) in enumerate(((o0, ev0, p0, P0),
                                                  (o1, ev1, p1, P1))):
                dv = _wide_evolve(mats(dP, b, e[b, m, j]), pj)
                num = torch.einsum("kg,skga->s", prop_k, o * dv)
                den = torch.einsum("kg,skga->s", prop_k, o * ev)
                den = torch.where(den > 0, den, torch.ones_like(den))
                r = 2 * m + j if chunked else int(src[b, m, j])
                grad_rows[b, r] = (w * num / den)[:S]
                if not chunked or int(tip[b, m, j]) >= 0:
                    slots[b, 2 * m + j] = _wide_evolve_t(Pj, o)
    return ll_rows, grad_rows


def emulate_wide_pernode(post_ops, pre_ops, root, P, dP, tips, pi, props,
                         weights):
    """(ll_rows [B, S], grad_rows [B, N1, S]) as the per-node wide kernels
    (csrc/pernode_lanes.cuh wide_ll_kernel / wide_grad_kernel) compute
    them past 32 categories, in the operands' dtype: post_ops into rows
    by internal node in the wide layout (a tip in place, the dummy N as
    ones), products stored unscaled then scaled in place; pre_ops with the
    up values in rows of their own, the largest o first, then the scaled
    o's sums and up[dest]."""
    B, N1, C = P.shape[:3]
    T, S = tips.shape[0], tips.shape[-1]
    N = N1 - 1
    rows = WideSlots(B, N1 - T, S, C, P.dtype)
    ups = WideSlots(B, N1 - T, S, C, P.dtype)
    K, Sp = rows.K, rows.Sp
    mats, prop_k, _ = _wide_model(P, dP, tips, props, K)
    shape = (Sp, K, WIDE_LANES, 4)
    cols = torch.arange(Sp).clamp(max=S - 1)
    tip_cols = tips[:, :, cols].transpose(1, 2)[:, :, None, None, :]
    w = weights[cols]
    ones = torch.ones(shape, dtype=P.dtype)
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.zeros((B, N1, S), dtype=P.dtype)
    for b in range(B):
        def value(n):
            if n < T:
                return tip_cols[n].expand(shape)
            return ones if n == N else rows[b, n - T]

        def ev(edge, n):
            return _wide_evolve(mats(P, b, edge), value(n))

        lsc = torch.zeros(Sp, dtype=torch.int64)
        for u, s1, e1, s2, e2 in post_ops[b].tolist():
            if u == N:
                continue
            rows[b, u - T] = ev(e1, s1) * ev(e2, s2)
            ex = _wide_exponent(rows[b, u - T])
            rows[b, u - T] = rows[b, u - T] * _pow2(ex, P.dtype)
            lsc = lsc + ex
        r = int(root[b])
        site = torch.einsum("kg,a,skga->s", prop_k, pi, rows[b, r - T])
        ll_rows[b] = (torch.log(site) + lsc.to(P.dtype) * math.log(2.0))[:S]
        for c, v, s1, e1, s2, e2 in pre_ops[b].tolist():
            if c == N:
                continue
            up = pi.expand(shape) if v == r else ups[b, v - T]
            o = up * ev(e1, s1) * ev(e2, s2)
            o = o * _pow2(_wide_exponent(o), P.dtype)
            p = value(c)
            num = torch.einsum("kg,skga->s", prop_k,
                               o * _wide_evolve(mats(dP, b, c), p))
            den = torch.einsum("kg,skga->s", prop_k, o * ev(c, c))
            den = torch.where(den > 0, den, torch.ones_like(den))
            grad_rows[b, c] = (w * num / den)[:S]
            if c >= T:
                ups[b, c - T] = _wide_evolve_t(mats(P, b, c), o)
    return ll_rows, grad_rows


# ---------------------------------------------------------------------------
# The float64 emulation of the on-chip bodies with K categories a lane
# (csrc/paired_ll_onchip.cuh, csrc/paired_grad_onchip.cu past 32 and, at
# K = 1, on 32 lanes): rows in shared memory, K x 512 bytes a pattern
# ---------------------------------------------------------------------------

class OnchipRows:
    """A block's rows of the on-chip bodies, [R][K][threads] float4 with
    threads = 32 Sp (one block of all Sp patterns, a warp each), as one
    flat buffer read and written at the kernels' offsets
    (r K + k) threads + 32 x + g: place k of lane g of pattern x of row r.
    Every pattern, place and lane of a row at once: values [Sp, K, 32, 4];
    lane g's place k holds category g + 32 k (c mod 32, c div 32)."""

    def __init__(self, R, S, C, dtype):
        self.K, self.Sp = paired.lane_categories(C), S
        self.threads = WIDE_LANES * S
        self.flat = torch.full((R * self.K * self.threads, 4), float("nan"),
                               dtype=dtype)
        x = torch.arange(S)[:, None, None]
        k = torch.arange(self.K)[None, :, None]
        g = torch.arange(WIDE_LANES)[None, None, :]
        self._col = k * self.threads + x * WIDE_LANES + g

    def _at(self, r):
        return r * self.K * self.threads + self._col

    def __getitem__(self, r):
        return self.flat[self._at(r)]

    def __setitem__(self, r, value):
        self.flat[self._at(r)] = value


def _onchip_child(rows, row_of, code, tip_cols, shape, T):
    """A child's value [Sp, K, 32, 4]: an op's output from its row, tip t
    in place, or all ones."""
    if code >= 0:
        return rows[row_of(code)]
    if -1 - code < T:
        return tip_cols[-1 - code].expand(shape)
    return torch.ones(shape, dtype=tip_cols.dtype)


def _onchip_postorder(b, dst, child, e, rows, row_of, mats, prop_k, pi,
                      tip_cols, shape, P):
    """Tree b's postorder as the K bodies run it: per op the K products of
    each lane, the largest entry over the places and the warp, one scaling
    by its power of two, one store; the LL rows [S] at the root op."""
    M = dst.shape[1]
    T = tip_cols.shape[0]
    lsc = torch.zeros(shape[0], dtype=torch.int64)
    for m in range(M):
        d = int(dst[b, m])
        if d == 2 * M + 1:
            continue
        p = [_onchip_child(rows, row_of, int(child[b, m, j]), tip_cols,
                           shape, T) for j in (0, 1)]
        prod = (_wide_evolve(mats(P, b, e[b, m, 0]), p[0])
                * _wide_evolve(mats(P, b, e[b, m, 1]), p[1]))
        ex = _wide_exponent(prod)
        prod = prod * _pow2(ex, P.dtype)
        lsc = lsc + ex
        if d == 2 * M:
            site = torch.einsum("kg,a,skga->s", prop_k, pi, prod)
            ll = torch.log(site) + lsc.to(P.dtype) * math.log(2.0)
        else:
            rows[row_of(m)] = prod
    return ll


def _onchip_model(P, dP, tips, props):
    """(mats, prop_k, tip_cols [T, S, 1, 1, 4], value shape) of the K
    layout: matrices and proportions zero past C (idle places)."""
    K = paired.lane_categories(P.shape[2])
    S = tips.shape[-1]
    mats, prop_k, _ = _wide_model(P, dP, tips, props, K)
    return (mats, prop_k, tips.transpose(1, 2)[:, :, None, None, :],
            (S, K, WIDE_LANES, 4))


def emulate_onchip_k_ll(dst, child, live_row, e, P, tips, pi, props,
                        weights):
    """Per-tree log likelihoods [B] as the on-chip LL body computes them
    with K = ceil(C / 32) categories a lane of 32 (at C <= 32, K = 1 on 32
    lanes), over a tape of the paired layout (post_dst `dst`, child codes,
    rows by liveness, edges), the rows at the kernel's offsets
    (OnchipRows), in the operands' dtype."""
    B = dst.shape[0]
    mats, prop_k, tip_cols, shape = _onchip_model(P, P, tips, props)
    peak = int(live_row.max()) + 1
    ll = []
    for b in range(B):
        rows = OnchipRows(peak, tips.shape[-1], P.shape[2], P.dtype)
        ll.append(_onchip_postorder(
            b, dst, child, e, rows, lambda m, b=b: int(live_row[b, m]),
            mats, prop_k, pi, tip_cols, shape, P))
    return torch.stack(ll) @ weights


def emulate_onchip_k_grad(dst, child, src, e, P, dP, tips, pi, props,
                          weights):
    """(ll_rows [B, S], grad_rows [B, N1, S]) as the on-chip grad body
    computes them with K = ceil(C / 32) categories a lane of 32, over a
    tape of the paired layout: op m's output in row m (rows by producer
    op, at the kernel's offsets), then the outside pass in reverse, one
    pass over the places: o0 = up ev1 and o1 = up ev0 formed once, the
    gradient's sums over the unscaled o's, then scaled by the power of
    two of the largest o (exact), child j's row src[b, m, j] (rows no op
    writes stay zero), and each child op's up value P^T o over its row.
    In the operands' dtype."""
    B, M = dst.shape
    N1, S = P.shape[1], tips.shape[-1]
    mats, prop_k, tip_cols, shape = _onchip_model(P, dP, tips, props)
    T = tip_cols.shape[0]
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.zeros((B, N1, S), dtype=P.dtype)
    for b in range(B):
        rows = OnchipRows(M, S, P.shape[2], P.dtype)
        ll_rows[b] = _onchip_postorder(b, dst, child, e, rows, lambda m: m,
                                       mats, prop_k, pi, tip_cols, shape, P)
        for m in range(M - 1, -1, -1):
            d = int(dst[b, m])
            if d == 2 * M + 1:
                continue
            up = pi.expand(shape) if d == 2 * M else rows[m]
            cs = [int(c) for c in child[b, m]]
            p = [_onchip_child(rows, lambda c: c, c, tip_cols, shape, T)
                 for c in cs]
            Pj = [mats(P, b, e[b, m, j]) for j in (0, 1)]
            ev = [_wide_evolve(Pj[j], p[j]) for j in (0, 1)]
            o = [up * ev[1], up * ev[0]]
            num = [torch.einsum("kg,skga->s", prop_k, o[j] * _wide_evolve(
                mats(dP, b, e[b, m, j]), p[j])) for j in (0, 1)]
            den = [torch.einsum("kg,skga->s", prop_k, o[j] * ev[j])
                   for j in (0, 1)]
            inv = _pow2(_wide_exponent(torch.stack(o, 1)), P.dtype)
            for j in (0, 1):
                n, dn = num[j] * inv.flatten(), den[j] * inv.flatten()
                dn = torch.where(dn > 0, dn, torch.ones_like(dn))
                grad_rows[b, int(src[b, m, j])] = weights * n / dn
                if cs[j] >= 0:  # the child op's outside value, in place
                    rows[cs[j]] = _wide_evolve_t(Pj[j], o[j] * inv)
    return ll_rows, grad_rows


def check_live_rows(dst, child, row, peak):
    """Rows by liveness (paired.live_rows) on a tape of the paired layout:
    every stored output keeps its row until the op that reads it, and is
    read; no two live outputs share a row; every row is below `peak`."""
    B, M = dst.shape
    for b in range(B):
        holder = {}  # row -> op whose output it holds
        for m in range(M):
            if dst[b, m] == 2 * M + 1:
                continue
            for c in child[b, m]:
                if c >= 0:
                    assert holder.pop(int(row[b, c])) == c  # still there
            if dst[b, m] != 2 * M:
                assert row[b, m] < peak and int(row[b, m]) not in holder
                holder[int(row[b, m])] = m
        assert not holder  # every stored output was read


def dummy_child_encoding():
    """Three taxa joined by two ops, then a root op whose second child is
    the DUMMY node through the identity edge: a unary root with a branch."""
    N = 6
    post = np.array([[[3, 0, 0, 1, 1], [4, 3, 3, 2, 2], [5, 4, 4, N, N],
                      [N, N, N, N, N]]], dtype=np.int32)
    pre = np.full((1, 1, 6), N, dtype=np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 0]], dtype=np.int32)
    return TreeBatchEncoding(num_taxa=3, num_slots=N, post_ops=post,
                             pre_ops=pre, root=np.array([5], np.int32),
                             edge_mask=mask, node_counts=np.array([6]))


def max_rel(a, b) -> float:
    """max |a - b| / |b|, elementwise."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def max_norm(a, b) -> float:
    """max |a - b| / max |b| (bench.py's gradient parity metric)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))



# ---------------------------------------------------------------------------
# Copied modules and the SBN / VBPI inputs
# ---------------------------------------------------------------------------

def without_docstrings(path, drop=()) -> str:
    """The module's AST dump with every docstring removed: two copies of a
    module compare equal where only their docstrings differ.  Functions
    and methods named in `drop` are removed too (a copy's named
    exceptions)."""
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body = body[1:]
        if isinstance(body, list) and drop:
            node.body = [item for item in body
                         if not (isinstance(item, ast.FunctionDef)
                                 and item.name in drop)]
    return ast.dump(tree)


def topology_counts(seed: int, num_taxa: int, distinct: int):
    """(Newick text of `distinct` random unrooted trees, each written a
    random 1-4 times, in a shuffled order): a sample with repeated
    topologies, as an MCMC run gives."""
    rng = np.random.default_rng(seed)
    lines = _synthetic.random_trees_newick(seed, num_taxa,
                                           distinct).splitlines()
    repeated = [line for line in lines for _ in range(rng.integers(1, 5))]
    rng.shuffle(repeated)
    return "\n".join(repeated) + "\n"
