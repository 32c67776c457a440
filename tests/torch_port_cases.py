"""Shared inputs for the tests that hold bito_tpu_torch against bito_tpu.

Both packages get the same Newick text and alignment (bito_tpu_torch's
seeded _synthetic generator) and the same numpy parameters, and each
builds its own engine from them.
"""
from __future__ import annotations

import ast
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
