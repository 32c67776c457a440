"""Shared inputs for the tests that hold bito_tpu_torch against bito_tpu.

Both packages get the same Newick text and alignment (bito_tpu_torch's
seeded _synthetic generator) and the same numpy parameters, and each
builds its own engine from them.
"""
from __future__ import annotations

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


def max_rel(a, b) -> float:
    """max |a - b| / |b|, elementwise."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def max_norm(a, b) -> float:
    """max |a - b| / max |b| (bench.py's gradient parity metric)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

