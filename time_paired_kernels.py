#!/usr/bin/env python3
"""Time the two paired kernels (rows 1-2 of PERF.md's table of kernels)
through their wrappers at the flagship's shape, and the engine's auto
LL+gradient call, with the bito_tpu_torch package of a given checkout: a
way to set one commit's kernels beside another's on one card, each
checkout in a process of its own, in turns (first, second, second,
first).

    python3 time_paired_kernels.py [--codon] [CHECKOUT] [C ...]

CHECKOUT (default: this script's directory) is the root of the checkout
whose package is imported and whose kernels are built, into its own
bito_tpu_torch/_build; C the rate category counts (default 4).  The
workload is chip_smoke.py's flagship: 200 random unrooted trees of 27
taxa over a DS1-shaped alignment (1,949 columns, 934 distinct),
GTR+Gamma C with bench.py's parameters, in float32 on the card.  For
each C it prints one line with the card's name and power limit: where
the checkout's auto route takes the paired kernels, each kernel's ms
(CUDA events, the mean of 50 calls after a warm-up, in two turns), and
the auto route's LL+gradient call (branch_eval_fn) in ms and evals/s,
whichever route it takes; where the checkout has the paired route's prep
kernel (prep.transition_prep), its device us at the batch and at twice
the batch beside the torch ops it replaced.  With --codon the workload
is chip_smoke.py's codon path instead (bito_tpu's config6: 128 trees
cycled from 10 random topologies of 27 taxa over 649 codons of 573
distinct patterns, MG94 with config6's parameters, constant rates at
C = 1 and Gamma C, shape 0.8, past it), and the kernels are rows 1b-2b,
the A=64 kernels (default C: 1).  Needs a card and nvcc.
"""
from __future__ import annotations

import os
import sys


CODON_PARAMS = {"substitution_model_rates": [2.5, 0.3],
                "substitution_model_frequencies": [0.3, 0.2, 0.3, 0.2]}


def main(argv):
    codon = argv[:1] == ["--codon"]
    argv = argv[codon:]
    root = os.path.abspath(argv[0] if argv else os.path.dirname(
        os.path.abspath(__file__)))
    counts = [int(c) for c in argv[1:]] or [1 if codon else 4]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from bito_tpu_torch import _synthetic
    from bito_tpu_torch.convert import params_from_numpy
    from bito_tpu_torch.core.newick import parse_newick_text
    from bito_tpu_torch.core.site_pattern import CodonSitePattern, SitePattern
    from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                                   PhyloModelSpecification)
    from bito_tpu_torch.perflab import card_line, cuda_ms, graph_ms
    from bito_tpu_torch.treelike import paired, prep
    from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

    if not torch.cuda.is_available():
        sys.exit("time_paired_kernels.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import bito_tpu_torch

    package = os.path.dirname(os.path.abspath(bito_tpu_torch.__file__))
    if os.path.dirname(package) != root:
        sys.exit(f"imported {package}, not the package of {root}")
    card = card_line()
    dev = torch.device("cuda")
    if codon:
        batch, model_name = 128, "MG94"
        coll = parse_newick_text(_synthetic.random_trees_newick(
            0, _synthetic.DS1_TAXA, 10))
        sp = CodonSitePattern(_synthetic.codon_alignment(
            0, coll.taxon_names, _synthetic.DS1_CODONS,
            _synthetic.DS1_DISTINCT_CODON_COLUMNS), coll.taxon_names)
        trees = [coll.trees[i % 10] for i in range(batch)]
    else:
        batch, model_name = 200, "GTR"
        text, aln = _synthetic.ds1_shaped(0, batch)
        coll = parse_newick_text(text)
        sp = SitePattern(aln, coll.taxon_names)
        trees = coll.trees
    for C in counts:
        site = "constant" if codon and C == 1 else f"gamma+{C}"
        raw = (dict(CODON_PARAMS, **({} if C == 1 else {
            "site_model_parameters": [0.8]})) if codon
               else _synthetic.GTR_GAMMA4_PARAMS)
        params = params_from_numpy({k: np.asarray(v) for k, v in raw.items()},
                                   dev, torch.float32)
        eng = TreeLikelihoodEngine(
            sp, PhyloModel(PhyloModelSpecification(model_name, site)),
            device=dev, dtype=torch.float32)
        enc = eng.encode(trees)
        bl = eng.branch_length_matrix(trees, enc)
        parts = []
        route = eng._route(True)
        if route == "paired":
            eig, rates, props, clock = eng._model_ingredients(params, batch)
            pi, prop = prep.kernel_model(eig, props)
            P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl,
                                               Q=eng._rate_Q(params))
            dst, tip, src, e, mask = eng._paired_tapes(enc)
            on = None if codon else eng._onchip_tape(enc)
            tips, w = eng._kernel_tips, eng._kernel_weights
            calls = {
                "ll": lambda: paired.paired_log_likelihoods(
                    dst, tip, e, P, tips, pi, prop, w, onchip=on),
                "grad": lambda: paired.paired_ll_and_gradients(
                    dst, tip, src, e, mask, P, dP, tips, pi, prop, w,
                    onchip=on)}
            ms = {k: [] for k in calls}
            for key in list(calls) + list(reversed(calls)):
                ms[key].append(cuda_ms(calls[key], 50))
            parts += [f"{k} kernel {sum(v) / len(v):.4f} ms ("
                      + "/".join(f"{x:.4f}" for x in v) + ")"
                      for k, v in ms.items()]
            if not codon and hasattr(prep, "transition_prep"):
                parts += prep_parts(eng, params, bl, batch, graph_ms, prep)
        fn = eng.branch_eval_fn(trees, params)
        call = cuda_ms(lambda: fn(bl), 20 if route == "paired" else 3)
        parts.append(f"auto ({route}) call {call:.4f} ms, "
                     f"{batch / (call / 1e3):.1f} evals/s")
        print(f"# {root}: {model_name} {site}, {batch} trees x "
              f"{eng.pattern_pad} "
              f"patterns: " + "; ".join(parts) + f"; on {card}", flush=True)
        del eng
        torch.cuda.empty_cache()


def prep_parts(eng, params, bl, batch, graph_ms, prep):
    """The paired route's prep at `batch` trees and at twice as many (each
    tree twice, as the benchmark's stream mix evaluates them): the prep
    kernel's device us beside its plain version's, the torch ops it
    replaced, each a CUDA graph of its launches timed in turns."""
    import torch

    parts = []
    for n in (batch, 2 * batch):
        eig, rates, _, clock = eng._model_ingredients(params, n)
        b = torch.cat([bl] * (n // batch))
        ops = {"kernel": (20, lambda: prep.transition_prep(eig, rates,
                                                           clock, b)),
               "torch ops": (5, lambda: prep.transition_prep_plain(
                   eig, rates, clock, b))}
        us = {k: [] for k in ops}
        for key in list(ops) + list(reversed(ops)):
            reps, fn = ops[key]
            us[key].append(graph_ms(fn, reps) * 1e3)
        parts.append(f"prep at {n} trees: " + ", ".join(
            f"{k} {sum(v) / len(v):.2f} us (" + "/".join(
                f"{x:.2f}" for x in v) + ")" for k, v in us.items()))
    return parts


if __name__ == "__main__":
    main(sys.argv[1:])
