#!/usr/bin/env python3
"""Time the two paired kernels (rows 1-2 of PERF.md's table of kernels)
through their wrappers at the flagship's shape, and the engine's auto
LL+gradient call, with the bito_tpu_torch package of a given checkout: a
way to set one commit's kernels beside another's on one card, each
checkout in a process of its own, in turns (first, second, second,
first).

    python3 time_paired_kernels.py [CHECKOUT] [C ...]

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
whichever route it takes.  Needs a card and nvcc.
"""
from __future__ import annotations

import os
import sys


def main(argv):
    root = os.path.abspath(argv[0] if argv else os.path.dirname(
        os.path.abspath(__file__)))
    counts = [int(c) for c in argv[1:]] or [4]
    sys.path.insert(0, root)
    import torch

    from bito_tpu_torch import _synthetic
    from bito_tpu_torch.convert import params_from_numpy
    from bito_tpu_torch.core.newick import parse_newick_text
    from bito_tpu_torch.core.site_pattern import SitePattern
    from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                                   PhyloModelSpecification)
    from bito_tpu_torch.perflab import card_line, cuda_ms
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
    batch = 200
    text, aln = _synthetic.ds1_shaped(0, batch)
    coll = parse_newick_text(text)
    sp = SitePattern(aln, coll.taxon_names)
    trees = coll.trees
    params = params_from_numpy(_synthetic.GTR_GAMMA4_PARAMS, dev,
                               torch.float32)
    for C in counts:
        eng = TreeLikelihoodEngine(
            sp, PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}")),
            device=dev, dtype=torch.float32)
        enc = eng.encode(trees)
        bl = eng.branch_length_matrix(trees, enc)
        parts = []
        route = eng._route(True)
        if route == "paired":
            eig, rates, props, clock = eng._model_ingredients(params, batch)
            pi, prop = prep.kernel_model(eig, props)
            P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
            dst, tip, src, e, mask = eng._paired_tapes(enc)
            on = eng._onchip_tape(enc)
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
        fn = eng.branch_eval_fn(trees, params)
        call = cuda_ms(lambda: fn(bl), 20 if route == "paired" else 3)
        parts.append(f"auto ({route}) call {call:.4f} ms, "
                     f"{batch / (call / 1e3):.1f} evals/s")
        print(f"# {root}: GTR+Gamma{C}, {batch} trees x {eng.pattern_pad} "
              f"patterns: " + "; ".join(parts) + f"; on {card}", flush=True)
        del eng
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
