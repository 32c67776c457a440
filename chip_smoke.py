#!/usr/bin/env python3
"""Drive bito_tpu_torch's kernel paths once on one NVIDIA card.

    python3 chip_smoke.py

The workload is the flagship configuration at full width: a DS1-shaped
problem (27 taxa, 1,949 columns drawn from 934 distinct ones, made from a
seed), GTR+Gamma4 with bench.py's parameters, and a batch of 200 random
unrooted trees with trifurcating roots.  Eight paths run the eleven
kernels, the six tree kernels in two bodies each; a ninth, the VBPI
trainer, and a tenth, the rooted time-tree instance, run the paired
kernels as their users' calls reach them; an eleventh, the GP engine,
runs no hand-written kernel; a twelfth, the NNI search, runs the paired
LL kernel where its TP-likelihood scoring reaches it:
  - paired: the engine's default (kernel="auto"), the on-chip bodies of
    paired_ll and paired_grad (csrc/paired_*_onchip.cu);
  - large: the same entry points on two trees of 921 taxa (128 patterns:
    a cherry comb and a balanced tree) past the on-chip bodies' limits,
    where the wrappers hand over to the global bodies (csrc/paired_ll.cu,
    csrc/paired_grad.cu);
  - chunked: the engine with kernel="chunked", the on-chip bodies of
    chunked_ll (csrc/paired_ll_onchip.cu on the chunked tape) and of
    chunked_grad (csrc/chunked_grad_onchip.cu);
  - large-chunked: the engine with kernel="chunked" on the large path's
    trees, past the on-chip bodies' limits: the global bodies of
    chunked_ll (csrc/chunked_ll.cu) and chunked_grad (csrc/chunked_grad.cu);
  - per-node: pernode_log_likelihoods and pernode_ll_and_gradients on the
    engine's own tapes, driven as bito_tpu's scripts/bench_kernel_race.py
    drives their originals (the engine has no route to them): the on-chip
    bodies of pernode_ll (csrc/paired_ll_onchip.cu on the per-node tape)
    and of pernode_grad (csrc/pernode_grad_onchip.cu);
  - large-pernode: the same functions on the large path's trees, past the
    on-chip bodies' limits: the global bodies of pernode_ll
    (csrc/pernode_ll.cu) and pernode_grad (csrc/pernode_grad.cu);
  - perflab: the perf lab's entry points (bito_tpu_torch/perflab, the
    counterparts of bito_tpu's scripts/perf_lab.py, perf_pipe_lab.py and
    perf_static_probe.py) at few repetitions: the per-node grad kernel's
    variants on the same operands (variant_grad, and pernode_grad as
    their base, the on-chip body), the nine pipe experiments (pipe_cell),
    the 4-D and 3-D
    stream sums (stream_sum, two entry points) and the static chain's
    slopes (static_chain);
  - vbpi: the VBPI trainer (vi.burrito.Burrito over the unrooted instance,
    api/instances.py) at bito_tpu's config4 shape: an MCMC sample of
    VBPI_TREES random trees in a Nexus file with a translate table and a
    DS1-shaped FASTA (27 taxa, 1,949 columns, 934 distinct), JC69 with
    constant rates and a strict clock, the split branch model, the
    lognormal scalar model, the simple optimizer, VBPI_PARTICLES
    particles.  The instance hands its engine one shared model row, so
    every step's likelihoods and gradients take the paired on-chip bodies
    at one rate category (paired_ll_onchip, paired_grad_onchip), on a new
    topology set every step; the SBN's EM and topology gradients run in
    float64 on the card (sbn/device.py).  The instance parses the Nexus
    file, counts the support and builds every sample's indexer
    representations in the native library (bito_tpu_torch/_native,
    bitocore.cpp, built with g++ at first use);
  - rooted: the rooted instance (rooted_instance, api/instances.py) at
    the shape of the rooted oracle (tests/test_rooted.py): ROOTED_TAXA
    dated taxa, a batch of BATCH random time trees with bifurcating roots
    (names t<i>_<date>, joins 0.5-10 years apart, branch lengths height
    differences; _synthetic.dated_trees_newick) over a DS1-shaped
    alignment (1,949 columns, 934 distinct), GTR+Weibull4 with the
    oracle's parameters (ROOTED_PARAMS: Weibull shape 0.1), a strict
    clock at rate ROOTED_RATE on every branch, so substitution lengths
    from 0.0005.  It parses the
    trees with the native parser, reads the dates from the names,
    prepares the model, asks for the log likelihoods with and without the
    log-det Jacobian and for every gradient key of phylo_gradients, then
    trains the SBN by simple average and asks for the unconditional
    subsplit probabilities.  The likelihoods and branch gradients take
    the paired on-chip bodies (one shared model row); the model-parameter
    gradients take one reverse-mode pass over the scan tape (its postorder,
    then an adjoint preorder);
  - chunklab: the chunk lab (perflab/perf_chunk_lab.py, the counterpart of
    scripts/perf_chunk_lab.py) on the flagship: every name of the script
    at one sweep of 40 calls, all through chunk_variant
    (perflab/csrc/chunk_variant.cu: the on-chip LL body of
    treelike/csrc/paired_ll_onchip.cuh with the script's knobs);
  - gp: gp_instance (api/gp.py) on bito_tpu's config3 flow at DS1's shape:
    a synthetic credible set of 12 rooted trees over 27 taxa (each the
    first after 2 random NNIs; DS1's credible set is not in the
    repository) with the DS1-shaped alignment: make_dag, make_gp_engine,
    populate_plvs, compute_likelihoods, the per-PCSP LLs, one
    optimize_branch_lengths_once, estimate_branch_lengths(GP_TOL,
    GP_MAX_ITER), estimate_sbn_parameters, calculate_hybrid_marginals;
  - nni: bito_tpu's config5 searches through gp_instance (read a FASTA and
    a seed Newick, make_dag, make_tp_engine and its two take-first setters
    or make_gp_engine and take_first_branch_length, make_nni_engine,
    run_init, run_main_loop / run_post_loop), top-1, on inputs from
    _synthetic.write_nni_inputs (DS1 and six_taxon are not in the
    repository: a random rooted seed tree, its synthetic credible set with
    uniform weights, and an alignment simulated under JC69 along the seed
    after TRUTH_NNIS random NNIs): the faithful TP-likelihood search (the
    product path) at DS1's shape, 27 taxa and 1,949 columns (934
    distinct), NNI_ITERS iterations at opt_max NNI_OPT_MAX, its per-edge
    PVs host numpy and its batched candidate scorer in float64 on the
    card, with nni/search.py's posterior tracking; the TP engine's
    top_tree_log_likelihoods (the paired on-chip LL body at C = 1); the
    whole-tree NNIEngine at DS1's shape for NNI_WHOLE_ITERS iterations,
    with TP-likelihood scoring (optimize_selected_branches on the scan
    tape, then the paired on-chip LL body) and with parsimony (Sankoff's
    torch operations); and the GP-scored search on NNI_GP_TAXA taxa and
    NNI_GP_SITES columns, run to completion (at most NNI_GP_ITERS
    iterations).

Phases, each printing its lines; any failure raises and exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from the
     sources in the checkout (nvcc, at first use), with each kernel's
     registers and spills.
  2. each kernel against its plain torch version in float64 on the same
     operands (both bodies of each tree kernel on the flagship's): LL
     relative error
     and gradient max-abs error over max |g|, both within 5e-5 (bench.py's
     on-device guard).  The probes: every variant of variant_grad the same
     way (nodot, which is not a likelihood, by equal non-finite places and
     finite values within the bounds); pipe_cell on the six experiments
     that fill their scratch, at 100 cells, on the script's ones block and
     on a block of small integers, and both stream sums, exactly on the
     integer block and, on a random bf16 block, within n u sum|x| of the
     float64 sums (n the groups a sum adds, u = 2^-24: the worst case of
     n float32 additions in any order);
     static_chain, both variants at every layout (1, 2 and 4 warps a
     column), within 1e-5 of max |out| against its float32 plain version.
     The rooted path's trees (bifurcating roots) through both paired
     on-chip kernels against their float64 plain versions within 5e-5.
     chunk_variant's variants (v0, w4, w8, norescale, notips, fixstore,
     nodot, unroll) against their float64 plain versions on the
     flagship's chunked operands: the LL within 5e-5 relative (notips,
     whose LL is 0 up to rounding, within 5e-5 a site; nodot, not a
     likelihood, by equal non-finite rows and finite ones, per-site log
     values, within 5e-5).
  3. each path, with every launch count set to 0 just before it and read
     just after: its kernels must have launched and no other path's; the
     results (log_likelihoods, ll_and_branch_gradients, calls over scaled
     branch lengths, and ll_eval_fn on the chunked path) must be finite
     and agree with the float64 engine (the scan tape) within the phase-2
     bounds; the float64 gradients are checked against central
     differences.  On the perflab path the variants must agree with base
     (nodot aside), the filled pipe experiments with phase 2's plain
     outputs, both stream sums with each other and the sum of the ones
     block, and every slope (both variants at every layout) must be
     finite and not under its FMA floor; each is printed beside that floor, and each pipe experiment's us per cell beside both
     terms of its bound (perf_pipe_lab.pipe_bound_ms).
     On the vbpi path: the EM on the card in float64 against the numpy
     backend within 1e-10; one warm-up step, then VBPI_STEPS steps timed
     by phase (Burrito.gradient_step's phases, the card synchronised at
     every boundary) and estimate_elbo, with the launch counts read after
     them (only the two paired on-chip kernels, and no call of the scan
     tape); then the last sample's LL and gradients from the card in
     float32 against the float64 engine, and the paired kernels against
     their float64 plain versions, on those trees, within 5e-5; the
     topology gradients on the card against the numpy backend within
     1e-10; a finite ELBO; the native indexer built every representation
     of the steps (no call of the pure-Python one), and the last sample's
     native representations equal the pure-Python ones.
     On the rooted path: only the two paired on-chip kernels launched, and
     the scan tape ran only for the model gradients' reverse pass; finite
     outputs of every key; the log likelihoods (with and without the
     Jacobian) and every gradient key within 5e-5 of the same instance in
     float64 on the card (the scan tape); the unconditional subsplit
     probabilities in [0, 1]; the host time of each call and both
     kernels' times on the path's operands beside their bounds.
     On the chunklab path: only chunk_variant launched; v0's rows equal
     chunked_ll_onchip's on the same operands; w2, w4, w8, norescale,
     fixstore and unroll within 5e-5 of v0.  On the gp path: no
     hand-written kernel launched; the DAG's node and edge counts; finite
     PLVs and LLs; the log marginal and every per-PCSP LL at the start,
     the log marginal after estimate_branch_lengths and after
     estimate_sbn_parameters, and the hybrid marginals within 5e-5
     relative of the same flow in float64 on the card; the SBN parameters
     within Q_BOUND absolute of float64's, a limit that a control (the
     same softmax on float64's LLs rounded to Q_CONTROL_BITS significand
     bits) must exceed.  On the nni path: paired_ll_onchip launched from
     top_tree_log_likelihoods and from the whole-tree engine's scoring
     and no other kernel (the faithful, parsimony and GP-scored searches
     launch none); the top-tree LLs and the whole-tree engine's float32
     candidate scores within BOUND of the float64 engine on the same
     trees, each iteration from the float32 run's own state; Sankoff's
     scores on the card equal to its float64 version's; the batched
     scorer's float64 scores on the card within SCORER_BOUND relative of
     the serial numpy scorer on the first and the last iteration's
     candidate sets (ROUNDED_BOUND where a Brent step was decided by
     rounding: the searches end at other points); the GP-scored search's
     float32 scores within BOUND of a float64 GP engine on the same
     grafted DAG from the float32 run's state, and a float32 GP engine
     refusing TF32; each search's iterations/s, an iteration split by
     phase (the engines' timer.phase names and the faithful search's
     score / accept / post, the card synchronised at each edge), the
     top-1 margins, and the torch operations on the card of one batched
     scorer call and of one GP-scored iteration.
  4. CUDA-event times of each kernel, its plain version and, where one
     PyTorch call computes the same function, that call; pipe_cell, the
     stream sums and static_chain, whose wrappers' host work outlasts
     their kernels, are timed from the device instead, with torch.sum
     beside the stream sums (perflab.graph_ms: the launches into
     an output allocated once, captured in a CUDA graph, its replays
     between CUDA events); the least time the card could take for the
     same work (for pipe_cell the larger of its device-memory bytes and
     its scratch's shared-memory bytes at 128 B a clock an SM); every
     pipe experiment at every tile that fits (the rule of
     perf_pipe_lab.pipe_plan); every body of the tree
     kernels that takes the shape (the on-chip LL bodies in both stagings
     on all three tapes, the paired grad body in both, the global bodies),
     on the flagship and on trees of BODY_TAXA taxa (the per-node ones
     also of PERNODE_TAXA taxa), each held once against its float64 plain
     version within the phase-2 bound before it is timed, beside the body
     the wrappers choose; each engine route's
     LL+gradient evals/s; the host time of a new topology set at B=200 and
     B=1000; chunk_variant's variants each alone beside its bound, and the
     chunk lab's names as evals/s (the chunklab path's sweeps) with
     preponly's share of a call; the gp path's populate + per-PCSP pass
     (best of 3, the card synchronised) and its optimize sweep (the gp
     path's call) with the device kernels and torch operations each runs;
     paired_ll_onchip at the whole-tree NNI engine's last candidate batch
     (JC69, C = 1) beside its plain version and its bound; all with the
     card's name and limit.
  5. one JSON line of the kernels, then the device line, last.

It has no CPU path: without a card it exits non-zero and prints no result.
"""
import contextlib
import json
import math
import re
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bito_tpu_torch import PRODUCT_DEVICE, PRODUCT_DTYPE, _native, _synthetic
from bito_tpu_torch.convert import gp_state, gp_state_from_numpy, params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.perflab import (GRAPH_TIMING, card_line, cuda_ms,
                                    graph_ms, max_sm_clock_mhz,
                                    perf_chunk_lab, perf_lab, perf_pipe_lab,
                                    perf_static_probe)
from bito_tpu_torch.api.gp import gp_instance
from bito_tpu_torch.dag.graft import graft_node_pairs
from bito_tpu_torch.gp.engine import GPEngine, _sbn_segment_softmax
from bito_tpu_torch.nni.engine import NNIEngine
from bito_tpu_torch.nni.golden import nni_sort_key
from bito_tpu_torch.nni.search import PosteriorProbabilityMaps, SearchResults
from bito_tpu_torch.parsimony.sankoff import SankoffHandler
from bito_tpu_torch.tp import batch_scorer
from bito_tpu_torch.api.instances import rooted_instance, unrooted_instance
from bito_tpu_torch.sbn import maps as sbn_maps
from bito_tpu_torch.treelike import (_kernels, chunked, paired, pernode, prep,
                                     pruning)
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine
from bito_tpu_torch.vi.burrito import Burrito

SEED = 0
BATCH = 200
SWEEP = 40
BOUND = 5e-5  # bench.py's on-device parity guard
PARAMS = _synthetic.GTR_GAMMA4_PARAMS  # bench.py's
LAB_REPS = 5  # CUDA-event repetitions of each perf-lab measurement here
CELLS = perf_pipe_lab.CELLS  # the pipe lab's cells, 100
PROBES = "bito_tpu_torch/perflab/csrc/"
LARGE_CHERRIES = 460  # the large path's trees: 921 taxa
LARGE_PATTERNS = 128
# phase 4's further shapes
BODY_TAXA = (64, 96, 128, 144, 160, 192, 256, 320, 400)
PERNODE_TAXA = (76, 84)  # and the per-node bodies' hand-over between them
TOPOLOGY_BATCH = 1000  # phase 4's larger new topology set
# the vbpi path: bito_tpu's bench_configs.py config4 (vip/benchmark.py)
VBPI_TREES = 10  # the MCMC sample (config4 reads DS1.subsampled_10.t)
VBPI_PARTICLES = 20
VBPI_STEPS = 5
VBPI_SPEC = ("JC69", "constant", "strict")
VBPI_EM = (0.0, 30, 0.0)  # alpha, iterations, score epsilon
# the rooted path: the rooted oracle's shape (tests/test_rooted.py)
ROOTED_TAXA = 69  # fluA's count
ROOTED_SPEC = ("GTR", "weibull+4", "strict")
ROOTED_RATE = 0.001  # every branch's strict-clock rate
# test_rooted.py's GTR frequencies and rates, and its Weibull shape
ROOTED_PARAMS = {"substitution_model_frequencies": [0.1, 0.2, 0.3, 0.4],
                 "substitution_model_rates": [0.05, 0.1, 0.15, 0.20, 0.25,
                                              0.25],
                 "site_model_parameters": [0.1]}
ROOTED_KEYS = ("branch_lengths", "ratios_root_height", "clock_model",
               "clock_model_rates", "substitution_model", "site_model")
# the gp path: bito_tpu's bench_configs.py config3 (GP on DS1's credible
# set, 140 edges) at DS1's shape, on a synthetic credible set
# bito_tpu's GP-scored NNI engine's estimate after an acceptance
# (nni/engine.py:560)
GP_TOL, GP_MAX_ITER = 1e-3, 5
GP_REPS = 3  # phase 4: best of 3 populate passes
# the SBN parameters' absolute limit against float64, and the control that
# must exceed it: the softmax on float64's LLs rounded to this many
# significand bits (float32 keeps 24)
Q_BOUND, Q_CONTROL_BITS = 1e-2, 18
# the nni path: bito_tpu's bench_configs.py config5 (the faithful
# TP-likelihood search on DS1, 20 iterations at opt_max 1, and the
# GP-scored search on six_taxon, run to completion), on synthetic inputs
NNI_ITERS, NNI_OPT_MAX = 20, 1
NNI_WHOLE_ITERS = 3  # the whole-tree engines at DS1's shape
NNI_GP_TAXA, NNI_GP_SITES, NNI_GP_ITERS = 6, 200, 10
# the batched scorer against the serial one: relative, and where a Brent
# step was decided by rounding (the searches end at other points), by the
# LL reached (tests/test_torch_batch_scorer.py)
SCORER_BOUND, ROUNDED_BOUND = 1e-10, 1e-7
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# name -> its source, its TPU kernel, the launcher that counts its
# launches, its path and the other paths that launch it
KERNELS = {
    "paired_ll_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_ll_onchip, path="paired",
        also=("vbpi", "rooted", "nni")),
    "paired_grad_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_onchip, path="paired",
        also=("vbpi", "rooted")),
    "paired_ll": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_ll_global, path="large"),
    "paired_grad": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_global, path="large"),
    "chunked_ll_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:384",
        wrapper=chunked.chunked_ll_onchip, path="chunked"),
    "chunked_ll": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_ll.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:384",
        wrapper=chunked.chunked_ll_global, path="large-chunked"),
    "chunked_grad_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:404",
        wrapper=chunked.chunked_grad_onchip, path="chunked"),
    "chunked_grad": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_grad.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:404",
        wrapper=chunked.chunked_grad_global, path="large-chunked"),
    "pernode_ll_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:90",
        wrapper=pernode.pernode_ll_onchip, path="pernode"),
    "pernode_ll": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_ll.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:90",
        wrapper=pernode.pernode_ll_global, path="large-pernode"),
    "pernode_grad_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:179",
        wrapper=pernode.pernode_grad_onchip, path="pernode",
        also=("perflab",)),
    "pernode_grad": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_grad.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:179",
        wrapper=pernode.pernode_grad_global, path="large-pernode"),
    "variant_grad": dict(
        source=PROBES + "variant_grad.cu", replaces="scripts/perf_lab.py:36",
        wrapper=perf_lab.variant_ll_and_gradients, path="perflab"),
    "pipe_cell": dict(
        source=PROBES + "pipe_cell.cu",
        replaces="scripts/perf_pipe_lab.py:29",
        wrapper=perf_pipe_lab.pipe_cell, path="perflab"),
    "stream_sum_4d": dict(
        source=PROBES + "stream_sum.cu",
        replaces="scripts/perf_pipe_lab.py:101",
        wrapper=perf_pipe_lab.stream_sum_4d, path="perflab"),
    "stream_sum_3d": dict(
        source=PROBES + "stream_sum.cu",
        replaces="scripts/perf_pipe_lab.py:109",
        wrapper=perf_pipe_lab.stream_sum_3d, path="perflab"),
    "static_chain": dict(
        source=PROBES + "static_chain.cu",
        replaces="scripts/perf_static_probe.py:50",
        wrapper=perf_static_probe.static_chain, path="perflab"),
    "chunk_variant": dict(
        source=PROBES + "chunk_variant.cu",
        replaces="scripts/perf_chunk_lab.py:60",
        wrapper=perf_chunk_lab.chunk_variant, path="chunklab"),
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(x, ref):
    return ((x.double() - ref.double()).abs() / ref.double().abs()).max().item()


def norm_err(x, ref):
    return ((x.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def ptxas_usage(log):
    """[(kernel, spill line, register line)] from nvcc's -Xptxas -v output,
    each kernel named as `paired_grad_kernel<4>` or
    `variant_grad_kernel<26,51,1,true>`."""
    usage, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?([a-z][a-z_]*_kernel)"
                      r"(I(?:L[ib]\d+E)+E)?", line)
        if m:
            args = re.findall(r"L([ib])(\d+)E", m.group(2) or "")
            kernel = m.group(1) + (
                "<" + ",".join(v if t == "i" else ("false", "true")[int(v)]
                               for t, v in args) + ">" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and kernel:
            usage.append((kernel, spill, line.split(":", 1)[-1].strip()))
            kernel = None
    return usage


def flagship():
    """The flagship workload: (trees, SitePattern, PhyloModel)."""
    text, alignment = _synthetic.ds1_shaped(SEED, BATCH)
    coll = parse_newick_text(text)
    sp = SitePattern(alignment, coll.taxon_names)
    return coll.trees, sp, PhyloModel(PhyloModelSpecification("GTR", "gamma+4"))


def large_trees():
    """The large path's workload: two trees of 2 * LARGE_CHERRIES + 1 taxa
    over LARGE_PATTERNS columns, a cherry comb (whose postorder keeps a
    third of its partials live) and a balanced tree (whose chunked
    schedule keeps half of them live): (trees, SitePattern, PhyloModel)."""
    coll = parse_newick_text(
        _synthetic.cherry_comb_newick(SEED, LARGE_CHERRIES, 1)
        + _synthetic.balanced_newick(SEED, 2 * LARGE_CHERRIES + 1, 1))
    aln = _synthetic.random_alignment(SEED + 1, coll.taxon_names,
                                      LARGE_PATTERNS)
    return (coll.trees, SitePattern(aln, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("GTR", "gamma+4")))


def body_shape(taxa):
    """One of phase 4's further shapes: BATCH random unrooted trees of
    `taxa` taxa over 1,024 distinct columns, GTR+Gamma4."""
    names = _synthetic.taxon_names(taxa)
    coll = parse_newick_text(_synthetic.random_trees_newick(
        SEED + 2, taxa, BATCH))
    aln = _synthetic.random_alignment(SEED + 3, names, 1024)
    return (coll.trees, SitePattern(aln, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("GTR", "gamma+4")))


def paired_bodies(label, eng, trees, params, card):
    """Phase 4's paired bodies side by side on one shape: every body that
    takes the shape (an on-chip staging where one warp of patterns fits,
    the global body always) is held once against the float64 plain version on
    the same operands, within BOUND, then timed twice in turns.  Prints
    one line; returns {body: ms}."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    on = eng._onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    M, N1 = dst.shape[1], P.shape[1]

    calls, labels = ll_bodies(
        on.ll_rows, M, N1,
        lambda plan: paired.paired_ll_onchip(dst, on, e, P, tips, pi, prop,
                                             plan) @ w,
        lambda: paired.paired_ll_global(dst, tip, e, P, tips, pi, prop) @ w)
    for ring in (False, True):
        plan = paired.onchip_plan("grad", on.grad_rows, M, N1, 4, ring)
        if plan is not None:
            key = "grad onchip " + ("ring" if ring else "staged")
            labels[key] = (f"{key} ({plan.cols} patterns a block, "
                           f"{plan.smem} B)")
            calls[key] = lambda plan=plan: paired.finish_rows(
                *paired.paired_grad_onchip(dst, on, src, e, P, dP, tips, pi,
                                           prop, w, plan), mask, w)
    calls["grad global"] = lambda: paired.finish_rows(
        *paired.paired_grad_global(dst, tip, src, e, P, dP, tips, pi, prop,
                                   w), mask, w)

    # The float64 plain version, a slice of trees at a time to bound its
    # scratch ([trees, 2M+3, C, 4, S] in float64, up to 2.5 GB); its time
    # is the host's launches, one set a slice.
    step = max(1, BATCH * 192 // max(M, 64) // 4)
    f64 = [x.double() for x in (tips, pi, prop, w)]
    refs = [paired.paired_ll_and_gradients_ref(
        dst[i:i + step], tip[i:i + step], src[i:i + step], e[i:i + step],
        mask[i:i + step], P[i:i + step].double(), dP[i:i + step].double(),
        *f64) for i in range(0, len(trees), step)]
    reps = body_reps(M)
    ms = held_then_timed(f"paired bodies, {label}", calls, refs, reps)
    print(f"# phase 4: paired bodies, {label} ({len(trees)} trees x "
          f"{eng.pattern_pad} patterns, {enc.num_taxa} taxa, M={M}; ms, "
          f"mean of two turns of {reps}): " + "; ".join(
              f"{labels.get(key, key)} {t:.4f}" for key, t in ms.items())
          + "; the wrappers take ll "
          f"{body_of(paired.onchip_plan('ll', on.ll_rows, M, N1, 4))}, grad "
          f"{body_of(paired.onchip_plan('grad', on.grad_rows, M, N1, 4))}; "
          f"on {card}")
    return ms


def body_reps(M):
    """Phase 4's repetitions of a body on a tape of M ops: 50 at the
    flagship, fewer as the calls grow (4 at 400 taxa)."""
    return max(4, 1600 // max(M, 32))


def held_then_timed(what, calls, refs, reps):
    """Hold each body's call once against the float64 plain version's
    (ll, grads) slices `refs` within BOUND ("ll ..." calls return ll,
    others (ll, grads)), then time each twice in turns, forward then
    backward.  Prints the errors; returns {body: mean ms}."""
    ll_ref = torch.cat([r[0] for r in refs])
    g_ref = torch.cat([r[1] for r in refs])
    errs = []
    for key, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        if key.startswith("ll"):
            err = rel_err(out, ll_ref)
        else:
            err = max(rel_err(out[0], ll_ref), norm_err(out[1], g_ref))
        errs.append(f"{key} {err:.3e}")
        check(bool(torch.isfinite(out if key.startswith("ll")
                                  else out[1]).all()) and err <= BOUND,
              f"{what}: {key} parity")
    print(f"# phase 4: {what}, against the float64 plain version (LL rel "
          f"err, grad max-abs/max|g|; bound {BOUND:g}): " + ", ".join(errs))
    ms = {}
    for key in list(calls) + list(reversed(calls)):
        ms.setdefault(key, []).append(cuda_ms(calls[key], reps))
    return {key: sum(v) / len(v) for key, v in ms.items()}


def ll_bodies(rows, M, N1, onchip, global_body):
    """Phase 4's LL calls on one tape of the paired layout (the paired,
    chunked or per-node tape): the on-chip body (onchip(plan)) in each
    staging where one warp of patterns fits, the global body always; and
    the line's labels, the on-chip ones with their warps a block and
    bytes."""
    calls, labels = {}, {}
    for ring in (False, True):
        plan = paired.onchip_plan("ll", rows, M, N1, 4, ring)
        if plan is not None:
            key = "ll onchip " + ("ring" if ring else "staged")
            calls[key] = lambda plan=plan: onchip(plan)
            labels[key] = (f"{key} ({plan.cols * plan.lanes // 32} warps, "
                           f"{plan.smem} B)")
    calls["ll global"] = global_body
    return calls, labels


def body_of(plan):
    """The body a wrapper takes by `plan`, as the phase 4 lines name it."""
    return "global" if plan is None else (
        "onchip " + ("ring" if plan.ring else "staged"))


def chunked_bodies(label, eng, trees, params, card):
    """Phase 4's chunked bodies side by side on one shape: the on-chip LL
    body in each staging and the on-chip grad body wherever one warp of
    patterns fits, the global bodies always, each held once against the
    float64 plain version on the same operands within BOUND, then timed
    twice in turns.  Prints one line; returns {body: ms}."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     eng.branch_length_matrix(trees, enc))
    dst, tip, e, row, mask = eng._chunked_tapes(enc)
    on = eng._chunked_onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    MW, N1 = dst.shape[1], P.shape[1]
    calls, labels = ll_bodies(
        on.ll_rows, MW, N1,
        lambda plan: chunked.chunked_ll_onchip(dst, on, e, P, tips, pi, prop,
                                               plan) @ w,
        lambda: chunked.chunked_ll_global(dst, tip, e, P, tips, pi, prop) @ w)
    plan = chunked.onchip_plan(on.grad_rows, MW, N1, 4, least=1)
    if plan is not None:
        calls["grad onchip"] = lambda: chunked.finish_rows(
            *chunked.chunked_grad_onchip(dst, on, e, P, dP, tips, pi, prop,
                                         w, plan), row, mask, w)
    calls["grad global"] = lambda: chunked.finish_rows(
        *chunked.chunked_grad_global(dst, tip, e, P, dP, tips, pi, prop, w),
        row, mask, w)
    # The float64 plain version, a slice of trees at a time to bound its
    # scratch ([trees, 2MW+2, C, 4, S] in float64, up to 2.5 GB).
    step = max(1, BATCH * 192 // max(MW, 64) // 4)
    f64 = [x.double() for x in (tips, pi, prop, w)]
    refs = [chunked.chunked_ll_and_gradients_ref(
        dst[i:i + step], tip[i:i + step], e[i:i + step], row[i:i + step],
        mask[i:i + step], P[i:i + step].double(), dP[i:i + step].double(),
        *f64) for i in range(0, len(trees), step)]
    reps = body_reps(MW)
    ms = held_then_timed(f"chunked bodies, {label}", calls, refs, reps)
    chosen = ("global" if chunked.onchip_plan(on.grad_rows, MW, N1, 4) is None
              else "onchip")
    if plan is not None:
        labels["grad onchip"] = (
            f"grad onchip ({plan.cols} patterns, "
            f"{plan.cols * chunked.W * 4 // 32} warps, {plan.smem} B)")
    print(f"# phase 4: chunked bodies, {label} ({len(trees)} trees x "
          f"{eng.pattern_pad} patterns, {enc.num_taxa} taxa, MW={MW}, "
          f"{on.ll_rows} LL rows, {on.grad_rows} grad rows; ms, mean of two "
          f"turns of {reps}): " + "; ".join(
              f"{labels.get(key, key)} {t:.4f}" for key, t in ms.items())
          + f"; the wrappers take ll "
          f"{body_of(chunked.ll_plan(on.ll_rows, MW, N1, 4))}, grad "
          f"{chosen}; on {card}")
    return ms


def pernode_bodies(label, eng, trees, params, card):
    """Phase 4's per-node bodies side by side on one shape: the on-chip
    LL body in each staging and the on-chip grad body wherever one warp of
    patterns fits, the global bodies always, each held once against the
    float64 plain version on the same operands within BOUND, then timed
    twice in turns.  Prints one line; returns {body: ms}."""
    dev = eng.device
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     eng.branch_length_matrix(trees, enc))
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=dev)
    on = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                             enc.num_taxa, enc.num_slots, dev)
    lt = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                         enc.num_slots, dev)
    tips, w = eng._kernel_tips, eng._kernel_weights
    N1, M = P.shape[1], post.shape[1]
    calls, labels = ll_bodies(
        lt.ll_rows, M, N1,
        lambda plan: pernode.pernode_ll_onchip(lt, P, tips, pi, prop,
                                               plan) @ w,
        lambda: pernode.pernode_ll_global(post, root, P, tips, pi, prop) @ w)
    plan = pernode.onchip_plan(on.rows, on.ints, N1, 4, least=1)
    if plan is not None:
        calls["grad onchip"] = lambda: pernode.finish_rows(
            *pernode.pernode_grad_onchip(on, root, P, dP, tips, pi, prop, w,
                                         plan), mask, w)
    calls["grad global"] = lambda: pernode.finish_rows(
        *pernode.pernode_grad_global(post, pre, root, P, dP, tips, pi, prop,
                                     w), mask, w)
    # The float64 plain version, a slice of trees at a time to bound its
    # scratch (partials and up values [trees, N1, C, 4, S] in float64).
    step = max(1, int(12e9) // (N1 * 16 * tips.shape[-1] * 8))
    f64 = [x.double() for x in (tips, pi, prop, w)]
    refs = [pernode.pernode_ll_and_gradients_ref(
        post[i:i + step], pre[i:i + step], root[i:i + step],
        mask[i:i + step], P[i:i + step].double(), dP[i:i + step].double(),
        *f64) for i in range(0, len(trees), step)]
    reps = body_reps(M)
    ms = held_then_timed(f"per-node bodies, {label}", calls, refs, reps)
    chosen = ("global" if pernode.onchip_plan(on.rows, on.ints, N1, 4) is None
              else "onchip")
    if plan is not None:
        labels["grad onchip"] = (f"grad onchip ({plan.cols * 4 // 32} warps, "
                                 f"{plan.smem} B)")
    print(f"# phase 4: per-node bodies, {label} ({len(trees)} trees x "
          f"{eng.pattern_pad} patterns, {enc.num_taxa} taxa, M={M}, "
          f"{lt.ll_rows} LL rows, {on.rows} grad rows; ms, mean of two turns "
          f"of {reps}): " + "; ".join(
              f"{labels.get(key, key)} {t:.4f}" for key, t in ms.items())
          + f"; the wrappers take ll "
          f"{body_of(paired.onchip_plan('ll', lt.ll_rows, M, N1, 4))}, grad "
          f"{chosen}; on {card}")
    return ms


def topology_set_ms(sp, model, trees, reps):
    """Host milliseconds the engine spends on a set of topologies it has
    not seen, before its first launch: (encoding, the paired tapes with
    the on-chip tape on the card, the on-chip tape alone), medians over
    `reps` fresh engines."""
    runs = []
    for _ in range(reps):
        e = TreeLikelihoodEngine(sp, model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = e.encode(trees)
        t1 = time.perf_counter()
        e._paired_tapes(enc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pe = paired.build_paired_encoding(enc)
        t3 = time.perf_counter()
        paired.onchip_tape(pe.post_dst, pe.tip_slot, e.device)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t4 - t3) * 1e3))
    return [float(np.median(c)) for c in zip(*runs)]


def tree_flops(enc, sp, model, batch):
    """(LL, LL+gradient) FLOPs of one call over `batch` trees, counted as
    bench.py:135-150 counts them: the algorithm's work over the true
    patterns, independent of the kernel."""
    S, C = sp.pattern_count, model.category_count
    CA = 4 * C
    E = int(np.asarray(enc.edge_mask).sum(axis=1).mean())
    n_internal = max(enc.num_slots - sp.num_taxa, 1)
    evolve = 2 * 16 * C * S
    fl_ll = E * evolve + n_internal * CA * S + 2 * CA * S
    fl_grad = fl_ll + E * (2 * evolve + 3 * CA * S)
    return fl_ll * batch, fl_grad * batch


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, moved):
    """(ms, "operations" or "bytes"): the least time the card could take,
    at PEAK_FLOPS and PEAK_BYTES."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_bound(flops, moved, library=None, shared_ms=0.0):
    """bound() of a phase-4 work entry, or its shared-memory term (ms of
    the bytes it must move through shared memory, pipe_cell's scratch)
    where that is larger."""
    return max(bound(flops, moved), (shared_ms, "bytes"))


def reset_launches():
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def read_launches(path):
    """{kernel: launches} for the kernels of `path`, after checking that
    each kernel the path runs launched and that no other kernel did."""
    counts = {name: spec["wrapper"].launches for name, spec in KERNELS.items()}
    print(f"# phase 3: {path} path launches {counts}")
    for name, spec in KERNELS.items():
        if spec["path"] == path or path in spec.get("also", ()):
            check(counts[name] > 0, f"{name} launched in the {path} path")
        else:
            check(counts[name] == 0, f"{name} did not launch in the {path} "
                  "path")
    return {n: c for n, c in counts.items() if KERNELS[n]["path"] == path}


# What phase 4 times each probe at (the flagship's operands for
# variant_grad).
PIPE_TIMED = "paired-like"
CHAIN_R = 20
# phase 4 times them, and their library call, by graph_ms
GRAPH_TIMED = ("pipe_cell", "stream_sum_4d", "stream_sum_3d", "static_chain",
               "chunk_variant")
LAB_SHAPES = {
    "variant_grad": f"unroll, float32, {BATCH} trees x 1024 patterns",
    "pipe_cell": f"{PIPE_TIMED}, {CELLS} cells",
    "stream_sum_4d": f"{CELLS} cells of 32 x 256 x 128 bf16",
    "stream_sum_3d": f"{CELLS} cells of 8192 x 128 bf16",
    "static_chain": f"dynamic, R={CHAIN_R}, 52 ops x 1024 columns",
    "chunk_variant": f"v0 (the shipping body), float32, {BATCH} trees x "
                     "1024 patterns",
}


def pipe_plan_line(exp):
    plan = perf_pipe_lab.pipe_plan(*exp[:2])
    return (f"T={plan.tile} columns a block, {16 * plan.tile} threads, "
            f"{plan.smem} B of shared memory, TMA boxes of {plan.stage_rows} "
            "rows")


def probe_parity(ops, dev, errs):
    """Phase 2 for the perf lab's four kernels: each against its plain
    version on the inputs of the perflab path.  Fills errs; returns phase
    4's {kernel: (call of the plain version, call of the kernel)}, the
    plain outputs of the filled pipe experiments, and {kernel: (FLOPs,
    bytes, call of the PyTorch function or None)} of the timed probes but
    variant_grad."""
    ops64 = {k: v.double() if v.is_floating_point() else v
             for k, v in ops.items()}
    lab_on = perf_lab.onchip_of(ops)
    worst = (0.0, 0.0)
    for name, knobs in perf_lab.VARIANTS.items():
        ll_k, g_k = perf_lab.variant_ll_and_gradients(**ops, **knobs,
                                                      onchip=lab_on)
        torch.cuda.synchronize()
        ll_p, g_p = perf_lab.variant_ll_and_gradients_ref(**ops64, **knobs)
        if knobs["nodot"]:  # not a likelihood: -inf where tips disagree
            fin = torch.isfinite(ll_p)
            check(torch.equal(torch.isfinite(ll_k), fin)
                  and torch.equal(ll_k[~fin].double(), ll_p[~fin]),
                  "variant_grad nodot: the same non-finite log likelihoods")
            ll_err = rel_err(ll_k[fin], ll_p[fin]) if fin.any() else 0.0
            g_err = ((g_k.double() - g_p).abs().max()
                     / max(g_p.abs().max().item(), 1.0)).item()
        else:
            ll_err, g_err = rel_err(ll_k, ll_p), norm_err(g_k, g_p)
            worst = max(worst, (g_err, (g_k.double() - g_p).abs().max().item()))
        print(f"# phase 2: variant_grad {name}: LL rel err {ll_err:.3e}, grad "
              f"max-abs/max|g| {g_err:.3e} (bound {BOUND:g}, plain version in "
              f"float64)")
        check(ll_err <= BOUND and g_err <= BOUND, f"variant_grad {name} parity")
    errs["variant_grad"] = worst

    # The pipe cell on the script's ones block (phase 3 holds the perflab
    # path to these outputs) and on a block of small integers, which tells
    # apart each cell's rows.
    plain_outs = {}
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, (rows, scratch_rows, init, loops, stores) in (
            perf_pipe_lab.EXPS.items()):
        if not init:  # no defined output on either side
            continue
        idx, big = perf_pipe_lab.pipe_inputs(rows, scratch_rows, CELLS, dev)
        ints = torch.randint(0, 8, tuple(big.shape), generator=gen,
                             dtype=torch.uint8, device=dev).to(torch.bfloat16)
        kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
                  stores=stores)
        for block, what in ((big, "ones"), (ints, "integers in [0, 8)")):
            out = perf_pipe_lab.pipe_cell(idx, block, **kw)
            torch.cuda.synchronize()
            want = perf_pipe_lab.pipe_cell_ref(idx, block, **kw)
            plain_outs.setdefault(name, want)
            err = (out - want).abs().max().item()
            worst = max(worst, err)
            print(f"# phase 2: pipe_cell {name}, block of {what}: max abs err "
                  f"{err:g} (exact)")
            check(err == 0, f"pipe_cell {name} parity on a block of {what}")
        del ints
    errs["pipe_cell"] = (worst, worst)

    _, nslices, rows, cols = perf_pipe_lab.DMA4D
    block = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, 8, (CELLS, nslices, rows, cols)),
        dtype=torch.bfloat16, device=dev)
    want = perf_pipe_lab.stream_sum_ref(block)
    # A random bf16 block against its float64 sums, within n u sum|x|:
    # the worst case of n float32 additions in any order (u = 2^-24, n the
    # groups a sum adds).
    rnd = torch.randn((CELLS, nslices, rows, cols), generator=gen,
                      device=dev).to(torch.bfloat16)
    groups = nslices * rows // 8
    want64 = rnd.double().reshape(CELLS, -1, 8, cols).sum(dim=1)
    tol = groups * 2.0**-24 * rnd.double().abs().reshape(
        CELLS, -1, 8, cols).sum(dim=1)
    for name, walk in (("stream_sum_4d", lambda x: x),
                       ("stream_sum_3d", lambda x: x.reshape(
                           CELLS, nslices * rows, cols))):
        out = KERNELS[name]["wrapper"](walk(block))
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        print(f"# phase 2: {name}: max abs err {err:g} (exact, integers in "
              f"[0, 8))")
        check(err == 0, f"{name} parity")
        out = KERNELS[name]["wrapper"](walk(rnd))
        torch.cuda.synchronize()
        diff = (out.double() - want64).abs()
        errs[name] = (diff.max().item(), diff.max().item())
        print(f"# phase 2: {name}: random bf16 block, max abs err "
              f"{diff.max().item():.3e} against the float64 sums, at most "
              f"{(diff / tol).max().item():.3e} of the bound n u sum|x| "
              f"(n={groups})")
        check(bool((diff <= tol).all()), f"{name} parity on a random block")
    del rnd, want64, tol

    tape, L = perf_static_probe.probe_inputs(dev)
    worst = (0.0, 0.0)
    for dynamic in (True, False):
        ref = perf_static_probe.static_chain_ref(tape, L, dynamic=dynamic,
                                                 R=CHAIN_R)
        for warps in perf_static_probe.LAYOUTS:
            out = perf_static_probe.static_chain(tape, L, dynamic=dynamic,
                                                 R=CHAIN_R, warps=warps)
            torch.cuda.synchronize()
            err = norm_err(out, ref)
            worst = max(worst, (err, (out - ref).abs().max().item()))
            print(f"# phase 2: static_chain dynamic={dynamic} R={CHAIN_R}, "
                  f"{warps} warps a column: max-abs/max|out| {err:.3e} "
                  "(bound 1e-5, float32 plain)")
            check(bool(torch.isfinite(out).all()) and err <= 1e-5,
                  f"static_chain dynamic={dynamic} warps={warps} parity")
    errs["static_chain"] = worst

    exp = perf_pipe_lab.EXPS[PIPE_TIMED]
    idx, big = perf_pipe_lab.pipe_inputs(*exp[:2], CELLS, dev)
    # (device-memory ms, shared-memory ms): the scratch's fill and stores
    # at 128 B a clock an SM
    pipe_terms = perf_pipe_lab.pipe_bound_ms(
        *exp, cells=CELLS,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count,
        clock_mhz=max_sm_clock_mhz())
    print(f"# phase 2: pipe_cell {PIPE_TIMED} plan: {pipe_plan_line(exp)}; "
          f"bound terms: device memory {pipe_terms[0]:.4f} ms, shared "
          f"memory {pipe_terms[1]:.4f} ms")
    pipe_kw = dict(zip(("scratch_rows", "init", "loops", "stores"), exp[1:]))
    pipe_plan = perf_pipe_lab.pipe_plan(*exp[:2])
    pipe_out = torch.empty((CELLS, 8, perf_pipe_lab.S), dtype=torch.float32,
                           device=dev)
    overlap = perf_static_probe.check_chain(tape, L)
    chain_out = torch.empty((8, perf_static_probe.S), dtype=torch.float32,
                            device=dev)
    big3 = block.reshape(CELLS, nslices * rows, cols)
    unroll = perf_lab.VARIANTS["unroll"]
    # What each probe must move and compute (phase 4's bound), and the one
    # PyTorch call that computes a stream sum: the grouped sum in float32.
    out_pipe = CELLS * 8 * perf_pipe_lab.S * 4
    out_sums = CELLS * 8 * cols * 4
    chain_flops = (2 * perf_static_probe.FMAS_PER_OP * perf_static_probe.S
                   * perf_static_probe.M * CHAIN_R)
    sum_outs = [torch.empty((CELLS, 8, cols), dtype=torch.float32,
                            device=dev) for _ in range(4)]
    work = {
        "pipe_cell": (0, nbytes(idx, big) + out_pipe, None, pipe_terms[1]),
        "stream_sum_4d": (CELLS * nslices * rows * cols, nbytes(block)
                          + out_sums, lambda: perf_pipe_lab.torch_stream_sum(
                              block, sum_outs[0])),
        "stream_sum_3d": (CELLS * nslices * rows * cols, nbytes(big3)
                          + out_sums, lambda: perf_pipe_lab.torch_stream_sum(
                              big3, sum_outs[1])),
        "static_chain": (chain_flops,
                         nbytes(tape, L) + 8 * perf_static_probe.S * 4, None),
    }
    # The pipe cell, the stream sums and the chain check their operands
    # once (above) and are timed at their launches into outputs allocated
    # once (graph_ms), torch.sum too.
    return {
        "variant_grad": (
            lambda: perf_lab.variant_ll_and_gradients_ref(**ops, **unroll),
            lambda: perf_lab.variant_ll_and_gradients(**ops, **unroll,
                                                      onchip=lab_on)),
        "pipe_cell": (
            lambda: perf_pipe_lab.pipe_cell_ref(idx, big, **pipe_kw),
            lambda: perf_pipe_lab.launch_pipe_cell(idx, big, pipe_out,
                                                   pipe_plan, **pipe_kw)),
        "stream_sum_4d": (lambda: perf_pipe_lab.stream_sum_ref(block),
                          lambda: perf_pipe_lab.launch_stream_sum(
                              block, sum_outs[2])),
        "stream_sum_3d": (lambda: perf_pipe_lab.stream_sum_ref(big3),
                          lambda: perf_pipe_lab.launch_stream_sum(
                              big3, sum_outs[3])),
        "static_chain": (
            lambda: perf_static_probe.static_chain_ref(tape, L, dynamic=True,
                                                       R=CHAIN_R),
            lambda: perf_static_probe.launch_chain(tape, L, chain_out, True,
                                                   CHAIN_R, overlap)),
    }, plain_outs, work


def run_perflab(ops, dev):
    """The perflab path: the perf lab's entry points, as `python -m
    bito_tpu_torch.perflab lab|pipe|static` runs them, at LAB_REPS
    repetitions.  Returns their results."""
    print("# phase 3: perflab path (python -m bito_tpu_torch.perflab lab, "
          f"pipe, pipe dma4d, static; {LAB_REPS} repetitions each)")
    tape, L = perf_static_probe.probe_inputs(dev)
    return dict(
        lab=perf_lab.run_variants(perf_lab.NAMES, ops, reps=LAB_REPS),
        pipe={name: perf_pipe_lab.run(name, *exp, reps=LAB_REPS, cells=CELLS)
              for name, exp in perf_pipe_lab.EXPS.items()},
        dma4d=perf_pipe_lab.run4d(*perf_pipe_lab.DMA4D, reps=LAB_REPS,
                                  cells=CELLS),
        static=perf_static_probe.slopes(tape, L, reps=LAB_REPS))


def check_perflab(lab, plain_outs):
    """Phase 3's checks of the perflab path's results."""
    _, ll0, g0 = lab["lab"]["base"]
    for name, (ms, ll, g) in lab["lab"].items():
        check(ms > 0, f"perflab {name} was timed")
        if name == "nodot":  # not a likelihood: no finiteness check
            continue
        check(bool(torch.isfinite(ll).all() and torch.isfinite(g).all()),
              f"perflab {name} outputs are finite")
        check(rel_err(ll, ll0) <= BOUND and norm_err(g, g0) <= BOUND,
              f"perflab {name} agrees with base")
    for name, (per_cell, out) in lab["pipe"].items():
        check(per_cell > 0 and out.shape == (CELLS, 8,
                                             perf_pipe_lab.S),
              f"pipe {name} timed, output shape")
        if name in plain_outs:
            check(torch.equal(out, plain_outs[name]),
                  f"pipe {name} equals its plain output")
    (_, out4, _), (_, out3, _) = lab["dma4d"]["4d"], lab["dma4d"]["3d"]
    groups = perf_pipe_lab.DMA4D[1] * perf_pipe_lab.DMA4D[2] // 8
    check(torch.equal(out4, out3) and bool((out4 == groups).all()),
          "dma4d: both layouts sum the ones block exactly")
    for row in lab["static"]:
        print(f"# phase 3: static chain dynamic={row['dynamic']}, "
              f"{row['warps']} warps a column: R={perf_static_probe.R_LO} "
              f"{row[f'R{perf_static_probe.R_LO}_ms']:.4f} ms, "
              f"R={perf_static_probe.R_HI} "
              f"{row[f'R{perf_static_probe.R_HI}_ms']:.4f} ms, slope "
              f"{row['us_per_op_slope']:.4f} us/op against an FMA floor of "
              f"{row['fma_floor_us_per_op']:.4f} us/op, "
              f"{row['busiest_sm_warps']} warps on the busiest SM ("
              f"{row['timing']})")
        # under the floor, the chain was collapsed: not a time of an op
        check(math.isfinite(row["us_per_op_slope"])
              and not row["below_floor"], "static slope is finite and not "
              "below its FMA floor")


class SyncedPhases:
    """A timer for Burrito.gradient_step: seconds per phase, the card
    synchronised where each phase starts and ends, so a phase's time holds
    its own device work and no other's."""

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def phase(self, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)


@contextlib.contextmanager
def counting_scan_calls():
    """Count the calls of the scan tape's entry points (the engine's route
    without a kernel, and the rooted instance's model gradients) while the
    block runs: {"calls": n}."""
    count = {"calls": 0}
    names = ("log_likelihoods_impl", "ll_and_branch_gradients_impl",
             "log_likelihoods_differentiable")
    saved = {name: getattr(pruning, name) for name in names}

    def counted(fn):
        def call(*args, **kwargs):
            count["calls"] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(pruning, name, counted(fn))
    try:
        yield count
    finally:
        for name, fn in saved.items():
            setattr(pruning, name, fn)


@contextlib.contextmanager
def counting_representations():
    """Count the calls that build unrooted indexer representations while
    the block runs: {"native": calls of the native indexer (each a whole
    tree set), "python": calls of sbn/maps.py's (each one tree)}."""
    count = {"native": 0, "python": 0}
    saved = (_native.PCSPIndexer.unrooted_representations,
             sbn_maps.unrooted_representation)

    def counted(kind, fn):
        def call(*args, **kwargs):
            count[kind] += 1
            return fn(*args, **kwargs)
        return call

    _native.PCSPIndexer.unrooted_representations = counted("native", saved[0])
    sbn_maps.unrooted_representation = counted("python", saved[1])
    try:
        yield count
    finally:
        (_native.PCSPIndexer.unrooted_representations,
         sbn_maps.unrooted_representation) = saved


def vbpi_em(nexus, dev):
    """The vbpi path's EM: on the card in float64, then the numpy backend
    on the same instance; held within 1e-10.  The device loop adds in
    linear space after a shift (as bito_tpu's does), so a PCSP whose mass
    is under exp(-745) of the largest is -inf there beside the numpy
    loop's log value: the same probability, 0."""
    inst = unrooted_instance("em", device=dev)
    inst.read_nexus_file(nexus)
    inst.process_loaded_trees()
    em_ms = []  # the first run loads the torch kernels it uses
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score = inst.train_expectation_maximization(*VBPI_EM)
        em_ms.append((time.perf_counter() - t0) * 1e3)
    on_card = inst.sbn_parameters
    want = inst.train_expectation_maximization(*VBPI_EM, backend="numpy")
    tiny = inst.sbn_parameters < -745.0
    err = max(np.abs(score - want).max() / np.abs(want).max(),
              np.abs(on_card[~tiny] - inst.sbn_parameters[~tiny]).max())
    print(f"# phase 3: vbpi EM on the card in float64 (alpha, iterations, "
          f"score epsilon = {VBPI_EM}; support {inst.sbn_support.size()}, "
          f"{len(score)} iterations; {em_ms[0]:.1f} ms the first run, "
          f"{em_ms[1]:.1f} ms the second): score {score[-1]:.6f},"
          f" max abs err against the numpy backend {err:.3e} (bound 1e-10), "
          f"{int(tiny.sum())} parameters under exp(-745)")
    check(len(score) == len(want) and np.isneginf(on_card[tiny]).all()
          and np.isfinite(on_card[~tiny]).all() and err <= 1e-10,
          "vbpi: the EM on the card matches the numpy backend")


def vbpi_path(dev, card):
    """The vbpi path: config4's VBPI run on the card (phase 3), checked as
    the module docstring says.  Returns its launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        nexus, fasta = _synthetic.write_vbpi_inputs(
            tmp, SEED, _synthetic.DS1_TAXA, VBPI_TREES, _synthetic.DS1_SITES,
            _synthetic.DS1_DISTINCT_COLUMNS)
        vbpi_em(nexus, dev)
        burrito = Burrito(
            mcmc_nexus_path=nexus, burn_in_fraction=0.0, fasta_path=fasta,
            phylo_model_specification=PhyloModelSpecification(*VBPI_SPEC),
            branch_model_name="split", scalar_model_name="lognormal",
            optimizer_name="simple", particle_count=VBPI_PARTICLES,
            seed=SEED, device=dev, dtype=PRODUCT_DTYPE)
    inst, eng = burrito.inst, burrito.inst.engine
    check(eng._route(eng._shared_model(inst._params_dict())) == "paired",
          "vbpi: the instance's shared model row takes the paired kernels")

    reset_launches()
    with counting_scan_calls() as scan, counting_representations() as reps:
        burrito.gradient_step()  # warm-up
        timer = SyncedPhases()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VBPI_STEPS):
            burrito.gradient_step(timer=timer)
        step_ms = (time.perf_counter() - t0) * 1e3 / VBPI_STEPS
        elbo = burrito.estimate_elbo(VBPI_PARTICLES)
        torch.cuda.synchronize()
    counts = {name: KERNELS[name]["wrapper"].launches
              for name in ("paired_ll_onchip", "paired_grad_onchip")}
    read_launches("vbpi")
    print(f"# phase 3: vbpi path: {scan['calls']} calls of the scan tape; "
          f"indexer representations: {reps['native']} native calls (a "
          f"tree set each), {reps['python']} pure-Python calls")
    check(scan["calls"] == 0, "vbpi: no call of the scan tape")
    check(reps["native"] > 0 and reps["python"] == 0,
          "vbpi: the native indexer builds the representations")
    phases = {name: s * 1e3 / VBPI_STEPS for name, s in timer.totals.items()}
    print(f"# phase 3: vbpi step ({_synthetic.DS1_TAXA} taxa, "
          f"{eng.site_pattern.pattern_count} patterns, {VBPI_PARTICLES} "
          f"particles, {'/'.join(VBPI_SPEC)}, split/lognormal/simple; mean of "
          f"{VBPI_STEPS} steps after one, the card synchronised at every "
          f"phase boundary): {step_ms:.2f} ms/step (phases' sum "
          f"{sum(phases.values()):.2f}); " + ", ".join(
              f"{name} {ms:.3f}" for name, ms in phases.items())
          + f" ms; on {card}")
    print(f"# phase 3: vbpi ELBO estimate ({VBPI_PARTICLES} particles): "
          f"{elbo:.6f}")
    check(math.isfinite(elbo), "vbpi: the ELBO is finite")

    # The last sample's trees: the card's LL and gradients in float32
    # against the float64 engine, and the kernels against their plain
    # versions.
    trees = inst.tree_collection.trees
    params = inst._params_dict()
    pgs = inst.phylo_gradients()
    ll = torch.tensor([g.log_likelihood() for g in pgs], dtype=torch.float64)
    grads = torch.as_tensor(np.stack([g.gradient["branch_lengths"]
                                      for g in pgs]), dtype=torch.float64)
    ref = TreeLikelihoodEngine(eng.site_pattern, eng.model, device=dev,
                               dtype=torch.float64)
    ll_ref, g_ref = ref.ll_and_branch_gradients(
        trees, {k: v.double() for k, v in params.items()})
    ll_err = rel_err(ll, ll_ref.cpu())
    g_err = norm_err(grads, g_ref[:, :grads.shape[1]].cpu())
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock,
                                       eng.branch_length_matrix(trees, enc))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    on = eng._onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    M, N1, C = dst.shape[1], P.shape[1], P.shape[2]
    check(C == 1 and paired.onchip_plan("ll", on.ll_rows, M, N1, C)
          and paired.onchip_plan("grad", on.grad_rows, M, N1, C),
          "vbpi: one rate category, and the trees fit the on-chip bodies")
    ll_ops = (dst, tip, e, P, tips, pi, prop, w)
    grad_ops = (dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
    calls = {"paired_ll_onchip": lambda: paired.paired_log_likelihoods(
                 *ll_ops, onchip=on),
             "paired_grad_onchip": lambda: paired.paired_ll_and_gradients(
                 *grad_ops, onchip=on)}
    ll_k = calls["paired_ll_onchip"]()
    ll_g, g_k = calls["paired_grad_onchip"]()
    ll_p, g_p = paired.paired_ll_and_gradients_ref(
        *[x.double() if x.is_floating_point() else x for x in grad_ops])
    k_err = max(rel_err(ll_k, ll_p), rel_err(ll_g, ll_p), norm_err(g_k, g_p))
    print(f"# phase 3: vbpi last sample ({len(trees)} trees, C={C}): the "
          f"card in float32 against the float64 engine: LL rel err "
          f"{ll_err:.3e}, grad max-abs/max|g| {g_err:.3e}; the paired "
          f"kernels against their float64 plain versions {k_err:.3e} (bound "
          f"{BOUND:g})")
    check(max(ll_err, g_err, k_err) <= BOUND,
          "vbpi: the card's LL and gradients agree with float64")

    # The SBN's topology gradients on the card (float64) against numpy.
    theta = np.array([t.branch_lengths[:-1] for t in trees])
    log_f = burrito.px_log_f(ll.numpy(), theta,
                             burrito.branch_model.px_branch_representation())
    got = inst.topology_gradients(log_f, burrito.use_vimco)
    want = inst.topology_gradients(log_f, burrito.use_vimco, backend="numpy")
    t_err = np.abs(got - want).max() / np.abs(want).max()
    print(f"# phase 3: vbpi topology gradients (VIMCO) on the card in "
          f"float64 against the numpy backend: max-abs/max|g| {t_err:.3e} "
          "(bound 1e-10)")
    check(bool(np.isfinite(got).all()) and t_err <= 1e-10,
          "vbpi: topology gradients on the card match numpy")

    # What the step's kernels and its new topology set cost.
    fl_ll, fl_grad = tree_flops(enc, eng.site_pattern, eng.model, len(trees))
    moved = nbytes(P, tips, pi, prop, w, dst, on.child, e)
    lines = []
    for name, flops, extra in (("paired_ll_onchip", fl_ll,
                                nbytes(on.live_row)),
                               ("paired_grad_onchip", fl_grad,
                                nbytes(src, dP, mask))):
        b_ms, b_by = bound(flops, moved + extra)
        lines.append(f"{name} {cuda_ms(calls[name], 50):.4f} ms (bound "
                     f"{b_ms:.4f} by {b_by}, {counts[name]} launches on the "
                     "path)")
    tape_ms = topology_set_ms(eng.site_pattern, eng.model, trees, 5)
    # The sample's SBN indexer representations (host): the native call the
    # step makes, then sbn/maps.py's on the same trees, which must agree.
    reps_ms, python_ms = [], []
    support = inst.sbn_support
    for _ in range(3):
        inst._indexer_reps_cache = None
        t0 = time.perf_counter()
        native_reps = inst.make_indexer_representations()
        t1 = time.perf_counter()
        python_reps = [sbn_maps.unrooted_representation(
            support.indexer, t.topology, support.size()) for t in trees]
        reps_ms.append((t1 - t0) * 1e3)
        python_ms.append((time.perf_counter() - t1) * 1e3)
    check(native_reps == python_reps, "vbpi: the last sample's native "
          "representations equal the pure-Python ones")
    print(f"# phase 3: vbpi shape ({len(trees)} trees x {eng.pattern_pad} "
          f"patterns, C={C}; CUDA events around 50 calls): " + ", ".join(lines)
          + "; a new topology set, host ms before the first launch: "
          "encoding {:.3f}, paired tapes {:.3f} (the on-chip tape {:.3f} of "
          "it); the sample's SBN indexer representations {:.3f} ms native "
          "(one call), {:.3f} ms pure Python, equal (host, medians of 3); on "
          "{}".format(*tape_ms, float(np.median(reps_ms)),
                      float(np.median(python_ms)), card))
    return counts


def rooted_files(tmp, taxa=ROOTED_TAXA, trees=BATCH):
    """The rooted path's inputs in `tmp`: `trees` dated time trees over
    `taxa` taxa (names t<i>_<date>, branch lengths height differences) and
    a DS1-shaped alignment over them (1,949 columns, 934 distinct), from
    SEED.  Returns (newick path, fasta path)."""
    text, dates = _synthetic.dated_trees_newick(SEED, taxa, trees)
    nwk, fasta = f"{tmp}/rooted.nwk", f"{tmp}/rooted.fasta"
    with open(nwk, "w") as f:
        f.write(text)
    with open(fasta, "w") as f:
        f.write(_synthetic.fasta_text(_synthetic.random_alignment(
            SEED + 1, list(dates), _synthetic.DS1_SITES,
            _synthetic.DS1_DISTINCT_COLUMNS)))
    return nwk, fasta


class HostTimes:
    """Host milliseconds of each call, the card synchronised around it."""

    def __init__(self):
        self.ms = {}

    def __call__(self, name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out


def rooted_instance_of(files, dev, dtype, times=None):
    """The rooted path's instance (rooted_instance, the user's entry point):
    the trees through the native parser, the dates from the names, the
    alignment, ROOTED_SPEC with the oracle's GTR rates, frequencies and
    Weibull shape (ROOTED_PARAMS), every tree's clock rates ROOTED_RATE.  `times` (a
    HostTimes) times each call."""
    call = times or (lambda name, fn, *a, **k: fn(*a, **k))
    nwk, fasta = files
    inst = rooted_instance("rooted", device=dev, dtype=dtype)
    call("read_newick_file", inst.read_newick_file, nwk)
    call("parse_dates_from_taxon_names", inst.parse_dates_from_taxon_names,
         True)
    inst.read_fasta_file(fasta)
    call("prepare_for_phylo_likelihood", inst.prepare_for_phylo_likelihood,
         PhyloModelSpecification(*ROOTED_SPEC))
    block = inst.get_phylo_model_param_block_map()
    for key, value in ROOTED_PARAMS.items():
        block[key][:] = value
    for state in inst.tree_states:
        state.rates[:] = ROOTED_RATE
    return inst


def rooted_parity(files, dev):
    """Phase 2 on the rooted trees: both paired kernels, through their
    wrappers, on the rooted instance's operands (bifurcating roots,
    substitution lengths rate x time, Weibull4) against their plain
    versions in float64.  Returns {kernel: (its call on these operands,
    its bound)} for phase 3's times."""
    inst = rooted_instance_of(files, dev, PRODUCT_DTYPE)
    eng, trees = inst.engine, inst.tree_collection.trees
    params = inst._params_dict()
    bl = inst._subst_branch_lengths()
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    on = eng._onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    M, N1, C = dst.shape[1], P.shape[1], P.shape[2]
    check(paired.onchip_plan("ll", on.ll_rows, M, N1, C)
          and paired.onchip_plan("grad", on.grad_rows, M, N1, C),
          "rooted: the trees fit the on-chip bodies")
    ll_ops = (dst, tip, e, P, tips, pi, prop, w)
    grad_ops = (dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
    ll_k = paired.paired_log_likelihoods(*ll_ops, onchip=on)
    ll_g, g_k = paired.paired_ll_and_gradients(*grad_ops, onchip=on)
    ll_p, g_p = paired.paired_ll_and_gradients_ref(
        *[x.double() if x.is_floating_point() else x for x in grad_ops])
    errs = (rel_err(ll_k, ll_p), rel_err(ll_g, ll_p), norm_err(g_k, g_p))
    print(f"# phase 2: rooted trees ({enc.num_taxa} taxa, bifurcating "
          f"roots, {len(trees)} trees x {eng.pattern_pad} patterns, C={C}): "
          f"paired_ll_onchip LL rel err {errs[0]:.3e}; paired_grad_onchip "
          f"LL rel err {errs[1]:.3e}, grad max-abs/max|g| {errs[2]:.3e} "
          f"(bound {BOUND:g}, plain version in float64 on the same operands)")
    check(max(errs) <= BOUND, "rooted: the paired kernels agree with their "
          "plain versions")
    fl_ll, fl_grad = tree_flops(enc, eng.site_pattern, eng.model, len(trees))
    moved = nbytes(P, tips, pi, prop, w, dst, on.child, e)
    calls = {"paired_ll_onchip": (
                 lambda: paired.paired_log_likelihoods(*ll_ops, onchip=on),
                 bound(fl_ll, moved + nbytes(on.live_row) + len(trees) * 4)),
             "paired_grad_onchip": (
                 lambda: paired.paired_ll_and_gradients(*grad_ops, onchip=on),
                 bound(fl_grad, moved + nbytes(src, dP, mask)
                       + len(trees) * (1 + enc.num_slots) * 4))}
    return calls


def rooted_path(files, dev, card, kernel_calls):
    """The rooted path (phase 3): rooted_instance on the card in float32,
    driven as a user drives it, then held against the same instance in
    float64 on the card (the scan tape), as the module docstring says."""
    times = HostTimes()
    reset_launches()
    with counting_scan_calls() as scan:
        inst = rooted_instance_of(files, dev, PRODUCT_DTYPE, times)
        ll = times("log_likelihoods", inst.log_likelihoods)
        ll0 = times("log_likelihoods (no Jacobian)", inst.log_likelihoods,
                    include_log_det_jacobian=False)
        pgs = times("phylo_gradients", inst.phylo_gradients)
        times("process_loaded_trees", inst.process_loaded_trees)
        times("train_simple_average", inst.train_simple_average)
        usp = times("unconditional_subsplit_probabilities",
                    inst.unconditional_subsplit_probabilities)
        torch.cuda.synchronize()
    counts = {name: KERNELS[name]["wrapper"].launches
              for name in ("paired_ll_onchip", "paired_grad_onchip")}
    read_launches("rooted")
    trees, eng = inst.tree_collection.trees, inst.engine
    print(f"# phase 3: rooted path ({eng.site_pattern.num_taxa} dated taxa, "
          f"{len(trees)} time trees, {eng.site_pattern.site_count} columns, "
          f"{eng.site_pattern.pattern_count} patterns, "
          f"{'+'.join(ROOTED_SPEC)} at shape "
          f"{ROOTED_PARAMS['site_model_parameters'][0]}, clock rate "
          f"{ROOTED_RATE}): "
          f"{scan['calls']} calls of the scan tape (the model gradients' "
          "postorder and adjoint preorder)")
    check(eng._route(eng._shared_model(inst._params_dict())) == "paired",
          "rooted: the instance's shared model row takes the paired kernels")
    check(scan["calls"] == 1, "rooted: only the model gradients (one "
          "reverse pass for both blocks) take the scan tape")
    # The same instance in float64 on the card: the engine's scan tape.
    ref = rooted_instance_of(files, dev, torch.float64)
    ll_ref = ref.log_likelihoods()
    ll0_ref = ref.log_likelihoods(include_log_det_jacobian=False)
    pgs_ref = ref.phylo_gradients()
    outs = [ll, ll0] + [g for pg in pgs for g in pg.gradient.values()]
    check(all(np.isfinite(x).all() for x in outs)
          and ll.shape == (len(trees),)
          and all(set(pg.gradient) == set(ROOTED_KEYS) for pg in pgs),
          "rooted: finite outputs of the expected shapes and keys")
    errs = {"LL": max(rel_err(torch.as_tensor(ll), torch.as_tensor(ll_ref)),
                      rel_err(torch.as_tensor(ll0),
                              torch.as_tensor(ll0_ref)))}
    for key in ROOTED_KEYS:
        errs[key] = norm_err(
            torch.as_tensor(np.stack([pg.gradient[key] for pg in pgs])),
            torch.as_tensor(np.stack([pg.gradient[key] for pg in pgs_ref])))
    print("# phase 3: rooted path against the instance in float64 on the "
          "card (LL rel err, gradients max-abs/max|g|): " + ", ".join(
              f"{key} {err:.3e}" for key, err in errs.items())
          + f" (bound {BOUND:g})")
    check(max(errs.values()) <= BOUND,
          "rooted: the card's LL and every gradient agree with float64")
    check(len(usp) > 0 and all(0.0 <= p <= 1.0 + 1e-12 for p in usp.values()),
          "rooted: unconditional subsplit probabilities in [0, 1]")
    lines = []
    for name, (call, (b_ms, b_by)) in kernel_calls.items():
        lines.append(f"{name} {cuda_ms(call, 20):.4f} ms (bound {b_ms:.4f} "
                     f"by {b_by}, {counts[name]} launches on the path)")
    print(f"# phase 3: rooted shape ({len(trees)} trees x {eng.pattern_pad} "
          f"patterns, C={eng.model.category_count}; CUDA events around 20 "
          "calls): " + ", ".join(lines) + "; host ms of each call: "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in times.ms.items())
          + f"; {len(usp)} subsplits; on {card}")
    return counts


# -- the chunk lab (row 11) ---------------------------------------------------
CHUNK_CHECKED = ("v0", "w4", "w8", "norescale", "notips", "fixstore", "nodot",
                 "unroll")


def chunk_tapes(enc, W, dev, flagship_tapes):
    """(post_dst, tip_slot, post_e, on-chip tape) of the chunked schedule at
    width W: the engine's own at chunked.W (`flagship_tapes`), else built."""
    if W == chunked.W:
        return flagship_tapes
    ce = chunked.build_chunked_encoding(enc, W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                   for x in (ce.post_dst, ce.tip_slot, ce.post_e))
    return dst, tip, e, chunked.onchip_tape(ce.post_dst, ce.tip_slot, dev)


def chunk_lab_parity(enc, ops, flagship_tapes, dev, errs):
    """Phase 2 for chunk_variant: each of the chunk lab's kernel variants
    against its float64 plain version (perf_chunk_lab.chunk_variant_ref)
    on the flagship's chunked operands: the LL within BOUND relative
    (notips: within BOUND per site of the plain version's near-zero LL;
    nodot, not a likelihood: the same non-finite rows, the finite ones,
    per-site log values near 0 here (the padded all-ones columns), within
    BOUND).  Prints every variant's error before it checks them.  Fills
    errs["chunk_variant"] with the worst LL error of the likelihood
    variants."""
    P, tips, pi, prop, w = ops
    w64 = w.double()
    worst, worst_abs, lines, results = 0.0, 0.0, [], []
    for name in CHUNK_CHECKED:
        variant, W = perf_chunk_lab.parse_name(name)
        dst, tip, e, on = chunk_tapes(enc, W, dev, flagship_tapes)
        rows = perf_chunk_lab.chunk_variant(dst, tip, e, P, tips, pi, prop,
                                            variant=variant, onchip=on)
        torch.cuda.synchronize()
        plain = perf_chunk_lab.chunk_variant_ref(dst, tip, e, P, tips, pi,
                                                 prop, variant=variant)
        ll, ll_p = rows.double() @ w64, plain @ w64
        if name == "nodot":
            fin = torch.isfinite(plain)
            same = torch.equal(torch.isfinite(rows), fin)
            err = ((rows.double() - plain)[fin].abs().max().item()
                   if same and fin.any() else (0.0 if same else math.inf))
            what = (f"rows max-abs err {err:.3e} ({int(fin.sum())} finite, "
                    f"max |row| {plain[fin].abs().max().item():.3e})")
        elif name == "notips":
            err = ((ll - ll_p).abs().max() / w64.sum()).item()
            what = (f"LL {ll.abs().max().item():.3e} (plain "
                    f"{ll_p.abs().max().item():.3e}), error per site "
                    f"{err:.3e}")
        else:
            err = rel_err(ll, ll_p)
            worst = max(worst, err)
            worst_abs = max(worst_abs, (ll - ll_p).abs().max().item())
            what = f"LL rel err {err:.3e}"
        lines.append(f"{name} {what}")
        results.append((name, err))
    errs["chunk_variant"] = (worst, worst_abs)
    print("# phase 2: chunk_variant against its float64 plain version on "
          f"the flagship's chunked operands (bound {BOUND:g}): "
          + "; ".join(lines))
    for name, err in results:
        check(err <= BOUND, f"chunk_variant {name} agrees with its plain "
              "version")


def run_chunklab(dev):
    """The chunklab path: the chunk lab's entry point, as `python -m
    bito_tpu_torch.perflab chunk` runs it, over every name at its five
    sweeps of perf_chunk_lab.ITERS calls, whose best phase 4 reports.
    Returns (the lab's Flagship, its results)."""
    print(f"# phase 3: chunklab path (python -m bito_tpu_torch.perflab "
          f"chunk: {' '.join(perf_chunk_lab.NAMES)}; five sweeps each)")
    flag = perf_chunk_lab.Flagship(dev)
    return flag, perf_chunk_lab.run(perf_chunk_lab.NAMES, flag, repeats=5)


def check_chunklab(flag, out):
    """Phase 3's checks of the chunklab path: every name timed; the
    likelihood variants finite; v0 equal to chunked_ll_onchip's rows on the
    same operands; w4, w8, norescale, fixstore and unroll within BOUND of
    v0."""
    check(all(ms > 0 for ms, _ in out.values()), "chunklab: every name timed")
    ll0 = out["v0"][1]
    for name in ("w2", "w4", "w8", "norescale", "fixstore", "unroll"):
        ll = out[name][1]
        check(bool(torch.isfinite(ll).all()) and rel_err(ll, ll0) <= BOUND,
              f"chunklab {name} agrees with v0")
    dst, tip, e, on = flag.tapes(chunked.W)
    P = flag.P()
    plan = chunked.ll_plan(on.ll_rows, dst.shape[1], P.shape[1], 4)
    ship = chunked.chunked_ll_onchip(dst, on, e, P, flag.tips, flag.pi,
                                     flag.props, plan)
    v0 = perf_chunk_lab.chunk_variant(dst, tip, e, P, flag.tips, flag.pi,
                                      flag.props, variant="v0", onchip=on)
    check(torch.equal(ship, v0), "chunklab: v0 equals chunked_ll_onchip's "
          "rows on the same operands")
    print("# phase 3: chunklab: v0's rows equal chunked_ll_onchip's; w4, w8 "
          "at most {:.3e} from v0 (LL rel err)".format(max(
              rel_err(out[n][1], ll0) for n in ("w4", "w8"))))


def chunk_lab_times(flag, res, enc_flops, card):
    """Phase 4 for row 11: each kernel variant alone (perflab.graph_ms, the
    launches into an output allocated once) beside its bound (the LL's
    FLOPs of bench.py at PEAK_FLOPS, nodot's without the evolves, against
    the bytes at PEAK_BYTES), then the chunklab path's results `res` (the
    best of five sweeps, as evals/s), and preponly's share of a flagship
    LL call."""
    fl_ll, fl_evolve = enc_flops
    dst, _tip, e, on = flag.tapes(chunked.W)
    P = flag.P()
    out = torch.empty((dst.shape[0], flag.tips.shape[-1]), device=P.device,
                      dtype=torch.float32)
    moved = nbytes(dst, on.child, on.live_row, e, P, flag.tips, flag.pi,
                   flag.props, out)
    lines = []
    for variant in perf_chunk_lab.VARIANT_CODES:
        rows = perf_chunk_lab.variant_rows(variant, dst, on)
        plan = perf_chunk_lab.variant_plan(variant, rows, dst.shape[1],
                                           P.shape[1], 4)
        ms = graph_ms(lambda: perf_chunk_lab.launch_chunk_variant(
            dst, on, e, P, flag.tips, flag.pi, flag.props, plan, out,
            variant=variant, rows=rows), 50,
            counter=perf_chunk_lab.chunk_variant)
        b_ms, b_by = bound(fl_ll - (fl_evolve if variant == "nodot" else 0),
                           moved)
        lines.append(f"{variant} {ms:.4f} ms (bound {b_ms:.4f} by {b_by}, "
                     f"{plan.cols * plan.lanes // 32} warps, {rows} rows)")
        check(ms >= b_ms, f"chunk_variant {variant} within its bound")
    print(f"# phase 4: chunk_variant, each variant alone ({GRAPH_TIMING}, "
          f"50 launches; {BATCH} trees x {flag.tips.shape[-1]} patterns): "
          + ", ".join(lines) + f" on {card}")
    per_call = {name: ms / perf_chunk_lab.ITERS for name, (ms, _) in
                res.items()}
    print("# phase 4: chunk lab, ms per call (best of 5 sweeps of "
          f"{perf_chunk_lab.ITERS} calls; evals/s = {BATCH} / ms): "
          + ", ".join(f"{n} {ms:.4f} ({BATCH / ms * 1e3:.1f} evals/s)"
                      for n, ms in per_call.items())
          + f"; preponly (P from float64 model ingredients, cast) is "
          f"{per_call['preponly'] / per_call['v0']:.3f} of v0's call, the "
          f"kernel alone (fixedop) {per_call['fixedop'] / per_call['v0']:.3f};"
          f" on {card}")
    return per_call


# -- the gp path ----------------------------------------------------------------
def gp_files(tmp):
    """The gp path's inputs, written to `tmp`: a synthetic credible set
    (_synthetic.credible_set_newick: 12 rooted trees over DS1's 27 taxa,
    each the first after 2 random NNIs, with branch lengths) and a
    DS1-shaped alignment (1,949 columns, 934 distinct).  Returns (newick,
    fasta)."""
    names = _synthetic.taxon_names(_synthetic.DS1_TAXA)
    nwk, fasta = f"{tmp}/credible.nwk", f"{tmp}/ds1_shaped.fasta"
    with open(nwk, "w") as f:
        f.write(_synthetic.credible_set_newick(SEED, _synthetic.DS1_TAXA))
    with open(fasta, "w") as f:
        f.write(_synthetic.fasta_text(_synthetic.random_alignment(
            SEED + 1, names, _synthetic.DS1_SITES,
            _synthetic.DS1_DISTINCT_COLUMNS)))
    return nwk, fasta


def gp_flow(files, dev, dtype, times=None, carry=None):
    """config3's flow through gp_instance (the user's entry point), timed
    by `times` (a HostTimes) where given: read, make_dag, make_gp_engine,
    populate_plvs, compute_likelihoods, the per-PCSP LLs; one
    optimize_branch_lengths_once; estimate_branch_lengths(GP_TOL,
    GP_MAX_ITER); estimate_sbn_parameters; calculate_hybrid_marginals.
    With `carry`, another run's states (after the sweep, after the
    estimate, after the SBN estimate), in convert.gp_state's form, the
    engine takes the first in place of its own sweep, the second before
    the SBN estimate and the third before the hybrid marginals, so that
    each step starts from the other run's numbers.  Returns (instance,
    {what: value}), with "states" this run's three and "sbn_in" the q and
    hybrid marginals that the SBN estimate's softmax takes."""
    call = times or (lambda name, fn, *a, **k: fn(*a, **k))
    nwk, fasta = files
    inst = gp_instance(device=dev, dtype=dtype)
    call("read_fasta_file", inst.read_fasta_file, fasta)
    call("read_newick_file", inst.read_newick_file, nwk)
    call("make_dag", inst.make_dag)
    call("make_gp_engine", inst.make_gp_engine)
    call("populate_plvs", inst.populate_plvs)
    call("compute_likelihoods", inst.compute_likelihoods)
    out = dict(marginal=inst.get_log_marginal_likelihood(),
               pcsp=call("get_per_gpcsp_log_likelihoods",
                         inst.get_per_gpcsp_log_likelihoods))
    if carry is None:
        call("optimize_branch_lengths_once",
             inst.optimize_branch_lengths_once)
    else:
        gp_state_from_numpy(inst.get_gp_engine(), **carry[0])
    states = [gp_state(inst.get_gp_engine())]
    out["estimate"] = call("estimate_branch_lengths",
                           inst.estimate_branch_lengths, GP_TOL, GP_MAX_ITER)
    out["plv_finite"] = bool(torch.isfinite(inst.get_gp_engine().plv).all())
    states.append(gp_state(inst.get_gp_engine()))
    if carry is not None:
        gp_state_from_numpy(inst.get_gp_engine(), **carry[1])
    # the per-PCSP LLs that the SBN estimate's softmax takes
    inst.populate_plvs()
    inst.compute_likelihoods()
    out["sbn_ll"] = inst.get_per_gpcsp_log_likelihoods()
    out["sbn_in"] = (inst.get_sbn_parameters(),
                     inst.get_hybrid_marginals().copy())
    call("estimate_sbn_parameters", inst.estimate_sbn_parameters)
    out["sbn_marginal"] = inst.get_log_marginal_likelihood()
    out["q"] = inst.get_sbn_parameters()
    states.append(gp_state(inst.get_gp_engine()))
    out["states"] = states
    if carry is not None:
        gp_state_from_numpy(inst.get_gp_engine(), **carry[2])
    call("calculate_hybrid_marginals", inst.calculate_hybrid_marginals)
    out["hybrid"] = inst.get_hybrid_marginals().copy()
    return inst, out


def gp_path(files, dev, card):
    """The gp path (phase 3): config3's flow on the card in float32, no
    hand-written kernel launched, held against the same flow in float64
    on the card: the log marginal and every per-PCSP LL at the start's
    branch lengths within BOUND relative; from the float32 run's lengths
    after its sweep (carried into the float64 engine), the log marginal
    after estimate_branch_lengths within BOUND relative (the objective,
    not the argmin: Brent in float32 stops at about sqrt(eps)); then, from
    the float32 run's branch lengths after the estimate, the
    log marginal after estimate_sbn_parameters within BOUND relative, and
    the SBN parameters within Q_BOUND absolute (at DS1's magnitudes, LLs
    near -7e4, float32 holds the per-PCSP LLs that the softmax takes to
    about 1e-2, and q moves with them); the control, the same softmax on
    float64's LLs rounded to Q_CONTROL_BITS significand bits, must exceed
    Q_BOUND; and from the float32 run's SBN parameters, every finite
    hybrid marginal within BOUND relative.  Returns (the float32 instance,
    its HostTimes)."""
    times = HostTimes()
    reset_launches()
    inst, out = gp_flow(files, dev, PRODUCT_DTYPE, times)
    torch.cuda.synchronize()
    read_launches("gp")
    dag, eng = inst.get_dag(), inst.get_gp_engine()
    print(f"# phase 3: gp path (config3's flow at DS1's shape: "
          f"{dag.taxon_count} taxa, {eng.site_pattern.site_count} columns, "
          f"{eng.S} patterns, a synthetic credible set of "
          f"{inst.tree_count()} trees): DAG of "
          f"{dag.node_count_without_dag_root()} nodes and {dag.edge_count()} "
          f"edges, {len(eng.schedule.rootward)} rootward and "
          f"{len(eng.schedule.leafward)} leafward levels, "
          f"{int(dag.topology_count())} topologies; no hand-written kernel "
          "launched")
    ref_inst, ref = gp_flow(files, dev, torch.float64, carry=out["states"])
    hyb, hyb_ref = out["hybrid"], ref["hybrid"]
    fin = np.isfinite(hyb_ref)
    errs = dict(
        marginal=abs(out["marginal"] - ref["marginal"]) / abs(ref["marginal"]),
        pcsp=float(np.max(np.abs(out["pcsp"] - ref["pcsp"])
                          / np.abs(ref["pcsp"]))),
        estimate=abs(out["estimate"] - ref["estimate"]) / abs(ref["estimate"]),
        sbn=abs(out["sbn_marginal"] - ref["sbn_marginal"])
        / abs(ref["sbn_marginal"]),
        sbn_ll=float(np.max(np.abs(out["sbn_ll"] - ref["sbn_ll"])
                            / np.abs(ref["sbn_ll"]))),
        hybrid=float(np.max(np.abs(hyb[fin] - hyb_ref[fin])
                            / np.abs(hyb_ref[fin]))) if fin.any() else 0.0)
    print("# phase 3: gp path against the same flow in float64 on the card "
          "(relative errors): " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in errs.items())
          + f" (bound {BOUND:g}); log marginal {out['marginal']:.4f} at the "
          f"start, {out['estimate']:.4f} after estimate_branch_lengths("
          f"{GP_TOL:g}, {GP_MAX_ITER}) (float64 {ref['estimate']:.4f}); "
          f"{int(fin.sum())} finite hybrid marginals; host ms of each call: "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in times.ms.items())
          + f"; on {card}")
    check(out["plv_finite"] and np.isfinite(out["pcsp"]).all()
          and np.isfinite([out["marginal"], out["estimate"]]).all(),
          "gp: finite PLVs, per-PCSP LLs and marginals")
    check(out["pcsp"].shape == (dag.edge_count(),), "gp: one LL a PCSP")
    check(out["estimate"] > out["marginal"], "gp: the estimate raised the "
          "log marginal")
    check(np.array_equal(np.isfinite(hyb), fin) and fin.any(),
          "gp: the same finite hybrid marginals")
    check(max(errs.values()) <= BOUND, "gp: float32 on the card agrees "
          "with float64")
    q_err = float(np.max(np.abs(out["q"] - ref["q"])))
    controls = {bits: float(np.max(np.abs(sbn_q_of_rounded(
        ref_inst.get_gp_engine(), ref["sbn_ll"], *ref["sbn_in"], bits)
        - ref["q"]))) for bits in sorted({53, 22, 20, 18, Q_CONTROL_BITS},
                                   reverse=True)}
    print(f"# phase 3: gp SBN parameters: max |q - q64| {q_err:.3e} "
          f"(bound {Q_BOUND:g}); the per-PCSP LLs' largest absolute error "
          f"{float(np.max(np.abs(out['sbn_ll'] - ref['sbn_ll']))):.3e}; "
          "controls, max |q - q64| of the softmax on float64's LLs rounded "
          "to n significand bits: " + ", ".join(
              f"n={b} {e:.3e}" for b, e in controls.items()))
    # at 53 bits the control recomputes float64's q, up to the card's
    # unordered float64 sums (about 1e-11 in an LL near -7e4)
    check(controls[53] <= 1e-9, "gp: the control's softmax is the SBN "
          "estimate's")
    check(controls[Q_CONTROL_BITS] > Q_BOUND, "gp: the q check's control "
          "fails it")
    check(q_err <= Q_BOUND, "gp: the SBN estimate agrees with float64")
    return inst, times


def sbn_q_of_rounded(eng, ll, q, hybrid, bits):
    """The SBN estimate's softmax (engine.update_sbn_probabilities' call
    of _sbn_segment_softmax) on `eng`'s segments, from SBN parameters `q`
    and hybrid marginals `hybrid`, on the per-PCSP LLs `ll` rounded to
    `bits` significand bits: the q check's control."""
    m, e = np.frexp(ll)
    ll = np.ldexp(np.round(m * 2.0 ** bits) / 2.0 ** bits, e)
    seg_ids, nseg, singleton, covered = eng._sbn_segment_arrays()
    return eng._host(_sbn_segment_softmax(
        eng._tensor(q), eng._tensor(ll), eng._tensor(hybrid), seg_ids, nseg,
        singleton, covered))


class CudaOps(TorchDispatchMode):
    """Counts the torch operations whose (first) output is a CUDA tensor
    (views excluded): about one kernel each, at a fraction of a profiler's
    cost on a program of 1e5 kernels."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if (not func.is_view and isinstance(first, torch.Tensor)
                and first.is_cuda):
            self.count += 1
        return out


def gp_times(inst, times, card):
    """Phase 4 for the gp path: config3's metrics on the gp path's float32
    instance, the card synchronised: ms per populate + per-PCSP pass
    (populate_plvs, compute_likelihoods, get_per_gpcsp_log_likelihoods;
    best of GP_REPS) and ms per optimize sweep (the gp path's
    optimize_branch_lengths_once, from its HostTimes `times`); the device
    kernels of a populate pass (torch.profiler) and the torch operations
    on the card of a pass and of a sweep (CudaOps, one further sweep)."""
    eng = inst.get_gp_engine()

    def populate_pass():
        eng.populate_plvs()
        eng.compute_likelihoods()
        eng.per_gpcsp_log_likelihoods()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    populate_pass()
    pop_ms = min(timed(populate_pass) for _ in range(GP_REPS))
    opt_ms = times.ms["optimize_branch_lengths_once"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        populate_pass()
        torch.cuda.synchronize()
    kernels = sum(1 for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    ops = {}
    for name, fn in (("populate", populate_pass),
                     ("sweep", eng.optimize_branch_lengths_once)):
        with CudaOps() as counter:
            fn()
        ops[name] = counter.count
    print(f"# phase 4: gp (config3's metrics, the card synchronised): "
          f"populate + per-PCSP pass {pop_ms:.3f} ms (best of {GP_REPS}; "
          f"{kernels} device kernels by torch.profiler, {ops['populate']} "
          f"torch operations on the card), optimize sweep {opt_ms:.3f} ms "
          f"(the gp path's call; {ops['sweep']} torch operations on the "
          f"card), {inst.get_dag().edge_count()} edges; on {card}")
    return pop_ms, opt_ms


# -- the nni path ---------------------------------------------------------------
def no_launches(what):
    """Check that no hand-written kernel launched (since the last reset)."""
    counts = {n: spec["wrapper"].launches for n, spec in KERNELS.items()}
    check(not any(counts.values()), f"{what}: no hand-written kernel "
          f"launched ({ {n: c for n, c in counts.items() if c} })")


def nni_instance(paths, dev, dtype, scoring):
    """A gp_instance as nni_search builds one: the FASTA and the seed
    Newick read, make_dag, then for TP scoring make_tp_engine and its two
    take-first setters, for GP scoring make_gp_engine and
    take_first_branch_length."""
    inst = gp_instance(device=dev, dtype=dtype)
    inst.read_fasta_file(paths["alignment.fasta"])
    inst.read_newick_file(paths["seed.nwk"])
    inst.make_dag()
    if scoring == "gp_likelihood":
        inst.make_gp_engine()
        inst.take_first_branch_length()
    else:
        inst.make_tp_engine()
        inst.tp_engine_set_branch_lengths_by_taking_first()
        inst.tp_engine_set_choice_map_by_taking_first()
    return inst


def timed_method(obj, name, timer, phase):
    """Wrap obj.name so that each call runs inside timer.phase(phase)."""
    fn = getattr(obj, name)

    def call(*args, **kwargs):
        with timer.phase(phase):
            return fn(*args, **kwargs)

    setattr(obj, name, call)


def batched_against_serial(search, label):
    """Hold the batched scorer (float64 on the card) against the serial
    numpy scorer on the search's next candidate set: within SCORER_BOUND
    relative, or ROUNDED_BOUND where a Brent step was decided by rounding.
    Returns (candidates, rounded, worst relative error of the others,
    torch operations on the card of one batched call)."""
    eng = search.engine
    nnis = sorted(search.new_adjacent or search.adjacent, key=nni_sort_key)
    best = eng.build_best_edge_map(nnis)
    batched, serial, rounded = batch_scorer.scores_with_brent_traces(
        eng, nnis, best)
    with CudaOps() as counter:
        eng.score_proposed_nnis_batched(nnis, best)
    ops = counter.count
    rel = np.abs(batched - serial) / np.abs(serial)
    worst = float(rel[~rounded].max()) if (~rounded).any() else 0.0
    print(f"# phase 3: nni batched scorer ({label} candidate set, "
          f"{len(nnis)} candidates): float64 on the card against the serial "
          f"numpy scorer, worst rel err {worst:.3e} (bound {SCORER_BOUND:g}) "
          f"over {int((~rounded).sum())}; {int(rounded.sum())} with a Brent "
          f"step decided by rounding, worst rel err "
          f"{float(rel[rounded].max()) if rounded.any() else 0.0:.3e} "
          f"(bound {ROUNDED_BOUND:g}); {ops} torch operations on the card "
          "in one batched call")
    check(np.isfinite(batched).all() and worst <= SCORER_BOUND
          and bool(np.all(rel[rounded] <= ROUNDED_BOUND)),
          f"nni: the batched scorer agrees with the serial scorer ({label})")
    return len(nnis), int(rounded.sum()), worst, ops


def faithful_search(paths, dev, card):
    """config5's product path: the faithful TP-likelihood search through
    gp_instance (make_nni_engine's default scoring) at DS1's shape,
    NNI_ITERS iterations at opt_max NNI_OPT_MAX, top-1, with nni/search.py's
    posterior tracking.  First the TP engine's top_tree_log_likelihoods
    (paired_ll_onchip) against float64.  The batched scorer is held to
    the serial scorer on the first and the last iteration's candidate
    sets; the search itself launches no hand-written kernel.  Returns
    {what: value} for phase 4 and the records."""
    inst = nni_instance(paths, dev, PRODUCT_DTYPE, "tp_likelihood")
    tp = inst.get_tp_engine()
    reset_launches()
    top = tp.top_tree_log_likelihoods()
    torch.cuda.synchronize()
    read_launches("nni")
    top_launches = paired.paired_ll_onchip.launches
    twin = TreeLikelihoodEngine(tp.site_pattern,
                                PhyloModel(PhyloModelSpecification()),
                                device=dev, dtype=torch.float64)
    top64 = twin.log_likelihoods(tp.top_trees(), {}).cpu().numpy()
    top_err = float(np.max(np.abs(top - top64) / np.abs(top64)))
    print(f"# phase 3: nni TP engine top_tree_log_likelihoods ("
          f"{len(top)} DAG edges' top trees, JC69, C = 1): "
          f"{top_launches} launches of paired_ll_onchip, rel err against "
          f"float64 {top_err:.3e} (bound {BOUND:g})")
    check(np.isfinite(top).all() and top_err <= BOUND,
          "nni: top-tree LLs agree with float64")

    eng = inst.make_nni_engine("tp_likelihood")
    search = eng.search
    check(search.engine.device == dev, "nni: the faithful engine's scorer "
          "runs on the card")
    search.engine.optimize_max_iter = NNI_OPT_MAX
    eng.set_top_k_score_filtering_scheme(1)
    pp_maps = PosteriorProbabilityMaps(
        paths["alignment.fasta"], paths["credible.nwk"], paths["pp.csv"],
        paths["pcsp_pp.csv"])
    results = SearchResults()
    timer = SyncedPhases()
    timed_method(search.engine, "score_adjacent_nnis", timer, "score")
    timed_method(search, "_add_accepted_nnis_to_dag", timer, "accept")
    timed_method(search, "run_post_loop", timer, "post")
    reset_launches()
    eng.run_init()
    cred0 = pp_maps.get_credible_edge_count(eng.dag)[0]
    checks, margins, loop_s = [], [], 0.0
    for it in range(1, NNI_ITERS + 1):
        if it in (1, NNI_ITERS):
            checks.append(batched_against_serial(
                search, "first" if it == 1 else "last"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accepted = eng.run_main_loop()
        loop_s += time.perf_counter() - t0
        ranked = sorted(search.scored.values(), reverse=True)
        margins.append(ranked[0] - ranked[1] if len(ranked) > 1 else math.inf)
        results.add_entry(it, eng.dag, eng, pp_maps, eng.scored_nnis())
        check(accepted, f"nni: the faithful search accepted at iteration {it}")
        t0 = time.perf_counter()
        eng.run_post_loop()
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
    no_launches("nni faithful search")
    cred = pp_maps.get_credible_edge_count(eng.dag)[0]
    phases = {n: v * 1e3 / NNI_ITERS for n, v in timer.totals.items()}
    ips = NNI_ITERS / loop_s
    print(f"# phase 3: nni faithful search (gp_instance, make_nni_engine "
          f"tp_likelihood; {eng.dag.taxon_count} taxa, "
          f"{search.engine.site_pattern.pattern_count} patterns, opt_max "
          f"{NNI_OPT_MAX}, top-1): {NNI_ITERS} iterations, "
          f"{len(results.rows)} accepted, {ips:.3f} iterations/s; an "
          "iteration (ms, the card synchronised at phase edges): "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in phases.items())
          + f"; DAG {eng.dag.node_count_without_dag_root()} nodes, "
          f"{eng.dag.edge_count()} edges, credible edges {cred0} -> {cred} "
          f"of {pp_maps.get_credible_edge_total()}; top-1 margins (best - "
          "second score) " + ", ".join(f"{m:.4g}" for m in margins)
          + f"; on {card}")
    check(len(results.rows) == NNI_ITERS
          and all(np.isfinite(r["score"]) for r in results.rows),
          "nni: one finite accepted score an iteration")
    return dict(ips=ips, phases=phases, checks=checks,
                top_launches=top_launches)


def pending_candidates(eng):
    """(keys, trees) that the whole-tree engine's next score_adjacent_nnis
    scores: the adjacent NNIs not yet scored, each with its candidate tree
    (a fresh copy)."""
    keys, trees = [], []
    for key, nni in eng.adjacent.items():
        if key in eng.scored:
            continue
        tree = eng._candidate_tree(nni)
        if tree is not None:
            keys.append(key)
            trees.append(tree)
    return keys, trees


def whole_tree_search(paths, dev, scoring, card):
    """The whole-tree NNIEngine at DS1's shape on the card in float32,
    NNI_WHOLE_ITERS iterations, top-1.  Each iteration's candidate trees
    are scored by a float64 engine on the card from the float32 run's own
    state.  With TP likelihood: the float32 run's candidate trees, with
    the branch lengths its optimize_selected_branches gave them, by the
    float64 engine (the scan tape) within BOUND relative of the float32
    scores; and, printed without a bound, the scores that float64 reaches
    when it optimizes the same trees' new edges itself (two Jacobi rounds
    of Brent from the same lengths, which float32's rounding can steer to
    another point: a branch at the lower bound moves a conflicting site's
    LL by log t).  With parsimony: Sankoff in float64, equal.  Returns (iterations/s, the last candidate set's trees,
    their site patterns, the iteration's phases, paired_ll_onchip's
    launches)."""
    inst = nni_instance(paths, dev, PRODUCT_DTYPE, scoring)
    likelihood = scoring == "tp_likelihood"
    sp = inst.get_tp_engine().site_pattern
    if likelihood:  # make_nni_engine's tp_likelihood is the faithful search
        eng = NNIEngine(inst.get_dag(), sp, inst.tree_collection.trees,
                        device=dev, dtype=PRODUCT_DTYPE)
        twin = TreeLikelihoodEngine(sp, PhyloModel(PhyloModelSpecification()),
                                    device=dev, dtype=torch.float64)
    else:
        eng = inst.make_nni_engine(scoring)
        twin = SankoffHandler(sp, device=dev, dtype=torch.float64)
    eng.timer = SyncedPhases()
    timed_method(eng, "score_adjacent_nnis", eng.timer, "score")
    timed_method(eng, "_rebuild_engines", eng.timer, "accept.rebuild")
    eng.set_top_k_score_filtering_scheme(1)
    reset_launches()
    eng.run_init()
    errs, margins, loop_s, trees = [], [], 0.0, []
    for it in range(NNI_WHOLE_ITERS):
        keys, trees = pending_candidates(eng)
        if likelihood:
            indexer = eng.dag.build_edge_indexer()
            sel = [eng._new_edge_nodes(t, indexer) for t in trees]
            bl = twin.optimize_selected_branches(
                trees, {}, sel, iterations=eng._optimization_iterations)
            for b, t in enumerate(trees):
                t.branch_lengths = bl[b, : t.topology.num_nodes].copy()
            ref = twin.log_likelihoods(trees, {}).cpu().numpy()
        else:
            ref = -twin.run_sankoff(trees)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(eng.run_main_loop(), f"nni {scoring}: accepted at {it + 1}")
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
        scores = {**eng.scored, **eng.accepted_scores_this_iter}
        got = np.array([scores[k] for k in keys])
        rest = [eng.scored[k] for k in eng.adjacent if k in eng.scored]
        margins.append(max(eng.accepted_scores_this_iter.values())
                       - max(rest) if rest else math.inf)
        if likelihood:
            mine = [eng._candidate_trees[k] for k in keys]
            kernel_ref = twin.log_likelihoods(mine, {}).cpu().numpy()
            errs.append((float(np.max(np.abs(got - ref) / np.abs(ref))),
                         float(np.max(np.abs(got - kernel_ref)
                                      / np.abs(kernel_ref)))))
        else:
            check(np.array_equal(got, ref), "nni tp_parsimony: Sankoff on "
                  "the card equals the float64 plain version")
        t0 = time.perf_counter()
        eng.run_post_loop()
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
    launches = 0
    if likelihood:
        read_launches("nni")
        launches = paired.paired_ll_onchip.launches
    else:
        no_launches("nni tp_parsimony")
    phases = {n: v * 1e3 / NNI_WHOLE_ITERS for n, v in eng.timer.totals.items()}
    ips = NNI_WHOLE_ITERS / loop_s
    what = ("candidate LLs against float64 on the float32 run's "
            f"optimized trees: worst rel err {max(e[1] for e in errs):.3e} "
            f"(bound {BOUND:g}); against float64's own optimization of the "
            f"same trees (no bound): worst rel err "
            f"{max(e[0] for e in errs):.3e}; {launches} launches of "
            "paired_ll_onchip"
            if likelihood else "Sankoff scores on the card equal to float64's "
            "plain version; no hand-written kernel launched")
    print(f"# phase 3: nni whole-tree engine, {scoring} ({sp.num_taxa} taxa, "
          f"{sp.pattern_count} patterns, top-1): {NNI_WHOLE_ITERS} iterations,"
          f" {len(keys)} candidates in the last, {ips:.3f} iterations/s; an "
          "iteration (ms, the card synchronised at phase edges): "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in phases.items())
          + f"; {what}; top-1 margins " + ", ".join(f"{m:.4g}" for m in margins)
          + f"; on {card}")
    if likelihood:
        check(all(e[1] <= BOUND for e in errs), "nni tp_likelihood: float32 "
              "candidate scores agree with float64 on the same trees")
    return ips, trees, sp, phases, launches


def gp_scores64(eng, dev):
    """The GP-scored engine's next scores, by a float64 GP engine on the
    card over the same grafted DAG, from the float32 run's state (its
    carried branch lengths and frozen q), as score_adjacent_nnis builds
    them."""
    keys = list(eng.adjacent)
    grafted, central = graft_node_pairs(
        eng.dag, [(eng.adjacent[k].parent, eng.adjacent[k].child)
                  for k in keys])
    e64 = GPEngine(eng.site_pattern, grafted, device=dev, dtype=torch.float64)
    eng._carry_branch_lengths(e64, dict(zip(eng.gp.dag.pretty_edges(),
                                            eng.gp._host(eng.gp._blc))))
    eng._carry_q(e64, keys)
    e64.populate_plvs()
    e64.compute_likelihoods()
    ll = e64.per_gpcsp_log_likelihoods()
    return {k: float(ll[c]) for k, c in zip(keys, central)}


def gp_scored_search(paths, dev, card):
    """config5's GP-scored search (gp_instance, make_gp_engine,
    take_first_branch_length, make_nni_engine gp_likelihood) on six taxa
    on the card in float32, run to completion (at most NNI_GP_ITERS
    iterations), top-1; each iteration's scores against a float64 GP
    engine from the float32 run's state within BOUND relative; no
    hand-written kernel.  A float32 GP engine refuses TF32.  Returns
    (iterations/s, the iteration's phases, torch operations on the card
    of one iteration)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        nni_instance(paths, dev, PRODUCT_DTYPE, "gp_likelihood")
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(refused, "nni: a float32 GP engine refuses TF32")
    inst = nni_instance(paths, dev, PRODUCT_DTYPE, "gp_likelihood")
    eng = inst.make_nni_engine("gp_likelihood")
    eng.set_top_k_score_filtering_scheme(1)
    reset_launches()
    eng.run_init()
    iters, errs, margins, loop_s, ops = 0, [], [], 0.0, None
    while iters < NNI_GP_ITERS and eng.adjacent_nni_count():
        ref = gp_scores64(eng, dev)
        # The first iteration counts the torch operations on the card (a
        # dispatch hook on every one) and is not timed.
        counting = contextlib.nullcontext() if iters else CudaOps()
        if iters == 1:
            eng.timer = SyncedPhases()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting:
            accepted = eng.run_main_loop()
            if accepted:
                eng.run_post_loop()
        torch.cuda.synchronize()
        if iters:
            loop_s += time.perf_counter() - t0
        else:
            ops = counting.count
        scores = {**eng.scored, **getattr(eng, "accepted_scores_this_iter",
                                          {})}
        errs.append(max(abs(scores[k] - v) / abs(v) for k, v in ref.items()))
        ranked = sorted(ref.values(), reverse=True)
        margins.append(ranked[0] - ranked[1] if len(ranked) > 1 else math.inf)
        if not accepted:
            break
        iters += 1
    no_launches("nni gp_likelihood")
    timed = max(iters - 1, 1)
    phases = {n: v * 1e3 / timed for n, v in eng.timer.totals.items()}
    ips = (iters - 1) / loop_s if iters > 1 else math.nan
    print(f"# phase 3: nni GP-scored search ({NNI_GP_TAXA} taxa, "
          f"{eng.site_pattern.pattern_count} patterns, top-1, to completion): "
          f"{iters} iterations, {ips:.3f} iterations/s (all but the first); "
          "an iteration (ms, the card synchronised at phase edges): "
          + ", ".join(
              f"{n} {ms:.1f}" for n, ms in phases.items())
          + f"; {ops} torch operations on the card in the first; scores "
          f"against float64 worst rel err {max(errs):.3e} (bound {BOUND:g}); "
          "top-1 margins (float64) " + ", ".join(f"{m:.4g}" for m in margins)
          + f"; no hand-written kernel launched; on {card}")
    check(iters > 0 and max(errs) <= BOUND, "nni: the GP-scored search's "
          "float32 scores agree with float64")
    return ips, phases, ops


def nni_path(tmp, dev, card):
    """The nni path (phase 3): config5's two searches, the faithful
    TP-likelihood search at DS1's shape and the GP-scored search on six
    taxa, and the whole-tree engine at DS1's shape with TP-likelihood and
    with parsimony scoring.  Inputs from _synthetic.write_nni_inputs: the
    seed is a random rooted tree, the alignment simulated under JC69 along
    the seed after TRUTH_NNIS random NNIs.  Returns {what: value} for
    phase 4 and the PERF.md lines."""
    ds1 = _synthetic.write_nni_inputs(
        tempfile.mkdtemp(dir=tmp), SEED, _synthetic.DS1_TAXA,
        _synthetic.DS1_SITES, _synthetic.DS1_DISTINCT_COLUMNS)
    six = _synthetic.write_nni_inputs(tempfile.mkdtemp(dir=tmp), SEED,
                                      NNI_GP_TAXA, NNI_GP_SITES)
    out = dict(faithful=faithful_search(ds1, dev, card))
    out["tp_likelihood"] = whole_tree_search(ds1, dev, "tp_likelihood", card)
    out["tp_parsimony"] = whole_tree_search(ds1, dev, "tp_parsimony", card)
    out["gp"] = gp_scored_search(six, dev, card)
    return out


def nni_kernel_times(nni, dev, card):
    """Phase 4 for the nni path: paired_ll_onchip at the whole-tree
    engine's last candidate batch (JC69, C = 1), its plain version and its
    bound; held once against the float64 plain version within BOUND."""
    _ips, trees, sp, _phases, _launches = nni["tp_likelihood"]
    model = PhyloModel(PhyloModelSpecification())
    e = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    enc = e.encode(trees)
    bl = e.branch_length_matrix(trees, enc)
    eig, rates, props, clock = e._model_ingredients({}, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P = prep.prepare_inputs(eig, rates, clock, bl)
    dst, tip, _src, edge, _mask = e._paired_tapes(enc)
    onchip = e._onchip_tape(enc)
    tips, w = e._kernel_tips, e._kernel_weights
    ops = (dst, tip, edge, P, tips, pi, prop, w)
    got = paired.paired_log_likelihoods(*ops, onchip=onchip)
    want = paired.paired_log_likelihoods_ref(
        *[x.double() if x.is_floating_point() else x for x in ops])
    err = rel_err(got, want)
    check(err <= BOUND, "nni: paired_ll_onchip at the candidate batch")
    p1 = cuda_ms(lambda: paired.paired_log_likelihoods_ref(*ops), 5)
    k1 = cuda_ms(lambda: paired.paired_log_likelihoods(*ops, onchip=onchip),
                 50)
    k2 = cuda_ms(lambda: paired.paired_log_likelihoods(*ops, onchip=onchip),
                 50)
    p2 = cuda_ms(lambda: paired.paired_log_likelihoods_ref(*ops), 5)
    fl_ll, _ = tree_flops(enc, sp, model, len(trees))
    moved = nbytes(dst, onchip.child, onchip.live_row, edge, P, tips, pi,
                   prop, w) + len(trees) * 4
    b_ms, b_by = bound(fl_ll, moved)
    print(f"# phase 4: nni paired_ll_onchip at the whole-tree engine's "
          f"candidate batch ({len(trees)} trees x {sp.num_taxa} taxa x "
          f"{sp.pattern_count} patterns, pad {e.pattern_pad}, C = 1): kernel "
          f"{(k1 + k2) / 2:.4f} ms (CUDA events around the calls), plain "
          f"{(p1 + p2) / 2:.4f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({fl_ll:,} FLOPs, {moved:,} bytes); rel err "
          f"against float64 {err:.3e}; on {card}")
    return (k1 + k2) / 2, (p1 + p2) / 2, b_ms


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs an NVIDIA card: "
                 "torch.cuda.is_available() is False")
    # The device line counts the visible cards; the run uses one.
    check(torch.cuda.device_count() == 1,
          f"one visible card, got {torch.cuda.device_count()} "
          "(choose one with CUDA_VISIBLE_DEVICES)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(PRODUCT_DEVICE)
    t_start = time.perf_counter()

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    print(card)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    print(f"# phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({so.name})")
    for kernel, spill, regs in ptxas_usage(so.with_suffix(".log").read_text()):
        print(f"#   ptxas {kernel}: {regs}; {spill}")

    # -- the workload ---------------------------------------------------------
    trees, sp, model = flagship()
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    ref = TreeLikelihoodEngine(sp, model, device=dev, dtype=torch.float64)
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    params64 = params_from_numpy(PARAMS, dev, torch.float64)
    enc = eng.encode(trees)
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    print(f"# workload: {sp.num_taxa} taxa, {sp.site_count} sites, "
          f"{sp.pattern_count} patterns (pad {eng.pattern_pad}), "
          f"{len(trees)} trees, {enc.num_slots} nodes, GTR+Gamma4; "
          f"chunked tape W={ce.W}, {ce.Mc} chunks")

    # -- 2. kernels against their plain versions ------------------------------
    ends = [time.perf_counter()]  # each phase's end, for its duration
    bl = eng.branch_length_matrix(trees, enc)
    eig, rates, props, clock = eng._model_ingredients(params, BATCH)
    pi, prop = prep.kernel_model(eig, props)
    tips, w = eng._kernel_tips, eng._kernel_weights
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    onchip = eng._onchip_tape(enc)
    P, dPq = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    _, dP = prep.prepare_inputs_grad(eig, rates, clock, bl)
    cdst, ctip, cedge, crow, _ = eng._chunked_tapes(enc)
    con = eng._chunked_onchip_tape(enc)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    pon = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                              enc.num_taxa, enc.num_slots, dev)
    pll = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                          enc.num_slots, dev)
    ll_ops = (dst, tip, e, P, tips, pi, prop, w)
    grad_ops = (dst, tip, src, e, mask, P, dPq, tips, pi, prop, w)
    check(all(paired.onchip_plan(k, r, M, P.shape[1], 4)
              for k, r, M in (("ll", onchip.ll_rows, dst.shape[1]),
                              ("grad", onchip.grad_rows, dst.shape[1]),
                              ("ll", pll.ll_rows, post.shape[1])))
          and chunked.ll_plan(con.ll_rows, cdst.shape[1], P.shape[1], 4)
          and chunked.onchip_plan(con.grad_rows, cdst.shape[1], P.shape[1], 4)
          and pernode.onchip_plan(pon.rows, pon.ints, P.shape[1], 4),
          "the flagship fits the on-chip bodies")
    args = {  # kernel -> (plain version, its arguments, call of the kernel)
        "paired_ll_onchip": (  # the wrappers' body here
            paired.paired_log_likelihoods_ref, ll_ops,
            lambda: paired.paired_log_likelihoods(*ll_ops, onchip=onchip)),
        "paired_grad_onchip": (
            paired.paired_ll_and_gradients_ref, grad_ops,
            lambda: paired.paired_ll_and_gradients(*grad_ops, onchip=onchip)),
        "paired_ll": (  # the global body, through the same final sums
            paired.paired_log_likelihoods_ref, ll_ops,
            lambda: paired.paired_ll_global(dst, tip, e, P, tips, pi,
                                            prop) @ w),
        "paired_grad": (
            paired.paired_ll_and_gradients_ref, grad_ops,
            lambda: paired.finish_rows(*paired.paired_grad_global(
                dst, tip, src, e, P, dPq, tips, pi, prop, w), mask, w)),
    }
    cgrad_ops = (cdst, ctip, cedge, crow, mask, P, dP, tips, pi, prop, w)
    args["chunked_grad_onchip"] = (  # the wrapper's body here
        chunked.chunked_ll_and_gradients_ref, cgrad_ops,
        lambda: chunked.chunked_ll_and_gradients(*cgrad_ops, onchip=con))
    args["chunked_grad"] = (  # the global body, through the same final sums
        chunked.chunked_ll_and_gradients_ref, cgrad_ops,
        lambda: chunked.finish_rows(*chunked.chunked_grad_global(
            cdst, ctip, cedge, P, dP, tips, pi, prop, w), crow, mask, w))
    cll_ops = (cdst, ctip, cedge, P, tips, pi, prop, w)
    args["chunked_ll_onchip"] = (  # the wrapper's body here
        chunked.chunked_log_likelihoods_ref, cll_ops,
        lambda: chunked.chunked_log_likelihoods(*cll_ops, onchip=con))
    args["chunked_ll"] = (  # the global body, through the same final sum
        chunked.chunked_log_likelihoods_ref, cll_ops,
        lambda: chunked.chunked_ll_global(cdst, ctip, cedge, P, tips, pi,
                                          prop) @ w)
    pll_ops = (post, root, P, tips, pi, prop, w)
    args["pernode_ll_onchip"] = (  # the wrapper's body here
        pernode.pernode_log_likelihoods_ref, pll_ops,
        lambda: pernode.pernode_log_likelihoods(*pll_ops, onchip=pll))
    args["pernode_ll"] = (  # the global body, through the same final sum
        pernode.pernode_log_likelihoods_ref, pll_ops,
        lambda: pernode.pernode_ll_global(post, root, P, tips, pi, prop) @ w)
    pgrad_ops = (post, pre, root, mask, P, dP, tips, pi, prop, w)
    args["pernode_grad_onchip"] = (  # the wrapper's body here
        pernode.pernode_ll_and_gradients_ref, pgrad_ops,
        lambda: pernode.pernode_ll_and_gradients(*pgrad_ops, onchip=pon))
    args["pernode_grad"] = (  # the global body, through the same final sums
        pernode.pernode_ll_and_gradients_ref, pgrad_ops,
        lambda: pernode.finish_rows(*pernode.pernode_grad_global(
            post, pre, root, P, dP, tips, pi, prop, w), mask, w))
    errs = {}  # kernel -> (relative or max-norm error, max abs error)
    for ll_name, grad_name in (("paired_ll_onchip", "paired_grad_onchip"),
                               ("paired_ll", "paired_grad"),
                               ("chunked_ll_onchip", "chunked_grad_onchip"),
                               ("chunked_ll", "chunked_grad"),
                               ("pernode_ll_onchip", "pernode_grad_onchip"),
                               ("pernode_ll", "pernode_grad")):
        ll_k = args[ll_name][2]()
        ll_g, g_k = args[grad_name][2]()
        torch.cuda.synchronize()
        plain, grad_args, _ = args[grad_name]
        ll_p, g_p = plain(*[x.double() if x.is_floating_point() else x
                            for x in grad_args])
        errs[ll_name] = (rel_err(ll_k, ll_p),
                         (ll_k.double() - ll_p).abs().max().item())
        errs[grad_name] = (norm_err(g_k, g_p),
                           (g_k.double() - g_p).abs().max().item())
        ll_g_err = rel_err(ll_g, ll_p)
        print(f"# phase 2: {ll_name} LL rel err {errs[ll_name][0]:.3e}; "
              f"{grad_name} LL rel err {ll_g_err:.3e}, grad max-abs/max|g| "
              f"{errs[grad_name][0]:.3e} (bound {BOUND:g}, plain version "
              f"in float64 on the same operands)")
        check(errs[ll_name][0] <= BOUND, f"{ll_name} LL parity")
        check(ll_g_err <= BOUND, f"{grad_name} LL parity")
        check(errs[grad_name][0] <= BOUND, f"{grad_name} gradient parity")

    lab_ops = dict(post_ops=post, pre_ops=pre, root=root, edge_mask=mask, P=P,
                   dP=dP, tips=tips, pi=pi, props=prop, weights=w)
    lab_calls, plain_outs, probe_work = probe_parity(lab_ops, dev, errs)
    chunk_lab_parity(enc, (P, tips, pi, prop, w), (cdst, ctip, cedge, con),
                     dev, errs)
    rooted_dir = tempfile.TemporaryDirectory()
    rooted_inputs = rooted_files(rooted_dir.name)
    rooted_calls = rooted_parity(rooted_inputs, dev)

    ends.append(time.perf_counter())
    # -- 3. the paths ------------------------------------------------------------
    scales = [1.0 + 0.001 * k for k in range(SWEEP)]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, params64)
    ref_fn = ref.branch_eval_fn(trees, params64)
    bl64 = bl.double()
    refs = [(ll_ref, g_ref)] + [ref_fn(bl64 * f) for f in scales]

    def against_reference(path, lls, pairs, refs=refs):
        """Hold the path's (ll) and sweep (ll, grads) against the float64
        engine's `refs`: lls at the base branch lengths, pairs [(ll,
        grads)] beside refs, at the base and then at scaled lengths."""
        ll_r0, g_r0 = refs[0]
        check(pairs[0][0].shape == ll_r0.shape
              and pairs[0][1].shape == g_r0.shape, f"{path} output shapes")
        outs = list(lls) + [x for pair in pairs for x in pair]
        check(all(bool(torch.isfinite(x).all()) for x in outs),
              f"{path} outputs are finite")
        ll_errs = [rel_err(x, ll_r0) for x in lls]
        g_errs = []
        for (ll_k, g_k), (ll_r, g_r) in zip(pairs, refs):
            ll_errs.append(rel_err(ll_k, ll_r))
            g_errs.append(norm_err(g_k, g_r))
        print(f"# phase 3: {path} path against the float64 engine (scan "
              f"tape), worst over {len(g_errs)} calls: LL rel err "
              f"{max(ll_errs):.3e}, grad max-abs/max|g| {max(g_errs):.3e} "
              f"(bound {BOUND:g})")
        check(max(ll_errs + g_errs) <= BOUND,
              f"{path} path agrees with the float64 engine")

    launches = {}
    reset_launches()
    ll = eng.log_likelihoods(trees, params)
    pairs = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs += [fn(bl * f) for f in scales]
    torch.cuda.synchronize()
    launches.update(read_launches("paired"))
    against_reference("paired", [ll], pairs)

    # The large path: the same entry points, past the on-chip bodies.
    ltrees, lsp, lmodel = large_trees()
    large = TreeLikelihoodEngine(lsp, lmodel, device=dev, dtype=PRODUCT_DTYPE)
    large64 = TreeLikelihoodEngine(lsp, lmodel, device=dev,
                                   dtype=torch.float64)
    lenc = large.encode(ltrees)
    lon = large._onchip_tape(lenc)
    lM, lN1 = large._paired_tapes(lenc)[0].shape[1], lenc.num_slots + 1
    print(f"# phase 3: large path: {lsp.num_taxa} taxa, {len(ltrees)} trees, "
          f"{large.pattern_pad} patterns; {lon.ll_rows} live rows (LL) and "
          f"{lon.grad_rows} rows (grad) a pattern; on-chip plans "
          f"{paired.onchip_plan('ll', lon.ll_rows, lM, lN1, 4)} (LL), "
          f"{paired.onchip_plan('grad', lon.grad_rows, lM, lN1, 4)} (grad)")
    lbl = large.branch_length_matrix(ltrees, lenc)
    lscales = scales[:3]
    lfn64 = large64.branch_eval_fn(ltrees, params64)
    lrefs = [large64.ll_and_branch_gradients(ltrees, params64)] + [
        lfn64(lbl.double() * f) for f in lscales]
    reset_launches()
    ll = large.log_likelihoods(ltrees, params)
    pairs = [large.ll_and_branch_gradients(ltrees, params)]
    fn = large.branch_eval_fn(ltrees, params)
    pairs += [fn(lbl * f) for f in lscales]
    torch.cuda.synchronize()
    launches.update(read_launches("large"))
    against_reference("large", [ll], pairs, lrefs)

    # The chunked route on the same trees, past the on-chip grad body.
    large.kernel = "chunked"
    lce = large._chunked_tapes(lenc)[0]
    lcon = large._chunked_onchip_tape(lenc)
    print(f"# phase 3: large-chunked path: MW={lce.shape[1]}, "
          f"{lcon.ll_rows} live rows (LL) and {lcon.grad_rows} rows (grad) "
          f"a pattern; on-chip plans "
          f"{chunked.ll_plan(lcon.ll_rows, lce.shape[1], lN1, 4)} "
          f"(LL), {chunked.onchip_plan(lcon.grad_rows, lce.shape[1], lN1, 4)}"
          " (grad)")
    reset_launches()
    ll = large.log_likelihoods(ltrees, params)
    pairs = [large.ll_and_branch_gradients(ltrees, params)]
    fn = large.branch_eval_fn(ltrees, params)
    pairs += [fn(lbl * f) for f in lscales]
    torch.cuda.synchronize()
    launches.update(read_launches("large-chunked"))
    against_reference("large-chunked", [ll], pairs, lrefs)

    # The per-node functions on the same trees, past the on-chip grad body.
    leig, lrates, lprops, lclock = large._model_ingredients(params,
                                                            len(ltrees))
    lpi, lprop = prep.kernel_model(leig, lprops)
    lpost, lpre, lroot = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                          for x in (lenc.post_ops, lenc.pre_ops, lenc.root))
    lmask = torch.as_tensor(lenc.edge_mask, dtype=torch.float32, device=dev)
    lpon = pernode.onchip_tape(lenc.post_ops, lenc.pre_ops, lenc.root,
                               lenc.num_taxa, lenc.num_slots, dev)
    lpll = pernode.ll_tape(lenc.post_ops, lenc.root, lenc.num_taxa,
                           lenc.num_slots, dev)
    print(f"# phase 3: large-pernode path: {lpll.ll_rows} live rows (LL) "
          f"and {lpon.rows} rows (grad) a pattern; on-chip plans "
          f"{paired.onchip_plan('ll', lpll.ll_rows, lpost.shape[1], lN1, 4)} "
          f"(LL), {pernode.onchip_plan(lpon.rows, lpon.ints, lN1, 4, least=1)}"
          " (grad)")
    ltips, lw = large._kernel_tips, large._kernel_weights
    reset_launches()
    lP, _ = prep.prepare_inputs_grad(leig, lrates, lclock, lbl)
    ll = pernode.pernode_log_likelihoods(lpost, lroot, lP, ltips, lpi, lprop,
                                         lw, onchip=lpll)
    pairs = []
    for f in [1.0] + lscales:
        Pk, dPk = prep.prepare_inputs_grad(leig, lrates, lclock, lbl * f)
        pairs.append(pernode.pernode_ll_and_gradients(
            lpost, lpre, lroot, lmask, Pk, dPk, ltips, lpi, lprop, lw,
            onchip=lpon))
    torch.cuda.synchronize()
    launches.update(read_launches("large-pernode"))
    against_reference("large-pernode", [ll], pairs, lrefs)
    del large, large64, lrefs, pairs

    eng.kernel = "chunked"
    reset_launches()
    ll = eng.log_likelihoods(trees, params)
    ll_fn = eng.ll_eval_fn(trees, params)(bl)
    pairs = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs += [fn(bl * f) for f in scales]
    torch.cuda.synchronize()
    launches.update(read_launches("chunked"))
    against_reference("chunked", [ll, ll_fn], pairs)
    eng.kernel = "auto"

    reset_launches()
    ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w,
                                         onchip=pll)
    pairs = []
    for f in [1.0] + scales:
        Pk, dPk = prep.prepare_inputs_grad(eig, rates, clock, bl * f)
        pairs.append(pernode.pernode_ll_and_gradients(
            post, pre, root, mask, Pk, dPk, tips, pi, prop, w, onchip=pon))
    torch.cuda.synchronize()
    launches.update(read_launches("pernode"))
    against_reference("pernode", [ll], pairs)

    reset_launches()
    lab = run_perflab(lab_ops, dev)
    torch.cuda.synchronize()
    launches.update(read_launches("perflab"))
    check_perflab(lab, plain_outs)

    reset_launches()
    chunk_flag, chunk_out = run_chunklab(dev)
    torch.cuda.synchronize()
    launches.update(read_launches("chunklab"))
    check_chunklab(chunk_flag, chunk_out)

    vbpi_path(dev, card)
    rooted_path(rooted_inputs, dev, card, rooted_calls)
    rooted_dir.cleanup()
    with tempfile.TemporaryDirectory() as gp_dir:
        gp_run = gp_path(gp_files(gp_dir), dev, card)
    with tempfile.TemporaryDirectory() as nni_dir:
        nni_run = nni_path(nni_dir, dev, card)

    # The float64 reference's own gradients against central differences.
    h = 1e-6
    for node in (0, 13, 40):
        step = torch.zeros_like(bl64)
        step[:, node] = h
        fd = (ref.log_likelihoods(trees, params64, bl64 + step)
              - ref.log_likelihoods(trees, params64, bl64 - step)) / (2 * h)
        fd_err = norm_err(g_ref[:, node], fd)
        print(f"# phase 3: float64 gradient vs central difference, node "
              f"{node}: max-abs/max|g| {fd_err:.3e}")
        check(fd_err <= 1e-6, "float64 gradient matches finite differences")

    ends.append(time.perf_counter())
    # -- 4. times --------------------------------------------------------------
    fl_ll, fl_grad = tree_flops(enc, sp, model, BATCH)
    tape_bytes = {"paired_ll_onchip": nbytes(dst, onchip.child,
                                             onchip.live_row, e),
                  "paired_grad_onchip": nbytes(dst, onchip.child, src, e),
                  "paired_ll": nbytes(dst, tip, e),
                  "paired_grad": nbytes(dst, tip, src, e),
                  "chunked_ll_onchip": nbytes(cdst, con.child, con.live_row,
                                              cedge),
                  "chunked_ll": nbytes(cdst, ctip, cedge),
                  "chunked_grad": nbytes(cdst, ctip, cedge, crow),
                  "chunked_grad_onchip": nbytes(cdst, con.child, cedge,
                                                crow),
                  "pernode_ll_onchip": nbytes(pll.post_dst, pll.child,
                                              pll.live_row, pll.post_e),
                  "pernode_ll": nbytes(post, root),
                  "pernode_grad_onchip": nbytes(pon.post, pon.groups,
                                                pon.zero, root),
                  "pernode_grad": nbytes(post, pre, root),
                  "variant_grad": nbytes(post, pre, root)}
    ll_out, grad_out = BATCH * 4, BATCH * (1 + enc.num_slots) * 4
    work = dict(probe_work)  # kernel -> (FLOPs, bytes, library call)
    for name, moved in tape_bytes.items():
        grad = name.endswith("_grad") or name.endswith("_grad_onchip")
        floats = (nbytes(P, tips, pi, prop, w) + (nbytes(dP, mask) if grad
                                                  else 0))
        work[name] = ((fl_grad if grad else fl_ll),
                      moved + floats + (grad_out if grad else ll_out), None)
    # chunk_variant at v0 (the shipping body): its rows [B, S] out, timed
    # alone into an output allocated once
    chunk_rows = torch.empty((BATCH, tips.shape[-1]), device=dev,
                             dtype=torch.float32)
    work["chunk_variant"] = (fl_ll, nbytes(cdst, con.child, con.live_row,
                                           cedge, P, tips, pi, prop,
                                           chunk_rows), None)
    chunk_plan = chunked.ll_plan(con.ll_rows, cdst.shape[1], P.shape[1], 4)
    times = {}  # kernel -> (ms, plain ms, library ms or None)
    calls = {name: (lambda p=plain, a=a: p(*a), kernel)
             for name, (plain, a, kernel) in args.items()}
    calls.update(lab_calls)
    calls["chunk_variant"] = (
        lambda: perf_chunk_lab.chunk_variant_ref(
            cdst, ctip, cedge, P, tips, pi, prop, variant="v0"),
        lambda: perf_chunk_lab.launch_chunk_variant(
            cdst, con, cedge, P, tips, pi, prop, chunk_plan, chunk_rows,
            variant="v0", rows=con.ll_rows))
    for name in KERNELS:
        plain, kernel = calls[name]
        library = work[name][2]
        # The probes' launches are short and their wrappers' host work is
        # not: they, and their library call, are timed from the device
        # (graph_ms).
        graphed = name in GRAPH_TIMED
        timer = (partial(graph_ms, counter=KERNELS[name]["wrapper"])
                 if graphed else cuda_ms)
        lib_timer = graph_ms if graphed else cuda_ms
        # plain, kernel, library, kernel, library, plain: all see the same
        # drift.
        p1 = cuda_ms(plain, 5)
        k1 = timer(kernel, 50)
        l1 = lib_timer(library, 50) if library else None
        k2 = timer(kernel, 50)
        l2 = lib_timer(library, 50) if library else None
        p2 = cuda_ms(plain, 5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2,
                       (l1 + l2) / 2 if library else None)
        b_ms, b_by = kernel_bound(*work[name])
        shape = LAB_SHAPES.get(name, f"float32, {BATCH} trees x "
                                     f"{eng.pattern_pad} patterns")
        terms = (f" (terms: device memory {bound(*work[name][:2])[0]:.4f}, "
                 f"shared memory {work[name][3]:.4f})"
                 if len(work[name]) > 3 else "")
        print(f"# phase 4: {name} kernel {times[name][0]:.4f} ms ("
              + (GRAPH_TIMING if name in GRAPH_TIMED else "CUDA events around "
                 "the calls") + f"), plain {times[name][1]:.4f} ms"
              + (f", torch.sum {times[name][2]:.4f} ms" if library else "")
              + f", bound {b_ms:.4f} ms by {b_by}{terms} ({shape}) on {card}")
        if name in GRAPH_TIMED:  # a device time under its bound is wrong
            check(times[name][0] >= b_ms, f"{name} within its bound")

    E = int(np.asarray(enc.edge_mask).sum(axis=1).mean())
    chunk_lab_times(chunk_flag, chunk_out,
                    (fl_ll, E * 2 * 16 * 4 * sp.pattern_count * BATCH), card)
    del chunk_flag, chunk_out

    # The pipe plan's rule: every experiment at every tile that fits.
    print(f"# phase 4: pipe_cell at every tile that fits ({GRAPH_TIMING}, "
          f"{LAB_REPS} launches; us/cell, {CELLS} cells), on {card}")
    print("# phase 4: pipe tiles " + json.dumps(
        perf_pipe_lab.tile_sweep(reps=LAB_REPS)))

    # The paired bodies side by side, on the flagship and on further
    # shapes up to the on-chip bodies' limit.
    paired_bodies("flagship", eng, trees, params, card)
    chunked_bodies("flagship", eng, trees, params, card)
    pernode_bodies("flagship", eng, trees, params, card)
    for taxa in BODY_TAXA:
        t2, sp2, model2 = body_shape(taxa)
        eng2 = TreeLikelihoodEngine(sp2, model2, device=dev,
                                    dtype=PRODUCT_DTYPE)
        paired_bodies(f"{taxa} taxa", eng2, t2, params, card)
        chunked_bodies(f"{taxa} taxa", eng2, t2, params, card)
        pernode_bodies(f"{taxa} taxa", eng2, t2, params, card)
        del eng2
        torch.cuda.empty_cache()
    for taxa in PERNODE_TAXA:
        t2, sp2, model2 = body_shape(taxa)
        pernode_bodies(f"{taxa} taxa", TreeLikelihoodEngine(
            sp2, model2, device=dev, dtype=PRODUCT_DTYPE), t2, params, card)

    def sweep_evals_per_s(kernel, calls):
        eng.kernel = kernel
        f = eng.branch_eval_fn(trees, params)
        ms = cuda_ms(lambda: f(bl), calls)
        return BATCH / (ms / 1e3), ms

    auto_rate = sweep_evals_per_s("auto", 40)
    rates_line = ", ".join(
        f"{label} {eps:.1f} ({ms:.4f} ms/call)" for label, (eps, ms) in [
            ("paired kernels (auto)", auto_rate),
            ("chunked kernels", sweep_evals_per_s("chunked", 40)),
            ("scan tape", sweep_evals_per_s("scan", 5))])
    eng.kernel = "auto"
    print(f"# phase 4: end to end, DS1-shaped GTR+Gamma4 LL+gradient "
          f"evals/s at B={BATCH}: {rates_line}, on {card}")
    # What a new topology set costs the host, against one call.
    text, aln = _synthetic.ds1_shaped(SEED + 4, TOPOLOGY_BATCH)
    coll = parse_newick_text(text)
    sets = [("B=%d" % BATCH, sp, trees, 5),
            ("B=%d" % TOPOLOGY_BATCH, SitePattern(aln, coll.taxon_names),
             coll.trees, 3)]
    print("# phase 4: a new topology set, host ms before the first launch "
          "(median over fresh engines): " + "; ".join(
              "{}: encoding {:.3f}, paired tapes {:.3f} (the on-chip tape "
              "{:.3f} of it)".format(label, *topology_set_ms(s2, model, t2,
                                                              reps))
              for label, s2, t2, reps in sets)
          + f"; one auto LL+gradient call at B={BATCH} takes "
          f"{auto_rate[1]:.4f} ms on {card}")
    nni_kernel_times(nni_run, dev, card)
    # Last, since its torch.profiler pass leaves the profiler set up.
    t0 = time.perf_counter()
    gp_times(*gp_run, card)
    del gp_run
    print(f"# phase 4: the gp times took {time.perf_counter() - t0:.1f} s")
    ends.append(time.perf_counter())
    print(f"# chip_smoke.py ran in {ends[-1] - t_start:.1f} s (phases 1-4: "
          + ", ".join(f"{b - a:.1f}" for a, b in zip([t_start] + ends, ends))
          + " s)")

    # -- 5. results -------------------------------------------------------------
    kernels = []
    for name, spec in KERNELS.items():
        b_ms, b_by = kernel_bound(*work[name])
        kernels.append(
            {"name": name, "route": "cuda", "source": spec["source"],
             "replaces": spec["replaces"], "launches": launches[name],
             "max_abs_err": errs[name][1], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": times[name][2]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
