"""Driver entry points: the port's counterpart of bito_tpu's
__graft_entry__.py, with the same three functions under the same names.

entry():             the flagship forward (batched GTR+Gamma4 tree log
                     likelihoods [B] on `_toy_inputs()`), as (fn,
                     example_args); on the card in float32 `fn` launches
                     the paired LL kernel (treelike/paired.py,
                     csrc/paired_ll_onchip.cu).
dryrun_multichip(n): the six programs of bito_tpu's dryrun (a training
                     step, the GP engine, the flagship engine on the
                     kernels, a VBPI step, a GP-scored NNI search and an
                     MG94 codon engine), each with its site patterns
                     sharded over n ranks of a torch.distributed job, on
                     tiny synthetic inputs; prints one line that ends in
                     OK, or raises.

Where bito_tpu lays a jax mesh over n devices of one process, a job here
is n processes (dist/): `dryrun_multichip(n)` called inside a job of n
ranks runs the programs on the job's group; called outside one, it
starts n ranks through `python -m bito_tpu_torch.dist.launch` (NCCL where
each rank has a card of its own, Gloo where ranks share one), each of
which runs `dryrun_rank`; `dryrun_results` returns every rank's results
where `dryrun_multichip` prints them.  bito_tpu reads the dryrun's inputs
from the reference's data directory; here they are synthetic stand-ins
of the same taxon counts made from fixed seeds (`write_inputs`,
_synthetic.py).

Everything runs on the card unless the caller passes device="cpu" (then
in float64, where the tests hold it to bito_tpu).  Every check raises
RuntimeError, so that `python -O` keeps it, and nothing falls back: no
card raises, and on the card the flagship programs take the kernels or
raise.  This module imports torch and numpy only.

Self-test on the card: `python -m bito_tpu_torch.graft_entry` runs the
entry forward and dryrun_multichip(torch.cuda.device_count()).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import _synthetic
from .device import PRODUCT_DEVICE, PRODUCT_DTYPE, TEST_DTYPE, resolve
from .models.site import gamma_median_category_rates
from .models.substitution import EigenDecomp, gtr_eigen
from .treelike import paired, prep

ENTRY_CATEGORIES = 4  # entry()'s Gamma categories, as bito_tpu's
GAMMA_SHAPE = 0.5
# The training step's toy inputs (bito_tpu's dryrun: 6 taxa, 64 patterns
# padded to a multiple of the ranks, 2 trees) and its ascent step.
TRAIN = dict(num_taxa=6, num_patterns=64, batch=2)
STEP, MIN_LENGTH = 1e-3, 1e-6
# Stand-ins for the reference's files, at their taxon counts; the seeds,
# and the site counts where the files' are not known here, are this
# module's.
HELLO = dict(seed=31, taxa=3, sites=31)  # hello.fasta, hello_rooted.nwk
DS1_REDUCED = dict(seed=32, taxa=5, trees=2,  # ds1-reduced-5.{nwk,fasta}
                   sites=_synthetic.DS1_SITES)
VBPI = dict(seed=33, taxa=_synthetic.DS1_TAXA, trees=10,  # DS1.subsampled_10.t
            sites=_synthetic.DS1_SITES,                   # and DS1.fasta
            distinct=_synthetic.DS1_DISTINCT_COLUMNS, particles=4, burrito=0)
FIVE_TAXON = dict(seed=34, taxa=5, sites=150)  # five_taxon.fasta, *_rooted.nwk
CODON = dict(seed=35, taxa=5, trees=2, codons=40)  # five_taxon as codons
NNI_ITERS = 2
BRANCH_LENGTH = 0.1  # programs 3 and 6: every branch this long
FLAGSHIP_PARAMS = {"substitution_model_rates": [1 / 6] * 6,
                   "substitution_model_frequencies": [0.25] * 4,
                   "site_model_parameters": [0.5]}
MG94_PARAMS = {"substitution_model_rates": [2.5, 0.3],
               "substitution_model_frequencies": [0.3, 0.2, 0.3, 0.2]}
# bito_tpu's tolerances for the sharded codon engine against the unsharded
CODON_LL_RTOL, CODON_GRAD_RTOL, CODON_GRAD_ATOL = 1e-5, 1e-3, 1e-4
# Programs 1, 3 and 4 against the float64 plain versions on the same
# inputs, unsharded (bench.py's on-device parity guard): LL relative,
# gradients relative to the largest
BOUND = 5e-5
# The launcher's heartbeat and wall-clock limits for the dryrun's ranks
STALL_S, HARD_S = 240, 900
# Rows 1 and 2 of the port's kernel table: each body's launcher
ROW_LAUNCHERS = {"paired_ll_onchip": paired.paired_ll_onchip,
                 "paired_ll": paired.paired_ll_global,
                 "paired_grad_onchip": paired.paired_grad_onchip,
                 "paired_grad": paired.paired_grad_global}
ROW1, ROW2 = ("paired_ll_onchip", "paired_ll"), ("paired_grad_onchip",
                                                "paired_grad")
RANK_LINE = "dryrun_rank "


def _devtype(device, dtype):
    """(device, dtype) resolved: the card in float32 unless the caller
    says otherwise; the CPU in float64 unless a dtype is given."""
    device = torch.device(PRODUCT_DEVICE if device is None else device)
    if dtype is None:
        dtype = PRODUCT_DTYPE if device.type == "cuda" else TEST_DTYPE
    return resolve(device, dtype)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"graft entry: {what}")


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------
def _toy_inputs(num_taxa=8, num_patterns=256, batch=4, categories=4,
                seed=0):
    """Synthetic tree batch and tip data with DS1-like structure, as
    numpy: (encoding, bl [B, num_slots], tips [T, S, 4], weights [S],
    rates6 [6], freqs [4]).  The same draws from default_rng(seed) in the
    same order as bito_tpu's, so every output equals its own: random
    rooted bifurcating topologies by sequential joins, then the branch
    lengths, the tips (0.25 or 1.25), the weights, the GTR rates and the
    frequencies."""
    from .core.tree import _renumber
    from .treelike.encode import encode_trees

    rng = np.random.default_rng(seed)
    topologies = []
    for _ in range(batch):
        roots = list(range(num_taxa))
        children = {i: [] for i in range(num_taxa)}
        next_id = num_taxa
        while len(roots) > 1:
            i, j = sorted(rng.choice(len(roots), size=2, replace=False))
            a, b = roots[i], roots[j]
            children[next_id] = [a, b]
            roots = [r for k, r in enumerate(roots) if k not in (i, j)]
            roots.append(next_id)
            next_id += 1
        ch_list = [children.get(i, []) for i in range(next_id)]
        topologies.append(_renumber(ch_list, num_taxa, roots[0]))
    enc = encode_trees(topologies)
    bl = rng.uniform(0.01, 0.3, (batch, enc.num_slots))
    tips = ((rng.random((num_taxa, num_patterns, 4)) < 0.3).astype(np.float64)
            + 0.25)
    weights = rng.integers(1, 5, num_patterns).astype(np.float64)
    rates6 = rng.dirichlet(np.ones(6))
    freqs = rng.dirichlet(np.ones(4))
    return enc, bl, tips, weights, rates6, freqs


def _paired_tapes(enc, device):
    """(post_dst, tip_slot, post_src, post_e, edge_mask, onchip) of an
    encoding on `device`: int32 tapes, the edge mask as float64 (cast by
    the caller), and the on-chip bodies' tape on the card (None on the
    CPU, where the wrappers run their plain versions)."""
    pe = paired.build_paired_encoding(enc)
    ints = tuple(torch.as_tensor(x, dtype=torch.int32, device=device)
                 for x in (pe.post_dst, pe.tip_slot, pe.post_src, pe.post_e))
    onchip = (paired.onchip_tape(pe.post_dst, pe.tip_slot, device,
                                 post_src=pe.post_src, post_e=pe.post_e,
                                 edges=enc.num_slots + 1)
              if device.type == "cuda" else None)
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float64, device=device)
    return ints + (mask, onchip)


def _gtr_gamma(rates6, freqs, device, categories=ENTRY_CATEGORIES):
    """The model of entry() and the training step, in float64 on
    `device`: (eigensystem, Gamma category rates, proportions)."""
    kw = dict(device=device, dtype=torch.float64)
    eig = gtr_eigen(torch.as_tensor(rates6, **kw),
                    torch.as_tensor(freqs, **kw))
    rates = gamma_median_category_rates(torch.tensor(GAMMA_SHAPE, **kw),
                                        categories)
    return eig, rates, torch.full((categories,), 1.0 / categories, **kw)


def entry(device=None, dtype=None):
    """(fn, example_args): the flagship forward, batched GTR+Gamma4 tree
    log likelihoods [B] on `_toy_inputs()`.

    example_args are bito_tpu's nine, in its order and layouts: bl
    [B, num_slots], tips [T, S, 4], weights [S], the eigensystem's U,
    values, U_inv and pi, the category rates and proportions, as tensors
    on `device` in `dtype`.  The paired tapes are built once, here.  `fn`
    forms P [B, N+1, C, 4, 4] from the eigensystem and the branch
    lengths in float64 on the device (identity at the tapes' DUMMY edge
    N, the engine's prep route), casts it to `dtype` and calls
    paired.paired_log_likelihoods: on the card in float32 the paired LL
    kernel, on the CPU its plain version.  `fn` takes tensors or arrays
    (bito_tpu's example_args as numpy included); `fn.operands` returns
    the wrapper's operands from the same nine.  Defaults: the card in
    float32; device="cpu" gives float64."""
    device, dtype = _devtype(device, dtype)
    enc, bl, tips, weights, rates6, freqs = _toy_inputs()
    B, C = bl.shape[0], ENTRY_CATEGORIES
    post_dst, tip_slot, _src, post_e, _mask, onchip = _paired_tapes(
        enc, device)
    eig, cat_rates, props = _gtr_gamma(rates6, freqs, device, C)
    clock = torch.ones((B,), dtype=torch.float64, device=device)

    def operands(bl, tips, weights, eig_U, eig_vals, eig_Uinv, eig_pi,
                 cat_rates, props):
        """paired_log_likelihoods' operands from the nine arguments."""
        def f64(x):
            return torch.as_tensor(x, dtype=torch.float64, device=device)

        def bcast(x):
            x = f64(x)
            return x.expand((B,) + tuple(x.shape))

        def operand(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        eig_b = EigenDecomp(bcast(eig_U), bcast(eig_vals), bcast(eig_Uinv),
                            bcast(eig_pi))
        P = prep.prepare_inputs(eig_b, bcast(cat_rates), clock, f64(bl),
                                dtype)
        return (post_dst, tip_slot, post_e, P,
                operand(tips).transpose(1, 2).contiguous(), operand(eig_pi),
                operand(props), operand(weights))

    def forward(bl, tips, weights, eig_U, eig_vals, eig_Uinv, eig_pi,
                cat_rates, props):
        return paired.paired_log_likelihoods(
            *operands(bl, tips, weights, eig_U, eig_vals, eig_Uinv, eig_pi,
                      cat_rates, props), onchip=onchip)

    forward.operands = operands
    example_args = tuple(
        torch.as_tensor(x, device=device).to(dtype).contiguous()
        for x in (bl, tips, weights, eig.U, eig.values, eig.U_inv, eig.pi,
                  cat_rates, props))
    return forward, example_args


# ---------------------------------------------------------------------------
# The dryrun's inputs and programs
# ---------------------------------------------------------------------------
def write_inputs(directory) -> dict:
    """Write the dryrun's file inputs into `directory` and return their
    paths by name: hello.fasta / hello_rooted.nwk (a random alignment, one
    rooted tree), the VBPI run's Nexus sample and alignment, and the NNI
    search's five-taxon inputs (_synthetic.write_nni_inputs)."""
    os.makedirs(directory, exist_ok=True)
    names = _synthetic.taxon_names(HELLO["taxa"])
    paths = {"hello.fasta": os.path.join(directory, "hello.fasta"),
             "hello_rooted.nwk": os.path.join(directory, "hello_rooted.nwk")}
    with open(paths["hello.fasta"], "w") as f:
        f.write(_synthetic.fasta_text(_synthetic.random_alignment(
            HELLO["seed"] + 1, names, HELLO["sites"])))
    with open(paths["hello_rooted.nwk"], "w") as f:
        f.write(_synthetic.credible_set_newick(HELLO["seed"], HELLO["taxa"],
                                               num_trees=1))
    vbpi = os.path.join(directory, "vbpi")
    os.makedirs(vbpi, exist_ok=True)
    paths["vbpi.t"], paths["vbpi.fasta"] = _synthetic.write_vbpi_inputs(
        vbpi, VBPI["seed"], VBPI["taxa"], VBPI["trees"], VBPI["sites"],
        VBPI["distinct"])
    nni = os.path.join(directory, "five_taxon")
    os.makedirs(nni, exist_ok=True)
    for name, path in _synthetic.write_nni_inputs(
            nni, FIVE_TAXON["seed"], FIVE_TAXON["taxa"],
            FIVE_TAXON["sites"]).items():
        paths["five_taxon/" + name] = path
    return paths


def ds1_reduced_inputs():
    """(Newick text, alignment) of program 3: ds1-reduced-5's stand-in."""
    d = DS1_REDUCED
    return (_synthetic.random_trees_newick(d["seed"], d["taxa"], d["trees"]),
            _synthetic.random_alignment(d["seed"] + 1,
                                        _synthetic.taxon_names(d["taxa"]),
                                        d["sites"]))


def codon_inputs():
    """(Newick text of unrooted trees, codon alignment) of program 6."""
    d = CODON
    return (_synthetic.random_trees_newick(d["seed"], d["taxa"], d["trees"]),
            _synthetic.codon_alignment(d["seed"] + 1,
                                       _synthetic.taxon_names(d["taxa"]),
                                       d["codons"]))


def _launch_counts():
    return {name: fn.launches for name, fn in ROW_LAUNCHERS.items()}


def _since(before):
    return {name: fn.launches - before[name]
            for name, fn in ROW_LAUNCHERS.items()}


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _ll_err(ll, ref) -> float:
    """The largest relative error of log likelihoods."""
    ll, ref = _host(ll).astype(np.float64), _host(ref).astype(np.float64)
    return float(np.max(np.abs(ll - ref) / np.abs(ref)))


def _errors(ll, grads, ll_ref, grads_ref) -> list:
    """[LL relative error, gradient error relative to the largest
    reference gradient] of (ll, grads) against float64 references."""
    grads, grads_ref = (_host(x).astype(np.float64)
                        for x in (grads, grads_ref))
    return [_ll_err(ll, ll_ref), float(np.max(np.abs(grads - grads_ref))
                                       / np.max(np.abs(grads_ref)))]


def _plain(eng, trees, params):
    """LL and branch gradients of `trees` under `params` by the float64
    scan tape on the CPU over `eng`'s site patterns and model, unsharded:
    the reference of an engine that ran the kernels."""
    from .treelike.engine import TreeLikelihoodEngine

    ref = TreeLikelihoodEngine(eng.site_pattern, eng.model, device="cpu",
                               dtype=torch.float64)
    ref.kernel = "scan"
    return ref.ll_and_branch_gradients(
        trees, {k: v.detach().to("cpu", torch.float64)
                for k, v in params.items()})


def _train_inputs(S, device, dtype):
    """The training step's toy batch on S patterns: (bl [B, num_slots] in
    float64 on `device`; the wrapper's operands before the tips, the
    tapes, edge mask, P and dP, in `dtype`; the tips [T, S, 4] and
    weights [S] as numpy; pi and the proportions in `dtype`; the on-chip
    tape)."""
    enc, bl, tips, weights, rates6, freqs = _toy_inputs(
        num_taxa=TRAIN["num_taxa"], num_patterns=S, batch=TRAIN["batch"])
    dst, tip, src, e, mask, onchip = _paired_tapes(enc, device)
    eig, rates, props = _gtr_gamma(rates6, freqs, device)
    B = bl.shape[0]

    def rows(x):
        return x.expand((B,) + tuple(x.shape))

    bl64 = torch.as_tensor(bl, dtype=torch.float64, device=device)
    P, dP = prep.prepare_inputs_grad_q(
        EigenDecomp(*(rows(x) for x in eig)), rows(rates),
        torch.ones((B,), dtype=torch.float64, device=device), bl64, dtype)
    return (bl64, (dst, tip, src, e, mask.to(dtype), P, dP), tips, weights,
            (eig.pi.to(dtype), props.to(dtype)), onchip)


def train_step(group, S, device, dtype):
    """Program 1: LL and branch gradients of the toy batch on S patterns
    through the pattern-sharded paired kernel wrapper, then one ascent
    step bl <- max(bl + STEP g, MIN_LENGTH).  Returns (ll [B], gradients,
    new bl), whole on every rank."""
    from .dist.multihost import place

    bl64, head, tips, weights, tail, onchip = _train_inputs(S, device, dtype)
    shard = place(tips, device=device, dtype=dtype, pattern_axis=1,
                  group=group).transpose(1, 2).contiguous()
    w = place(weights, device=device, dtype=dtype, pattern_axis=0,
              group=group)
    ll, grads = paired.paired_ll_and_gradients_sharded(
        group, *head, shard, *tail, w, onchip=onchip)
    return ll, grads, torch.clamp(bl64.to(dtype) + STEP * grads,
                                  min=MIN_LENGTH)


def train_plain(S):
    """Program 1's LL and gradients on S patterns by the paired wrapper's
    plain version, unsharded, in float64 on the CPU."""
    _bl, head, tips, weights, tail, _ = _train_inputs(
        S, torch.device("cpu"), torch.float64)
    return paired.paired_ll_and_gradients(
        *head, torch.as_tensor(tips).transpose(1, 2).contiguous(), *tail,
        torch.as_tensor(weights))


def gp_program(paths, group, device, dtype):
    """Program 2: the GP engine on hello's stand-in, sharded: populate,
    likelihoods, one branch-length sweep; the log marginal."""
    from .api.gp import gp_instance

    inst = gp_instance("dryrun", device=device, dtype=dtype)
    inst.read_fasta_file(paths["hello.fasta"])
    inst.read_newick_file(paths["hello_rooted.nwk"])
    inst.make_gp_engine()
    eng = inst.get_gp_engine()
    eng.shard_patterns(group)
    inst.populate_plvs()
    inst.compute_likelihoods()
    eng.optimize_branch_lengths_once()
    return inst.get_log_marginal_likelihood()


def flagship_program(group, device):
    """Program 3: the flagship engine (GTR+Gamma4, float32) sharded on
    the paired kernels: auto on the card, whose route must be the
    kernels' and not the scan tape; on the CPU the kernels' wrappers
    (kernel="cuda"), which run their plain versions there.  Returns (LL
    and gradients of two trees at BRANCH_LENGTH, the LL call's rows)."""
    from .convert import params_from_numpy
    from .core.newick import parse_newick_text
    from .core.site_pattern import SitePattern
    from .models.phylo_model import PhyloModel, PhyloModelSpecification
    from .treelike.engine import TreeLikelihoodEngine

    text, aln = ds1_reduced_inputs()
    coll = parse_newick_text(text)
    like = TreeLikelihoodEngine(
        SitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("GTR", "gamma+4")),
        device=device, dtype=torch.float32)
    like.kernel = "auto" if device.type == "cuda" else "cuda"
    like.shard_patterns(group)
    _check(like._route(True) == "paired",
           "pattern sharding dropped the paired kernels for the scan tape")
    trees = coll.trees[:2]
    for t in trees:
        t.branch_lengths[:] = BRANCH_LENGTH
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in FLAGSHIP_PARAMS.items()}, device,
        torch.float32)
    ll, grads = like.ll_and_branch_gradients(trees, params)
    return (ll, grads, like.log_likelihoods(trees, params), like, trees,
            params)


def vbpi_program(paths, group, device, dtype):
    """Program 4: one VBPI gradient step with the instance engine sharded
    (JC69, the split branch model, lognormal scalars, the simple
    optimizer), then an ELBO estimate.  Every rank makes the trainer from
    the same seed, so every rank draws the same trees.  Returns (the
    ELBO, the trainer)."""
    from .models.phylo_model import PhyloModelSpecification
    from .vi.burrito import Burrito

    burro = Burrito(
        mcmc_nexus_path=paths["vbpi.t"], burn_in_fraction=0.0,
        fasta_path=paths["vbpi.fasta"],
        phylo_model_specification=PhyloModelSpecification(
            "JC69", "constant", "strict"),
        branch_model_name="split", scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=VBPI["particles"],
        thread_count=1, seed=VBPI["burrito"], device=device, dtype=dtype)
    burro.inst.engine.shard_patterns(group)
    _check(burro.inst.engine.group is not None,
           "the VBPI instance engine is not sharded")
    burro.gradient_step()
    return burro.estimate_elbo(particle_count=VBPI["particles"]), burro


def nni_program(paths, group, device, dtype):
    """Program 5: a GP-scored NNI search of at most NNI_ITERS iterations
    on the five-taxon stand-in, its scoring sharded.  Returns
    (iterations, the scored NNIs' keys joined by "|" and sorted, their
    scores)."""
    from .api.gp import gp_instance

    inst = gp_instance("dryrun_nni", device=device, dtype=dtype)
    inst.read_fasta_file(paths["five_taxon/alignment.fasta"])
    inst.read_newick_file(paths["five_taxon/seed.nwk"])
    inst.make_dag()
    inst.make_gp_engine()
    inst.take_first_branch_length()
    nni = inst.make_nni_engine("gp_likelihood")
    nni.shard_patterns(group)
    nni.set_top_k_score_filtering_scheme(1)
    nni.run_init()
    it = 0
    while it < NNI_ITERS and nni.adjacent_nni_count():
        if not nni.run_main_loop():
            break
        it += 1
    scores = nni.scored_nnis()
    keys = sorted(scores)
    return (it, ["|".join(k) for k in keys],
            np.array([scores[k] for k in keys], dtype=np.float64))


def codon_program(group, device, dtype):
    """Program 6: MG94 (64 states) LL and gradients of two trees on the
    scan tape, sharded, against the same engine unsharded within bito_tpu's
    tolerances.  Returns (sharded LL, gradients, unsharded LL,
    gradients)."""
    from .convert import params_from_numpy
    from .core.newick import parse_newick_text
    from .core.site_pattern import CodonSitePattern
    from .models.phylo_model import PhyloModel, PhyloModelSpecification
    from .treelike.engine import TreeLikelihoodEngine

    text, aln = codon_inputs()
    coll = parse_newick_text(text)
    spc = CodonSitePattern(aln, coll.taxon_names)
    trees = coll.trees[:2]
    for t in trees:
        t.branch_lengths[:] = BRANCH_LENGTH
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in MG94_PARAMS.items()}, device, dtype)
    out = []
    for shard in (True, False):
        eng = TreeLikelihoodEngine(
            spc, PhyloModel(PhyloModelSpecification("MG94")), device=device,
            dtype=dtype)
        eng.kernel = "scan"
        if shard:
            eng.shard_patterns(group)
        out += list(eng.ll_and_branch_gradients(trees, params))
    ll_c, g_c, ll_u, g_u = (_host(x) for x in out)
    _check(np.isfinite(ll_c).all() and np.isfinite(g_c).all(),
           "the sharded codon engine's LL or gradients are not finite")
    _check(np.allclose(ll_c, ll_u, rtol=CODON_LL_RTOL),
           "the sharded codon LL diverges from the unsharded")
    _check(np.allclose(g_c, g_u, rtol=CODON_GRAD_RTOL,
                       atol=CODON_GRAD_ATOL * np.abs(g_u).max()),
           "the sharded codon gradients diverge from the unsharded")
    return ll_c, g_c, ll_u, g_u


def dryrun_rank(device=None) -> dict:
    """The dryrun's six programs on this rank's share of the site
    patterns of the world, on `device` (the card in float32 where None;
    the CPU in float64).  Program 3 runs in float32, as bito_tpu's does.
    Returns their results, whole on every rank, and this rank's launches
    of rows 1-2 (each body's launcher) per program.  Programs 1, 3 and 4
    are held within BOUND of the float64 plain versions on the same
    inputs, unsharded, on the CPU (program 4 on its trainer's last
    sample, by calls outside its count of launches).  On the card the
    flagship programs (1, 3 and 4) must have launched the paired
    kernels, row 2 in each and row 1 in 3 and 4; the codon program takes
    the scan tape and launches neither."""
    from .dist.mesh import group_rank_size, make_group, pad_to_multiple

    device, dtype = _devtype(device, None)
    group = make_group()
    rank, size = group_rank_size(group)
    out = {"rank": rank, "size": size, "device": str(device),
           "dtype": str(dtype).replace("torch.", "")}
    launches, seconds = {}, {}
    t0 = time.perf_counter()

    def done(program, before):
        launches[program] = _since(before)
        seconds[program] = time.perf_counter() - t0 - sum(seconds.values())
        print(f"# dryrun rank {rank}: {program} took "
              f"{seconds[program]:.1f} s", flush=True)

    def held(program, errors):
        out[program + "_err"] = errors
        _check(max(errors) <= BOUND, f"{program}: the kernels' LL or "
               f"gradients differ from the float64 plain version by "
               f"{errors} (bound {BOUND:g})")

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_inputs(tmp)
        S = pad_to_multiple(TRAIN["num_patterns"], size)
        before = _launch_counts()
        ll, grads, new_bl = train_step(group, S, device, dtype)
        out["loss"], out["ll"], out["new_bl"] = (float(ll.sum()), _host(ll),
                                                 _host(new_bl))
        _check(np.isfinite(out["loss"]), "the training step's loss is not "
               "finite")
        _check(np.isfinite(out["new_bl"]).all(), "the training step's "
               "branch lengths are not finite")
        done("train", before)
        held("train", _errors(ll, grads, *train_plain(S)))
        before = _launch_counts()
        out["gp_marginal"] = gp_program(paths, group, device, dtype)
        _check(np.isfinite(out["gp_marginal"]),
               "the GP engine's log marginal is not finite")
        done("gp", before)
        before = _launch_counts()
        ll_p, g_p, ll_only, like, trees, params = flagship_program(group,
                                                                   device)
        out["cuda_ll"], out["cuda_grad"], out["cuda_ll_only"] = (
            _host(ll_p), _host(g_p), _host(ll_only))
        _check(np.isfinite(out["cuda_ll"]).all()
               and np.isfinite(out["cuda_grad"]).all()
               and np.isfinite(out["cuda_ll_only"]).all(),
               "the sharded flagship engine's LL or gradients are not "
               "finite")
        done("flagship", before)
        ll_r, g_r = _plain(like, trees, params)
        held("flagship", _errors(ll_p, g_p, ll_r, g_r)
             + [_ll_err(ll_only, ll_r)])
        before = _launch_counts()
        out["vbpi_elbo"], burro = vbpi_program(paths, group, device, dtype)
        _check(np.isfinite(out["vbpi_elbo"]),
               "the sharded VBPI step's ELBO is not finite")
        done("vbpi", before)
        trees, params = (burro.inst.tree_collection.trees,
                         burro.inst._params_dict())
        held("vbpi", _errors(
            *burro.inst.engine.ll_and_branch_gradients(trees, params),
            *_plain(burro.inst.engine, trees, params)))
        before = _launch_counts()
        out["nni_iters"], out["nni_keys"], out["nni_scores"] = nni_program(
            paths, group, device, dtype)
        _check(out["nni_scores"].size > 0
               and np.isfinite(out["nni_scores"]).all(),
               "the sharded NNI search scored nothing finite")
        done("nni", before)
        before = _launch_counts()
        (out["codon_ll"], out["codon_grad"], out["codon_ll_unsharded"],
         out["codon_grad_unsharded"]) = codon_program(group, device, dtype)
        done("codon", before)
    if device.type == "cuda":
        for program, rows in (("train", (ROW2,)), ("flagship", (ROW1, ROW2)),
                              ("vbpi", (ROW1, ROW2))):
            for row in rows:
                _check(sum(launches[program][n] for n in row) > 0,
                       f"{program}: {row[0]}'s kernel did not launch")
        _check(not any(launches["codon"].values()),
               "codon: the scan tape launched a paired kernel")
    out["launches"], out["seconds"] = launches, seconds
    return out


def ok_line(n_devices: int, r: dict) -> str:
    """bito_tpu's line (its sharded_pallas_ll named sharded_cuda_ll)."""
    return (f"dryrun_multichip({n_devices}): loss={r['loss']:.4f} "
            f"gp_marginal={r['gp_marginal']:.4f} "
            f"sharded_cuda_ll={float(r['cuda_ll'][0]):.4f} "
            f"vbpi_elbo={r['vbpi_elbo']:.4f} "
            f"nni_iters={r['nni_iters']} nni_scored={len(r['nni_scores'])} "
            f"codon_ll={float(r['codon_ll'][0]):.4f} OK")


def rank_line(n_devices: int, r: dict) -> str:
    """One rank's backend, device, dtype, launches of rows 1-2 and
    seconds a program."""
    launched = {program: {k: n for k, n in counts.items() if n}
                for program, counts in r["launches"].items()}
    return (f"dryrun_multichip({n_devices}): rank {r['rank']} of "
            f"{r['size']} ({r['backend']}, {r['device']}, {r['dtype']}): "
            f"launches {json.dumps(launched)}; seconds "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["seconds"].items()))


def _jsonable(r: dict) -> dict:
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in r.items()}


# A rank's own fields: its rank, its card (rank r of a job with a card a
# rank runs on cuda:r), its launches and its seconds
PER_RANK = ("rank", "device", "launches", "seconds")


def _same_results(results):
    """Raise unless every rank returned rank 0's results (the programs'
    outputs are whole on every rank) on the same kind of device."""
    keys = [k for k in results[0] if k not in PER_RANK]
    kind = torch.device(results[0]["device"]).type
    for r in results[1:]:
        _check(torch.device(r["device"]).type == kind,
               f"rank {r['rank']} ran on {r['device']}, rank 0 on "
               f"{results[0]['device']}")
        for k in keys:
            _check(np.array_equal(np.asarray(r[k]), np.asarray(results[0][k])),
                   f"rank {r['rank']}'s {k} differs from rank 0's")


def _rank_main():
    """A rank started by dryrun_multichip through dist.launch (importing
    bito_tpu_torch joined the job): the rank body on the world, its
    results printed as one line."""
    import torch.distributed as dist

    from .dist import multihost

    _check(dist.is_initialized(), "the rank did not join a job")
    device = multihost.local_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    out = dryrun_rank(device=device)
    out["backend"] = dist.get_backend()
    print(RANK_LINE + json.dumps(_jsonable(out)), flush=True)
    dist.destroy_process_group()


_RANK_SCRIPT = """import sys
sys.path.insert(0, {root!r})
from bito_tpu_torch.graft_entry import _rank_main
_rank_main()
"""


def _launch_ranks(n_devices: int, device) -> list:
    """Start n_devices ranks of the rank body through dist.launch and
    return their results; raise where the launcher exits non-zero (its
    message names the rank at fault) or a rank printed no result."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("BITO_COORDINATOR", None)
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "dryrun_rank.py")
        with open(script, "w") as f:
            f.write(_RANK_SCRIPT.format(root=root))
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "bito_tpu_torch.dist.launch", "-n",
                 str(n_devices), "--device", device.type, "--stall-timeout",
                 str(STALL_S), "--hard-timeout", str(HARD_S), script],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=HARD_S + 60)
        except subprocess.TimeoutExpired as exc:
            raise RuntimeError(f"dryrun_multichip({n_devices}): the launcher "
                               f"outlasted {HARD_S + 60} s") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): the launcher exited "
            f"{proc.returncode}:\n{proc.stderr[-4000:]}\n"
            f"{proc.stdout[-4000:]}")
    results = {}
    for line in proc.stdout.splitlines():
        m = re.match(r"\[p(\d+)\] " + RANK_LINE + r"(.*)$", line)
        if m:
            results[int(m.group(1))] = json.loads(m.group(2))
    missing = [r for r in range(n_devices) if r not in results]
    _check(not missing, f"rank(s) {missing} printed no result:\n"
           + proc.stdout[-4000:])
    return [results[r] for r in range(n_devices)]


def dryrun_results(n_devices: int, device=None) -> list:
    """Every rank's dryrun_rank results (JSON-able), checked to be the
    same on every rank but for each rank's own launches and seconds.

    Inside a job of n_devices ranks it runs dryrun_rank on the job's
    group (this rank's device: BITO_DEVICE, unless `device` names one)
    and gathers every rank's results.  Outside a job it starts n_devices
    ranks on `device`'s kind (the card where None) through `python -m
    bito_tpu_torch.dist.launch` with its backend rule (NCCL where each
    rank has a card of its own, Gloo where ranks share one), each running
    dryrun_rank."""
    import torch.distributed as dist

    if dist.is_initialized():
        from .dist import multihost

        size = dist.get_world_size()
        if size != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a job of "
                             f"{size} ranks")
        out = dryrun_rank(device=device or multihost.local_device())
        out["backend"] = dist.get_backend()
        results = [None] * size
        dist.all_gather_object(results, _jsonable(out))
    else:
        dev, _ = _devtype(device, None)
        results = _launch_ranks(n_devices, dev)
    _same_results(results)
    return results


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the dryrun's six programs with the site patterns sharded over
    n_devices ranks (dryrun_results: inside a job of n_devices ranks on
    its group, else on n_devices ranks started through dist.launch), then
    print each rank's launches of rows 1-2 and seconds per program, and
    bito_tpu's line, which ends in OK; raise on any failure."""
    results = dryrun_results(n_devices, device)
    for r in results:
        print(rank_line(n_devices, r), flush=True)
    print(ok_line(n_devices, results[0]), flush=True)


if __name__ == "__main__":
    fn, args = entry()
    print("entry forward:", _host(fn(*args)))
    dryrun_multichip(torch.cuda.device_count())
