"""The port's pattern-sharded engines (bito_tpu_torch/dist, the engines'
shard_patterns) against bito_tpu's unsharded ones, on the CPU in float64
over Gloo, and the launcher's failure handling.

The sharded jobs run as the port's users run them: this file, run as a
script, is the worker that `python -m bito_tpu_torch.dist.launch` starts
once a rank; it imports neither jax nor bito_tpu, and each rank writes
what it computed to an .npz that the test reads.  bito_tpu is the oracle,
computed in the pytest process meanwhile.  One 2-rank run covers a
flagship-like engine (8 taxa, about 300 patterns, 4 trees, GTR+Gamma4) on
the scan, paired, chunked and leveled routes (plain versions, on the CPU)
and through the public *_sharded wrappers, the GP engine after
estimate_branch_lengths(1e-4, 5), a Newton sweep and the hybrid
marginals, one GP-scored NNI iteration, a rooted instance's phylo
gradients (against the port's unsharded instance, which
test_torch_rooted.py holds to bito_tpu's), and a VBPI trainer (Burrito,
6 taxa, JC69, 4 particles) whose instance engine is sharded: two
gradient steps and an ELBO estimate against the same trainer unsharded
within 1e-8 (test_torch_vi.py holds that one to bito_tpu's), the same
samples on both ranks, and the engine's guard raising on both ranks once
rank 1 draws other topologies, then the driver's dryrun inside the job
(graft_entry.dryrun_results: its training step, GP engine, VBPI step and
codon engine against bito_tpu's unsharded programs on the same synthetic
inputs, the codon engine within 1e-10; its flagship engine and NNI
search the same on both ranks); one 3-rank run an MG94 engine
whose padded pattern count is not a multiple of 3 (the port pads with
64-state tips, where bito_tpu/treelike/engine.py:401-402 pads with
4-state ones).  Bounds are tests/test_dist.py's: LL 1e-9, gradients 1e-8,
log marginal and branch lengths 1e-9, absolute (the rooted gradient keys
1e-8 of their scale).
"""
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # a worker: the port from this checkout
    sys.path.insert(0, str(ROOT))

from bito_tpu_torch import _synthetic  # noqa: E402
from bito_tpu_torch.dist import launch, mesh, multihost  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)
LL_BOUND, GRAD_BOUND, GP_BOUND = 1e-9, 1e-8, 1e-9
# Seconds a launcher subprocess may take, and the launcher's heartbeat
# limit: alone on a quiet host the 2-rank run takes about 16 s, under six
# busy test workers about 100 s.
LAUNCH_TIMEOUT, STALL_TIMEOUT = 400, "120"
FLAG = dict(seed=5, taxa=8, trees=4, sites=360, distinct=300)
GP = dict(seed=2, taxa=6, sites=200)
NNI = dict(seed=0, taxa=5, sites=150)
ROOTED = dict(seed=3, taxa=8, trees=2, sites=80)
# test_rooted.py's parameter values and strict-clock rate.
ROOTED_PARAMS = {"substitution_model_frequencies": [0.1, 0.2, 0.3, 0.4],
                 "site_model_parameters": [0.7],
                 "substitution_model_rates": [0.05, 0.1, 0.15, 0.2, 0.25,
                                              0.25]}
CODON = dict(seed=3, taxa=6, codons=40, distinct=30, trees=3)
MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2])}
KERNELS = ("scan", "cuda", "chunked")
ROOTED_KEYS = ("branch_lengths", "ratios_root_height", "clock_model",
               "substitution_model", "site_model")
# The VBPI trainer's inputs (_synthetic.write_vbpi_inputs), its seed, and
# test_torch_vi.py's bound on a trainer's state.
VBPI = dict(seed=8, taxa=6, trees=10, sites=100, particles=4, burrito=3,
            steps=2)
VBPI_BOUND = 1e-8
# The dryrun's codon engine against bito_tpu's unsharded scan tape
CODON_BOUND = 1e-10
# The dryrun's flagship engine, float32 as bito_tpu's runs it, against
# bito_tpu's float64 engine: LL relative, gradients relative to the
# largest (chip_smoke.py's float32 bound)
FLOAT32_BOUND = 5e-5


def _flagship_inputs():
    text = _synthetic.random_trees_newick(FLAG["seed"], FLAG["taxa"],
                                          FLAG["trees"])
    names = _synthetic.taxon_names(FLAG["taxa"])
    return text, _synthetic.random_alignment(FLAG["seed"] + 1, names,
                                             FLAG["sites"], FLAG["distinct"])


def _gp_inputs():
    text = _synthetic.credible_set_newick(GP["seed"], GP["taxa"])
    names = _synthetic.taxon_names(GP["taxa"])
    return text, _synthetic.random_alignment(GP["seed"] + 1, names,
                                             GP["sites"])


def _rooted_instance(make, spec, directory, **kw):
    """A rooted time-tree instance (GTR+Gamma4, strict clock) made by
    `make` (the port's rooted_instance or bito_tpu's) on dated synthetic
    trees written into `directory`, with test_rooted.py's parameters."""
    os.makedirs(directory, exist_ok=True)
    text, dates = _synthetic.dated_trees_newick(ROOTED["seed"],
                                                ROOTED["taxa"],
                                                ROOTED["trees"])
    nwk, fasta = (os.path.join(directory, n) for n in ("t.nwk", "a.fasta"))
    with open(nwk, "w") as f:
        f.write(text)
    with open(fasta, "w") as f:
        f.write(_synthetic.fasta_text(_synthetic.random_alignment(
            ROOTED["seed"] + 7, list(dates), ROOTED["sites"])))
    inst = make("rooted", **kw)
    inst.read_newick_file(nwk)
    inst.parse_dates_from_taxon_names(True)
    inst.read_fasta_file(fasta)
    inst.prepare_for_phylo_likelihood(spec("GTR", "gamma+4", clock="strict"),
                                      1)
    block = inst.get_phylo_model_param_block_map()
    for key, value in ROOTED_PARAMS.items():
        block[key][:] = value
    for state in inst.tree_states:
        state.rates[:] = 0.001
    return inst


def _codon_inputs():
    text = _synthetic.random_trees_newick(CODON["seed"], CODON["taxa"],
                                          CODON["trees"])
    names = _synthetic.taxon_names(CODON["taxa"])
    return text, _synthetic.codon_alignment(CODON["seed"] + 1, names,
                                            CODON["codons"],
                                            CODON["distinct"])


# ---------------------------------------------------------------------------
# The worker (this file run as a script by the launcher)
# ---------------------------------------------------------------------------
def _flagship_worker(out):
    from bito_tpu_torch.convert import params_from_numpy
    from bito_tpu_torch.core.newick import parse_newick_text
    from bito_tpu_torch.core.site_pattern import SitePattern
    from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                                   PhyloModelSpecification)
    from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

    text, aln = _flagship_inputs()
    coll = parse_newick_text(text)
    sp = SitePattern(aln, coll.taxon_names)
    model = PhyloModel(PhyloModelSpecification("GTR", "gamma+4"))
    params = params_from_numpy(_synthetic.GTR_GAMMA4_PARAMS, **F64)
    for kernel in KERNELS:
        eng = TreeLikelihoodEngine(sp, model, **F64)
        eng.kernel = kernel
        eng.shard_patterns()
        out[f"{kernel}_width"] = eng.pattern_pad
        out[f"{kernel}_ll"] = eng.log_likelihoods(coll.trees, params)
        out[f"{kernel}_grad_ll"], out[f"{kernel}_grad"] = (
            eng.ll_and_branch_gradients(coll.trees, params))
        if kernel != "scan":
            out[f"{kernel}_wrapper_ll"], out[f"{kernel}_wrapper_grad_ll"], \
                out[f"{kernel}_wrapper_grad"] = _sharded_wrappers(
                    eng, coll.trees, params)
    leveled = TreeLikelihoodEngine(sp, model, **F64)
    leveled.use_leveled = True
    leveled.shard_patterns()
    out["leveled_ll"] = leveled.log_likelihoods(coll.trees, params)
    out["leveled_grad_ll"], out["leveled_grad"] = (
        leveled.ll_and_branch_gradients(coll.trees, params))
    # The selected-branch Brent, whose objective is reduced at every
    # evaluation, against the same engine unsharded.
    selected = [[0, 1], [2], [3, 4], [5]]
    out["selected_bl"] = eng.optimize_selected_branches(coll.trees, params,
                                                        selected)
    whole = TreeLikelihoodEngine(sp, model, **F64)
    out["selected_bl_unsharded"] = whole.optimize_selected_branches(
        coll.trees, params, selected)


def _sharded_wrappers(eng, trees, params):
    """The engine's route through its public *_sharded wrappers, called on
    the engine's slice: (LL, LL of the grad call, gradients)."""
    from bito_tpu_torch.treelike import chunked, paired, prep

    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props, eng.dtype)
    ops = (eng._kernel_tips, pi, prop, eng._kernel_weights)
    P = prep.prepare_inputs(eig, rates, clock, bl, eng.dtype)
    P_, dP = prep.prepare_inputs_grad(eig, rates, clock, bl, eng.dtype)
    if eng.kernel == "cuda":
        dst, tip, src, e, mask = eng._paired_tapes(enc)
        ll = paired.paired_log_likelihoods_sharded(eng.group, dst, tip, e, P,
                                                   *ops)
        return ll, *paired.paired_ll_and_gradients_sharded(
            eng.group, dst, tip, src, e, mask, P_, dP, *ops)
    dst, tip, e, row, mask = eng._chunked_tapes(enc)
    ll = chunked.chunked_log_likelihoods_sharded(eng.group, dst, tip, e, P,
                                                 *ops)
    return ll, *chunked.chunked_ll_and_gradients_sharded(
        eng.group, dst, tip, e, row, mask, P_, dP, *ops)


def _gp_worker(out):
    from bito_tpu_torch.core.newick import parse_newick_text
    from bito_tpu_torch.core.site_pattern import SitePattern
    from bito_tpu_torch.dag.subsplit_dag import build_dag_from_topologies
    from bito_tpu_torch.gp.engine import GPEngine

    text, aln = _gp_inputs()
    coll = parse_newick_text(text)
    dag = build_dag_from_topologies([t.topology for t in coll.trees],
                                    coll.taxon_names)
    eng = GPEngine(SitePattern(aln, coll.taxon_names), dag, **F64)
    eng.shard_patterns()
    out["gp_marginal"] = eng.estimate_branch_lengths(1e-4, 5)
    out["gp_bl"] = eng.branch_lengths
    out["gp_per_pcsp"] = eng.per_gpcsp_log_likelihoods()
    # Newton's sweep (its second derivative a jvp of the rank's sum) and
    # the quartet hybrid program, each reduced over the ranks.
    eng.set_optimization_method("newton")
    eng.optimize_branch_lengths_once()
    out["gp_newton_bl"] = eng.branch_lengths
    eng.calculate_hybrid_marginals()
    out["gp_hybrid"] = eng.hybrid_marginal_log_likelihoods


def _rooted_worker(out, directory):
    """The rooted instance's phylo gradients (the model keys from one
    reverse pass whose sums over patterns the engine reduces), sharded
    and unsharded; tests/test_torch_rooted.py holds the unsharded
    instance to bito_tpu's."""
    from bito_tpu_torch.api.instances import rooted_instance
    from bito_tpu_torch.models.phylo_model import PhyloModelSpecification

    for name in ("rooted", "rooted_unsharded"):
        inst = _rooted_instance(rooted_instance, PhyloModelSpecification,
                                directory, native=False, **F64)
        if name == "rooted":
            inst.engine.shard_patterns()
        grads = inst.phylo_gradients()
        out[f"{name}_ll"] = np.array([g.log_likelihood() for g in grads])
        for key in ROOTED_KEYS:
            out[f"{name}_{key}"] = np.stack([g.gradient[key]
                                             for g in grads])


def _nni_worker(out, directory):
    from bito_tpu_torch.api.gp import gp_instance

    os.makedirs(directory, exist_ok=True)
    paths = _synthetic.write_nni_inputs(directory, NNI["seed"], NNI["taxa"],
                                        NNI["sites"])
    inst = gp_instance(**F64)
    inst.read_fasta_file(paths["alignment.fasta"])
    inst.read_newick_file(paths["seed.nwk"])
    inst.make_dag()
    inst.make_gp_engine()
    inst.take_first_branch_length()
    eng = inst.make_nni_engine("gp_likelihood")
    print("nni engine built", flush=True)
    eng.shard_patterns()
    eng.set_top_k_score_filtering_scheme(1)
    eng.run_init()
    out["nni_accepted"] = eng.run_main_loop()
    scores = eng.scored_nnis()
    keys = sorted(scores)
    out["nni_keys"] = np.array(["|".join(k) for k in keys])
    out["nni_scores"] = np.array([scores[k] for k in keys])
    out["nni_accepted_keys"] = np.array(
        ["|".join(k) for k in eng.accepted_scores_this_iter])
    out["nni_marginal"] = eng.gp.log_marginal_likelihood()


def _vbpi_burrito(directory):
    """The VBPI trainer of VBPI's inputs, written into `directory`, in
    float64 on the CPU (JC69, the split branch model, the simple
    optimizer)."""
    from bito_tpu_torch.models.phylo_model import PhyloModelSpecification
    from bito_tpu_torch.vi.burrito import Burrito

    os.makedirs(directory, exist_ok=True)
    nexus, fasta = _synthetic.write_vbpi_inputs(
        directory, VBPI["seed"], VBPI["taxa"], VBPI["trees"], VBPI["sites"])
    return Burrito(
        mcmc_nexus_path=nexus, burn_in_fraction=0.0, fasta_path=fasta,
        phylo_model_specification=PhyloModelSpecification(
            "JC69", "constant", "strict"),
        branch_model_name="split", scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=VBPI["particles"],
        seed=VBPI["burrito"], **F64)


def _vbpi_run(burrito, out, prefix):
    """VBPI["steps"] gradient steps, then an ELBO estimate, into `out`:
    each step's sampled topologies (their keys, joined) and branch
    lengths, the ELBO, the SBN parameters and the scalar parameters."""
    keys, lengths = [], []
    for _ in range(VBPI["steps"]):
        burrito.gradient_step()
        trees = burrito.inst.tree_collection.trees
        keys.append(" ".join(",".join(map(str, t.topology.key()))
                             for t in trees))
        lengths.append(np.stack([t.branch_lengths for t in trees]))
    out[f"{prefix}_keys"] = np.array(keys)
    out[f"{prefix}_lengths"] = np.stack(lengths)
    out[f"{prefix}_elbo"] = burrito.estimate_elbo(VBPI["particles"])
    out[f"{prefix}_sbn"] = np.array(burrito.inst.sbn_parameters)
    out[f"{prefix}_q"] = np.array(burrito.branch_model.scalar_model.q_params)


def _vbpi_worker(out, directory):
    """The trainer with its instance engine sharded, then the guard: rank
    1 re-seeds its topology sampler, both ranks draw a batch, and the
    phylo gradients must raise on both (caught here: the raise is what
    this rank reports)."""
    burrito = _vbpi_burrito(directory)
    engine = burrito.inst.engine
    engine.shard_patterns()
    out["vbpi_width"] = engine.pattern_pad
    _vbpi_run(burrito, out, "vbpi")
    ranks = [None] * multihost.process_count()
    torch.distributed.all_gather_object(
        ranks, (str(out["vbpi_keys"]), out["vbpi_lengths"].tobytes()))
    assert all(r == ranks[0] for r in ranks), "the ranks drew other samples"
    if multihost.process_index() == 1:
        burrito.inst.rng = np.random.default_rng(VBPI["burrito"] + 1000)
    burrito.sample_topologies(VBPI["particles"])
    drawn = [None] * multihost.process_count()
    torch.distributed.all_gather_object(drawn, [
        t.topology.key() for t in burrito.inst.tree_collection.trees])
    assert drawn[0] != drawn[1], "rank 1's new seed drew rank 0's trees"
    try:
        burrito.inst.phylo_gradients()
        out["vbpi_guard"] = ""
    except RuntimeError as err:
        out["vbpi_guard"] = str(err)


def _dryrun_worker(out):
    """The driver's dryrun inside this job (graft_entry.dryrun_results:
    the rank body on the world, every rank's results gathered and checked
    equal), in float64 on the CPU: this rank's results under dryrun_
    keys."""
    from bito_tpu_torch import graft_entry

    results = graft_entry.dryrun_results(2, device="cpu")
    rank = multihost.process_index()
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:  # the CPU runs the plain versions, no kernel
        assert not any(n for counts in r["launches"].values()
                       for n in counts.values())
    for key, value in results[rank].items():
        if key not in ("rank", "size", "launches", "seconds"):
            out[f"dryrun_{key}"] = np.asarray(value)


def _codon_worker(out):
    from bito_tpu_torch.convert import params_from_numpy
    from bito_tpu_torch.core.newick import parse_newick_text
    from bito_tpu_torch.core.site_pattern import CodonSitePattern
    from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                                   PhyloModelSpecification)
    from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

    text, aln = _codon_inputs()
    coll = parse_newick_text(text)
    sp = CodonSitePattern(aln, coll.taxon_names)
    model = PhyloModel(PhyloModelSpecification("MG94"))
    params = params_from_numpy(MG94, **F64)
    for kernel in ("scan", "cuda"):
        eng = TreeLikelihoodEngine(sp, model, **F64)
        eng.kernel = kernel
        out["codon_pad"] = eng.pattern_pad
        eng.shard_patterns()
        out[f"codon_{kernel}_width"] = eng.pattern_pad
        out[f"codon_{kernel}_tip_states"] = eng.tip_partials.shape[-1]
        out[f"codon_{kernel}_ll"] = eng.log_likelihoods(coll.trees, params)
        out[f"codon_{kernel}_grad_ll"], out[f"codon_{kernel}_grad"] = (
            eng.ll_and_branch_gradients(coll.trees, params))


def _worker(case, path, directory=None):
    import bito_tpu_torch  # noqa: F401  (joins the job: BITO_COORDINATOR)

    assert torch.distributed.is_initialized()
    assert "jax" not in sys.modules and "bito_tpu" not in sys.modules
    rank = multihost.process_index()
    out = {"rank": rank, "size": multihost.process_count(),
           "backend": torch.distributed.get_backend()}
    t0 = time.perf_counter()
    if case == "pair":
        _flagship_worker(out)
        print(f"rank {rank}: flagship {time.perf_counter() - t0:.1f} s",
              flush=True)
        _gp_worker(out)
        print(f"rank {rank}: gp {time.perf_counter() - t0:.1f} s", flush=True)
        _nni_worker(out, os.path.join(directory, f"nni{rank}"))
        print(f"rank {rank}: nni {time.perf_counter() - t0:.1f} s",
              flush=True)
        _rooted_worker(out, os.path.join(directory, f"rooted{rank}"))
        print(f"rank {rank}: rooted {time.perf_counter() - t0:.1f} s",
              flush=True)
        _dryrun_worker(out)
        print(f"rank {rank}: dryrun {time.perf_counter() - t0:.1f} s",
              flush=True)
        _vbpi_worker(out, os.path.join(directory, f"vbpi{rank}"))
    else:
        _codon_worker(out)
    print(f"rank {rank}: {case} {time.perf_counter() - t0:.1f} s", flush=True)
    out = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
           for k, v in out.items()}
    np.savez(f"{path}.{rank}.npz", **out)
    print(f"rank {rank}: wrote {len(out)} results", flush=True)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
def _launch(tmp, args, script, script_args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("BITO_COORDINATOR", None)
    return subprocess.Popen(
        [sys.executable, "-m", "bito_tpu_torch.dist.launch", *args,
         str(script), *script_args], cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _finish(proc, timeout=LAUNCH_TIMEOUT):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
        out, err = proc.communicate()
        pytest.fail(f"the launcher outlasted {timeout} s:\n{out}\n{err}")
    return proc.returncode, out, err


def _ranks(path, n):
    return [dict(np.load(f"{path}.{r}.npz")) for r in range(n)]


def _jax_flagship():
    from bito_tpu.core.newick import parse_newick_text as jparse
    from bito_tpu.core.site_pattern import SitePattern as JSitePattern
    from bito_tpu.models.phylo_model import PhyloModel as JModel
    from bito_tpu.models.phylo_model import PhyloModelSpecification as JSpec
    from bito_tpu.treelike.engine import TreeLikelihoodEngine as JEngine

    text, aln = _flagship_inputs()
    coll = jparse(text)
    eng = JEngine(JSitePattern(aln, coll.taxon_names),
                  JModel(JSpec("GTR", "gamma+4")))
    eng.kernel = "scan"
    params = {k: np.asarray(v) for k, v in
              _synthetic.GTR_GAMMA4_PARAMS.items()}
    ll, grads = eng.ll_and_branch_gradients(coll.trees, params)
    return np.asarray(ll), np.asarray(grads)


def _jax_gp():
    from bito_tpu.core.newick import parse_newick_text as jparse
    from bito_tpu.core.site_pattern import SitePattern as JSitePattern
    from bito_tpu.dag.subsplit_dag import build_dag_from_topologies
    from bito_tpu.gp.engine import GPEngine as JGPEngine

    text, aln = _gp_inputs()
    coll = jparse(text)
    dag = build_dag_from_topologies([t.topology for t in coll.trees],
                                    coll.taxon_names)
    eng = JGPEngine(JSitePattern(aln, coll.taxon_names), dag)
    marginal = eng.estimate_branch_lengths(1e-4, 5)
    out = (marginal, np.asarray(eng.branch_lengths),
           np.asarray(eng.per_gpcsp_log_likelihoods()))
    eng.set_optimization_method("newton")
    eng.optimize_branch_lengths_once()
    newton_bl = np.asarray(eng.branch_lengths)
    eng.calculate_hybrid_marginals()
    return out + (newton_bl, np.asarray(eng.hybrid_marginal_log_likelihoods))


def _jax_nni(directory):
    from bito_tpu.api.gp import gp_instance as jax_gp

    os.makedirs(directory, exist_ok=True)
    paths = _synthetic.write_nni_inputs(directory, NNI["seed"], NNI["taxa"],
                                        NNI["sites"])
    inst = jax_gp("")
    inst.read_fasta_file(paths["alignment.fasta"])
    inst.read_newick_file(paths["seed.nwk"])
    inst.make_dag()
    inst.make_gp_engine()
    inst.take_first_branch_length()
    eng = inst.make_nni_engine("gp_likelihood")
    eng.set_top_k_score_filtering_scheme(1)
    eng.run_init()
    accepted = eng.run_main_loop()
    return (accepted, eng.scored_nnis(), list(eng.accepted_scores_this_iter),
            eng.gp.log_marginal_likelihood())


def _jax_codon():
    from bito_tpu.core.newick import parse_newick_text as jparse
    from bito_tpu.core.site_pattern import CodonSitePattern as JCodon
    from bito_tpu.models.phylo_model import PhyloModel as JModel
    from bito_tpu.models.phylo_model import PhyloModelSpecification as JSpec
    from bito_tpu.treelike.engine import TreeLikelihoodEngine as JEngine

    text, aln = _codon_inputs()
    coll = jparse(text)
    eng = JEngine(JCodon(aln, coll.taxon_names), JModel(JSpec("MG94")))
    eng.kernel = "scan"
    ll, grads = eng.ll_and_branch_gradients(coll.trees, dict(MG94))
    return np.asarray(ll), np.asarray(grads)


def _jax_dryrun(directory):
    """bito_tpu's unsharded counterparts of the dryrun's six programs on
    the inputs that graft_entry makes, in float64: the training step
    (__graft_entry__._toy_inputs, pruning.ll_and_branch_gradients_impl,
    the ascent step), the GP engine's flow, the flagship engine's scan
    tape, the VBPI step, the GP-scored NNI search and the codon engine's
    scan tape."""
    import importlib.util

    import jax.numpy as jnp

    from bito_tpu.api.gp import gp_instance as jax_gp
    from bito_tpu.core.newick import parse_newick_text as jparse
    from bito_tpu.core.site_pattern import CodonSitePattern as JCodon
    from bito_tpu.core.site_pattern import SitePattern as JSitePattern
    from bito_tpu.models.phylo_model import PhyloModel as JModel
    from bito_tpu.models.phylo_model import PhyloModelSpecification as JSpec
    from bito_tpu.models.site import gamma_median_category_rates
    from bito_tpu.models.substitution import gtr_eigen
    from bito_tpu.treelike import pruning
    from bito_tpu.treelike.engine import TreeLikelihoodEngine as JEngine
    from bito_tpu.vi.burrito import Burrito as JaxBurrito
    from bito_tpu_torch import graft_entry

    spec = importlib.util.spec_from_file_location(
        "graft_entry_reference", ROOT / "__graft_entry__.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    out = {}
    train = graft_entry.TRAIN
    S = mesh.pad_to_multiple(train["num_patterns"], 2)
    enc, bl, tips, weights, rates6, freqs = reference._toy_inputs(
        num_taxa=train["num_taxa"], num_patterns=S, batch=train["batch"])
    B, C = bl.shape[0], graft_entry.ENTRY_CATEGORIES
    eig = gtr_eigen(rates6, freqs)

    def bcast(x):
        return jnp.broadcast_to(x, (B,) + x.shape)

    ll, grads = pruning.ll_and_branch_gradients_impl(
        jnp.asarray(enc.post_ops), jnp.asarray(enc.pre_ops),
        jnp.asarray(enc.root), jnp.asarray(enc.edge_mask, dtype=bl.dtype),
        tips, weights, bl, type(eig)(*(bcast(x) for x in eig)),
        bcast(gamma_median_category_rates(
            jnp.asarray(graft_entry.GAMMA_SHAPE), C)),
        bcast(jnp.full((C,), 1.0 / C)), jnp.ones((B,), bl.dtype),
        num_slots=enc.num_slots, pattern_pad=S, category_count=C)
    out["loss"] = float(ll.sum())
    out["new_bl"] = np.asarray(jnp.maximum(bl + graft_entry.STEP * grads,
                                           graft_entry.MIN_LENGTH))
    paths = graft_entry.write_inputs(directory)
    inst = jax_gp("")
    inst.read_fasta_file(paths["hello.fasta"])
    inst.read_newick_file(paths["hello_rooted.nwk"])
    inst.make_gp_engine()
    inst.populate_plvs()
    inst.compute_likelihoods()
    inst.get_gp_engine().optimize_branch_lengths_once()
    out["gp_marginal"] = inst.get_log_marginal_likelihood()
    text, aln = graft_entry.ds1_reduced_inputs()
    coll = jparse(text)
    eng = JEngine(JSitePattern(aln, coll.taxon_names),
                  JModel(JSpec("GTR", "gamma+4")), dtype=jnp.float64)
    eng.kernel = "scan"
    trees = coll.trees[:2]
    for t in trees:
        t.branch_lengths[:] = graft_entry.BRANCH_LENGTH
    ll, grads = eng.ll_and_branch_gradients(
        trees,
        {k: np.asarray(v) for k, v in graft_entry.FLAGSHIP_PARAMS.items()})
    out["flagship_ll"], out["flagship_grad"] = (np.asarray(ll),
                                                np.asarray(grads))
    vbpi = graft_entry.VBPI
    burrito = JaxBurrito(
        mcmc_nexus_path=paths["vbpi.t"], burn_in_fraction=0.0,
        fasta_path=paths["vbpi.fasta"],
        phylo_model_specification=JSpec("JC69", "constant", "strict"),
        branch_model_name="split", scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=vbpi["particles"],
        seed=vbpi["burrito"])
    burrito.gradient_step()
    out["vbpi_elbo"] = burrito.estimate_elbo(particle_count=vbpi["particles"])
    inst = jax_gp("")
    inst.read_fasta_file(paths["five_taxon/alignment.fasta"])
    inst.read_newick_file(paths["five_taxon/seed.nwk"])
    inst.make_dag()
    inst.make_gp_engine()
    inst.take_first_branch_length()
    nni = inst.make_nni_engine("gp_likelihood")
    nni.set_top_k_score_filtering_scheme(1)
    nni.run_init()
    it = 0
    while it < graft_entry.NNI_ITERS and nni.adjacent_nni_count():
        if not nni.run_main_loop():
            break
        it += 1
    out["nni_iters"] = it
    scores = nni.scored_nnis()
    keys = sorted(scores)
    out["nni_keys"] = ["|".join(k) for k in keys]
    out["nni_scores"] = np.array([scores[k] for k in keys])
    text, aln = graft_entry.codon_inputs()
    coll = jparse(text)
    eng = JEngine(JCodon(aln, coll.taxon_names), JModel(JSpec("MG94")))
    eng.kernel = "scan"
    trees = coll.trees[:2]
    for t in trees:
        t.branch_lengths[:] = graft_entry.BRANCH_LENGTH
    ll, grads = eng.ll_and_branch_gradients(
        trees, {k: np.asarray(v) for k, v in graft_entry.MG94_PARAMS.items()})
    out["codon_ll"], out["codon_grad"] = np.asarray(ll), np.asarray(grads)
    return out


def _same_on_every_rank(ranks, keys):
    for key in keys:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


def test_two_ranks_match_bito_tpus_unsharded_engines(tmp_path):
    """2 ranks over Gloo: every route of the flagship-like engine, the GP
    engine after estimate_branch_lengths, one GP-scored NNI iteration and
    the driver's dryrun programs, the same on both ranks and within
    test_dist.py's bounds of bito_tpu's unsharded engines (the dryrun's
    codon engine within CODON_BOUND)."""
    out = tmp_path / "pair"
    proc = _launch(tmp_path, ["-n", "2", "--device", "cpu", "--backend",
                              "gloo", "--stall-timeout", STALL_TIMEOUT],
                   pathlib.Path(__file__), ["pair", str(out), str(tmp_path)])
    ll_ref, g_ref = _jax_flagship()
    marginal_ref, bl_ref, per_pcsp_ref, newton_ref, hybrid_ref = _jax_gp()
    nni_ref = _jax_nni(tmp_path / "jax_nni")
    vbpi_ref = {}
    _vbpi_run(_vbpi_burrito(tmp_path / "vbpi_unsharded"), vbpi_ref, "vbpi")
    dryrun_ref = _jax_dryrun(tmp_path / "jax_dryrun")
    rc, stdout, stderr = _finish(proc)
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    ranks = _ranks(out, 2)
    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert all(str(r["backend"]) == "gloo" for r in ranks)
    # 300 patterns pad to 384 (the engine's multiple of 128), 192 a rank.
    assert all(int(r[f"{k}_width"]) == 192 for r in ranks for k in KERNELS)
    _same_on_every_rank(ranks, [k for k in ranks[0] if k != "rank"])
    r = ranks[0]
    for kernel in ("cuda", "chunked"):
        for key in ("ll", "grad_ll", "grad"):
            np.testing.assert_allclose(r[f"{kernel}_wrapper_{key}"],
                                       r[f"{kernel}_{key}"], rtol=0,
                                       atol=1e-12, err_msg=kernel)
    for kernel in KERNELS + ("leveled",):
        for key in (f"{kernel}_ll", f"{kernel}_grad_ll"):
            np.testing.assert_allclose(r[key], ll_ref, rtol=0, atol=LL_BOUND,
                                       err_msg=key)
        np.testing.assert_allclose(r[f"{kernel}_grad"], g_ref, rtol=0,
                                   atol=GRAD_BOUND, err_msg=kernel)
    np.testing.assert_allclose(r["selected_bl"], r["selected_bl_unsharded"],
                               rtol=0, atol=GP_BOUND)
    assert abs(float(r["gp_marginal"]) - marginal_ref) <= GP_BOUND
    np.testing.assert_allclose(r["gp_bl"], bl_ref, rtol=0, atol=GP_BOUND)
    np.testing.assert_allclose(r["gp_per_pcsp"], per_pcsp_ref, rtol=0,
                               atol=LL_BOUND)
    np.testing.assert_allclose(r["gp_newton_bl"], newton_ref, rtol=0,
                               atol=GP_BOUND)
    finite = np.isfinite(hybrid_ref)
    assert finite.any()
    np.testing.assert_array_equal(np.isfinite(r["gp_hybrid"]), finite)
    np.testing.assert_allclose(r["gp_hybrid"][finite], hybrid_ref[finite],
                               rtol=0, atol=LL_BOUND)
    # The rooted instance against the port's unsharded one (held to
    # bito_tpu's by test_torch_rooted.py): LL within 1e-9, each gradient
    # key within 1e-8 of its scale, max(1, max |g|), as the clock
    # gradient's entries are about 3e5 here, where float64 rounds its
    # sum over the branches at about 1e-8.
    np.testing.assert_allclose(r["rooted_ll"], r["rooted_unsharded_ll"],
                               rtol=0, atol=LL_BOUND)
    for key in ROOTED_KEYS:
        ref = r[f"rooted_unsharded_{key}"]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(r[f"rooted_{key}"], ref, rtol=0,
                                   atol=GRAD_BOUND * scale, err_msg=key)
    accepted, scores, accepted_keys, nni_marginal = nni_ref
    assert bool(r["nni_accepted"]) == accepted
    keys = sorted(scores)
    assert list(r["nni_keys"]) == ["|".join(k) for k in keys]
    np.testing.assert_allclose(r["nni_scores"], [scores[k] for k in keys],
                               rtol=0, atol=LL_BOUND)
    assert list(r["nni_accepted_keys"]) == ["|".join(k)
                                            for k in accepted_keys]
    assert abs(float(r["nni_marginal"]) - nni_marginal) <= GP_BOUND
    # The sharded VBPI trainer against the unsharded one: the same samples
    # on both ranks (_same_on_every_rank) and as unsharded, and its state
    # within VBPI_BOUND; then the guard raised on both ranks.
    assert int(r["vbpi_width"]) * 2 == 128  # 100 sites pad to 128
    assert list(r["vbpi_keys"]) == list(vbpi_ref["vbpi_keys"])
    for key in ("vbpi_lengths", "vbpi_elbo", "vbpi_sbn", "vbpi_q"):
        np.testing.assert_allclose(r[key], vbpi_ref[key], rtol=VBPI_BOUND,
                                   atol=VBPI_BOUND, err_msg=key)
    for rank in ranks:
        guard = str(rank["vbpi_guard"])
        assert "different tree topologies" in guard, guard
        assert "rank(s) [1] differ from rank 0" in guard, guard
    # The dryrun's programs (their results the same on both ranks, above)
    # against bito_tpu's unsharded ones: the training step's loss and
    # updated lengths, the GP log marginal, the flagship engine (float32,
    # as bito_tpu's, within FLOAT32_BOUND of float64), the VBPI ELBO, the
    # NNI search's iterations, keys and scores, and the codon engine.
    assert str(r["dryrun_dtype"]) == "float64"
    assert abs(float(r["dryrun_loss"]) - dryrun_ref["loss"]) <= LL_BOUND
    np.testing.assert_allclose(r["dryrun_new_bl"], dryrun_ref["new_bl"],
                               rtol=0, atol=GRAD_BOUND)
    assert abs(float(r["dryrun_gp_marginal"])
               - dryrun_ref["gp_marginal"]) <= GP_BOUND
    np.testing.assert_allclose(float(r["dryrun_vbpi_elbo"]),
                               dryrun_ref["vbpi_elbo"], rtol=VBPI_BOUND,
                               atol=VBPI_BOUND)
    np.testing.assert_allclose(r["dryrun_codon_ll"], dryrun_ref["codon_ll"],
                               rtol=CODON_BOUND, atol=0)
    scale = max(1.0, float(np.abs(dryrun_ref["codon_grad"]).max()))
    np.testing.assert_allclose(r["dryrun_codon_grad"],
                               dryrun_ref["codon_grad"], rtol=0,
                               atol=CODON_BOUND * scale)
    assert r["dryrun_cuda_ll"].shape == (2,)
    np.testing.assert_allclose(r["dryrun_cuda_ll_only"], r["dryrun_cuda_ll"],
                               rtol=5e-5, atol=0)
    assert 1 <= int(r["dryrun_nni_iters"]) <= 2
    assert r["dryrun_nni_scores"].size and np.isfinite(
        r["dryrun_nni_scores"]).all()
    for key in ("cuda_ll", "cuda_ll_only"):
        np.testing.assert_allclose(r[f"dryrun_{key}"],
                                   dryrun_ref["flagship_ll"],
                                   rtol=FLOAT32_BOUND, atol=0, err_msg=key)
    scale = float(np.abs(dryrun_ref["flagship_grad"]).max())
    np.testing.assert_allclose(r["dryrun_cuda_grad"],
                               dryrun_ref["flagship_grad"], rtol=0,
                               atol=FLOAT32_BOUND * scale)
    assert int(r["dryrun_nni_iters"]) == dryrun_ref["nni_iters"]
    assert list(r["dryrun_nni_keys"]) == dryrun_ref["nni_keys"]
    np.testing.assert_allclose(r["dryrun_nni_scores"],
                               dryrun_ref["nni_scores"], rtol=0,
                               atol=GP_BOUND)


def test_three_ranks_shard_a_codon_engine(tmp_path):
    """3 ranks over Gloo, MG94 (64 states): the padded pattern count (128)
    is not a multiple of 3, so each rank's slice ends in padding of
    64-state all-ones tips; the scan and paired routes' LL and gradients
    within the bounds of bito_tpu's unsharded engine."""
    out = tmp_path / "codon"
    proc = _launch(tmp_path, ["-n", "3", "--device", "cpu",
                              "--stall-timeout", STALL_TIMEOUT],
                   pathlib.Path(__file__), ["codon", str(out)])
    ll_ref, g_ref = _jax_codon()
    rc, stdout, stderr = _finish(proc)
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    ranks = _ranks(out, 3)
    assert int(ranks[0]["codon_pad"]) % 3
    _same_on_every_rank(ranks, [k for k in ranks[0] if k != "rank"])
    r = ranks[0]
    for kernel in ("scan", "cuda"):
        assert int(r[f"codon_{kernel}_width"]) * 3 == mesh.pad_to_multiple(
            int(r["codon_pad"]), 3 * 4)
        assert int(r[f"codon_{kernel}_tip_states"]) == 64
        for key in (f"codon_{kernel}_ll", f"codon_{kernel}_grad_ll"):
            np.testing.assert_allclose(r[key], ll_ref, rtol=0, atol=LL_BOUND,
                                       err_msg=key)
        np.testing.assert_allclose(r[f"codon_{kernel}_grad"], g_ref, rtol=0,
                                   atol=GRAD_BOUND, err_msg=kernel)


# Rank 0 says it is up, then sleeps.  Rank 1 waits for rank 0 to be up,
# printing as it waits (a heartbeat, so the stall timeout cannot fire
# before both are up), then goes silent or exits 3.
SILENT = """
import os, sys, time
rank = int(os.environ["BITO_PROCESS_ID"])
print("rank", rank, "up", flush=True)
fault, marker = sys.argv[1:]
if rank == 0:
    open(marker, "w").close()
else:
    while not os.path.exists(marker):
        print("rank 1 waits for rank 0", flush=True)
        time.sleep(0.5)
    if fault == "silent":
        time.sleep(120)
    sys.exit(3)
time.sleep(120)
"""


@pytest.mark.parametrize("fault", ["silent", "fails"])
def test_launcher_kills_and_names_a_wedged_or_failed_rank(tmp_path, capsys,
                                                          fault):
    """A rank that goes silent past a 3 s stall timeout, or one that exits
    non-zero, ends the job at once: the launcher (its main, in this
    process) kills the rank(s) still running, names each worker's state,
    and exits non-zero."""
    script = tmp_path / "worker.py"
    script.write_text(SILENT)
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as exc:
        launch.main(["-n", "2", "--device", "cpu", "--stall-timeout", "3",
                     str(script), fault, str(tmp_path / "rank0_up")])
    diag = str(exc.value.code)
    stdout = capsys.readouterr().out
    assert "[p0] rank 0 up" in stdout and "[p1] rank 1 up" in stdout
    if fault == "silent":
        assert "wedged" in diag
        assert "worker p1: running (killed)" in diag
    else:
        assert "p1 exited non-zero" in diag
        assert "worker p1: exited 3" in diag
    assert "worker p0: running (killed)" in diag
    assert time.monotonic() - t0 < 45


def test_launcher_refuses_nccl_without_a_card_a_rank(tmp_path):
    """NCCL asked for more ranks than visible cards (none here) fails in the
    launcher, before any worker starts."""
    script = tmp_path / "worker.py"
    marker = tmp_path / "started"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    with pytest.raises(SystemExit) as exc:
        launch.main(["-n", "2", "--device", "cuda", "--backend", "nccl",
                     str(script)])
    assert "NCCL takes one card a rank" in str(exc.value.code)
    assert "no worker started" in str(exc.value.code)
    assert not marker.exists()


def test_launcher_defaults_to_the_card_and_refuses_without_one(tmp_path):
    """Without --device the ranks run on the card; where no card is
    visible (here) the launcher fails before any worker starts, rather
    than run them on the CPU."""
    script = tmp_path / "worker.py"
    marker = tmp_path / "started"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    with pytest.raises(SystemExit) as exc:
        launch.main(["-n", "2", str(script)])
    assert "CUDA is not available" in str(exc.value.code)
    assert "no worker started" in str(exc.value.code)
    assert not marker.exists()


def test_backend_rule_and_checks():
    """The backend comes from a rule, never a trial: Gloo on the CPU, and
    NCCL refused off the card or with more ranks than cards."""
    assert multihost.default_backend("cpu", 2) == "gloo"
    multihost.check_backend("gloo", "cpu", 3)
    with pytest.raises(ValueError, match="needs device 'cuda'"):
        multihost.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="one card a rank"):
        multihost.check_backend("nccl", "cuda",
                                torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        multihost.check_backend("mpi", "cpu", 1)


def test_single_process_run_is_untouched(monkeypatch):
    """Without BITO_COORDINATOR, initialize does nothing: one process, rank
    0, no group; the engines' shard_patterns then raise rather than run
    unsharded.  The local device is the card unless BITO_DEVICE says cpu,
    and the card refuses where none is visible (here)."""
    monkeypatch.delenv("BITO_COORDINATOR", raising=False)
    monkeypatch.delenv("BITO_DEVICE", raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.is_primary()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.local_device()
    monkeypatch.setenv("BITO_DEVICE", "cpu")
    assert multihost.local_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_group()


def test_multi_host_recipe_takes_the_hosts_own_card(monkeypatch):
    """The module docstring's recipe, rank 1 of 2 on a host of its own
    with one card (the card and the group mocked): NCCL is not refused
    for the world's 2 ranks, and the rank takes its host's card 0."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("card", d))
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **k: calls.setdefault("group", (a, k)))
    for key, value in (("BITO_COORDINATOR", "host0:8476"),
                       ("BITO_NUM_PROCESSES", "2"), ("BITO_PROCESS_ID", "1"),
                       ("BITO_BACKEND", "nccl")):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("BITO_DEVICE", raising=False)
    multihost.initialize()
    assert calls["card"] == 0
    (backend,), kw = calls["group"]
    assert backend == "nccl"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://host0:8476", 2, 1)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    assert multihost.local_device() == torch.device("cuda", 0)
    # Behind a loopback coordinator every rank is on this host: NCCL for
    # 2 ranks on its one card raises before the group forms.
    calls.clear()
    monkeypatch.setenv("BITO_COORDINATOR", "localhost:8476")
    with pytest.raises(ValueError, match="one card a rank"):
        multihost.initialize()
    assert not calls


@pytest.mark.parametrize("total,size", [(384, 2), (132, 3), (8, 4)])
def test_pattern_shards_tile_the_axis(total, size):
    """The ranks' PatternShards are contiguous, equal, and tile the axis;
    take() returns a contiguous slice of its own."""
    shards = [multihost.PatternShard(r, size, total) for r in range(size)]
    assert [s.start for s in shards] == [r * total // size
                                         for r in range(size)]
    assert shards[-1].stop == total
    x = torch.arange(3 * total, dtype=torch.float64).reshape(3, total).T
    parts = [s.take(x, 0) for s in shards]
    assert all(p.is_contiguous() for p in parts)
    torch.testing.assert_close(torch.cat(parts), x)
    with pytest.raises(ValueError):
        multihost.PatternShard(0, size, total + 1)
    assert mesh.pad_to_multiple(total + 1, size) % size == 0


if __name__ == "__main__":
    _worker(*sys.argv[1:])
