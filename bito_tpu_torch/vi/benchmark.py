"""VBPI against an MCMC run on a fixed topology (the `benchmark` command).

Counterpart of bito_tpu.vi.benchmark (the reference's vip/benchmark.py):
`fixed` reads a directory X holding X_out.t (an MCMC sample, read after a
burn-in of BURN_IN of its trees) and X.fasta, fits the VBPI trainer
(vi.burrito.Burrito) on them under JC69 with constant rates and a strict
clock from the branch model's mode matched to the MCMC's last sample, and
returns what bito_tpu returns, without pandas:
  run_details      {"gradient_time": seconds of the steps,
                    "final_elbo": an ELBO estimate after them};
  opt_trace        the optimizer's ELBO trace as a structured numpy array
                   with bito_tpu's columns, index and elbo (empty for the
                   simple optimizer, which records none);
  fitting_results  the variational branch-length samples beside the MCMC
                   split lengths, a structured numpy array with columns
                   type ("vb" or "mcmc"), variable (the split's index, as
                   a string) and value, the vb rows variable by variable
                   and then the mcmc rows, as bito_tpu's frames have them.
`write_csv` writes either table with the csv module.
"""
from __future__ import annotations

import csv
import os
import time

import numpy as np

from ..api.instances import unrooted_instance
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE
from ..models.phylo_model import PhyloModelSpecification
from .burrito import Burrito

BURN_IN = 0.1  # the share of the MCMC sample dropped from its start
TRACE_COLUMNS = [("index", np.int64), ("elbo", np.float64)]


def _fitting_table(vb_sample: np.ndarray, mcmc_lengths) -> np.ndarray:
    """The vb samples [draws, splits], each split's column in turn, then
    each split's MCMC lengths, as rows (type, variable, value)."""
    rows = [("vb", str(v), x) for v in range(vb_sample.shape[1])
            for x in vb_sample[:, v]]
    rows += [("mcmc", str(v), x) for v, lengths in enumerate(mcmc_lengths)
             for x in lengths]
    width = max((len(r[1]) for r in rows), default=1)
    return np.array(rows, dtype=[("type", "U4"), ("variable", f"U{width}"),
                                 ("value", np.float64)])


def fixed(data_path, *, branch_model_name, scalar_model_name, optimizer_name,
          step_count, particle_count, thread_count=1,
          final_elbo_particle_count=10000, device=PRODUCT_DEVICE,
          dtype=PRODUCT_DTYPE, seed=0):
    """Fit VBPI to the data in `data_path` (see the module docstring) in
    `step_count` steps of `particle_count` particles on `device` in
    `dtype`, the trainer's generators seeded by `seed`.  Returns
    (run_details, opt_trace, fitting_results)."""
    data_path = os.path.normpath(data_path)
    name = os.path.basename(data_path)
    nexus = os.path.join(data_path, name + "_out.t")
    fasta = os.path.join(data_path, name + ".fasta")
    mcmc = unrooted_instance("mcmc_inst", device=device, dtype=dtype)
    mcmc.read_nexus_file(nexus)
    mcmc.tree_collection.erase(0, int(BURN_IN * mcmc.tree_count()))
    mcmc.process_loaded_trees()
    mcmc_lengths = [np.asarray(a) for a in mcmc.split_lengths()]

    burrito = Burrito(
        mcmc_nexus_path=nexus, burn_in_fraction=BURN_IN, fasta_path=fasta,
        phylo_model_specification=PhyloModelSpecification(
            substitution="JC69", site="constant", clock="strict"),
        branch_model_name=branch_model_name,
        scalar_model_name=scalar_model_name, optimizer_name=optimizer_name,
        particle_count=particle_count, thread_count=thread_count, seed=seed,
        device=device, dtype=dtype)
    burrito.branch_model.mode_match(np.array([a[-1] for a in mcmc_lengths]))

    start = time.perf_counter()
    burrito.gradient_steps(step_count)
    gradient_time = time.perf_counter() - start
    trace = np.array(list(enumerate(burrito.opt.trace)), dtype=TRACE_COLUMNS)
    vb_sample = np.asarray(burrito.branch_model.sample_all(
        mcmc.tree_count()))
    fitting = _fitting_table(vb_sample, mcmc_lengths)
    final_elbo = float(burrito.estimate_elbo(
        particle_count=final_elbo_particle_count))
    return ({"gradient_time": gradient_time, "final_elbo": final_elbo},
            trace, fitting)


def write_csv(path: str, table: np.ndarray) -> None:
    """One of fixed's tables as CSV: a header of its column names, then a
    row a record (pandas' row index, which bito_tpu's to_csv writes first,
    is not written)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(table.dtype.names)
        for row in table.tolist():
            writer.writerow([repr(x) if isinstance(x, float) else x
                             for x in row])
