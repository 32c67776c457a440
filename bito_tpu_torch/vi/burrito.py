"""Burrito: the VBPI trainer (reference: vip/burrito.py:12-185).

Port of bito_tpu.vi.burrito on the port's unrooted instance, on the card
in float32 unless the caller passes another device and dtype.  Each
gradient step samples topologies from the SBN, samples branch lengths
from the branch model, computes the batch's likelihoods and branch
gradients on the instance's engine (the paired kernels on the card: the
instance hands the engine one shared model row), assembles the scalar
(reparameterization) and topology (VIMCO) gradients, and Adam-steps both
parameter sets.

Sharded over the site patterns (`burrito.inst.engine.shard_patterns()`
on every rank of a process group), each rank samples topologies and
branch lengths on its own host, and the engine adds the ranks' partial
likelihoods tree by tree: every rank must then draw the same samples,
that is, make its Burrito with the same `seed` (and the same inputs).
The engine checks the topologies on every call and raises on every rank
where they differ; equal branch lengths follow from equal seeds.
"""
from __future__ import annotations

import numpy as np

from ..api.instances import unrooted_instance
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE
from ..models.phylo_model import PhyloModelSpecification
from . import branch_model as branch_model_mod
from . import optimizers, sbn_model


def _logsumexp(x):
    m = np.max(x)
    return m + np.log(np.sum(np.exp(x - m)))


class Burrito:
    def __init__(
        self,
        *,
        mcmc_nexus_path,
        burn_in_fraction,
        fasta_path,
        phylo_model_specification,
        branch_model_name,
        scalar_model_name,
        optimizer_name,
        particle_count,
        thread_count=1,
        use_vimco=True,
        seed=0,
        device=PRODUCT_DEVICE,
        dtype=PRODUCT_DTYPE,
    ):
        self.particle_count = particle_count
        self.use_vimco = use_vimco
        self.inst = unrooted_instance("burrito", device=device, dtype=dtype)
        self.inst.rng = np.random.default_rng(seed)

        # Read MCMC run to get tree structure.
        self.inst.read_nexus_file(mcmc_nexus_path)
        burn_in_count = int(burn_in_fraction * self.inst.tree_count())
        self.inst.tree_collection.erase(0, burn_in_count)
        self.inst.process_loaded_trees()

        # Set up tree likelihood calculation.
        self.inst.read_fasta_file(fasta_path)
        self.inst.prepare_for_phylo_likelihood(
            phylo_model_specification, thread_count, [], True, particle_count
        )
        sbn = sbn_model.SBNModel(self.inst)
        self.branch_model = branch_model_mod.of_name(
            branch_model_name, scalar_model_name, self.inst
        )
        self.branch_model.scalar_model.rng = np.random.default_rng(seed + 1)
        self.opt = optimizers.of_name(
            optimizer_name, sbn, self.branch_model.scalar_model,
            self.estimate_elbo,
        )
        self.elbo_trace = []

    @property
    def sbn_model(self):
        return self.opt.sbn_model

    def sample_topologies(self, count):
        """Sample trees into the instance; return per-tree branch-length
        views (excluding the unused root entry)."""
        self.inst.sample_trees(count)
        return [
            tree.branch_lengths[:-1]
            for tree in self.inst.tree_collection.trees
        ]

    def gradient_step(self, beta_t=1.0, timer=None):
        """One VBPI step (reference vip/burrito.py:84-117).  Pass as `timer`
        any object whose `phase(name)` returns a context manager (such as
        bito_tpu's utils.timing.PhaseTimer) to get the per-phase budget
        (sampling / representations / branch sampling / device LL+grad /
        scalar grads / topology grads / Adam)."""
        from contextlib import nullcontext

        ph = (timer.phase if timer is not None
              else (lambda name: nullcontext()))
        with ph("sample_topologies"):
            px_branch_lengths = self.sample_topologies(self.particle_count)
        with ph("branch_representation"):
            px_branch_representation = (
                self.branch_model.px_branch_representation())
        with ph("branch_sample"):
            (px_theta_sample, dg_dpsi, dlog_qg_dpsi,
             ) = self.branch_model.sample_and_gradients(
                px_branch_representation)
            for i, branch_lengths in enumerate(px_branch_lengths):
                branch_lengths[:] = px_theta_sample[i, :]
        with ph("device_ll_grad"):
            phylo_gradients = self.inst.phylo_gradients()
        with ph("scalar_grad"):
            scalar_grad = self.branch_model.scalar_grad(
                px_theta_sample, phylo_gradients, px_branch_representation,
                dg_dpsi, dlog_qg_dpsi,
            )
            px_phylo_log_like = beta_t * np.array(
                [g.log_likelihood_ for g in phylo_gradients]
            )
        with ph("px_log_f"):
            px_log_f = self.px_log_f(
                px_phylo_log_like, px_theta_sample, px_branch_representation
            )
        with ph("topology_gradients"):
            sbn_grad = self.inst.topology_gradients(px_log_f, self.use_vimco)
        with ph("adam"):
            self.opt.gradient_step(
                {"scalar_params": scalar_grad, "sbn_params": sbn_grad}
            )

    def gradient_steps(self, step_count, track_elbo=True):
        betas = np.maximum(
            np.arange(1, step_count + 1, dtype=np.float64) / step_count, 0.001
        )
        for step in range(step_count):
            self.gradient_step(betas[step])
            if track_elbo:
                self.elbo_trace.append(
                    self.estimate_elbo(self.particle_count)
                )

    def estimate_elbo(self, particle_count):
        px_branch_lengths = self.sample_topologies(particle_count)
        px_branch_representation = self.branch_model.px_branch_representation()
        px_theta_sample = self.branch_model.sample(px_branch_representation)
        for i, branch_lengths in enumerate(px_branch_lengths):
            branch_lengths[:] = px_theta_sample[i, :]
        px_phylo_log_like = self.inst.log_likelihoods()
        return self.elbo_of_sample(
            px_phylo_log_like, px_theta_sample, px_branch_representation
        )

    def elbo_of_sample(self, px_phylo_log_like, px_theta_sample,
                       px_branch_representation):
        px_log_prior = self.branch_model.log_prior(px_theta_sample)
        elbo_total = (
            np.sum(px_phylo_log_like + px_log_prior)
            - np.sum(np.log(self.inst.calculate_sbn_probabilities()))
            - self.branch_model.log_prob(px_theta_sample,
                                         px_branch_representation)
        )
        return elbo_total / self.inst.tree_count()

    def px_log_f(self, px_phylo_log_like, px_theta_sample,
                 px_branch_representation):
        px_log_prior = self.branch_model.log_prior(px_theta_sample)
        px_log_sbn_prob = np.log(self.inst.calculate_sbn_probabilities())
        px_branch_log_prob = np.array(
            list(
                self.branch_model.log_prob_generator(
                    px_theta_sample, px_branch_representation
                )
            )
        )
        return (px_phylo_log_like + px_log_prior - px_log_sbn_prob
                - px_branch_log_prob)

    def marginal_likelihood_estimate(self, particle_count):
        px_branch_lengths = self.sample_topologies(particle_count)
        px_branch_representation = self.branch_model.px_branch_representation()
        px_theta_sample = self.branch_model.sample(px_branch_representation)
        for i, branch_lengths in enumerate(px_branch_lengths):
            branch_lengths[:] = px_theta_sample[i, :]
        px_phylo_log_like = self.inst.log_likelihoods()
        px_log_f = self.px_log_f(
            px_phylo_log_like, px_theta_sample, px_branch_representation
        )
        return _logsumexp(px_log_f) - np.log(particle_count)
