"""Carry state from bito_tpu to the port.

bito_tpu's engines take a parameter dict keyed by the model's block names
(models/phylo_model.py), with values that are shared rows [k] or per-tree
rows [B, k].  The port uses the same keys; this turns the numpy form of
such a dict into the port's tensors, so both packages compute from the
same numbers.  A VBPI trainer's state carries over the same way, as numpy
(load_burrito_state), without importing bito_tpu: the caller reads it.  So
does a rooted instance's (rooted_state reads it from either package's
instance, load_rooted_state writes it into the port's), and a GP
engine's (gp_state reads it from either package's engine,
gp_state_from_numpy writes it into the port's).

The TP and NNI engines keep their state on the host, as bito_tpu's do:
the TP engine's branch lengths and choice map, the faithful eval
engine's per-edge PVs, the NNI sets and supporting trees are numpy
arrays and Python objects, the same in both packages.  The one tensor
state among them is the GP-scored NNI engine's GP engine
(`engine.gp`), which gp_state and gp_state_from_numpy carry.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import resolve


def params_from_numpy(params: Mapping[str, np.ndarray], device,
                      dtype) -> Dict[str, torch.Tensor]:
    """{block name: array} -> {block name: tensor on (device, dtype)}."""
    device, dtype = resolve(device, dtype)
    return {key: torch.as_tensor(np.asarray(value), dtype=dtype, device=device)
            for key, value in params.items()}


# The VBPI trainer's state, as numpy: what a Burrito needs to take the next
# step where another left off.
BURRITO_STATE = ("sbn_parameters", "q_params", "scalar_rng_state",
                 "topology_rng_state", "adam_count", "adam_mu", "adam_nu",
                 "step_size", "sbn_step_size", "step_number",
                 "phylo_model_params")


def load_burrito_state(burrito, state: Mapping) -> None:
    """Load a Burrito's state, read as numpy from another (a bito_tpu
    Burrito's, say), into the port's `burrito`, which must have been built
    from the same trees and alignment:
      sbn_parameters      the SBN's log parameters [support size];
      q_params            the scalar model's parameters [variables, k];
      scalar_rng_state    its numpy rng's bit_generator.state;
      topology_rng_state  the instance's rng's (the topology sampler's);
      adam_count, adam_mu, adam_nu
                          Adam's step count and {group: moments};
      step_size, sbn_step_size, step_number
                          the optimizer's step sizes and step count;
      phylo_model_params  the instance's per-tree model rows [trees, p].
    The arrays are written in place, so the views the trainer shares (the
    SBN model's parameters, a PSP model's q_params) keep seeing them."""
    missing = set(BURRITO_STATE) - set(state)
    if missing:
        raise KeyError(f"state lacks {sorted(missing)}")
    inst, opt = burrito.inst, burrito.opt
    scalar = burrito.branch_model.scalar_model
    for have, key in ((inst.sbn_parameters, "sbn_parameters"),
                      (scalar.q_params, "q_params")):
        value = np.asarray(state[key], dtype=np.float64)
        if value.shape != have.shape:
            raise ValueError(f"{key}: shape {value.shape}, the trainer has "
                             f"{have.shape}")
        np.copyto(have, value)
    scalar.rng.bit_generator.state = state["scalar_rng_state"]
    inst.rng.bit_generator.state = state["topology_rng_state"]
    opt.set_adam_state(state["adam_count"], state["adam_mu"],
                       state["adam_nu"])
    opt.step_size = np.array(state["step_size"], dtype=np.float64)
    opt.sbn_step_size = float(state["sbn_step_size"])
    opt.step_number = int(state["step_number"])
    inst.phylo_model_params = np.array(state["phylo_model_params"],
                                       dtype=np.float64)


# A rooted instance's state, as numpy: each tree's time-tree fields
# (treelike/rooted.py's RootedTreeState) and branch lengths, and the
# instance's model parameter rows.
ROOTED_TREE_STATE = ("node_heights", "node_bounds", "height_ratios", "rates")


def rooted_state(inst) -> Dict[str, object]:
    """Read a rooted instance's state as numpy, from bito_tpu's instance or
    the port's (both have tree_states, tree_collection and
    phylo_model_params): {field: [one array a tree]} for
    ROOTED_TREE_STATE and "branch_lengths", and "phylo_model_params"."""
    state = {key: [np.array(getattr(s, key), dtype=np.float64)
                   for s in inst.tree_states]
             for key in ROOTED_TREE_STATE}
    state["branch_lengths"] = [np.array(t.branch_lengths, dtype=np.float64)
                               for t in inst.tree_collection.trees]
    state["phylo_model_params"] = np.array(inst.phylo_model_params,
                                           dtype=np.float64)
    return state


def load_rooted_state(inst, state: Mapping) -> None:
    """Write `state` (rooted_state's form) into the port's rooted instance
    `inst`, whose trees and dates were read from the same files and whose
    model was prepared with the same specification.  The arrays are
    written in place; the model rows reach the engine through
    params_from_numpy, as every call's do."""
    states, trees = inst.tree_states, inst.tree_collection.trees
    for key in ROOTED_TREE_STATE + ("branch_lengths",):
        values = state[key]
        if len(values) != len(trees):
            raise ValueError(f"{key}: {len(values)} trees, the instance has "
                             f"{len(trees)}")
        for i, value in enumerate(values):
            have = (trees[i].branch_lengths if key == "branch_lengths"
                    else getattr(states[i], key))
            value = np.asarray(value, dtype=np.float64)
            if value.shape != have.shape:
                raise ValueError(f"{key} of tree {i}: shape {value.shape}, "
                                 f"the instance has {have.shape}")
            np.copyto(have, value)
    params = np.asarray(state["phylo_model_params"], dtype=np.float64)
    if params.shape[1:] != inst.phylo_model_params.shape[1:]:
        raise ValueError(f"phylo_model_params: shape {params.shape}, the "
                         f"instance has {inst.phylo_model_params.shape}")
    inst.phylo_model_params = params.copy()


# A GP engine's state, as numpy: the branch lengths and SBN parameters q
# of its DAG's edges, in edge-id order.
GP_STATE = ("branch_lengths", "q")


def _as_numpy(value) -> np.ndarray:
    """A host array of `value`: a torch tensor (on any device), or
    anything numpy takes (a bito_tpu engine's arrays)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.array(value, dtype=np.float64)


def gp_state(engine) -> Dict[str, np.ndarray]:
    """Read a GP engine's state as numpy, from bito_tpu's engine or the
    port's (both have branch_lengths and q over the DAG's edges)."""
    return {key: _as_numpy(getattr(engine, key)) for key in GP_STATE}


def gp_state_from_numpy(engine, branch_lengths, q) -> None:
    """Carry a GP engine's branch lengths and SBN parameters, as numpy (a
    bito_tpu engine's, say: gp_state), into the port's `engine`, whose DAG
    was built from the same trees: the same edges in the same order.  The
    values take the engine's device and dtype; its PLVs and likelihoods
    are left to the next populate."""
    E = engine.schedule.edge_count
    for key, value in (("branch_lengths", branch_lengths), ("q", q)):
        value = _as_numpy(value)
        if value.shape != (E,):
            raise ValueError(f"{key}: shape {value.shape}, the engine's DAG "
                             f"has {E} edges")
        setattr(engine, key, value)
