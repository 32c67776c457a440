"""Checkpoint / resume for instances and engines.

Port of bito_tpu.utils.checkpoint, on the same on-disk format: one atomic
.npz file with the arrays as members and everything else in a JSON
metadata tree (`__meta__`), array leaves at full float64 precision;
legacy JSON snapshots still load.  A snapshot written by either package
loads into the other.  The reference has no binary checkpointing (SURVEY
section 5.4: CSV and Newick round trips).

The module is bito_tpu's code but for restore_gp, which puts q on the GP
engine's device in its dtype (bito_tpu hands it to jnp.asarray).  The
instances, the GP instance and the Burrito keep the state these snapshot
as host numpy arrays in both packages, so the rest carries over as it
is.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


def _from_jsonable(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        elif isinstance(v, dict):
            out[k] = _from_jsonable(v)
        else:
            out[k] = v
    return out


def save_state(path: str, state: Dict[str, Any]):
    """Atomic single-file snapshot: arrays as npz members, everything else
    in a JSON metadata tree stored alongside them."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}

    def strip(tree: Dict[str, Any], prefix: str) -> Dict[str, Any]:
        out = {}
        for k, v in tree.items():
            if isinstance(v, np.ndarray):
                key = prefix + str(k)
                arrays[key] = v
                out[k] = {"__npz__": key}
            elif isinstance(v, dict):
                out[k] = strip(v, prefix + str(k) + "/")
            else:
                out[k] = v
        return out

    meta = strip(state, "")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.asarray(json.dumps(meta)), **arrays)
    os.replace(tmp, path)


def load_state(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        head = f.read(2)
    if head != b"PK":  # legacy JSON snapshot
        with open(path) as f:
            return _from_jsonable(json.load(f))
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["__meta__"]))

        def rebuild(tree: Dict[str, Any]) -> Dict[str, Any]:
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict) and "__npz__" in v:
                    out[k] = npz[v["__npz__"]]
                elif isinstance(v, dict):
                    out[k] = rebuild(v)
                else:
                    out[k] = v
            return out

        return rebuild(meta)


# -- instance-level helpers -------------------------------------------------
def checkpoint_instance(inst, path: str, extra: Optional[Dict] = None):
    """Snapshot an SBN instance: SBN parameters + support identity +
    per-tree model params (reference CSV round trips, unified)."""
    state = {
        "kind": "sbn_instance",
        "rooted": inst.rooted,
        "taxon_names": list(inst.tree_collection.taxon_names),
        "sbn_parameters": np.asarray(inst.sbn_parameters),
        "pretty_indexer": (inst.pretty_indexer()
                           if inst.sbn_support is not None else []),
        "newick": inst.tree_collection.newick(),
    }
    if inst.phylo_model_params is not None:
        state["phylo_model_params"] = np.asarray(inst.phylo_model_params)
    if extra:
        state["extra"] = extra
    save_state(path, state)


def restore_instance(inst, path: str) -> Dict[str, Any]:
    """Restore SBN parameters (matched by pretty-indexer key, so layouts
    may differ across versions) and model params into an instance whose
    trees/support are already processed.  Returns the extra payload."""
    state = load_state(path)
    if inst.sbn_support is not None and state["pretty_indexer"]:
        by_key = dict(zip(state["pretty_indexer"],
                          state["sbn_parameters"]))
        params = np.asarray(inst.sbn_parameters)
        for i, key in enumerate(inst.pretty_indexer()):
            if key in by_key:
                params[i] = by_key[key]
        inst.sbn_parameters = params
    if "phylo_model_params" in state and inst.phylo_model_params is not None:
        inst.phylo_model_params[:] = state["phylo_model_params"]
    return state.get("extra", {})


def checkpoint_gp(gp_inst, path: str):
    """Snapshot a GP instance: branch lengths + q, keyed by PCSP strings."""
    dag = gp_inst.get_dag()
    save_state(path, {
        "kind": "gp_instance",
        "taxon_names": list(dag.taxon_names),
        "pcsp_keys": dag.pretty_edges(),
        "branch_lengths": gp_inst.get_branch_lengths(),
        "q": gp_inst.get_sbn_parameters(),
    })


def restore_gp(gp_inst, path: str):
    state = load_state(path)
    dag = gp_inst.get_dag()
    by_key_bl = dict(zip(state["pcsp_keys"], state["branch_lengths"]))
    by_key_q = dict(zip(state["pcsp_keys"], state["q"]))
    bl = np.array(gp_inst.get_branch_lengths())
    q = np.array(gp_inst.get_sbn_parameters())
    for e, key in enumerate(dag.pretty_edges()):
        if key in by_key_bl:
            bl[e] = by_key_bl[key]
            q[e] = by_key_q[key]
    gp_inst.set_branch_lengths(bl)
    import torch

    engine = gp_inst.get_gp_engine()
    engine.q = torch.as_tensor(q, dtype=engine.dtype, device=engine.device)


def checkpoint_burrito(burro, path: str, step: int = 0):
    """Snapshot a VI training run: variational + SBN parameters and Adam
    moments, for deterministic resume."""
    opt = burro.opt
    save_state(path, {
        "kind": "burrito",
        "step": step,
        "q_params": np.asarray(burro.branch_model.scalar_model.q_params),
        "sbn_parameters": np.asarray(burro.inst.sbn_parameters),
        "step_size": np.asarray(opt.step_size),
        "sbn_step_size": opt.sbn_step_size,
        "adam_t": opt.adam_count,
        "adam_mean": opt.adam_mu,
        "adam_var": opt.adam_nu,
    })


def restore_burrito(burro, path: str) -> int:
    state = load_state(path)
    burro.branch_model.scalar_model.q_params[:] = state["q_params"]
    burro.inst.sbn_parameters[:] = state["sbn_parameters"]
    opt = burro.opt
    opt.step_size = state["step_size"]
    opt.sbn_step_size = state["sbn_step_size"]
    opt.set_adam_state(int(state["adam_t"]), state["adam_mean"],
                       state["adam_var"])
    return int(state["step"])
