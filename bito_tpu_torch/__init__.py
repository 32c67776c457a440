"""bito_tpu_torch: the PyTorch and CUDA port of bito_tpu.

Batched phylogenetic tree likelihoods and branch-length gradients on one
NVIDIA Hopper card, the VBPI instances and generalized pruning on the
subsplit DAG.  Subpackages mirror bito_tpu's (core, models, treelike,
sbn, vi, api, dag, gp, _native), so each module has an obvious
counterpart; the JAX package stays the reference and the tests pin this
package to it.

The public surface is bito_tpu's (itself the reference pybind module
`bito`, src/pybito.cpp:91-1288): the instances, tree collections, model
specifications and bitset factories, beside the port's device policy
(PRODUCT_DEVICE, PRODUCT_DTYPE, TEST_DEVICE, TEST_DTYPE).  Every instance
takes `device=` and `dtype=`, the card in float32 by default.  bito_tpu's
persistent XLA compilation cache has no counterpart: torch compiles no
program a shape, and the CUDA kernels are built once into
bito_tpu_torch/_build (treelike/_kernels.py).  As bito_tpu does, the
package joins a multi-process job when it is imported with
BITO_COORDINATOR set (dist/multihost.py, which dist/launch.py drives).

This package imports torch and numpy only, never jax and never bito_tpu,
and importing it builds nothing (neither the CUDA kernels nor the native
library).
"""
import os as _os


def _maybe_init_distributed():
    """Join a multi-process job at import, as bito_tpu does: activated by
    BITO_COORDINATOR, which dist.launch sets; without it nothing happens.
    Explicit callers can run dist.multihost.initialize(...) instead."""
    if not _os.environ.get("BITO_COORDINATOR"):
        return
    from .dist import multihost

    multihost.initialize()


_maybe_init_distributed()

from .device import PRODUCT_DEVICE, PRODUCT_DTYPE, TEST_DEVICE, TEST_DTYPE

from .api.instances import (
    GenericSBNInstance,
    PhyloGradient,
    RootedSBNInstance,
    UnrootedSBNInstance,
    rooted_instance,
    unrooted_instance,
)
from .core.bitset import PCSP, Subsplit
from .core.newick import (
    parse_newick_file,
    parse_newick_text,
    parse_nexus_file,
    read_fasta,
)
from .core.site_pattern import SitePattern
from .core.tree import Topology, Tree, TreeCollection
from .models.phylo_model import PhyloModel, PhyloModelSpecification

__version__ = "0.1.0"

__all__ = [
    "GenericSBNInstance",
    "PhyloGradient",
    "RootedSBNInstance",
    "UnrootedSBNInstance",
    "rooted_instance",
    "unrooted_instance",
    "PCSP",
    "Subsplit",
    "parse_newick_file",
    "parse_newick_text",
    "parse_nexus_file",
    "read_fasta",
    "SitePattern",
    "Topology",
    "Tree",
    "TreeCollection",
    "PhyloModel",
    "PhyloModelSpecification",
    "phylo_flags",
    "phylo_gradient_mapkeys",
    "phylo_model_mapkeys",
    "git_commit",
    "git_branch",
    "git_tags",
    "subsplit",
    "pcsp",
    "subsplit_to_string",
    "subsplit_get_clade",
    "subsplit_is_leaf",
    "subsplit_is_rootsplit",
    "subsplit_is_uca",
    "pcsp_to_string",
    "pcsp_get_parent_subsplit",
    "pcsp_get_child_subsplit",
    "clade_get_count",
    "to_hash_string",
    "gp_instance",
    "GPInstance",
    "PRODUCT_DEVICE",
    "PRODUCT_DTYPE",
    "TEST_DEVICE",
    "TEST_DTYPE",
]

# Flag-name constants (mirror of the reference submodule bito.phylo_flags,
# src/pybito.cpp:1269-1287).
from .treelike import phylo_flags as phylo_flags  # noqa: E402


# Gradient/model map-key constants (mirror of bito.phylo_gradient_mapkeys /
# bito.phylo_model_mapkeys).
class phylo_gradient_mapkeys:
    BRANCH_LENGTHS = "branch_lengths"
    RATIOS_ROOT_HEIGHT = "ratios_root_height"
    SUBSTITUTION_MODEL = "substitution_model"
    SITE_MODEL = "site_model"
    CLOCK_MODEL = "clock_model"


class phylo_model_mapkeys:
    SUBSTITUTION_MODEL_RATES = "substitution_model_rates"
    SUBSTITUTION_MODEL_FREQUENCIES = "substitution_model_frequencies"
    SITE_MODEL_PARAMETERS = "site_model_parameters"
    CLOCK_MODEL_RATES = "clock_model_rates"


def _git_info(kind: str) -> str:
    """The package checkout's git commit, branch or tags ("unknown" outside
    a git checkout)."""
    import os
    import subprocess

    try:
        out = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.abspath(__file__)),
             {"commit": "rev-parse", "branch": "rev-parse",
              "tags": "describe"}[kind],
             *({"commit": ["HEAD"], "branch": ["--abbrev-ref", "HEAD"],
                "tags": ["--tags", "--always"]}[kind])],
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def git_commit() -> str:
    """Reference bito.git_commit."""
    return _git_info("commit")


def git_branch() -> str:
    return _git_info("branch")


def git_tags() -> str:
    return _git_info("tags")


from .core.bitset import (  # noqa: E402
    subsplit,
    pcsp,
    subsplit_to_string,
    subsplit_get_clade,
    subsplit_is_leaf,
    subsplit_is_rootsplit,
    subsplit_is_uca,
    pcsp_to_string,
    pcsp_get_parent_subsplit,
    pcsp_get_child_subsplit,
    clade_get_count,
    to_hash_string,
)
from .api.gp import gp_instance, GPInstance  # noqa: E402
