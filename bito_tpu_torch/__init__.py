"""bito_tpu_torch: the PyTorch and CUDA port of bito_tpu.

Batched phylogenetic tree likelihoods and branch-length gradients on one
NVIDIA Hopper card.  Subpackages mirror bito_tpu's (core, models,
treelike, sbn, vi, api, dag, _native), so each module has an obvious
counterpart; the JAX package stays the reference and the tests pin this
package to it.

This package imports torch and numpy only, never jax and never bito_tpu.
"""
from .device import PRODUCT_DEVICE, PRODUCT_DTYPE, TEST_DEVICE, TEST_DTYPE

__version__ = "0.1.0"
