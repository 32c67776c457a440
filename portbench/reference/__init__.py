"""The plain reference that decides `correct`: per-tree log likelihoods
and branch-length gradients, in float64, from the raw inputs alone (the
alignment, the parent arrays, the branch lengths and the model's
parameters).  It imports numpy, scipy and torch only: nothing of the
program under test.

  patterns.py  site patterns and tip partials of an alignment
  models.py    rate matrices, stationary frequencies, rate categories
  tree.py      the pruning algorithm and its preorder (gradients), in
               float64, or in float32 with every product's operands
               rounded to TF32 (the control)
"""
from .tree import Model, evaluate, model_of  # noqa: F401
