"""Log likelihoods and branch-length gradients of a batch of trees through
TreeLikelihoodEngine.branch_eval_fn: the closure that binds the batch's
tapes and the model's ingredients once, the hot path of a VBPI inner loop
or a branch-length sweep."""

GRADIENTS = True


def bind(engine, trees, params):
    """fn(bl [B, N]) -> (ll [B], grads [B, N])."""
    return engine.branch_eval_fn(trees, params)
