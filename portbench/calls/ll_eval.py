"""Log likelihoods alone of a batch of trees through
TreeLikelihoodEngine.ll_eval_fn, which goes through log_likelihoods'
dispatch on every call."""

GRADIENTS = False


def bind(engine, trees, params):
    """fn(bl [B, N]) -> (ll [B], None)."""
    fn = engine.ll_eval_fn(trees, params)
    return lambda bl: (fn(bl), None)
