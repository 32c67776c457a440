"""The algorithm's FLOPs over every evaluation of the measured window
(untraced), divided by the window's seconds times the configuration's
peak, in %: the whole call's share of the card's peak."""
from portbench import work


def read(run):
    flops = run.evals * work.flops_per_tree(run.config, run.patterns,
                                            run.gradients)
    return 100.0 * flops / (run.window.seconds * run.config["peak_flops"])
