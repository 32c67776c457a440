"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU (its look for a card skipped), the program
in float64, each fault that these cells can have planted in the closure
the window calls.  One chip, so no exchange between chips to leave out."""
import pytest
import torch

from portbench.tests.portbench_cases import (correct, cpu_run, one_thread,
                                             small_cell)

CELLS = ["ds1_gtr_gamma4.stream", "ds1_mg94.stream", "ds1_gtr_gamma4.sync"]


def unchanged(fn):
    """Every call returns the first call's answer."""
    first = []

    def broken(*args):
        if not first:
            first.append(fn(*args))
        return first[0]

    return broken


def half_batch(fn):
    """Half of the trees left out, their rows the mean of the rest."""
    def broken(*args):
        ll, grads = fn(*args)
        h = ll.shape[0] // 2
        ll, grads = ll.clone(), grads.clone()
        ll[h:] = ll[:h].mean()
        grads[h:] = grads[:h].mean(0)
        return ll, grads

    return broken


def one_ll_altered(fn):
    """One tree's log likelihood off by one part in a thousand."""
    def broken(*args):
        ll, grads = fn(*args)
        ll = ll.clone()
        ll[0] *= 1.001
        return ll, grads

    return broken


def one_gradient_altered(fn):
    """One branch's gradient of one tree off by a hundredth of its tree's
    largest."""
    def broken(*args):
        ll, grads = fn(*args)
        grads = grads.clone()
        grads[-1, 0] += 0.01 * grads[-1].abs().max()
        return ll, grads

    return broken


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    cell = small_cell(name)
    with one_thread():
        run, sample = cpu_run(cell, 2 ** 32 + 5)
    assert run.window.calls > 0 and correct(cell, run, sample)


@pytest.mark.parametrize("fault", [unchanged, half_batch, one_ll_altered,
                                   one_gradient_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault):
    cell = small_cell(name)
    with one_thread():
        run, sample = cpu_run(cell, 11, wrap=fault)
    assert not correct(cell, run, sample)


def test_a_non_finite_read_back_counts_as_failed():
    cell = small_cell("ds1_gtr_gamma4.sync")

    def nan(fn):
        def broken(*args):
            ll, grads = fn(*args)
            return torch.full_like(ll, float("nan")), grads
        return broken

    with one_thread():
        run, sample = cpu_run(cell, 12, wrap=nan)
    assert run.window.failed == run.window.calls * cell.config["trees"]
    assert not correct(cell, run, sample)
