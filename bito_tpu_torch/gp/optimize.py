"""Vectorized 1-D optimizers for batched branch-length optimization.

Counterpart of bito_tpu.gp.optimize, in torch: the reference Optimization
namespace (reference: src/optimization.hpp:13-402), BrentMinimize,
BrentMinimizeWithGradients, GradientAscent, LogSpaceGradientAscent and
NewtonRaphson, with a whole level's edges optimized at once: every lane
carries its own optimizer state and the objective is one batched
evaluation per iteration.  Each lane follows the serial algorithm, with a
per-lane `done` mask that freezes it once the serial loop would have
broken, so the result does not depend on when a lane converged.

What differs from bito_tpu: its fixed-count `fori_loop` (Brent) is a
Python loop of the same iterations over device tensors, with no read back
to the host; its `while_loop`s (the ascents, Newton) are Python loops that
read the all-done flag back each iteration.  Brent's per-lane
derivative is the caller's `fprime`, or one `torch.func.jvp` with a ones
tangent, as bito_tpu takes one `jax.jvp`.  Constants are bito_tpu's (the reference's bounds in
log-branch-length space, src/dag_branch_handler.hpp:272-294).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

# float32 of the reference's "golden ratio, don't need too much precision
# here!" constant (src/optimization.hpp:208): 2 - phi rounded to f32.
GOLDEN = float(np.float32(0.3819660))

SIGNIFICANT_DIGITS = 10       # src/dag_branch_handler.hpp:288
STEP_SIZE = 5e-4              # src/dag_branch_handler.hpp:291
LOG_SPACE_STEP_SIZE = 1.0005  # src/dag_branch_handler.hpp:292
MAX_ITER = 1000               # src/dag_branch_handler.hpp:294
NEWTON_DENOM_TOL = 1e-10      # src/dag_branch_handler.hpp:290


def _batched_grad(f):
    """Per-lane derivative of a batched R^K -> R^K objective (each output
    lane depends only on its own input lane), via one jvp with a ones
    tangent."""

    def fprime(y):
        _, dy = torch.func.jvp(f, (y,), (torch.ones_like(y),))
        return dy

    return fprime


def _where(cond, a, b):
    """torch.where with Python numbers taken in the tensors' dtype."""
    like = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.full_like(like, a)
    if not torch.is_tensor(b):
        b = torch.full_like(like, b)
    return torch.where(cond, a, b)


def brent_minimize_batched(
    f: Callable[[torch.Tensor], torch.Tensor],
    guess: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    significant_digits: int = SIGNIFICANT_DIGITS,
    iterations: int = 40,
    use_gradients: bool = False,
    step_size: float = STEP_SIZE,
    fprime: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Brent minimization (reference Optimization::BrentMinimize,
    src/optimization.hpp:70-188, and ::BrentMinimizeWithGradients,
    190-329 when use_gradients), vectorized: each lane of guess/lo/hi is an
    independent minimization of the batched objective f.  Runs
    `iterations` steps on the device, frozen lanes unchanged.  With
    use_gradients, `fprime` is f's per-lane derivative (a jvp of f where
    it is not given).

    Returns the argmin y.  Callers replicate the reference's reset-if-worse
    guard (dag_branch_handler.cpp:143-150) by comparing f(y) to f(guess).
    """
    tolerance = math.ldexp(1.0, 1 - significant_digits)
    if use_gradients and fprime is None:
        fprime = _batched_grad(f)

    x = guess
    fx = f(x)
    w, v, fw, fv = x, x, fx, fx
    delta, delta2 = torch.zeros_like(x), torch.zeros_like(x)
    done = torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    for _ in range(iterations):
        mid = 0.5 * (lo + hi)
        fract1 = tolerance * torch.abs(x) + tolerance / 4.0
        fract2 = 2.0 * fract1
        done = done | (torch.abs(x - mid) <= (fract2 - 0.5 * (hi - lo)))

        # Parabolic fit through (x, w, v); only attempted when the
        # step-before-last moved more than fract1.
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2.0 * (q - r)
        p = torch.where(q > 0, -p, p)
        q = torch.abs(q)
        td = delta2
        accept = (
            (torch.abs(delta2) > fract1)
            & ~(torch.abs(p) >= torch.abs(q * td / 2.0))
            & ~(p <= q * (lo - x))
            & ~(p >= q * (hi - x))
        )
        delta_para = p / _where(q == 0, 1.0, q)
        u_para = x + delta_para
        # Near-bound parabolic steps degrade to a minimal move toward mid.
        delta_para = torch.where(
            ((u_para - lo) < fract2) | ((hi - u_para) < fract2),
            torch.where((mid - x) < 0, -torch.abs(fract1), torch.abs(fract1)),
            delta_para,
        )
        # Golden bisection (always recomputes delta2; the parabolic branch
        # preserves the previous delta as delta2 only when accepted).
        delta2_gold = torch.where(x >= mid, lo - x, hi - x)
        delta_new = torch.where(accept, delta_para, GOLDEN * delta2_gold)
        delta2_new = torch.where(accept, delta, delta2_gold)

        u = torch.where(
            torch.abs(delta_new) >= fract1, x + delta_new,
            torch.where(delta_new > 0, x + torch.abs(fract1),
                        x - torch.abs(fract1)),
        )
        fu = f(u)
        improved = fu <= fx

        if use_gradients:
            # Reference BrentMinimizeWithGradients: when the trial point is
            # worse, try one gradient-descent step from x before giving up.
            u_g = x - step_size * fprime(x)
            fu_g = f(u_g)
            grad_improved = ~improved & (fu_g <= fx)
            u = torch.where(grad_improved, u_g, u)
            fu = torch.where(grad_improved, fu_g, fu)
            improved = improved | grad_improved

        # Bracket updates: improvement moves the far bracket to x; failure
        # moves the near bracket to u.
        lo_new = torch.where(improved, torch.where(u >= x, x, lo),
                             torch.where(u < x, u, lo))
        hi_new = torch.where(improved, torch.where(u >= x, hi, x),
                             torch.where(u < x, hi, u))
        # Control-point updates.
        second = (fu <= fw) | (w == x)
        third = (fu <= fv) | (v == x) | (v == w)
        v_new = torch.where(improved, w, torch.where(second, w,
                            torch.where(third, u, v)))
        fv_new = torch.where(improved, fw, torch.where(second, fw,
                             torch.where(third, fu, fv)))
        w_new = torch.where(improved, x, torch.where(second, u, w))
        fw_new = torch.where(improved, fx, torch.where(second, fu, fw))
        x_new = torch.where(improved, u, x)
        fx_new = torch.where(improved, fu, fx)

        def frz(new, old):
            return torch.where(done, old, new)

        lo, hi = frz(lo_new, lo), frz(hi_new, hi)
        x, w, v = frz(x_new, x), frz(w_new, w), frz(v_new, v)
        fx, fw, fv = frz(fx_new, fx), frz(fw_new, fw), frz(fv_new, fv)
        delta, delta2 = frz(delta_new, delta), frz(delta2_new, delta2)
    return x


def _ascent(f_and_fprime, x, min_x, significant_digits, max_iter, step):
    """The loop of GradientAscent and LogSpaceGradientAscent: step(x, f'(x))
    floored at min_x, per lane until |f'(x)| < |f(x)| * 10^-digits, while
    some lane runs and at most max_iter + 1 times (bito_tpu's while_loop
    condition, read back to the host)."""
    tolerance = 10.0 ** (-significant_digits)
    done = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for _ in range(max_iter + 1):
        if bool(done.all()):
            break
        fx, gx = f_and_fprime(x)
        new_x = torch.maximum(step(x, gx), min_x)
        x = torch.where(done, x, new_x)
        done = done | (torch.abs(gx) < torch.abs(fx) * tolerance)
    return x


def gradient_ascent_batched(
    f_and_fprime: Callable[[torch.Tensor], tuple],
    x: torch.Tensor,
    min_x: torch.Tensor,
    significant_digits: int = SIGNIFICANT_DIGITS,
    step_size: float = STEP_SIZE,
    max_iter: int = MAX_ITER,
) -> torch.Tensor:
    """Reference Optimization::GradientAscent (src/optimization.hpp:331-345):
    fixed-step ascent on f(x) with floor min_x; stops per lane when
    |f'(x)| < |f(x)| * 10^-digits."""
    return _ascent(f_and_fprime, x, min_x, significant_digits, max_iter,
                   lambda x, gx: x + gx * step_size)


def log_space_gradient_ascent_batched(
    f_and_fprime: Callable[[torch.Tensor], tuple],
    x: torch.Tensor,
    min_x: torch.Tensor,
    significant_digits: int = SIGNIFICANT_DIGITS,
    log_space_step_size: float = LOG_SPACE_STEP_SIZE,
    max_iter: int = MAX_ITER,
) -> torch.Tensor:
    """Reference Optimization::LogSpaceGradientAscent
    (src/optimization.hpp:347-365): ascent on y = log x with the chain-rule
    gradient x * f'(x)."""
    return _ascent(
        f_and_fprime, x, min_x, significant_digits, max_iter,
        lambda x, gx: torch.exp(torch.log(x) + x * gx * log_space_step_size))


def newton_raphson_batched(
    f_and_two_derivatives: Callable[[torch.Tensor], tuple],
    y: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    significant_digits: int = SIGNIFICANT_DIGITS,
    epsilon: float = NEWTON_DENOM_TOL,
    max_iter: int = MAX_ITER,
) -> torch.Tensor:
    """Reference Optimization::NewtonRaphsonOptimization
    (src/optimization.hpp:367-402) in log-branch-length space: the callable
    returns (f, f', f'') wrt y = log(branch length) — the caller applies the
    chain rule (gp_engine.cpp:643-653: f'_y = x f'_x, f''_y = f'_y +
    x^2 f''_x).  Per-lane stopping mirrors the serial loop: tiny second
    derivative, tiny step, or relative first-derivative convergence."""
    tolerance = 10.0 ** (-significant_digits)
    done = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    for _ in range(max_iter + 1):
        if bool(done.all()):
            break
        fy, gy, hy = f_and_two_derivatives(y)
        done = done | (torch.abs(hy) < epsilon)
        new_y = y - gy / _where(hy == 0, 1.0, hy)
        new_y = torch.where(new_y < lo, y - 0.5 * (y - lo), new_y)
        new_y = torch.where(new_y > hi, y - 0.5 * (y - hi), new_y)
        delta = torch.abs(y - new_y)
        # The serial loop returns the PRE-step x when a stop criterion
        # fires (src/optimization.hpp:394-396), so stopping lanes freeze
        # before applying this step.
        stop = (delta < tolerance) | (torch.abs(gy) < torch.abs(fy) * tolerance)
        y = torch.where(done | stop, y, new_y)
        done = done | stop
    return y


def newton_maximize_batched(
    fdf: Callable[[torch.Tensor], tuple],
    init: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    iterations: int = 25,
    epsilon: float = 1e-5,
) -> torch.Tensor:
    """Maximize via newton_raphson_batched given fdf(y) -> (f'(y), f''(y));
    the reference's relative-f stop is disabled (f unknown), leaving the
    step-size and curvature stops."""

    def f3(y):
        g, h = fdf(y)
        return torch.full_like(y, math.inf), g, h

    return newton_raphson_batched(f3, torch.clamp(init, lo, hi), lo, hi,
                                  epsilon=epsilon, max_iter=iterations)
