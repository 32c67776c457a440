"""Felsenstein's pruning over a batch of unrooted trees, with the
preorder pass that gives every branch's gradient, in plain torch.

The trees come as parent arrays over one numbering: tips 0..T-1, internal
nodes T..N-1 with every child's id below its parent's, the root N-1 (a
trifurcation).  Branch v joins node v to its parent; its length is
bl[b, v].  Transition matrices come from the rate matrix by
torch.linalg.matrix_exp in float64, and their derivatives by
d/dt exp(Q r t) = r Q exp(Q r t).  Partials are rescaled at every internal
node by their largest entry over categories and states, with the log of
the scale carried per pattern, so that neither pass underflows.

`control=True` runs the same algorithm in float32 with the operands of
every product of the tree passes rounded to TF32 (10 explicit mantissa
bits, round to nearest with ties away from zero, as cvt.rna and the
tensor cores' TF32 inputs round): the precision below the program's
float32, which `correct` has to refuse.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import models


@dataclass
class Model:
    """A shared substitution model: Q [A, A] and pi [A], and rate
    categories with their proportions, all float64 numpy."""
    Q: np.ndarray
    pi: np.ndarray
    rates: np.ndarray
    props: np.ndarray


def model_of(config: dict) -> Model:
    """The configuration's model from its name and parameters alone."""
    spec, params = config["model"], config["params"]
    Q, pi = models.SUBSTITUTION[spec["substitution"]](
        params["substitution_model_rates"],
        params["substitution_model_frequencies"])
    rates, props = models.categories(spec["site"], params)
    return Model(Q, pi, rates, props)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _children(parents: np.ndarray) -> np.ndarray:
    """[B, N, 3] children of each node, padded with N."""
    B, N = parents.shape
    ch = np.full((B, N, 3), N, dtype=np.int64)
    fill = np.zeros((B, N), dtype=np.int64)
    for b in range(B):
        for v in range(N - 1):
            p = parents[b, v]
            ch[b, p, fill[b, p]] = v
            fill[b, p] += 1
    return ch


def _block(model: Model, tips, w, parents, ch, bl, control: bool):
    """(ll [b], grads [b, N]) of one block of trees, as float64."""
    dev = tips.device
    dt = torch.float32 if control else torch.float64

    def mm(a, b):
        return tf32(a) @ tf32(b) if control else a @ b

    b, N = parents.shape
    T, S, A = tips.shape
    C = len(model.rates)
    root = N - 1
    ar = torch.arange(b, device=dev)
    f64 = dict(device=dev, dtype=torch.float64)
    Q = torch.as_tensor(model.Q, **f64)
    rates = torch.as_tensor(model.rates, **f64)
    t = bl[:, :, None] * rates                                  # [b, N, C]
    P64 = torch.linalg.matrix_exp(Q * t[..., None, None])       # [b,N,C,A,A]
    dP = (rates[:, None, None] * (Q @ P64)).to(dt)
    P = P64.to(dt)
    del P64
    pi = torch.as_tensor(model.pi, device=dev, dtype=dt)
    props = torch.as_tensor(model.props, device=dev, dtype=dt)
    tips, w = tips.to(dt), w.to(dt)

    # Postorder: Lt = partial / its scale, lam = log of the scale, and the
    # message m = P Lt up each branch (slot N: ones).
    Lt = torch.empty((b, N, C, S, A), device=dev, dtype=dt)
    lam = torch.zeros((b, N + 1, S), device=dev, dtype=dt)
    m = torch.empty((b, N + 1, C, S, A), device=dev, dtype=dt)
    m[:, N] = 1.0
    Lt[:, :T] = tips[None, :, None]
    m[:, :T] = mm(Lt[:, :T], P[:, :T].transpose(-1, -2))
    for v in range(T, N):
        prod = m[ar, ch[:, v, 0]] * m[ar, ch[:, v, 1]] * m[ar, ch[:, v, 2]]
        scale = prod.amax(dim=(1, 3))                           # [b, S]
        Lt[:, v] = prod / scale[:, None, :, None]
        lam[:, v] = (lam[ar, ch[:, v, 0]] + lam[ar, ch[:, v, 1]]
                     + lam[ar, ch[:, v, 2]] + torch.log(scale))
        if v < root:
            m[:, v] = mm(Lt[:, v], P[:, v].transpose(-1, -2))
    site = ((Lt[:, root] * pi).sum(-1) * props[:, None]).sum(1)  # [b, S]
    ll = ((torch.log(site) + lam[:, root]) * w).sum(-1)

    # Preorder: g = what sits above branch v at its parent (the parent's
    # outside vector times the siblings' messages), scaled as Lt is, with
    # its log scale mu; out = g P is the outside vector of node v.
    out = torch.empty((b, N, C, S, A), device=dev, dtype=dt)
    mu = torch.zeros((b, N, S), device=dev, dtype=dt)
    out[:, root] = pi
    grads = torch.zeros((b, N), device=dev, dtype=dt)
    for v in range(root - 1, -1, -1):
        p = parents[:, v]
        g, gl = out[ar, p], mu[ar, p]
        for k in range(3):
            c = ch[ar, p, k]
            sib = torch.where(c == v, N, c)
            g = g * m[ar, sib]
            gl = gl + lam[ar, sib]
        scale = g.amax(dim=(1, 3))
        g = g / scale[:, None, :, None]
        gl = gl + torch.log(scale)
        dm = mm(Lt[:, v], dP[:, v].transpose(-1, -2))
        num = ((g * dm).sum(-1) * props[:, None]).sum(1)         # [b, S]
        ratio = num / site * torch.exp(gl + lam[:, v] - lam[:, root])
        grads[:, v] = (ratio * w).sum(-1)
        if v >= T:
            out[:, v] = mm(g, P[:, v])
            mu[:, v] = gl
    return ll.double(), grads.double()


def evaluate(model: Model, tips: np.ndarray, weights: np.ndarray,
             parents: np.ndarray, bl: torch.Tensor, *, control: bool = False,
             block_bytes: int = 1 << 30):
    """(log likelihoods [B], branch gradients [B, N]) float64 on bl's
    device, the root's column 0.  tips [T, S, A] and weights [S] from
    patterns.site_patterns, parents [B, N] int, bl [B, N].  The batch runs
    in blocks of trees whose partials take about `block_bytes` each."""
    dev = bl.device
    B, N = parents.shape
    T, S, A = tips.shape
    per_tree = N * len(model.rates) * S * A * 8
    step = max(1, min(B, block_bytes // per_tree))
    tips_t = torch.as_tensor(tips, device=dev, dtype=torch.float64)
    w = torch.as_tensor(weights, device=dev, dtype=torch.float64)
    ch = _children(np.asarray(parents))
    bl = bl.to(torch.float64)
    lls, grads = [], []
    for b0 in range(0, B, step):
        sl = slice(b0, min(B, b0 + step))
        ll, g = _block(
            model, tips_t, w,
            torch.as_tensor(parents[sl], device=dev, dtype=torch.long),
            torch.as_tensor(ch[sl], device=dev), bl[sl], control)
        lls.append(ll)
        grads.append(g)
    return torch.cat(lls), torch.cat(grads)
