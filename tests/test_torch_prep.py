"""The paired route's prep (treelike/prep.py prepare_inputs_grad_q) and the
kernel that forms P and dP on the card (transition_prep,
models/csrc/transition_prep.cu), without a card: which inputs take the
kernel (the card faked by patching paired.on_cpu, the launch by a
stand-in), that the CPU and float64 calls and operands outside the
kernel's domain run the torch ops, that the build compiles the kernel's
source outside treelike/csrc so that the benchmark's trace counts it
under the model prep and not among the tree kernels, and that the
launcher raises on what the kernel does not take before it touches a
card.  The kernel against the torch ops runs in
tests/test_torch_cuda.py."""
import re

import pytest
import torch

from bito_tpu_torch.models.substitution import (EigenDecomp, build_gtr_q,
                                                gtr_eigen)
from bito_tpu_torch.treelike import _kernels, paired, prep
from torch_port_cases import one_torch_thread

F64 = torch.float64
B, N, C = 3, 8, 4


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _gtr(batch=B, per_tree=False):
    """A GTR eigensystem, one row expanded over the trees or a row a
    tree, with gamma-like rates [B, C], clock [B] and branch lengths
    [B, N] float32 (one of them 0)."""
    g = torch.Generator().manual_seed(3)
    rows = batch if per_tree else 1
    rates6 = torch.rand((rows, 6), generator=g, dtype=F64) + 0.1
    freqs = torch.rand((rows, 4), generator=g, dtype=F64) + 0.2
    eig = gtr_eigen(rates6 / rates6.sum(-1, keepdim=True),
                    freqs / freqs.sum(-1, keepdim=True))
    if not per_tree:
        eig = EigenDecomp(*(x.expand((batch,) + x.shape[1:]) for x in eig))
    rates = torch.tensor([0.02, 0.3, 1.0, 2.68], dtype=F64).expand(batch, C)
    clock = torch.full((batch,), 1.3, dtype=F64)
    bl = (torch.rand((batch, N), generator=g) * 0.2).float()
    bl[0, 1] = 0.0
    return eig, rates, clock, bl


def _eig64(batch=B):
    """A 64-state reversible eigensystem, a row a tree (the eigen route of
    per-tree codon rows)."""
    g = torch.Generator().manual_seed(5)
    S = torch.rand((batch, 64, 64), generator=g, dtype=F64)
    S = S + S.transpose(-1, -2)
    S = S - torch.diag_embed(S.sum(-1))
    values, V = torch.linalg.eigh(S)
    return EigenDecomp(V, values, V.transpose(-1, -2),
                       torch.full((batch, 64), 1 / 64, dtype=F64))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("per_tree", [False, True])
def test_cpu_calls_take_the_torch_ops(dtype, per_tree):
    """On the CPU, in float32 and in float64 operands, prepare_inputs_grad_q
    launches nothing and gives transition_prep_plain's P and dP: the
    identity and zero at the identity edge N."""
    eig, rates, clock, bl = _gtr(per_tree=per_tree)
    before = prep.transition_prep.launches
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, dtype)
    assert prep.transition_prep.launches == before
    P0, dP0 = prep.transition_prep_plain(eig, rates, clock, bl, dtype)
    assert P.dtype == dP.dtype == dtype
    assert P.shape == dP.shape == (B, N + 1, C, 4, 4)
    assert torch.equal(P, P0) and torch.equal(dP, dP0)
    assert torch.equal(P[:, N], torch.eye(4, dtype=dtype).expand(B, C, 4, 4))
    assert not dP[:, N].any()


def _routes(monkeypatch):
    """Fake the card for prepare_inputs_grad_q and record the launches in
    place of the kernel's."""
    calls = []
    monkeypatch.setattr(paired, "on_cpu", lambda t: False)

    def launch(*args):
        calls.append(args)
        return "kernel"

    monkeypatch.setattr(prep, "_launch", launch)
    return calls


@pytest.mark.parametrize("bl_case", ["contiguous", "sliced", "transposed"])
def test_card_call_in_the_domain_takes_the_kernel(monkeypatch, bl_case):
    """On the card, at 4 states on the eigen route with float32 operands,
    the prep hands its ingredients and branch lengths to the launch, as
    they are (a slice of a wider buffer, or a transposed one, with its
    strides), and runs no torch op of its own."""
    eig, rates, clock, bl = _gtr()
    if bl_case == "sliced":
        bl = torch.cat([bl, bl], 1)[:, :N]
    elif bl_case == "transposed":
        bl = bl.t().contiguous().t()
    calls = _routes(monkeypatch)
    assert prep.prepare_inputs_grad_q(eig, rates, clock, bl) == "kernel"
    assert len(calls) == 1
    assert calls[0][0] is eig and calls[0][1] is rates
    assert calls[0][2] is clock and calls[0][3] is bl


@pytest.mark.parametrize("case", ["float64", "codon_Q", "A64_rows", "Q4",
                                  "bl_float16", "float32_ingredients",
                                  "clock_scalar"])
def test_card_call_outside_the_domain_takes_the_torch_ops(monkeypatch, case):
    """On the card, float64 operands, a shared Q (the codon models'
    uniformized route, here also at 4 states), the eigen route at 64
    states (per-tree codon rows), and operands the kernel does not read
    (float16 branch lengths, float32 ingredients, a clock that is not a
    row a tree) keep the torch ops: nothing is launched and the result is
    transition_prep_plain's."""
    eig, rates, clock, bl = _gtr()
    dtype, Q = torch.float32, None
    if case == "float64":
        dtype = F64
    elif case == "Q4":
        Q = build_gtr_q(torch.full((6,), 1 / 6, dtype=F64),
                        torch.full((4,), 0.25, dtype=F64))
    elif case == "codon_Q":
        eig64 = _eig64()
        eig = eig64
        Q = (eig64.U[0] * eig64.values[0][None]) @ eig64.U_inv[0]
    elif case == "A64_rows":
        eig = _eig64()
    elif case == "bl_float16":
        bl = bl.half()
    elif case == "float32_ingredients":
        eig = EigenDecomp(*(x.float() for x in eig))
        rates, clock = rates.float(), clock.float()
    else:
        clock = clock[:1]
    calls = _routes(monkeypatch)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, dtype, Q=Q)
    assert calls == []
    P0, dP0 = prep.transition_prep_plain(eig, rates, clock, bl, dtype, Q=Q)
    assert torch.equal(P, P0) and torch.equal(dP, dP0)


def test_sources_list_the_prep_kernel():
    """The build compiles the kernel's source, which lies under
    models/csrc, and binds its entry point."""
    assert "models/csrc/transition_prep.cu" in _kernels._SOURCES
    assert not any(s.startswith("treelike/csrc/transition_prep")
                   for s in _kernels._SOURCES)
    assert "bito_transition_prep" in _kernels._SIGNATURES
    assert (_kernels._ROOT / "models/csrc/transition_prep.cu").is_file()


def test_trace_counts_the_prep_kernel_under_the_model_prep():
    """portbench's trace names the tree kernels by the `__global__`
    functions of treelike/csrc; the prep kernel's is not among them, so a
    traced window counts its time in prep_ms.evals, with the model prep,
    and leaves kernel_roofline's denominator to the tree kernels."""
    from portbench import trace

    src = (_kernels._ROOT / "models/csrc/transition_prep.cu").read_text()
    names = set(trace._GLOBAL.findall(src))
    assert names == {"transition_prep_kernel"}
    tree = trace.library_kernels()
    assert "paired_grad_onchip_kernel" in tree
    assert not names & tree
    assert not re.search(r"transition_prep", " ".join(sorted(tree)))


def _bad_operands(case):
    eig, rates, clock, bl = _gtr()
    if case == "bl_1d":
        bl = bl[0]
    elif case == "clock_shape":
        clock = clock[:, None]
    elif case == "bl_float16":
        bl = bl.half()
    elif case == "bl_int32":
        bl = bl.int()
    elif case == "A64":
        eig = _eig64()
    elif case == "float32_ingredients":
        eig = EigenDecomp(*(x.float() for x in eig))
    elif case == "rates_shape":
        rates = torch.ones((B + 1, C), dtype=F64)
    return eig, rates, clock, bl


@pytest.mark.parametrize("case,error,match", [
    ("bl_1d", ValueError, r"\[B, N\]"),
    ("clock_shape", ValueError, "clock_rate has shape"),
    ("bl_float16", TypeError, "float32 or float64"),
    ("bl_int32", TypeError, "float32 or float64"),
    ("A64", ValueError, "4-state"),
    ("float32_ingredients", TypeError, "float64"),
    ("rates_shape", ValueError, "category_rates has shape"),
    ("cpu", ValueError, "CUDA"),
])
def test_launcher_refuses_what_the_kernel_does_not_take(case, error, match):
    """transition_prep raises on branch lengths that are not [B, N] or not
    float32 / float64, on a model of other than 4 states (A = 64 with Q
    None forced into it), on ingredients that are not float64 or not
    [B, ...], and on operands off the card, before any launch."""
    before = prep.transition_prep.launches
    with pytest.raises(error, match=match):
        prep.transition_prep(*_bad_operands(case))
    assert prep.transition_prep.launches == before
