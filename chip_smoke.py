#!/usr/bin/env python3
"""Drive bito_tpu_torch's main path once on one NVIDIA card.

    python3 chip_smoke.py

The workload is the flagship configuration at full width: a DS1-shaped
problem (27 taxa, 1,949 columns drawn from 934 distinct ones, made from a
seed), GTR+Gamma4 with bench.py's parameters, and a batch of 200 random
unrooted trees with trifurcating roots.

Phases, each printing its lines; any failure raises and exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from the
     sources in the checkout (nvcc, at first use).
  2. each kernel against its plain torch version in float64 on the same
     operands: LL relative error and gradient max-abs error over max |g|,
     both within 5e-5 (bench.py's on-device guard).
  3. the main path through the engine's entry points (log_likelihoods,
     ll_and_branch_gradients, 40 branch_eval_fn calls over scaled branch
     lengths), with every launch count set to 0 first: both kernels must
     have launched, and the results must be finite and agree with the
     float64 engine (the scan tape) within the phase-2 bounds, whose
     gradients are checked against central differences.
  4. CUDA-event times of each kernel and its plain version, and the
     engine's LL+gradient evals/s, each with the card's name and limit.
  5. one JSON line of the kernels, then the device line, last.

It has no CPU path: without a card it exits non-zero and prints no result.
"""
import json
import re
import subprocess
import sys
import time

import torch

from bito_tpu_torch import PRODUCT_DEVICE, PRODUCT_DTYPE, _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import _kernels, paired, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

SEED = 0
BATCH = 200
SWEEP = 40
BOUND = 5e-5  # bench.py's on-device parity guard
PARAMS = _synthetic.GTR_GAMMA4_PARAMS  # bench.py's
KERNELS = {
    "paired_ll": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_log_likelihoods),
    "paired_grad": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_ll_and_gradients),
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(x, ref):
    return ((x.double() - ref.double()).abs() / ref.double().abs()).max().item()


def norm_err(x, ref):
    return ((x.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_usage(log):
    """[(kernel, spill line, register line)] from nvcc's -Xptxas -v output,
    each kernel named as `paired_grad_kernel<4>`."""
    usage, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*(paired_(?:ll|grad)_kernel)"
                      r"ILi(\d+)E", line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and kernel:
            usage.append((kernel, spill, line.split(":", 1)[-1].strip()))
            kernel = None
    return usage


def flagship():
    """The flagship workload: (trees, SitePattern, PhyloModel)."""
    text, alignment = _synthetic.ds1_shaped(SEED, BATCH)
    coll = parse_newick_text(text)
    sp = SitePattern(alignment, coll.taxon_names)
    return coll.trees, sp, PhyloModel(PhyloModelSpecification("GTR", "gamma+4"))


def cuda_ms(fn, reps):
    """Mean milliseconds per call over `reps` calls, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs an NVIDIA card: "
                 "torch.cuda.is_available() is False")
    # The device line counts the visible cards; the run uses one.
    check(torch.cuda.device_count() == 1,
          f"one visible card, got {torch.cuda.device_count()} "
          "(choose one with CUDA_VISIBLE_DEVICES)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(PRODUCT_DEVICE)

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    print(card)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    print(f"# phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({so.name})")
    for kernel, spill, regs in ptxas_usage(so.with_suffix(".log").read_text()):
        print(f"#   ptxas {kernel}: {regs}; {spill}")

    # -- the workload ---------------------------------------------------------
    trees, sp, model = flagship()
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    ref = TreeLikelihoodEngine(sp, model, device=dev, dtype=torch.float64)
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    params64 = params_from_numpy(PARAMS, dev, torch.float64)
    enc = eng.encode(trees)
    print(f"# workload: {sp.num_taxa} taxa, {sp.site_count} sites, "
          f"{sp.pattern_count} patterns (pad {eng.pattern_pad}), "
          f"{len(trees)} trees, {enc.num_slots} nodes, GTR+Gamma4")

    # -- 2. kernels against their plain versions ------------------------------
    bl = eng.branch_length_matrix(trees, enc)
    eig, rates, props, clock = eng._model_ingredients(params, BATCH)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    tips, w = eng._kernel_tips, eng._kernel_weights
    ll_args = (dst, tip, e, P, tips, pi, prop, w)
    grad_args = (dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
    ll_k = paired.paired_log_likelihoods(*ll_args)
    ll_g, g_k = paired.paired_ll_and_gradients(*grad_args)
    torch.cuda.synchronize()
    d64 = [x.double() if x.is_floating_point() else x for x in grad_args]
    ll_p, g_p = paired.paired_ll_and_gradients_ref(*d64)
    errs = {
        "paired_ll": (rel_err(ll_k, ll_p), (ll_k.double() - ll_p).abs().max().item()),
        "paired_grad": (norm_err(g_k, g_p), (g_k.double() - g_p).abs().max().item()),
    }
    ll_g_err = rel_err(ll_g, ll_p)
    print(f"# phase 2: paired_ll LL rel err {errs['paired_ll'][0]:.3e}; "
          f"paired_grad LL rel err {ll_g_err:.3e}, grad max-abs/max|g| "
          f"{errs['paired_grad'][0]:.3e} (bound {BOUND:g}, plain version "
          f"in float64 on the same operands)")
    check(errs["paired_ll"][0] <= BOUND, "paired_ll LL parity")
    check(ll_g_err <= BOUND, "paired_grad LL parity")
    check(errs["paired_grad"][0] <= BOUND, "paired_grad gradient parity")

    # -- 3. the main path through the engine's entry points -------------------
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    ll = eng.log_likelihoods(trees, params)
    ll2, grads = eng.ll_and_branch_gradients(trees, params)
    fn = eng.branch_eval_fn(trees, params)
    sweep = [fn(bl * (1.0 + 0.001 * k)) for k in range(SWEEP)]
    torch.cuda.synchronize()
    launches = {name: spec["wrapper"].launches
                for name, spec in KERNELS.items()}
    print(f"# phase 3: launches in the main path {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched in the main path")
    N = enc.num_slots
    check(ll.shape == (BATCH,) and grads.shape == (BATCH, N),
          "output shapes")
    outs = [ll, ll2, grads] + [x for pair in sweep for x in pair]
    check(all(bool(torch.isfinite(x).all()) for x in outs), "finite outputs")

    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, params64)
    ll_errs = [rel_err(ll, ll_ref), rel_err(ll2, ll_ref)]
    g_errs = [norm_err(grads, g_ref)]
    ref_fn = ref.branch_eval_fn(trees, params64)
    bl64 = bl.double()
    for k, (ll_k2, g_k2) in enumerate(sweep):
        ll_r, g_r = ref_fn(bl64 * (1.0 + 0.001 * k))
        ll_errs.append(rel_err(ll_k2, ll_r))
        g_errs.append(norm_err(g_k2, g_r))
    print(f"# phase 3: against the float64 engine (scan tape), worst over "
          f"{len(g_errs)} calls: LL rel err {max(ll_errs):.3e}, grad "
          f"max-abs/max|g| {max(g_errs):.3e} (bound {BOUND:g})")
    check(max(ll_errs + g_errs) <= BOUND,
          "main path agrees with the float64 engine")
    # The float64 reference's own gradients against central differences.
    h = 1e-6
    for node in (0, 13, 40):
        step = torch.zeros_like(bl64)
        step[:, node] = h
        fd = (ref.log_likelihoods(trees, params64, bl64 + step)
              - ref.log_likelihoods(trees, params64, bl64 - step)) / (2 * h)
        fd_err = norm_err(g_ref[:, node], fd)
        print(f"# phase 3: float64 gradient vs central difference, node "
              f"{node}: max-abs/max|g| {fd_err:.3e}")
        check(fd_err <= 1e-6, "float64 gradient matches finite differences")

    # -- 4. times --------------------------------------------------------------
    plain = {"paired_ll": lambda: paired.paired_log_likelihoods_ref(*ll_args),
             "paired_grad": lambda: paired.paired_ll_and_gradients_ref(*grad_args)}
    kernel = {"paired_ll": lambda: paired.paired_log_likelihoods(*ll_args),
              "paired_grad": lambda: paired.paired_ll_and_gradients(*grad_args)}
    times = {}
    for name in KERNELS:
        # plain, kernel, kernel, plain: both sides see the same drift.
        p1 = cuda_ms(plain[name], 5)
        k1 = cuda_ms(kernel[name], 50)
        k2 = cuda_ms(kernel[name], 50)
        p2 = cuda_ms(plain[name], 5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"# phase 4: {name} kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms (float32, {BATCH} trees x "
              f"{eng.pattern_pad} patterns) on {card}")

    def sweep_evals_per_s(engine, calls):
        f = engine.branch_eval_fn(trees, params)
        ms = cuda_ms(lambda: f(bl), calls)
        return BATCH / (ms / 1e3), ms

    eps, ms = sweep_evals_per_s(eng, 40)
    eng.kernel = "scan"
    eps_scan, ms_scan = sweep_evals_per_s(eng, 5)
    eng.kernel = "auto"
    print(f"# phase 4: end to end, DS1-shaped GTR+Gamma4 LL+gradient "
          f"evals/s at B={BATCH}: kernels {eps:.1f} ({ms:.4f} ms/call), "
          f"scan tape {eps_scan:.1f} ({ms_scan:.4f} ms/call), on {card}")

    # -- 5. results -------------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], "launches": launches[name],
         "max_abs_err": errs[name][1], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, spec in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
