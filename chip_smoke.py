#!/usr/bin/env python3
"""Drive bito_tpu_torch's kernel paths once on one NVIDIA card.

    python3 chip_smoke.py

The workload is the flagship configuration at full width: a DS1-shaped
problem (27 taxa, 1,949 columns drawn from 934 distinct ones, made from a
seed), GTR+Gamma4 with bench.py's parameters, and a batch of 200 random
unrooted trees with trifurcating roots.  Three paths run six kernels:
  - paired: the engine's default (kernel="auto"), paired_ll and
    paired_grad;
  - chunked: the same engine with kernel="chunked", chunked_ll and
    chunked_grad;
  - per-node: pernode_log_likelihoods and pernode_ll_and_gradients on the
    engine's own tapes, driven as bito_tpu's scripts/bench_kernel_race.py
    drives their originals (the engine has no route to them).

Phases, each printing its lines; any failure raises and exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from the
     sources in the checkout (nvcc, at first use), with each kernel's
     registers and spills.
  2. each kernel against its plain torch version in float64 on the same
     operands: LL relative error and gradient max-abs error over max |g|,
     both within 5e-5 (bench.py's on-device guard).
  3. each path, with every launch count set to 0 just before it and read
     just after: its kernels must have launched and no other path's; the
     results (log_likelihoods, ll_and_branch_gradients, 40 calls over
     scaled branch lengths, and ll_eval_fn on the chunked path) must be
     finite and agree with the float64 engine (the scan tape) within the
     phase-2 bounds; the float64 gradients are checked against central
     differences.
  4. CUDA-event times of each kernel and its plain version, and each
     engine route's LL+gradient evals/s, with the card's name and limit.
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
from bito_tpu_torch.treelike import _kernels, chunked, paired, pernode, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

SEED = 0
BATCH = 200
SWEEP = 40
BOUND = 5e-5  # bench.py's on-device parity guard
PARAMS = _synthetic.GTR_GAMMA4_PARAMS  # bench.py's
KERNELS = {  # name -> its source, its TPU kernel, its wrapper and its path
    "paired_ll": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_log_likelihoods, path="paired"),
    "paired_grad": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_ll_and_gradients, path="paired"),
    "chunked_ll": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_ll.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:384",
        wrapper=chunked.chunked_log_likelihoods, path="chunked"),
    "chunked_grad": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_grad.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:404",
        wrapper=chunked.chunked_ll_and_gradients, path="chunked"),
    "pernode_ll": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_ll.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:90",
        wrapper=pernode.pernode_log_likelihoods, path="pernode"),
    "pernode_grad": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_grad.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:179",
        wrapper=pernode.pernode_ll_and_gradients, path="pernode"),
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
        m = re.search(r"Compiling entry function '.*?((?:paired|chunked|pernode)"
                      r"_(?:ll|grad)_kernel)ILi(\d+)E", line)
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


def reset_launches():
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def read_launches(path):
    """{kernel: launches} for the kernels of `path`, after checking that
    each launched and that no kernel of another path did."""
    counts = {name: spec["wrapper"].launches for name, spec in KERNELS.items()}
    print(f"# phase 3: {path} path launches {counts}")
    for name, spec in KERNELS.items():
        if spec["path"] == path:
            check(counts[name] > 0, f"{name} launched in the {path} path")
        else:
            check(counts[name] == 0, f"{name} did not launch in the {path} "
                  "path")
    return {n: c for n, c in counts.items() if KERNELS[n]["path"] == path}


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
    t_start = time.perf_counter()

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
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    print(f"# workload: {sp.num_taxa} taxa, {sp.site_count} sites, "
          f"{sp.pattern_count} patterns (pad {eng.pattern_pad}), "
          f"{len(trees)} trees, {enc.num_slots} nodes, GTR+Gamma4; "
          f"chunked tape W={ce.W}, {ce.Mc} chunks")

    # -- 2. kernels against their plain versions ------------------------------
    bl = eng.branch_length_matrix(trees, enc)
    eig, rates, props, clock = eng._model_ingredients(params, BATCH)
    pi, prop = prep.kernel_model(eig, props)
    tips, w = eng._kernel_tips, eng._kernel_weights
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    P, dPq = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    _, dP = prep.prepare_inputs_grad(eig, rates, clock, bl)
    cdst, ctip, cedge, crow, _ = eng._chunked_tapes(enc)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    args = {  # kernel -> (plain version, wrapper arguments)
        "paired_ll": (paired.paired_log_likelihoods_ref,
                      (dst, tip, e, P, tips, pi, prop, w)),
        "paired_grad": (paired.paired_ll_and_gradients_ref,
                        (dst, tip, src, e, mask, P, dPq, tips, pi, prop, w)),
        "chunked_ll": (chunked.chunked_log_likelihoods_ref,
                       (cdst, ctip, cedge, P, tips, pi, prop, w)),
        "chunked_grad": (chunked.chunked_ll_and_gradients_ref,
                         (cdst, ctip, cedge, crow, mask, P, dP, tips, pi, prop,
                          w)),
        "pernode_ll": (pernode.pernode_log_likelihoods_ref,
                       (post, root, P, tips, pi, prop, w)),
        "pernode_grad": (pernode.pernode_ll_and_gradients_ref,
                         (post, pre, root, mask, P, dP, tips, pi, prop, w)),
    }
    errs = {}  # kernel -> (relative or max-norm error, max abs error)
    for ll_name in ("paired_ll", "chunked_ll", "pernode_ll"):
        grad_name = ll_name.replace("_ll", "_grad")
        ll_k = KERNELS[ll_name]["wrapper"](*args[ll_name][1])
        ll_g, g_k = KERNELS[grad_name]["wrapper"](*args[grad_name][1])
        torch.cuda.synchronize()
        plain, grad_args = args[grad_name]
        ll_p, g_p = plain(*[x.double() if x.is_floating_point() else x
                            for x in grad_args])
        errs[ll_name] = (rel_err(ll_k, ll_p),
                         (ll_k.double() - ll_p).abs().max().item())
        errs[grad_name] = (norm_err(g_k, g_p),
                           (g_k.double() - g_p).abs().max().item())
        ll_g_err = rel_err(ll_g, ll_p)
        print(f"# phase 2: {ll_name} LL rel err {errs[ll_name][0]:.3e}; "
              f"{grad_name} LL rel err {ll_g_err:.3e}, grad max-abs/max|g| "
              f"{errs[grad_name][0]:.3e} (bound {BOUND:g}, plain version "
              f"in float64 on the same operands)")
        check(errs[ll_name][0] <= BOUND, f"{ll_name} LL parity")
        check(ll_g_err <= BOUND, f"{grad_name} LL parity")
        check(errs[grad_name][0] <= BOUND, f"{grad_name} gradient parity")

    # -- 3. the paths ------------------------------------------------------------
    N = enc.num_slots
    scales = [1.0 + 0.001 * k for k in range(SWEEP)]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, params64)
    ref_fn = ref.branch_eval_fn(trees, params64)
    bl64 = bl.double()
    sweep_ref = [ref_fn(bl64 * f) for f in scales]

    def against_reference(path, lls, pairs):
        """Hold the path's (ll) and sweep (ll, grads) against the float64
        engine: lls at the base branch lengths, pairs [(ll, grads)] with
        pairs[0] at the base and pairs[1:] at scales[k]."""
        check(pairs[0][0].shape == (BATCH,)
              and pairs[0][1].shape == (BATCH, N), f"{path} output shapes")
        outs = list(lls) + [x for pair in pairs for x in pair]
        check(all(bool(torch.isfinite(x).all()) for x in outs),
              f"{path} outputs are finite")
        ll_errs = [rel_err(x, ll_ref) for x in lls]
        g_errs = []
        for (ll_k, g_k), (ll_r, g_r) in zip(pairs, [(ll_ref, g_ref)]
                                             + sweep_ref):
            ll_errs.append(rel_err(ll_k, ll_r))
            g_errs.append(norm_err(g_k, g_r))
        print(f"# phase 3: {path} path against the float64 engine (scan "
              f"tape), worst over {len(g_errs)} calls: LL rel err "
              f"{max(ll_errs):.3e}, grad max-abs/max|g| {max(g_errs):.3e} "
              f"(bound {BOUND:g})")
        check(max(ll_errs + g_errs) <= BOUND,
              f"{path} path agrees with the float64 engine")

    launches = {}
    reset_launches()
    ll = eng.log_likelihoods(trees, params)
    pairs = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs += [fn(bl * f) for f in scales]
    torch.cuda.synchronize()
    launches.update(read_launches("paired"))
    against_reference("paired", [ll], pairs)

    eng.kernel = "chunked"
    reset_launches()
    ll = eng.log_likelihoods(trees, params)
    ll_fn = eng.ll_eval_fn(trees, params)(bl)
    pairs = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs += [fn(bl * f) for f in scales]
    torch.cuda.synchronize()
    launches.update(read_launches("chunked"))
    against_reference("chunked", [ll, ll_fn], pairs)
    eng.kernel = "auto"

    reset_launches()
    ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w)
    pairs = []
    for f in [1.0] + scales:
        Pk, dPk = prep.prepare_inputs_grad(eig, rates, clock, bl * f)
        pairs.append(pernode.pernode_ll_and_gradients(
            post, pre, root, mask, Pk, dPk, tips, pi, prop, w))
    torch.cuda.synchronize()
    launches.update(read_launches("pernode"))
    against_reference("pernode", [ll], pairs)

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
    times = {}
    for name in KERNELS:
        plain, a = args[name]
        wrapper = KERNELS[name]["wrapper"]
        # plain, kernel, kernel, plain: both sides see the same drift.
        p1 = cuda_ms(lambda: plain(*a), 5)
        k1 = cuda_ms(lambda: wrapper(*a), 50)
        k2 = cuda_ms(lambda: wrapper(*a), 50)
        p2 = cuda_ms(lambda: plain(*a), 5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"# phase 4: {name} kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms (float32, {BATCH} trees x "
              f"{eng.pattern_pad} patterns) on {card}")

    def sweep_evals_per_s(kernel, calls):
        eng.kernel = kernel
        f = eng.branch_eval_fn(trees, params)
        ms = cuda_ms(lambda: f(bl), calls)
        return BATCH / (ms / 1e3), ms

    rates_line = ", ".join(
        f"{label} {eps:.1f} ({ms:.4f} ms/call)" for label, (eps, ms) in [
            ("paired kernels (auto)", sweep_evals_per_s("auto", 40)),
            ("chunked kernels", sweep_evals_per_s("chunked", 40)),
            ("scan tape", sweep_evals_per_s("scan", 5))])
    eng.kernel = "auto"
    print(f"# phase 4: end to end, DS1-shaped GTR+Gamma4 LL+gradient "
          f"evals/s at B={BATCH}: {rates_line}, on {card}")
    print(f"# chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s")

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
