#!/usr/bin/env python3
"""Where the device time of one branch_eval_fn call goes, on one NVIDIA card.

    python3 profile_main_path.py [auto|chunked|codon]

The workload is chip_smoke.py's flagship (DS1 shape, GTR+Gamma4, 200
trees) through the engine's kernel path in float32: the paired kernels
(engine.kernel "auto", the default) or the chunked ones ("chunked"); or
chip_smoke.py's codon path ("codon": config6's shape, MG94 at 64
states, 128 trees, on auto, the A=64 kernels).
After 5 warm-up calls it traces 20 back-to-back calls with torch.profiler
and reads the device side from the exported Chrome trace alone: its
kernel, memcpy and memset events.  (The profiler's per-operator rows also carry the time of
the kernels they launch, so a sum over key_averages() counts it twice.)
It prints, per call:
  - busy ms: the union of the device events' intervals;
  - window ms: first device event's start to last device event's end;
  - idle share: 1 - busy / window;
  - each kernel name's ms and share of busy time, largest first;
and the same calls untraced, timed with CUDA events, to show what the
tracing costs.  It has no CPU path: without a card it exits non-zero.
"""
import collections
import json
import os
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

from bito_tpu_torch import PRODUCT_DEVICE, PRODUCT_DTYPE
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine
from chip_smoke import PARAMS, card_line, codon_workload, cuda_ms, flagship

CALLS = 20
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_path):
    """[(name, start_us, end_us)] of the trace's device activity."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def union_us(intervals):
    """Total length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def main():
    kernel = sys.argv[1] if len(sys.argv) > 1 else "auto"
    if kernel not in ("auto", "chunked", "codon"):
        sys.exit("usage: profile_main_path.py [auto|chunked|codon], got "
                 f"{kernel!r}")
    if not torch.cuda.is_available():
        sys.exit("profile_main_path.py needs an NVIDIA card: "
                 "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device(PRODUCT_DEVICE)
    if kernel == "codon":
        trees, sp, model, numpy_params = codon_workload()
    else:
        (trees, sp, model), numpy_params = flagship(), PARAMS
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    eng.kernel = "auto" if kernel == "codon" else kernel
    params = params_from_numpy(numpy_params, dev, PRODUCT_DTYPE)
    bl = eng.branch_length_matrix(trees, eng.encode(trees))
    fn = eng.branch_eval_fn(trees, params)
    for _ in range(5):
        fn(bl)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn(bl)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = device_events(path)
    if not events:
        raise RuntimeError("the trace holds no device activity")

    n = CALLS
    busy = union_us((s, e) for _, s, e in events) / 1e3 / n
    window = (max(e for _, _, e in events)
              - min(s for _, s, _ in events)) / 1e3 / n
    untraced = cuda_ms(lambda: fn(bl), n)
    print(card)
    print(f"# traced {n} calls (kernel={kernel!r}): busy {busy:.4f} "
          f"ms/call, window {window:.4f} ms/call, idle share "
          f"{1 - busy / window:.4f}; "
          f"untraced {untraced:.4f} ms/call (CUDA events)")
    by_name = collections.defaultdict(float)
    for name, s, e in events:
        by_name[name] += (e - s) / 1e3 / n
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        print(f"#   {ms:.4f} ms/call  {ms / busy:7.2%}  {name[:100]}")


if __name__ == "__main__":
    main()
