"""Local multi-process launcher: N ranks of one torch.distributed job.

    python -m bito_tpu_torch.dist.launch -n 2 [--device cuda|cpu] \
        [--backend gloo|nccl] [--stall-timeout S] [--hard-timeout S] \
        script.py [args...]

Port of bito_tpu.dist.launch.  Spawns N copies of script.py, each wired
to one coordinator through the BITO_* variables that
dist.multihost.initialize reads (`import bito_tpu_torch` joins the job),
with BITO_DEVICE and BITO_BACKEND from --device and --backend.  bito_tpu's
--devices-per-process and XLA_FLAGS have no counterpart: a rank is one
process on one device.  The device is the card unless --device cpu says
otherwise; the backend defaults to multihost.default_backend's rule (NCCL
where each rank has a card of its own, else Gloo).  NCCL asked for more
ranks than visible cards, or the card where none is visible, fails here,
before any worker starts.  Worker output is streamed with a `[p<i>]`
prefix, unbuffered.  Each worker runs one intra-op thread
(OMP_NUM_THREADS=1) unless the caller set OMP_NUM_THREADS.

Failure: every output line of any worker counts as a heartbeat.  If no
worker prints for --stall-timeout seconds (default 120), if the job
outlasts --hard-timeout (default none), or if a worker exits non-zero,
the launcher kills exactly the worker processes it spawned that are still
running and exits non-zero with each worker's state and last lines, so
the rank at fault is named.  It exits 0 only when every worker did.

On machines of their own, start one process a rank through the cluster's
scheduler and set the BITO_* variables yourself (dist/multihost.py).
"""
from __future__ import annotations

import argparse
import collections
import os
import socket
import subprocess
import sys
import threading
import time

from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from .multihost import DEVICES, check_backend, default_backend


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bito_tpu_torch.dist.launch")
    ap.add_argument("-n", "--num-processes", type=int, required=True)
    ap.add_argument("--device", choices=DEVICES, default=PRODUCT_DEVICE,
                    help="each worker's device (BITO_DEVICE); default: "
                         "the card")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="torch.distributed backend (BITO_BACKEND); "
                         "default: NCCL where each rank has a card of its "
                         "own, else Gloo")
    ap.add_argument("--stall-timeout", type=float, default=120.0,
                    help="seconds without output from ANY worker before "
                         "the job is declared wedged and killed")
    ap.add_argument("--hard-timeout", type=float, default=0.0,
                    help="absolute wall-clock cap (0 = none)")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.num_processes < 1:
        sys.exit("bito_tpu_torch.dist.launch: -n must be at least 1")

    backend = args.backend or default_backend(args.device,
                                              args.num_processes)
    try:
        check_backend(backend, args.device, args.num_processes)
        resolve(args.device, PRODUCT_DTYPE)
    except (ValueError, RuntimeError) as exc:
        sys.exit(f"bito_tpu_torch.dist.launch: {exc}; no worker started")

    port = _free_port()
    procs = []
    for pid in range(args.num_processes):
        env = dict(os.environ)
        env["BITO_COORDINATOR"] = f"localhost:{port}"
        env["BITO_NUM_PROCESSES"] = str(args.num_processes)
        env["BITO_PROCESS_ID"] = str(pid)
        env["BITO_DEVICE"] = args.device
        env["BITO_BACKEND"] = backend
        env["PYTHONUNBUFFERED"] = "1"
        # One thread a rank unless the caller says otherwise, as torchrun
        # does: ranks that share the host's cores and each take all of
        # them run the small operations of the CPU path many times slower.
        env.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen(
            [sys.executable, args.script] + args.script_args,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))

    last_output = [time.monotonic()]
    tails = [collections.deque(maxlen=5) for _ in procs]

    def pump(i, p):
        for line in p.stdout:
            last_output[0] = time.monotonic()
            tails[i].append(line.rstrip())
            sys.stdout.write(f"[p{i}] {line}")
            sys.stdout.flush()

    threads = [threading.Thread(target=pump, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()

    start = time.monotonic()

    def _states():
        return ["running (killed)" if p.poll() is None
                else f"exited {p.returncode}" for p in procs]

    def _diagnose(reason: str, states) -> str:
        lines = [f"bito_tpu_torch.dist.launch: {reason}"]
        for i, state in enumerate(states):
            lines.append(f"  worker p{i}: {state}; last output:")
            for ln in tails[i] or ["    <none>"]:
                lines.append(f"    {ln}")
        return "\n".join(lines)

    killed_reason = None
    while any(p.poll() is None for p in procs):
        time.sleep(0.25)
        now = time.monotonic()
        failed = [i for i, p in enumerate(procs)
                  if p.poll() is not None and p.returncode != 0]
        if failed:
            killed_reason = ("worker(s) " + ", ".join(f"p{i}" for i in failed)
                             + " exited non-zero")
            break
        if args.stall_timeout and now - last_output[0] > args.stall_timeout:
            killed_reason = (f"no worker output for "
                             f"{args.stall_timeout:g}s — wedged")
            break
        if args.hard_timeout and now - start > args.hard_timeout:
            killed_reason = f"exceeded hard timeout {args.hard_timeout:g}s"
            break

    if killed_reason is not None:
        states = _states()
        # Kill the exact processes this launcher spawned (never patterns).
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in threads:
            t.join(timeout=2)
        sys.exit(_diagnose(killed_reason, states))

    codes = [p.wait() for p in procs]
    for t in threads:
        t.join(timeout=2)
    if any(codes):
        sys.exit(_diagnose(f"workers exited with {codes}", _states()))


if __name__ == "__main__":
    main()
