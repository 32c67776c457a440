"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  It exits non-zero, and prints no result, where there is no card.
The last line of standard output is the result (see harness.result);
the numbers the check compared, each beside its limit, are the last lines
of standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def process_age_s() -> float:
    """Seconds since this process started, at 10 ms resolution (Linux's
    /proc), so that set-up counts the interpreter's start as well."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def fix_caches() -> None:
    """Point the kernel caches of torch (the NVRTC-built kernels, such as
    the Gamma categories' ndtri) and of triton at fixed directories inside
    the checkout, before torch is imported: only a checkout's first run
    builds them.  The program's own library builds into
    bito_tpu_torch/_build/ there already."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".portbench_cache")
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = os.path.join(root, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        parser.error("--seed must be >= 0 and --seconds > 0")
    fix_caches()
    from . import harness

    # The process's start on the clock that times the window.
    start = T0 - (process_age_s() - (time.perf_counter() - T0))
    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), start)


if __name__ == "__main__":
    sys.exit(main())
