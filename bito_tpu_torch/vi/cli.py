"""The vip-equivalent command line (the reference's vip/cli.py):

    python -m bito_tpu_torch.vi.cli benchmark [options] DATA_PATH
    python -m bito_tpu_torch.vi.cli dag-to-dot -fasta F -newick N -output O

Counterpart of bito_tpu.vi.cli on argparse (the machine with the card has
no click), with bito_tpu's options and defaults.  `benchmark` runs
vi.benchmark.fixed on DATA_PATH, a directory X holding X_out.t (an MCMC
run on a fixed topology) and X.fasta, prints the run details, and with
--out-prefix P writes P_opt_trace.csv and P_fitting_results.csv; the port
adds --device and --dtype (the card in float32 by default).
`dag-to-dot` writes the subsplit DAG of a FASTA and a Newick file as a
.dot file, and renders an .svg beside it where the graphviz package and
its `dot` program are present, else says it wrote the .dot only.
"""
from __future__ import annotations

import argparse
import pprint
import sys

import torch

SCALAR_MODELS = ("lognormal", "tf_lognormal", "tf_truncated_lognormal",
                 "tf_gamma", "jax_lognormal", "jax_truncated_lognormal",
                 "jax_gamma")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _bool(text: str) -> bool:
    """click's BOOL: true/false, yes/no, 1/0, on/off, any case."""
    value = text.strip().lower()
    if value in ("1", "true", "t", "yes", "y", "on"):
        return True
    if value in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"{text!r} is not a valid boolean")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bito_tpu_torch.vi.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    bench = sub.add_parser(
        "benchmark", help="Do a benchmarking comparison to an MCMC run.")
    bench.add_argument("--branch-model", choices=("split", "psp"),
                       default="split")
    bench.add_argument("--scalar-model", choices=SCALAR_MODELS,
                       default="lognormal")
    bench.add_argument("--optimizer", choices=("simple", "bump"),
                       default="simple")
    bench.add_argument("--step-count", type=int, default=5,
                       help="Number of gradient descent steps to take.")
    bench.add_argument("--particle-count", type=int, default=10,
                       help="Number of particles for stochastic gradient "
                            "estimation.")
    bench.add_argument("--thread-count", type=int, default=4,
                       help="Accepted for bito compatibility (batching "
                            "replaces threads).")
    bench.add_argument("--out-prefix", default=None,
                       help="Path prefix to which output should be saved.")
    bench.add_argument("--final-elbo-particle-count", type=int,
                       default=10000)
    bench.add_argument("--device", default="cuda")
    bench.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    bench.add_argument("data_path")
    dot = sub.add_parser(
        "dag-to-dot", help="Convert a subsplit DAG to a .dot file (and .svg "
                           "when graphviz is installed).")
    dot.add_argument("-fasta", "--fasta-path", required=True)
    dot.add_argument("-newick", "--newick-path", required=True)
    dot.add_argument("-output", "--output-path", required=True)
    dot.add_argument("-edges", "--edge-labels", type=_bool, default=False)
    return ap


def benchmark(args) -> None:
    from . import benchmark as benchmark_mod

    print("Starting validation:")
    pprint.pprint(vars(args))
    run_details, opt_trace, fitting_results = benchmark_mod.fixed(
        args.data_path, branch_model_name=args.branch_model,
        scalar_model_name=args.scalar_model, optimizer_name=args.optimizer,
        step_count=args.step_count, particle_count=args.particle_count,
        thread_count=args.thread_count,
        final_elbo_particle_count=args.final_elbo_particle_count,
        device=args.device, dtype=DTYPES[args.dtype])
    if args.out_prefix is not None:
        benchmark_mod.write_csv(args.out_prefix + "_opt_trace.csv", opt_trace)
        benchmark_mod.write_csv(args.out_prefix + "_fitting_results.csv",
                                fitting_results)
    pprint.pprint(run_details)


def dag_to_dot(args) -> None:
    import os
    import shutil

    from ..api.gp import gp_instance

    # The DAG and its .dot are host work: the instance builds no engine.
    inst = gp_instance("", device="cpu", dtype=torch.float64)
    for path in (args.fasta_path, args.newick_path):
        if not os.path.exists(path):
            sys.exit(f"dag-to-dot: {path} does not exist")
    inst.read_fasta_file(args.fasta_path)
    inst.read_newick_file(args.newick_path)
    inst.make_dag()
    inst.subsplit_dag_to_dot(args.output_path, args.edge_labels)
    try:
        import graphviz
    except ImportError:
        print(f"graphviz rendering unavailable (no graphviz package); wrote "
              f"{args.output_path} only")
        return
    if shutil.which("dot") is None:
        print(f"graphviz rendering unavailable (no dot program); wrote "
              f"{args.output_path} only")
        return
    graphviz.render("dot", "svg", args.output_path)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    {"benchmark": benchmark, "dag-to-dot": dag_to_dot}[args.command](args)


if __name__ == "__main__":
    main()
