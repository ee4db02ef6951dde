"""CLI entry point: the JAX package's subcommands and flags, on the card.

  python -m genome_assembly_tpu_torch assemble    --n 500 --l 100 --p 0.01 --k 5
  python -m genome_assembly_tpu_torch experiments --skip-1 --iterations 2
  python -m genome_assembly_tpu_torch experiments --quick --no-plots
  python -m genome_assembly_tpu_torch assemble --device cpu   # on the host

``--device`` (default ``cuda``) is the torch device of the run; it raises
when no card is present and never moves to the CPU on its own. The kernels
are built at first use into ``genome_assembly_tpu_torch/build/``. Plots
need matplotlib and pandas and are imported only when drawn; pass
``--no-plots`` where they are not installed.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import sys

import numpy as np
import torch

from .core.dispatch import resolve_device


def _default_fasta() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "data", "phix174.fasta")


def cmd_assemble(args) -> int:
    from .experiments.runner import test_assembly
    from .simulate import read_genome_from_fasta
    from .utils.tracing import global_tracer, profile

    device = resolve_device(args.device)
    genome = read_genome_from_fasta(args.fasta)
    rng = random.Random(args.seed) if args.seed is not None else None
    np_rng = (np.random.RandomState(args.seed)
              if args.seed is not None else None)
    prof = (profile(args.profile) if args.profile
            else contextlib.nullcontext())
    with prof, torch.profiler.record_function("test_assembly"):
        contigs, measures, _, _ = test_assembly(
            genome, args.l, args.n, args.p, args.k, args.name, 1,
            path=args.plots, rng=rng, np_rng=np_rng, verbose=args.verbose,
            banded=args.banded, exact_parity=not args.fast_layout,
            consensus=args.consensus, device=device)
    print(f"contigs: {len(contigs)}")
    for name, value in measures.items():
        print(f"{name}: {value}")
    if args.trace or args.verbose:
        print("\n-- stage trace --")
        print(global_tracer().report())
    return 0


def quick_grids(genome_length: int):
    """``--quick``'s grids (coverage targets, N, l, p, k): 12 configs over
    the three experiments."""
    return ([round(100 * 50 / genome_length, 3), 2],
            np.array([100, 200]), np.array([50, 100]),
            np.array([0.01]), np.array([5]))


def cmd_experiments(args) -> int:
    from .experiments.harness import run_experiments
    from .simulate import read_genome_from_fasta

    device = resolve_device(args.device)
    grids = None
    if args.quick:
        grids = quick_grids(len(read_genome_from_fasta(args.fasta)))
    run_experiments(
        file_path=args.fasta, path_to_save_csvs=args.results,
        path_to_save_plots=args.plots, skip_1=args.skip_1,
        skip_2=args.skip_2, skip_3=args.skip_3,
        data_replace_experiment=args.data_replace_experiment,
        num_iterations=args.iterations, make_plots=not args.no_plots,
        grids=grids, n_jobs=args.jobs, device=device)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="genome_assembly_tpu_torch",
        description="OLC genome-assembly framework, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device of the run (default: cuda; raises "
                   "without a card; cpu runs on the host)")

    pa = sub.add_parser("assemble", help="single end-to-end assembly run")
    pa.add_argument("--fasta", default=_default_fasta())
    pa.add_argument("--n", type=int, default=500, help="number of reads")
    pa.add_argument("--l", type=int, default=100, help="read length")
    pa.add_argument("--p", type=float, default=0.0, help="error probability")
    pa.add_argument("--k", type=int, default=5, help="k-mer filter size")
    pa.add_argument("--seed", type=int, default=None)
    pa.add_argument("--name", default="cli")
    pa.add_argument("--plots", default="plots")
    pa.add_argument("--verbose", action="store_true")
    pa.add_argument("--banded", dest="banded", action="store_const",
                    const=True, default="auto",
                    help="force diagonal-banded SW for the metrics pass "
                         "(default: auto — banded for genomes of 16384 bp "
                         "or more, with full-width fallback)")
    pa.add_argument("--full-width", dest="banded", action="store_const",
                    const=False,
                    help="force the full-width (reference-shape) SW for "
                         "the metrics pass")
    pa.add_argument("--fast-layout", action="store_true",
                    help="guarded greedy best-overlap chaining layout "
                         "(with redundancy suppression + consensus) "
                         "instead of the reference-parity cycle-removal/"
                         "topo/walk stack (faster; different contig "
                         "semantics)")
    pa.add_argument("--consensus", action="store_true",
                    help="polish exact-parity contigs by pileup majority "
                         "vote (flagged: corrected sequences are not "
                         "bit-identical to the reference's)")
    pa.add_argument("--trace", action="store_true",
                    help="print the per-stage wall-time/throughput table")
    pa.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace to DIR/trace.json")
    pa.add_argument("--device", default="cuda", help=device_help)
    pa.set_defaults(fn=cmd_assemble)

    pe = sub.add_parser("experiments", help="run the 3-experiment sweep")
    pe.add_argument("--fasta", default=_default_fasta())
    pe.add_argument("--results", default="results")
    pe.add_argument("--plots", default="plots")
    pe.add_argument("--skip-1", action="store_true")
    pe.add_argument("--skip-2", action="store_true")
    pe.add_argument("--skip-3", action="store_true")
    pe.add_argument("--iterations", type=int, default=10)
    pe.add_argument("--jobs", type=int, default=1,
                    help="process pool size over configs (1 = sequential; "
                         "the card is the parallel resource; >1 spawns "
                         "workers that share it)")
    pe.add_argument("--no-plots", action="store_true")
    pe.add_argument("--quick", action="store_true",
                    help="tiny grid for smoke tests")
    pe.add_argument("--data-replace-experiment", type=int, default=None)
    pe.add_argument("--device", default="cuda", help=device_help)
    pe.set_defaults(fn=cmd_experiments)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
