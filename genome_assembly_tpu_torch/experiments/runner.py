"""Single-config pipeline run + simulation runners.

`test_assembly` is the end-to-end unit (reference testAssembly.py:7-39):
read generation -> error injection -> assembly -> metrics. It is the port's
main path. `test_assembly_new_pipeline` is the same unit around the
string-graph pipeline (testAssembly.py:42-72).

`run_simulations` / `run_simulations_parallel` mirror experiments.py:451-539:
each parameter config runs `num_iterations` times; numeric result keys are
aggregated into "<key> avg" / "<key> std" / "<key> raw" columns. The card
is the parallel resource, so configs run one after another by default;
``n_jobs > 1`` runs them in a pool of spawned processes that share the
card.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..core.dispatch import resolve_device
from ..metrics.measures import calculate_measures
from ..models.overlap_graph import assemble_contigs_using_overlap_graphs
from ..simulate.errors import generate_error_prone_reads
from ..simulate.reads import generate_error_free_reads
from ..utils.tracing import stage


def test_assembly(genome: str, l: int, N: int, error_prob: float, k: int,
                  experiment_name: str, num_iteration: int, path: str = "plots",
                  rng: random.Random | None = None,
                  np_rng: np.random.RandomState | None = None,
                  plot_hooks=None, device="cuda", use_native: bool = True,
                  verbose: bool = False, banded: bool | str = "auto",
                  exact_parity: bool = True, consensus: bool = False):
    """Run one assembly simulation; returns
    (contigs, measures, contigs_alignment_details, error_prone_reads).

    `device` is the torch device of the device stages ("cuda" by default;
    True and False as in the JAX package: the card or the host; raises
    without a card, pass "cpu" to run on the host). `path` is only handed
    to `plot_hooks`. `banded` chooses the metrics pass's alignment route
    (`calculate_measures`): "auto" bands genomes of 16384 bp or more with
    seeded, stability-verified bands, True forces banding, False full
    width. `exact_parity=False` switches the layout to the fast greedy
    chaining (graph/greedy.py, with its consensus polish; documented
    non-parity semantics); `consensus=True` polishes the exact-parity
    contigs by pileup majority vote (graph/consensus.py).
    `use_native=False` runs the Python cycle removal (or, with the fast
    layout, the Python accept loop) in place of the C++ engine."""
    dev = resolve_device(device)
    with stage("simulate.reads", items=N):
        error_free = generate_error_free_reads(genome, l, N, rng=rng)
        error_prone = generate_error_prone_reads(error_free, error_prob,
                                                 rs=np_rng)

    params = {"N": N, "l": l, "k": k, "error_prob": error_prob,
              "experiment_name": experiment_name, "num_iteration": num_iteration}
    contigs = assemble_contigs_using_overlap_graphs(
        error_prone, k=k, params=params, device=dev, use_native=use_native,
        verbose=verbose, exact_parity=exact_parity, consensus=consensus)

    with stage("metrics.calculate", items=len(contigs)):
        measures, details = calculate_measures(
            contigs, error_prone, len(error_prone), l, error_prob, k, genome,
            experiment_name, num_iteration, path, plot_hooks=plot_hooks,
            verbose=verbose, banded=banded, device=dev)
    return contigs, measures, details, error_prone


def test_assembly_new_pipeline(genome: str, l: int, N: int,
                               experiment_name: str, num_iteration: int,
                               path: str, error_prob: float, fuzz: int,
                               rng: random.Random | None = None,
                               np_rng: np.random.RandomState | None = None,
                               device="cuda", plot_hooks=None):
    """String-graph pipeline run (reference testAssembly.py:42-72);
    `fuzz` doubles as the k slot in the measures call, as in the reference
    (testAssembly.py:69). Returns (contigs, measures,
    contigs_alignment_details, error_prone_reads). `device` is the torch
    device of the scoring, the reduction and the metrics pass ("cuda" by
    default; True and False as in the JAX package; raises without a
    card)."""
    from ..models.string_graph import assemble_contigs_string

    dev = resolve_device(device)
    with stage("simulate.reads", items=N):
        error_free = generate_error_free_reads(genome, l, N, rng=rng)
        error_prone = generate_error_prone_reads(error_free, error_prob,
                                                 rs=np_rng)
    contigs = assemble_contigs_string(error_prone, fuzz=fuzz, device=dev)
    with stage("metrics.calculate", items=len(contigs)):
        measures, details = calculate_measures(
            contigs, error_prone, len(error_prone), l, error_prob, fuzz,
            genome, experiment_name, num_iteration, path,
            plot_hooks=plot_hooks, device=dev)
    return contigs, measures, details, error_prone


def run_simulations(params_list: list[dict], num_iteration: int,
                    path: str = "plots", **kw) -> list[dict]:
    """Run each config once (reference experiments.py:451-478)."""
    results = []
    for params in params_list:
        contigs, measures, details, reads = test_assembly(
            params["reference_genome"], params["read_length"],
            params["num_reads"], params["error_prob"], params["k"],
            params["experiment_name"], num_iteration, path, **kw)
        params = dict(params)
        params["contigs"] = contigs
        params["contigs_alignments_details"] = details
        params["error_prone_reads"] = reads
        results.append({**params, **measures})
    return results


def _aggregate(iteration_results: list[dict], params: dict) -> dict:
    numeric_keys = [k for k, v in iteration_results[0].items()
                    if isinstance(v, (int, float, np.number))
                    and not isinstance(v, bool)]
    avg = {k: float(np.mean([r[k] for r in iteration_results])) for k in numeric_keys}
    std = {k: float(np.std([r[k] for r in iteration_results])) for k in numeric_keys}
    return {
        **params,
        **{f"{k} avg": avg[k] for k in numeric_keys},
        **{f"{k} std": std[k] for k in numeric_keys},
        **{f"{k} raw": [r[k] for r in iteration_results] for k in numeric_keys},
    }


def run_for_params(params: dict, path: str = "plots", **kw) -> dict:
    """All iterations of one config, aggregated (experiments.py:493-534).

    Per-iteration artifacts land in `path`/test_assembly/N=.._l=.._p=.._k=..
    like the reference (experiments.py:500-503). `kw` goes to
    `test_assembly` (`device`, `rng`, `np_rng`, `plot_hooks`, `banded`,
    ...)."""
    print(f"Running {params['experiment_name']} simulation with "
          f"N={params['num_reads']}, l={params['read_length']}, "
          f"p={params['error_prob']}, k={params['k']}, "
          f"expected coverage={params['expected_coverage']:.2f}x")
    folder = os.path.join(
        path, f"test_assembly/N={params['num_reads']}_"
              f"l={params['read_length']}_p={params['error_prob']}_"
              f"k={params['k']}")
    iters = []
    for i in range(params["num_iterations"]):
        results = run_simulations([params], num_iteration=i + 1,
                                  path=folder, **kw)
        iters.append(results[0])
    return _aggregate(iters, params)


def run_simulations_parallel(params_list: list[dict], path: str = "plots",
                             n_jobs: int = 1, **kw) -> list[dict]:
    """Run all configs; results come back in `params_list` order.

    ``n_jobs == 1`` runs them one after another in this process. ``n_jobs >
    1`` runs them in a pool of ``n_jobs`` processes started by ``spawn``
    (a process forked after CUDA was touched cannot use the card), the
    counterpart of the reference's joblib pool (experiments.py:537). Each
    worker holds its own CUDA context on the same card and loads the
    kernel libraries itself. `kw` is pickled for each config, as joblib
    pickles it, so each config starts from its own copy of any `rng` /
    `np_rng` given: its result equals ``run_for_params(p, path,
    rng=copy.deepcopy(rng), ...)``. Stage times of the workers do not
    reach this process's tracer.
    """
    if n_jobs == 1:
        return [run_for_params(p, path=path, **kw) for p in params_list]
    with ProcessPoolExecutor(
            max_workers=n_jobs,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(run_for_params, p, path=path, **kw)
                   for p in params_list]
        return [f.result() for f in futures]
