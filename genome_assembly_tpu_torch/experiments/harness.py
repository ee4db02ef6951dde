"""Experiment orchestration (reference experiments.py:22-448, C26-C28/C30).

Three experiments over the PhiX parameter grids (experiments.py:47-53):
1. constant coverage C in [N*l/G rounded, 2, 5, 10, 30], sweeping l with
   N = ceil(C*G/l);
2. varying l at each fixed N;
3. varying N at each fixed l (log x-scale).

Each config runs `num_iterations` times and is aggregated to avg/std/raw
columns (runner.py); `run_kw` goes to `test_assembly` (`device`, `rng`,
`np_rng`, ...) and `n_jobs` to the process pool. Results are persisted via
persist.save_results with a reference-compatible CSV schema, and the
plotting suite mirrors the reference's grouped/fixed-k/fixed-p/comparison
plots.

Differences from the reference (deliberate):
- plots are optional (`make_plots=False` skips matplotlib and pandas
  entirely: the card machine has neither, so sweeps there run without
  plots);
- seeds are explicit for reproducibility;
- the experiment-3 result-routing bug (experiments.py:166-171 stores into
  the vary-l dicts so exp-3 comparison plots get empty data) is fixed: we
  store into the vary-n dicts.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.config import ParamBounds
from ..persist import create_paths, load_and_clean_results, save_results
from ..simulate import read_genome_from_fasta
from .runner import run_simulations_parallel


def default_grids(genome_length: int, bounds: ParamBounds | None = None):
    """The reference's parameter grids (experiments.py:47-53)."""
    b = bounds or ParamBounds()
    c_small = round((b.lower_n * b.lower_l) / genome_length, 3)
    coverage_targets = [c_small, 2, 5, 10, 30]
    n_values = np.unique(np.logspace(
        np.log10(b.lower_n), np.log10(b.big_n), 5).astype(int))
    l_values = np.unique(np.linspace(b.lower_l, b.upper_l, 3).astype(int))
    error_probs = np.unique(np.logspace(
        np.log10(b.lower_p), np.log10(b.upper_p), 3))
    k_values = np.unique(np.linspace(5, 15, 3).astype(int))
    return coverage_targets, n_values, l_values, error_probs, k_values


def filter_results(results: list[dict], key: str, values) -> list[dict]:
    """Filter result dicts by key == value (experiments.py:427-448);
    iterable `values` concatenates the per-value filtered groups in order."""
    if isinstance(values, (list, tuple, np.ndarray)):
        out: list[dict] = []
        for value in values:
            out.extend(r for r in results if r[key] == value)
        return out
    return [r for r in results if r[key] == values]


def _plots():
    """Lazy import so headless/metrics-only runs never touch matplotlib."""
    from .. import plots
    return plots


def experiment_const_coverage(reference_genome: str, coverage_target: float,
                              error_probs, k_values, n_values=None,
                              l_values=None, x_axis_var: str = "n",
                              experiment_name: str | None = None,
                              paths: list[str] | None = None,
                              num_iterations: int = 10,
                              log_scale: bool = False,
                              return_results: bool = False,
                              make_plots: bool = True, **run_kw):
    """Vary (N, l) jointly at constant coverage (experiments.py:225-335).

    Exactly one of n_values / l_values is given; the other is derived as
    ceil(C*G/value) (experiments.py:267-276).
    """
    if paths is None:
        paths = ["results", "plots"]
    genome_length = len(reference_genome)

    if n_values is not None and l_values is None:
        l_values = [int(np.ceil(coverage_target * genome_length / n))
                    for n in n_values]
        x_axis_var = "num_reads"
    elif l_values is not None and n_values is None:
        n_values = [int(np.ceil(coverage_target * genome_length / l))
                    for l in l_values]
        x_axis_var = "read_length"
    else:
        raise ValueError(
            "Either n_values or l_values must be provided, but not both")

    expected_coverage = [n * l / genome_length
                         for n, l in zip(n_values, l_values)]

    if make_plots:
        run_kw.setdefault("plot_hooks", _plots().iteration_hooks())

    params = []
    for p in error_probs:
        for k in k_values:
            for j, (n, l) in enumerate(zip(n_values, l_values)):
                params.append({
                    "num_reads": int(n), "read_length": int(l),
                    "error_prob": float(p), "k": int(k),
                    "reference_genome": reference_genome,
                    "expected_coverage": expected_coverage[j],
                    "experiment_name": experiment_name,
                    "num_iterations": num_iterations,
                    "contigs": None,
                })

    results = run_simulations_parallel(params, path=paths[1], **run_kw)
    os.makedirs(paths[0], exist_ok=True)
    save_results(results, experiment_name, path=paths[0])

    if make_plots:
        plots = _plots()
        folders = create_paths(
            [(paths[1], name) for name in ["fixed_p", "fixed_k"]])
        by_k = filter_results(results, "k", list(k_values))
        plots.plot_const_coverage_results(
            by_k, coverage_target=coverage_target, x_axis_var=x_axis_var,
            path=folders[0], log_scale=log_scale, grouping_value="k",
            num_iterations=len(results))
        by_p = filter_results(results, "error_prob", list(error_probs))
        plots.plot_const_coverage_results(
            by_p, coverage_target=coverage_target, x_axis_var=x_axis_var,
            path=folders[1], log_scale=log_scale, grouping_value="error_prob",
            num_iterations=len(results))
        plots.plot_experiment_results_by_two_values(
            results, x_key=x_axis_var, group_key_1="error_prob",
            group_key_2="k", coverage_key="expected_coverage", path=paths[1],
            log_scale=log_scale, num_iterations=num_iterations)

    if return_results:
        return results


def experiment_varying_value(reference_genome: str, n_values, l_values,
                             p_values, k_values, expected_coverage,
                             experiment_name: str, paths: list[str],
                             num_iterations: int = 10,
                             log_scale: bool = False, separator=None,
                             return_results: bool = False,
                             make_plots: bool = True, **run_kw):
    """Sweep one of N / l over the full p x k grid (experiments.py:338-424)."""
    if make_plots:
        run_kw.setdefault("plot_hooks", _plots().iteration_hooks())

    params = []
    for p in p_values:
        for j, n in enumerate(n_values):
            for m, l in enumerate(l_values):
                for k in k_values:
                    params.append({
                        "num_reads": int(n), "read_length": int(l),
                        "error_prob": float(p), "k": int(k),
                        "reference_genome": reference_genome,
                        "expected_coverage":
                            expected_coverage[j] if len(n_values) > 1
                            else expected_coverage[m],
                        "experiment_name": experiment_name,
                        "num_iterations": num_iterations,
                        "contigs": None,
                    })

    results = run_simulations_parallel(params, path=paths[1], **run_kw)
    os.makedirs(paths[0], exist_ok=True)
    save_results(results, experiment_name, path=paths[0])

    if make_plots:
        plots = _plots()
        folders = create_paths(
            [(paths[1], name) for name in ["fixed_p", "fixed_k"]])
        x_key = "num_reads" if len(n_values) > 1 else "read_length"
        plots.plot_experiment_results_by_other_values(
            results, x_key=x_key, coverage_key="expected_coverage",
            path=folders[0], log_scale=log_scale,
            num_iterations=num_iterations, separator=separator,
            other_value_key="k")
        plots.plot_experiment_results_by_other_values(
            results, x_key=x_key, coverage_key="expected_coverage",
            path=folders[1], log_scale=log_scale,
            num_iterations=num_iterations, separator=separator,
            other_value_key="error_prob")
        for xk in ["num_reads", "read_length"]:
            plots.plot_experiment_results_by_two_values(
                results, x_key=xk, group_key_1="error_prob", group_key_2="k",
                coverage_key="expected_coverage", path=paths[1],
                log_scale=log_scale, num_iterations=num_iterations)

    if return_results:
        return results


def run_experiments(file_path: str = "data/phix174.fasta",
                    path_to_save_csvs: str = "results",
                    path_to_save_plots: str = "plots",
                    skip_1: bool = False, skip_2: bool = False,
                    skip_3: bool = False, data_replace_experiment=None,
                    num_iterations: int = 10, make_plots: bool = True,
                    grids=None, **run_kw):
    """Full 3-experiment sweep + cross-experiment comparison plots
    (experiments.py:22-222)."""
    genome = read_genome_from_fasta(file_path)
    genome_length = len(genome)
    if grids is None:
        grids = default_grids(genome_length)
    coverage_targets, n_values, l_values, error_probs, k_values = grids

    paths_cmp_fixed_k: list[str] = []
    paths_cmp_fixed_p: list[str] = []
    path_to_loaded_data = None

    results_1_fixed_k, results_1_fixed_p = {}, {}
    results_2_fixed_k, results_2_fixed_p = {}, {}
    results_3_fixed_k, results_3_fixed_p = {}, {}

    # ---- experiment 1: constant coverage ----
    if not skip_1 or data_replace_experiment == 1:
        print("Experiment #1 started!")
        for C in coverage_targets:
            experiment_name = f"experiment_const_coverage/C_{C}"
            paths_c = create_paths([(path_to_save_csvs, experiment_name),
                                    (path_to_save_plots, experiment_name)])
            prefix = "experiment_const_coverage/comparison"
            paths_cmp_fixed_k.append(create_paths(
                [(path_to_save_plots, f"{prefix}/fixed_k")])[0])
            paths_cmp_fixed_p.append(create_paths(
                [(path_to_save_plots, f"{prefix}/fixed_p")])[0])
            if data_replace_experiment != 1:
                results = experiment_const_coverage(
                    genome, C, error_probs, k_values, l_values=l_values,
                    x_axis_var="l", experiment_name=experiment_name,
                    paths=paths_c, num_iterations=num_iterations,
                    return_results=True, make_plots=make_plots, **run_kw)
                results_1_fixed_k[C] = filter_results(results, "k", k_values)
                results_1_fixed_p[C] = filter_results(
                    results, "error_prob", error_probs)
            else:
                path_to_loaded_data = (
                    f"{path_to_save_csvs}/{experiment_name}")
        print("Experiment #1 completed!")

    # ---- experiment 2: varying l at fixed N ----
    if not skip_2 or data_replace_experiment == 2:
        print("Experiment #2 started!")
        for n in n_values:
            suffix = f"experiment_varying_l/fixed_n_{n}"
            paths_vary_l = create_paths([(path_to_save_csvs, suffix),
                                         (path_to_save_plots, suffix)])
            prefix = "experiment_varying_l/comparison"
            paths_cmp_fixed_k.append(create_paths(
                [(path_to_save_plots, f"{prefix}/fixed_k")])[0])
            paths_cmp_fixed_p.append(create_paths(
                [(path_to_save_plots, f"{prefix}/fixed_p")])[0])
            median_l = int(l_values[len(l_values) // 2])
            if data_replace_experiment != 2:
                results = experiment_varying_value(
                    genome, [n], l_values, error_probs, k_values,
                    expected_coverage=coverage_targets,
                    experiment_name=f"experiment_varying_l_fixed_n_{n}",
                    paths=paths_vary_l, num_iterations=num_iterations,
                    separator=median_l, return_results=True,
                    make_plots=make_plots, **run_kw)
                results_2_fixed_k[n] = filter_results(results, "k", k_values)
                results_2_fixed_p[n] = filter_results(
                    results, "error_prob", error_probs)
            else:
                path_to_loaded_data = f"{path_to_save_csvs}/{suffix}"
        print("Experiment #2 completed!")

    # ---- experiment 3: varying N at fixed l ----
    if not skip_3 or data_replace_experiment == 3:
        print("Experiment #3 started!")
        for l in l_values:
            suffix = f"experiment_varying_n/fixed_l_{l}"
            paths_vary_n = create_paths([(path_to_save_csvs, suffix),
                                         (path_to_save_plots, suffix)])
            prefix = "experiment_varying_n/comparison"
            paths_cmp_fixed_k.append(create_paths(
                [(path_to_save_plots, f"{prefix}/fixed_k")])[0])
            paths_cmp_fixed_p.append(create_paths(
                [(path_to_save_plots, f"{prefix}/fixed_p")])[0])
            median_n = int(n_values[len(n_values) // 2])
            if data_replace_experiment != 3:
                results = experiment_varying_value(
                    genome, n_values, [l], error_probs, k_values,
                    expected_coverage=coverage_targets,
                    experiment_name=f"experiment_varying_n_fixed_l_{l}",
                    paths=paths_vary_n, num_iterations=num_iterations,
                    separator=median_n, return_results=True, log_scale=True,
                    make_plots=make_plots, **run_kw)
                results_3_fixed_k[l] = filter_results(results, "k", k_values)
                results_3_fixed_p[l] = filter_results(
                    results, "error_prob", error_probs)
            else:
                path_to_loaded_data = f"{path_to_save_csvs}/{suffix}"
        print("Experiment #3 completed!")

    # ---- optional data reload instead of recompute ----
    # The reference builds flat per-k/per-p lists here (experiments.py:193-199)
    # and then feeds them to plot_coverage_comparison, which expects
    # {coverage: rows} — its reload path crashes (another §2.3-class defect).
    # We group the reloaded rows by expected_coverage so the comparison
    # plots work from saved CSVs.
    results_fixed_k, results_fixed_p = {}, {}
    if data_replace_experiment is not None and path_to_loaded_data:
        results = load_and_clean_results(path_to_loaded_data) or []
        results_k = filter_results(results, "k", k_values)
        results_p = filter_results(results, "error_prob", list(error_probs))
        for rows, out in [(results_k, results_fixed_k),
                          (results_p, results_fixed_p)]:
            for r in rows:
                out.setdefault(r.get("expected_coverage"), []).append(r)

    # ---- cross-experiment comparison plots ----
    if make_plots:
        print("Plotting Comparison Graphs...")
        plots = _plots()
        cmp_idx = 0
        for flag, repl, res_k, res_p in [
                (not skip_1, 1, results_1_fixed_k, results_1_fixed_p),
                (not skip_2, 2, results_2_fixed_k, results_2_fixed_p),
                (not skip_3, 3, results_3_fixed_k, results_3_fixed_p)]:
            if flag or data_replace_experiment == repl:
                rk = results_fixed_k if data_replace_experiment == repl else res_k
                rp = results_fixed_p if data_replace_experiment == repl else res_p
                if cmp_idx < len(paths_cmp_fixed_k):
                    plots.plot_coverage_comparison(
                        rk, genome_length, path=paths_cmp_fixed_k[cmp_idx])
                    plots.plot_coverage_comparison(
                        rp, genome_length, path=paths_cmp_fixed_p[cmp_idx])
                cmp_idx += 1

    print("All experiments completed!")
