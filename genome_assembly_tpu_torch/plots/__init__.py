"""Visualization suite (reference plots.py, C20-C22).

A copy of the JAX package's ``plots``: host-side matplotlib (Agg backend)
and pandas, fed numpy arrays and result dicts, never a CUDA tensor. The
experiment harness imports it only when plots are asked for, so a sweep
with ``make_plots=False`` runs where neither library is installed.
"""

from .helpers import (
    add_average_trend_line,
    add_boundary_lines,
    check_x_values_boundaries,
    create_figure,
    generate_x_tick_labels,
    save_figure,
    setup_plot_axis,
)
from .iteration import (
    plot_genome_coverage,
    plot_genome_depth,
    plot_reconstructed_coverage,
)
from .sweeps import (
    plot_const_coverage_results,
    plot_coverage_comparison,
    plot_experiment_results_by_other_values,
    plot_experiment_results_by_two_values,
)

def iteration_hooks() -> dict:
    """Hooks dict consumed by metrics.calculate_measures — wires the
    per-iteration coverage/depth plots into the metrics pass the way the
    reference calls them inline (performanceMeasures.py:57-58)."""
    return {"coverage": plot_genome_coverage, "depth": plot_genome_depth}


__all__ = [
    "iteration_hooks",
    "plot_genome_coverage",
    "plot_genome_depth",
    "plot_reconstructed_coverage",
    "plot_experiment_results_by_other_values",
    "plot_const_coverage_results",
    "plot_coverage_comparison",
    "plot_experiment_results_by_two_values",
    "setup_plot_axis",
    "add_average_trend_line",
    "generate_x_tick_labels",
    "add_boundary_lines",
    "check_x_values_boundaries",
    "create_figure",
    "save_figure",
]
