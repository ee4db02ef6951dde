from .harness import (
    default_grids,
    experiment_const_coverage,
    experiment_varying_value,
    filter_results,
    run_experiments,
)
from .runner import (
    run_for_params,
    run_simulations,
    run_simulations_parallel,
    test_assembly,
)

__all__ = [
    "test_assembly",
    "run_simulations",
    "run_simulations_parallel",
    "run_for_params",
    "run_experiments",
    "experiment_const_coverage",
    "experiment_varying_value",
    "filter_results",
    "default_grids",
]
