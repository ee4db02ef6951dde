"""Persistence: result-directory management and CSV round-trip.

Capability parity with the reference's createAndSave.py (C23-C25 in
SURVEY.md §2.1): results.csv / summary.csv schema is byte-compatible
(column names "<metric> avg/std/raw", createAndSave.py:44-54 and
experiments.py:528-533) so reference CSVs and ours are cross-loadable.
The port writes and reads them with the standard library
(``csv_io.py``): the bytes written and the records read equal the JAX
package's pandas route.
"""

from .paths import create_paths
from .csv_io import (
    load_all_results,
    load_and_clean_results,
    load_and_combine_results,
    load_coverage_results_from_csv,
    load_results_from_csv,
    parse_list_with_numpy,
    save_results,
)

__all__ = [
    "create_paths",
    "save_results",
    "load_results_from_csv",
    "load_coverage_results_from_csv",
    "parse_list_with_numpy",
    "load_and_clean_results",
    "load_and_combine_results",
    "load_all_results",
]
