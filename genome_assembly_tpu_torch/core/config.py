"""Configuration constants.

The reference's experiment bounds and metric names (``consts.py:1-45``),
value-identical so that experiment grids and CSV schemas match.
"""

from __future__ import annotations

from dataclasses import dataclass

# Metric names — must match the reference exactly (consts.py:8) so that
# results.csv / summary.csv are cross-loadable.
METRIC_NAMES = [
    "Number of Contigs",
    "Genome Coverage",
    "N50",
    "Mismatch Rate Aligned Regions",
    "Mismatch Rate Genome Level",
]

METRIC_LABELS = [
    "Number of Contigs",
    "Genome Coverage (%)",
    "N50",
    "Mismatch Rate Aligned Regions (%)",
    "Mismatch Rate Genome (%)",
]


@dataclass(frozen=True)
class ParamBounds:
    """Experiment parameter bounds (consts.py:2-7, consts.py:29-30)."""

    lower_l: int = 50
    upper_l: int = 150
    lower_n: int = 100
    upper_n: int = 1_000_000
    lower_p: float = 0.001
    upper_p: float = 0.1
    big_n: int = 10_000

