"""Configuration layer.

The reference's experiment bounds and metric names (``consts.py:1-45``),
value-identical so that experiment grids and CSV schemas match, and the
parameters of one assembly run.
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



@dataclass
class AssemblyConfig:
    """Parameters of a single assembly run (the reference's `params` dict,
    testAssembly.py:29)."""

    num_reads: int = 500
    read_length: int = 100
    error_prob: float = 0.0
    k: int = 5
    num_iteration: int = 1
    experiment_name: str = "default"
    # scoring parameters (aligners.py:7) — defaults give the no-gap
    # degenerate overlap DP (see ops/overlap.py)
    match_score: int = 10
    mismatch: int = -1
    indel: int = -(2**31)
    # engine knobs (no analog in the reference)
    exact_parity: bool = True        # replicate reference iteration orders bit-for-bit
    use_native: bool = True          # C++ graph runtime
    device_scoring: bool = True      # score candidate pairs on the card
    verbose: bool = False

    def as_params_dict(self) -> dict:
        return {
            "N": self.num_reads,
            "l": self.read_length,
            "error_prob": self.error_prob,
            "k": self.k,
            "experiment_name": self.experiment_name,
            "num_iteration": self.num_iteration,
        }
