from .align_to_ref import (
    align_contigs_to_reference,
    align_read_or_contig_to_reference,
)
from .measures import (
    calculate_genome_coverage_and_mismatch_rate,
    calculate_measures,
    calculate_n50,
)

__all__ = [
    "align_contigs_to_reference",
    "align_read_or_contig_to_reference",
    "calculate_measures",
    "calculate_n50",
    "calculate_genome_coverage_and_mismatch_rate",
]
