from .errors import generate_error_prone_reads, inject_errors_device
from .fasta import read_genome_from_fasta
from .reads import (
    calculate_coverage,
    generate_error_free_reads,
    reads_to_device,
    sample_reads_device,
)

__all__ = [
    "read_genome_from_fasta",
    "generate_error_free_reads",
    "sample_reads_device",
    "reads_to_device",
    "calculate_coverage",
    "generate_error_prone_reads",
    "inject_errors_device",
]
