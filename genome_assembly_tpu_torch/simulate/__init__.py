from .errors import generate_error_prone_reads
from .fasta import read_genome_from_fasta
from .reads import calculate_coverage, generate_error_free_reads

__all__ = [
    "read_genome_from_fasta",
    "generate_error_free_reads",
    "calculate_coverage",
    "generate_error_prone_reads",
]
