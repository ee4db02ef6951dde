from .overlap_graph import assemble_contigs_using_overlap_graphs
from .string_graph import assemble_contigs_string
from .unitig import assemble_contigs

__all__ = [
    "assemble_contigs_using_overlap_graphs",
    "assemble_contigs_string",
    "assemble_contigs",
]
