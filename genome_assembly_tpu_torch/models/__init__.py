from .overlap_graph import assemble_contigs_using_overlap_graphs

__all__ = ["assemble_contigs_using_overlap_graphs"]
