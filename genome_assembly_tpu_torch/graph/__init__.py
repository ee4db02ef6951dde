from .build import OverlapGraph, build_overlap_graph
from .consensus import polish_contigs
from .cycles import remove_cycles
from .greedy import assemble_contigs_greedy, greedy_chain
from .layout import walk_contigs
from .topo import topological_order

__all__ = [
    "OverlapGraph",
    "assemble_contigs_greedy",
    "build_overlap_graph",
    "greedy_chain",
    "polish_contigs",
    "remove_cycles",
    "topological_order",
    "walk_contigs",
]
