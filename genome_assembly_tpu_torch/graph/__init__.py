from .build import OverlapGraph, build_overlap_graph
from .cycles import remove_cycles
from .layout import walk_contigs
from .topo import topological_order

__all__ = [
    "OverlapGraph",
    "build_overlap_graph",
    "remove_cycles",
    "topological_order",
    "walk_contigs",
]
