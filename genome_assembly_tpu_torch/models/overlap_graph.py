"""Primary assembly pipeline: k-mer-filtered overlap graph -> greedy cycle
removal -> topological layout -> contig merge.

Equivalent of the reference's `assemble_contigs_using_overlap_graphs`
(overlapGraphs.py:151-193), returning the identical contig list (content and
order) for identical input reads. This slice ports the exact-parity layout
only; the fast greedy layout (`exact_parity=False`) and the consensus polish
(`consensus=True`) raise NotImplementedError until their slice.
"""

from __future__ import annotations

from ..core.dispatch import resolve_device
from ..graph.build import build_overlap_graph
from ..graph.cycles import remove_cycles
from ..graph.layout import walk_contigs
from ..graph.topo import topological_order
from ..utils.tracing import stage


def assemble_contigs_using_overlap_graphs(reads: list[str], k: int = 5,
                                          params: dict | None = None,
                                          device="cuda",
                                          use_native: bool = True,
                                          verbose: bool = False,
                                          exact_parity: bool = True,
                                          consensus: bool = False) -> list[str]:
    """Assemble contigs from reads.

    Args:
        reads: DNA read strings.
        k: k-mer prefilter length (0 disables filtering).
        params: optional run metadata (reference signature parity,
            overlapGraphs.py:151).
        device: torch device that scores the candidate pairs ("cuda" by
            default, True and False as in the JAX package; raises without
            a card).
        use_native: must be True: the C++ cycle removal (the Python one
            is ROADMAP A9).
        exact_parity: must be True in this slice (the reference layout).
        consensus: must be False in this slice.

    Every stage feeds the global tracer (utils/tracing.py).
    """
    if not exact_parity:
        raise NotImplementedError(
            "the fast greedy layout (exact_parity=False) is not ported yet "
            "(ROADMAP A6)")
    if consensus:
        raise NotImplementedError(
            "the consensus polish (consensus=True) is not ported yet "
            "(ROADMAP A6)")
    dev = resolve_device(device)

    def log(msg):
        if verbose:
            print(msg)

    log(f"Constructing overlap graph (k={k}, reads={len(reads)})...")
    with stage("graph.build"):
        g = build_overlap_graph(reads, k=k, device=dev)
    log(f"Removing cycles ({len(g.src)} edges)...")
    with stage("graph.remove_cycles", items=len(g.src)):
        remove_cycles(g, use_native=use_native)
    log("Sorting graph topologically...")
    with stage("graph.topo_sort"):
        topo_nodes = topological_order(g)
    log("Creating contigs...")
    with stage("graph.walk_contigs"):
        return walk_contigs(g, topo_nodes)
