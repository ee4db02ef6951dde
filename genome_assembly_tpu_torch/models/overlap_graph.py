"""Primary assembly pipeline: k-mer-filtered overlap graph -> greedy cycle
removal -> topological layout -> contig merge.

Equivalent of the reference's `assemble_contigs_using_overlap_graphs`
(overlapGraphs.py:151-193), returning the identical contig list (content and
order) for identical input reads; with `exact_parity=False` the fast greedy
layout (graph/greedy.py) and with `consensus=True` the consensus polish
(graph/consensus.py), as in the JAX package.
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
        use_native: the C++ engine; False runs the Python loops instead
            (the cycle removal with exact_parity, the accept loop with the
            fast layout), never as a fallback.
        exact_parity: True (default) reproduces the reference layout
            bit for bit; False switches to the fast greedy best-overlap
            chaining layout (graph/greedy.py), with its own consensus
            default (on).
        consensus: polish the exact-parity walk's contigs by majority vote
            over their read pileup (graph/consensus.py); off by default.

    Every stage feeds the global tracer (utils/tracing.py).
    """
    dev = resolve_device(device)

    def log(msg):
        if verbose:
            print(msg)

    if not exact_parity:
        from ..graph.greedy import assemble_contigs_greedy

        log(f"Fast-layout assembly (k={k}, reads={len(reads)})...")
        with stage("graph.greedy_layout"):
            return assemble_contigs_greedy(reads, k=k, device=dev,
                                           use_native=use_native)

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
        if not consensus:
            return walk_contigs(g, topo_nodes)
        contigs, (pr, po, pc) = walk_contigs(g, topo_nodes,
                                             with_placements=True)
    log("Consensus polish...")
    with stage("graph.consensus"):
        from ..graph.consensus import polish_contigs

        return polish_contigs(contigs, g.unique_reads, pr, po, pc,
                              place_weight=g.counts[pr].astype("int64"))
