"""Layout: topological-order contig walking and merging.

Reference semantics (overlapGraphs.py:64-103,151-193):
- topo order of read-copy nodes is collapsed to base (unique) reads; LATER
  copies OVERWRITE the topo index while dict key order keeps the FIRST
  occurrence order (overlapGraphs.py:174-178);
- iterate bases in that key order; for each unvisited base, start one contig
  per copy (the visited check happens once, before the copy loop);
- `create_contig`: greedy walk — among alive out-neighbors whose base is
  unvisited, choose minimum topo index (first minimum; edge weight ignored),
  append next_read[end_position:], mark bases visited, repeat.

A copy of the JAX package's host implementation, without the read
placements that only its consensus polish (not ported yet) reads.
"""

from __future__ import annotations

import numpy as np

from .build import OverlapGraph


def collapse_topo_order(g: OverlapGraph, topo_nodes: list[int]):
    """Base-read topo map: {base: last-copy topo index}, first-occurrence key
    order. Returns (ordered base list, base->index dict)."""
    base_arr = g.base_array()
    topo_order: dict[int, int] = {}
    for i, node in enumerate(topo_nodes):
        topo_order[int(base_arr[node])] = i
    return list(topo_order.keys()), topo_order


def create_contig(g: OverlapGraph, start_node: int, visited: set[int],
                  topo_order: dict[int, int], base_arr: np.ndarray) -> str:
    """Greedy walk from `start_node` (reference overlapGraphs.py:64-103)."""
    base0 = int(base_arr[start_node])
    contig_parts = [g.unique_reads[base0]]
    visited.add(base0)
    node = start_node
    while True:
        best_edge = -1
        best_topo = None
        for e in g.adj[node]:
            if not g.alive[e]:
                continue
            nb_base = int(base_arr[g.dst[e]])
            if nb_base in visited:
                continue
            t = topo_order.get(nb_base, float("inf"))
            if best_topo is None or t < best_topo:
                best_topo = t
                best_edge = e
        if best_edge < 0:
            break
        nxt = int(g.dst[best_edge])
        nb_base = int(base_arr[nxt])
        end = int(g.end_pos[best_edge])
        contig_parts.append(g.unique_reads[nb_base][end:])
        node = nxt
        visited.add(nb_base)
    return "".join(contig_parts)


def walk_contigs(g: OverlapGraph, topo_nodes: list[int],
                 with_placements: bool = False) -> list[str]:
    """All contigs in reference emission order (overlapGraphs.py:183-192).
    `with_placements=True` (the read placements of the consensus polish)
    is not ported yet (ROADMAP A6)."""
    if with_placements:
        raise NotImplementedError(
            "walk_contigs(with_placements=True) is not ported yet "
            "(ROADMAP A6)")
    base_arr = g.base_array()
    base_order, topo_order = collapse_topo_order(g, topo_nodes)
    visited: set[int] = set()
    contigs: list[str] = []
    for base in base_order:
        if base in visited:
            continue
        for copy in range(int(g.counts[base])):
            node = int(g.offsets[base]) + copy
            contigs.append(create_contig(g, node, visited, topo_order,
                                         base_arr))
    return contigs
