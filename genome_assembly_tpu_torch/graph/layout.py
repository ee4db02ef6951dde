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

A copy of the JAX package's host implementation, read placements (for the
consensus polish) included.
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
                  topo_order: dict[int, int], base_arr: np.ndarray,
                  placements: list | None = None,
                  contig_idx: int = 0) -> str:
    """Greedy walk from `start_node` (reference overlapGraphs.py:64-103).

    When `placements` is given, appends one (base read idx, offset in
    contig, contig_idx) triple per walked read — the pileup geometry the
    consensus polish (graph/consensus.py) votes over.
    """
    base0 = int(base_arr[start_node])
    contig_parts = [g.unique_reads[base0]]
    cur_len = len(g.unique_reads[base0])
    if placements is not None:
        placements.append((base0, 0, contig_idx))
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
        if placements is not None:
            placements.append((nb_base, cur_len - end, contig_idx))
        contig_parts.append(g.unique_reads[nb_base][end:])
        cur_len += len(g.unique_reads[nb_base]) - end
        node = nxt
        visited.add(nb_base)
    return "".join(contig_parts)


def walk_contigs(g: OverlapGraph, topo_nodes: list[int],
                 with_placements: bool = False):
    """All contigs in reference emission order (overlapGraphs.py:183-192).

    With `with_placements=True` additionally returns the read-placement
    arrays (place_read, place_off, place_contig) for the consensus
    polish; the contig list itself is unchanged either way.
    """
    base_arr = g.base_array()
    base_order, topo_order = collapse_topo_order(g, topo_nodes)
    visited: set[int] = set()
    contigs: list[str] = []
    placements: list | None = [] if with_placements else None
    for base in base_order:
        if base in visited:
            continue
        for copy in range(int(g.counts[base])):
            node = int(g.offsets[base]) + copy
            contigs.append(create_contig(g, node, visited, topo_order,
                                         base_arr, placements, len(contigs)))
    if not with_placements:
        return contigs
    pl = np.asarray(placements, np.int64).reshape(-1, 3)
    return contigs, (pl[:, 0], pl[:, 1], pl[:, 2])
