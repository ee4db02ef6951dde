"""Cycle removal: greedy weakest-edge deletion until the graph is a DAG.

Reference semantics (overlapGraphs.py:106-130): repeatedly call NetworkX
`find_cycle(G, orientation='original')` and delete the minimum-weight edge of
the found cycle (first minimum in cycle order), until no cycle remains.

Bit-for-bit parity therefore requires reproducing *which* cycle NetworkX
finds, which is a function of node insertion order and per-node adjacency
order. `find_first_cycle` below is a from-scratch implementation of the same
contract over our edge-list graph: an edge-DFS from each start node in node-id
order, maintaining the active path, yielding the first edge whose head is on
the active path; nodes fully explored without finding a cycle are skipped for
later start nodes.

`remove_cycles` runs the C++ engine (native/graphcore.cpp, a copy of the JAX
package's) by default and the Python loop (a copy of the JAX package's) when
the caller passes ``use_native=False``. It never moves from one to the
other on its own: the Python loop is orders of magnitude slower (more than
75x at PhiX N = 10,000), so an engine that cannot be built raises.
"""

from __future__ import annotations

from .build import OverlapGraph


def find_first_cycle(g: OverlapGraph, explored: set[int] | None = None):
    """Find the first cycle under edge-DFS order.

    Returns a list of edge indices forming the cycle (trimmed so the first
    edge's tail equals the cycle-closing head), or None if the graph is
    acyclic. `explored` (mutated) carries fully-explored nodes across calls
    within one search; pass None for standalone use.
    """
    if explored is None:
        explored = set()
    n = g.num_nodes

    for start in range(n):
        if start in explored:
            continue
        # --- edge-DFS from `start` with find_cycle's path maintenance ---
        visited_nodes: set[int] = set()
        iters: dict[int, int] = {}          # node -> next position in adj list
        stack: list[int] = [start]
        path_edges: list[int] = []          # active path (edge indices)
        seen = {start}
        active = {start}
        prev_head = -1
        cycle: list[int] | None = None

        while stack:
            node = stack[-1]
            if node not in visited_nodes:
                visited_nodes.add(node)
                iters[node] = 0
            # next alive out-edge of `node`
            adj = g.adj[node]
            pos = iters[node]
            eidx = -1
            while pos < len(adj):
                if g.alive[adj[pos]]:
                    eidx = adj[pos]
                    pos += 1
                    break
                pos += 1
            iters[node] = pos
            if eidx < 0:
                stack.pop()
                continue
            tail, head = int(g.src[eidx]), int(g.dst[eidx])
            stack.append(head)
            # --- find_cycle wrapper logic ---
            if head in explored:
                continue
            if prev_head != -1 and tail != prev_head:
                # backtracked: pop path until its last head == tail
                while True:
                    if not path_edges:
                        active = {tail}
                        break
                    popped = path_edges.pop()
                    active.discard(int(g.dst[popped]))
                    if path_edges and int(g.dst[path_edges[-1]]) == tail:
                        break
            path_edges.append(eidx)
            if head in active:
                cycle = list(path_edges)
                final = head
                break
            seen.add(head)
            active.add(head)
            prev_head = head

        if cycle is not None:
            # trim leading edges before the cycle entry point
            for i, e in enumerate(cycle):
                if int(g.src[e]) == final:
                    return cycle[i:]
            return cycle
        explored.update(seen)
    return None


def remove_cycles_python(g: OverlapGraph) -> int:
    """Pure-Python weakest-edge cycle removal. Returns #edges removed."""
    removed = 0
    while True:
        cycle = find_first_cycle(g)
        if cycle is None:
            return removed
        # first minimum-weight edge in cycle order (overlapGraphs.py:126-128)
        weakest = min(cycle, key=lambda e: int(g.weight[e]))
        g.alive[weakest] = False
        removed += 1


def remove_cycles(g: OverlapGraph, use_native: bool = True) -> int:
    """Remove cycles in place (g.alive); returns the number of edges removed.
    ``use_native=True`` runs the C++ engine and raises when it cannot be
    built or loaded; ``use_native=False`` runs `remove_cycles_python`."""
    if not use_native:
        return remove_cycles_python(g)
    from ..native import graphcore

    return graphcore.remove_cycles(g)
