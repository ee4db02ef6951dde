"""Topological ordering with NetworkX-identical output order (a copy of
the JAX package's host implementation).

The reference calls `nx.topological_sort(dag)` (overlapGraphs.py:173), which
is Kahn's algorithm by *generations*: the first generation is all zero
in-degree nodes in node insertion order; each generation is processed in
order, appending children (in adjacency order) whose in-degree drops to zero.
The concatenation of generations is the emitted order. Reimplemented here
over the edge-list graph (alive edges only).
"""

from __future__ import annotations

import numpy as np

from .build import OverlapGraph


def topological_order(g: OverlapGraph) -> list[int]:
    """Node ids in NetworkX `topological_sort` order.

    Raises ValueError if the graph still has a cycle.
    """
    n = g.num_nodes
    indeg = np.zeros(n, dtype=np.int64)
    alive_dst = g.dst[g.alive]
    np.add.at(indeg, alive_dst, 1)

    order: list[int] = []
    generation = [v for v in range(n) if indeg[v] == 0]
    remaining = int((indeg > 0).sum())
    while generation:
        next_gen: list[int] = []
        for node in generation:
            for e in g.adj[node]:
                if not g.alive[e]:
                    continue
                child = int(g.dst[e])
                indeg[child] -= 1
                if indeg[child] == 0:
                    next_gen.append(child)
                    remaining -= 1
        order.extend(generation)
        generation = next_gen
    if remaining:
        raise ValueError("Graph is not a DAG! Cycles still exist.")
    return order
