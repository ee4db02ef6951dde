"""Cycle removal: greedy weakest-edge deletion until the graph is a DAG.

Reference semantics (overlapGraphs.py:106-130): repeatedly call NetworkX
`find_cycle(G, orientation='original')` and delete the minimum-weight edge of
the found cycle (first minimum in cycle order), until no cycle remains.

The port runs the C++ engine (native/graphcore.cpp, a copy of the JAX
package's) and nothing else: the JAX package's pure-Python loop is its
reference and stays there; at this slice's main path it is more than 75x
slower than the engine, so the port never falls back to it.
"""

from __future__ import annotations

from .build import OverlapGraph


def remove_cycles(g: OverlapGraph, use_native: bool = True) -> int:
    """Remove cycles in place (g.alive); returns the number of edges removed.
    Raises when the C++ engine cannot be built or loaded. `use_native=False`
    asks for the Python loop, which is not ported (ROADMAP A9)."""
    if not use_native:
        raise NotImplementedError(
            "the Python cycle removal (use_native=False) is not ported "
            "(ROADMAP A9)")
    from ..native import graphcore

    return graphcore.remove_cycles(g)
