"""Alternative pipeline #2: string graph + unitig collapse (reference C13,
overlapGraphs.py:332-412).

Stages:
1. positional-combinations graph: edges follow `combinations(reads, 2)` —
   one direction per positional pair, so with duplicate reads both
   directions (and self-pairs) can occur (overlapGraphs.py:344); nodes are
   read STRINGS (duplicates collapse); edges kept when score > 0; the pairs
   are scored by the port's `score_pairs` (on a card: the all-pairs kernel,
   whose diagonal answers the self-pairs);
2. path-based transitive reduction: an edge (v, w) is removed when some
   other successor u of v (u before w in combination order) reaches w in the
   ORIGINAL graph (overlapGraphs.py:354-367), as tensor ops on a torch
   device (see `removed_successor_pairs`);
3. unitigs: maximal forward extensions through nodes with out-degree 1 and
   in-degree 1, merged via end_position (overlapGraphs.py:370-402).

Deviation (defensive, SURVEY.md §2.3 policy of not replicating defects): the
reference's extension loop never marks nodes during the walk, so a reachable
2-cycle of degree-1 nodes loops forever; we stop when the next node is
already on the current path. Every result equals the JAX package's
``models/unitig.py``; `_DiGraph` and `find_unitigs` are copies of its host
code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import resolve_device
from ..graph.build import score_pairs
from ..utils.tracing import stage

# elements of the (rows, U, U) int32 temporary of one block of the
# reduction: 128 MiB a block
REDUCTION_BLOCK_ELEMENTS = 1 << 25


class _DiGraph:
    """Minimal insertion-ordered digraph over string nodes — reproduces the
    NetworkX dict-of-dicts iteration orders the reference relies on."""

    def __init__(self):
        self.succ: dict[str, dict[str, dict]] = {}
        self.pred: dict[str, dict[str, dict]] = {}

    def add_node(self, n: str) -> None:
        if n not in self.succ:
            self.succ[n] = {}
            self.pred[n] = {}

    def add_edge(self, u: str, v: str, **attrs) -> None:
        self.add_node(u)
        self.add_node(v)
        self.succ[u][v] = attrs
        self.pred[v][u] = attrs

    def remove_edge(self, u: str, v: str) -> None:
        del self.succ[u][v]
        del self.pred[v][u]

    def has_edge(self, u: str, v: str) -> bool:
        return u in self.succ and v in self.succ[u]

    def nodes(self):
        return list(self.succ.keys())

    def successors(self, n: str):
        return list(self.succ[n].keys())

    def predecessors(self, n: str):
        return list(self.pred[n].keys())

    def has_path(self, src: str, dst: str) -> bool:
        if src == dst:
            return True
        seen = {src}
        stack = [src]
        while stack:
            u = stack.pop()
            for v in self.succ[u]:
                if v == dst:
                    return True
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return False

    def copy(self) -> "_DiGraph":
        g = _DiGraph()
        for n in self.succ:
            g.add_node(n)
        for u, nbrs in self.succ.items():
            for v, attrs in nbrs.items():
                g.succ[u][v] = dict(attrs)
                g.pred[v][u] = dict(attrs)
        return g


def combination_pairs(node_of_read: np.ndarray):
    """Distinct ordered node pairs (ia, ib) of `combinations(reads, 2)` in
    first-occurrence order (overlapGraphs.py:344), from each read's node
    index: positional pairs i < j run i-major, as `np.triu_indices` lists
    them, and a repeated (node_a, node_b) keeps its first position."""
    n_reads = len(node_of_read)
    i, j = np.triu_indices(n_reads, k=1)
    a = node_of_read[i]
    b = node_of_read[j]
    n_nodes = int(node_of_read.max()) + 1 if n_reads else 0
    _, first = np.unique(a * n_nodes + b, return_index=True)
    first.sort()
    return a[first].astype(np.int32), b[first].astype(np.int32)


def construct_string_graph(reads: list[str], device="cuda") -> _DiGraph:
    """Combinations-ordered graph with score > 0 edges
    (overlapGraphs.py:332-351); each distinct ordered string pair is scored
    once, by `score_pairs` on `device` ("cuda" by default, True and False
    as in the JAX package)."""
    dev = resolve_device(device)
    g = _DiGraph()
    for read in reads:
        g.add_node(read)
    if len(reads) < 2:
        return g

    node_list = g.nodes()
    index = {r: i for i, r in enumerate(node_list)}
    node_of_read = np.fromiter((index[r] for r in reads), np.int64,
                               len(reads))
    ia, ib = combination_pairs(node_of_read)
    scores, ends = score_pairs(node_list, (ia, ib), device=dev)
    for k in np.nonzero(scores > 0)[0].tolist():
        g.add_edge(node_list[ia[k]], node_list[ib[k]],
                   weight=int(scores[k]), end_position=int(ends[k]))
    return g


def reachability(adj: torch.Tensor) -> torch.Tensor:
    """(U, U) bool: a path of length >= 1 from u to x, by repeated squaring
    of the boolean adjacency (0/1 float32 products, exact)."""
    reach = adj.clone()
    while True:
        f = reach.to(torch.float32)
        grown = reach | ((f @ f) > 0)
        if torch.equal(grown, reach):
            return reach
        reach = grown


def removed_successor_pairs(n_nodes: int, src, dst, rank,
                            device) -> torch.Tensor:
    """(U, U) bool: the edges (v, w) that the JAX package's
    transitive_reduction2 removes (unitig.py:116-124).

    (v, w) goes exactly when some u in S(v) that precedes w in v's
    successor order has a path of length >= 1 to w in the original graph:
    an exclusive prefix-OR of the reachability rows of v's successors in
    their order, here as the earliest rank among v's successors that reach
    w, compared with w's own rank, in blocks of rows. `src`, `dst`, `rank`
    list every edge with its position in its source's successor order."""
    src = torch.as_tensor(np.asarray(src, np.int64), device=device)
    dst = torch.as_tensor(np.asarray(dst, np.int64), device=device)
    adj = torch.zeros((n_nodes, n_nodes), dtype=torch.bool, device=device)
    adj[src, dst] = True
    never = torch.iinfo(torch.int32).max
    ranks = torch.full((n_nodes, n_nodes), never, dtype=torch.int32,
                       device=device)
    ranks[src, dst] = torch.as_tensor(np.asarray(rank, np.int32),
                                      device=device)
    reach = reachability(adj)
    removed = torch.zeros_like(adj)
    rows = max(1, REDUCTION_BLOCK_ELEMENTS // max(1, n_nodes * n_nodes))
    for lo in range(0, n_nodes, rows):
        hi = min(lo + rows, n_nodes)
        earliest = torch.where(reach[None, :, :], ranks[lo:hi, :, None],
                               never).amin(dim=1)
        removed[lo:hi] = adj[lo:hi] & (earliest < ranks[lo:hi])
    return removed


def transitive_reduction2(graph: _DiGraph, device="cuda") -> _DiGraph:
    """Remove (v, w) when another successor pair (u before w) has a path
    u ->* w in the original graph (overlapGraphs.py:354-367); the
    reachability and the removal test run as tensor ops on `device` (see
    `removed_successor_pairs`). Returns a reduced copy, `graph` unchanged."""
    dev = resolve_device(device)
    nodes = graph.nodes()
    index = {n: i for i, n in enumerate(nodes)}
    src, dst, rank = [], [], []
    for u in nodes:
        for k, v in enumerate(graph.succ[u]):
            src.append(index[u])
            dst.append(index[v])
            rank.append(k)
    reduced = graph.copy()
    if not src:
        return reduced
    removed = removed_successor_pairs(len(nodes), src, dst, rank, dev)
    for v, w in torch.nonzero(removed).cpu().tolist():
        reduced.remove_edge(nodes[v], nodes[w])
    return reduced


def find_unitigs(graph: _DiGraph) -> list[str]:
    """Collapse non-branching forward paths (overlapGraphs.py:370-402)."""
    unitigs: list[str] = []
    visited: set[str] = set()
    for node in graph.nodes():
        if node in visited:
            continue
        path = [node]
        while (len(graph.successors(path[-1])) == 1
               and len(graph.predecessors(path[-1])) == 1):
            nxt = graph.successors(path[-1])[0]
            if nxt in visited or nxt in path:
                break
            path.append(nxt)
        visited.update(path)
        seq = path[0]
        for i in range(1, len(path)):
            overlap_len = graph.succ[path[i - 1]][path[i]]["end_position"]
            seq += path[i][overlap_len:]
        unitigs.append(seq)
    return unitigs


def assemble_contigs(reads: list[str], device="cuda") -> list[str]:
    """Unitig pipeline (overlapGraphs.py:405-412), scoring and reducing on
    `device` ("cuda" by default; raises without a card). Feeds the
    tracer's "graph.build", "graph.transitive_reduction" and
    "graph.unitigs" stages."""
    dev = resolve_device(device)
    with stage("graph.build", items=len(reads)):
        graph = construct_string_graph(reads, device=dev)
    with stage("graph.transitive_reduction"):
        reduced = transitive_reduction2(graph, device=dev)
    with stage("graph.unitigs"):
        return find_unitigs(reduced)
