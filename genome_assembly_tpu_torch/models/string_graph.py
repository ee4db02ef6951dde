"""Alternative pipeline #1: Myers-style string graph (reference C12,
overlapGraphs.py:196-329).

Stages:
1. all-ordered-pairs overlap scoring over unique reads, edges only for
   score > 0 (overlapGraphs.py:219-230), through the port's `score_pairs`
   (on a card: the all-pairs kernel and a gather, since the pairs are all
   U(U-1) of them);
2. Myers mark-and-eliminate transitive reduction with the reference's
   weight test w(w,x) + w(v,w) >= w(v,x) (overlapGraphs.py:235-303), as
   tensor ops on a torch device (see `transitive_reduction`);
3. greedy walk WITHOUT topological order: first unvisited neighbor in
   adjacency order wins (create_contig with an empty topo map,
   overlapGraphs.py:323-327), one contig per unique read base.

Copy semantics: copies of a duplicate read share identical edge sets, so
marks and eliminations are functions of the base read only — the reduction
runs at base level and fans out, which is behaviorally identical to the
reference's per-copy loops. Every result equals the JAX package's
``models/string_graph.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import resolve_device
from ..graph.build import OverlapGraph, dedup_reads, fanout_edges, score_pairs
from ..graph.candidates import candidate_pairs_dense
from ..graph.layout import create_contig
from ..utils.tracing import stage

# elements of the (rows, U, U) int64 temporaries of one block of the
# reduction: 256 MiB a block
REDUCTION_BLOCK_ELEMENTS = 1 << 25


def build_string_graph(reads: list[str], device="cuda") -> OverlapGraph:
    """All-pairs overlap graph thresholded at score > 0
    (overlapGraphs.py:219-230). Pairs run `ua`-major over every ordered
    pair of distinct unique reads; the kept pairs fan out to copy pairs in
    the JAX package's edge order (`graph/build.py::fanout_edges`).
    `device` is the torch device that scores the pairs ("cuda" by default,
    True and False as in the JAX package)."""
    dev = resolve_device(device)
    unique, counts = dedup_reads(reads)
    offsets = np.zeros(len(unique) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    ia, ib = candidate_pairs_dense(len(unique))
    scores, ends = score_pairs(unique, (ia, ib), device=dev)
    keep = scores > 0
    src, dst, weight, end_pos = fanout_edges(
        ia[keep], ib[keep], scores[keep], ends[keep], counts, offsets)
    return OverlapGraph(unique_reads=unique, counts=counts, offsets=offsets,
                        src=src, dst=dst, weight=weight, end_pos=end_pos)


def reduced_base_pairs(n_unique: int, bu, bv, weight,
                       device) -> torch.Tensor:
    """(U, U) bool: the base pairs (v, x) that the Myers loop eliminates.

    With S(v) the successors of v and W the weight of a base pair, the JAX
    package's loop (string_graph.py:80-94) eliminates (v, x) exactly when
    x is in S(v) and some w in S(v) has x in S(w) and W[v,w] + W[w,x] >=
    W[v,x]: a mark turns ELIMINATED only from INPLAY, which means x in
    S(v), and never back, so the visiting order does not matter. That is
    the max-plus product of the masked weight matrix with itself, compared
    with `>=`, here in blocks of rows. `bu`, `bv`, `weight` list each base
    pair once; there are no self-loops at base level."""
    bu = torch.as_tensor(np.asarray(bu, np.int64), device=device)
    bv = torch.as_tensor(np.asarray(bv, np.int64), device=device)
    w = torch.as_tensor(np.asarray(weight, np.int64), device=device)
    adj = torch.zeros((n_unique, n_unique), dtype=torch.bool, device=device)
    adj[bu, bv] = True
    wmat = torch.zeros((n_unique, n_unique), dtype=torch.int64, device=device)
    wmat[bu, bv] = w
    never = torch.iinfo(torch.int64).min
    reduced = torch.zeros_like(adj)
    rows = max(1, REDUCTION_BLOCK_ELEMENTS // max(1, n_unique * n_unique))
    for lo in range(0, n_unique, rows):
        hi = min(lo + rows, n_unique)
        # two-step weights v -> w -> x over the w that link them
        via = wmat[lo:hi, :, None] + wmat[None, :, :]
        linked = adj[lo:hi, :, None] & adj[None, :, :]
        best = torch.where(linked, via, never).amax(dim=1)
        reduced[lo:hi] = adj[lo:hi] & (best >= wmat[lo:hi])
    return reduced


def transitive_reduction(g: OverlapGraph, device="cuda") -> None:
    """Myers mark-and-eliminate over bases; deletes reduced edges in place
    (overlapGraphs.py:235-303 semantics, single pass), as tensor ops on
    `device` (see `reduced_base_pairs`). A base pair's weight is that of its
    first alive edge, as in the JAX package; copy pairs share it."""
    dev = resolve_device(device)
    base_arr = g.base_array()
    live = np.nonzero(g.alive)[0]
    if len(live) == 0:
        return
    bu = base_arr[g.src[live]].astype(np.int64)
    bv = base_arr[g.dst[live]].astype(np.int64)
    _, first = np.unique(bu * g.num_unique + bv, return_index=True)
    reduced = reduced_base_pairs(g.num_unique, bu[first], bv[first],
                                 g.weight[live][first], dev).cpu().numpy()
    g.alive[live] = ~reduced[bu, bv]


def alive_subgraph(g: OverlapGraph) -> OverlapGraph:
    """The graph of g's alive edges, in their order: the same adjacency
    order for every walk, without the dead edges to skip."""
    keep = g.alive
    return OverlapGraph(unique_reads=g.unique_reads, counts=g.counts,
                        offsets=g.offsets, src=g.src[keep], dst=g.dst[keep],
                        weight=g.weight[keep], end_pos=g.end_pos[keep])


def assemble_contigs_string(reads: list[str], fuzz: int = 5,
                            device="cuda") -> list[str]:
    """String-graph pipeline (overlapGraphs.py:306-329). `fuzz` is accepted
    for signature parity; like the reference, the reduction tests weights,
    not lengths, so fuzz is unused. `device` is the torch device of the
    scoring and of the reduction ("cuda" by default; raises without a
    card). Feeds the tracer's "graph.build", "graph.transitive_reduction"
    and "graph.walk_contigs" stages."""
    dev = resolve_device(device)
    with stage("graph.build", items=len(reads)):
        g = build_string_graph(reads, device=dev)
    with stage("graph.transitive_reduction", items=len(g.src)):
        transitive_reduction(g, device=dev)
    with stage("graph.walk_contigs"):
        walk = alive_subgraph(g)
        base_arr = walk.base_array()
        visited: set[int] = set()
        contigs: list[str] = []
        # node insertion order == base-major, copy-minor; first copy of an
        # unvisited base starts the contig (overlapGraphs.py:323-327)
        for base in range(walk.num_unique):
            if base in visited:
                continue
            contigs.append(create_contig(walk, int(walk.offsets[base]),
                                         visited, {}, base_arr))
    return contigs
