"""Overlap-graph construction.

Reference semantics (overlapGraphs.py:5-61):
- duplicate reads collapse to (unique read, count) in first-occurrence order;
  every copy becomes its own node ("read_0", "read_1", ... in the reference —
  here node ids are dense ints: node(u, c) = offset[u] + c);
- a k-mer prefix index maps each unique read's first k chars (whole read if
  shorter) to candidates; each read's last k chars look up its successor
  candidates; k = 0 disables filtering (all ordered unique pairs);
- identical reads never get edges; every copy pair of two distinct reads gets
  the same (weight, end_position) edge — one alignment per unique pair,
  fanned out to copies;
- NO score threshold: even zero/negative-score candidate edges are added.

Edge insertion order is preserved exactly (it determines adjacency order,
hence cycle-removal and topological order, hence the contigs): candidates
are enumerated in reference order (the sort-join as torch ops on the
caller's device for 1 <= k <= 31), and scoring on a CUDA device either runs
the all-pairs kernel over every unique pair and gathers the candidates (the
dense route) or the pair-list kernel over the candidates alone (the sparse
route), or, for fewer than 200,000 pairs of reads with an N, the C++ scorer
(``core/dispatch.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import dispatch
from ..core.encoding import PAD, encode_batch
from ..utils.tracing import stage

# The JAX package's dense all-pairs limit: up to this many unique reads a
# CUDA device scores all U^2 pairs and gathers. GA_TPU_DENSE_MAX_U
# overrides it, as in the JAX package (dense_max_u).
DENSE_MAX_U = 16384


def dense_max_u() -> int:
    """GA_TPU_DENSE_MAX_U, or DENSE_MAX_U when it is unset."""
    return int(os.environ.get("GA_TPU_DENSE_MAX_U", DENSE_MAX_U))


@dataclass
class OverlapGraph:
    """Edge-list overlap graph over read-copy nodes.

    Nodes are dense ints; node (unique u, copy c) has id offset[u] + c.
    `adj[v]` lists edge indices out of v in insertion order; `alive` supports
    edge deletion without disturbing order.
    """

    unique_reads: list[str]
    counts: np.ndarray            # (U,) int32 copies per unique read
    offsets: np.ndarray           # (U+1,) int64 node-id offsets
    src: np.ndarray               # (E,) int32 node ids
    dst: np.ndarray               # (E,) int32
    weight: np.ndarray            # (E,) int32
    end_pos: np.ndarray           # (E,) int32
    adj: list[list[int]] = field(default_factory=list)
    alive: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.alive is None:
            self.alive = np.ones(len(self.src), dtype=bool)
        if not self.adj:
            # insertion-order adjacency without a Python per-edge loop: a
            # STABLE argsort of src keeps edge indices in insertion order
            # within each node's group
            order = np.argsort(self.src, kind="stable")
            bounds = np.searchsorted(
                self.src[order], np.arange(self.num_nodes + 1))
            self.adj = [order[bounds[v]:bounds[v + 1]]
                        for v in range(self.num_nodes)]

    @property
    def num_nodes(self) -> int:
        return int(self.offsets[-1])

    @property
    def num_unique(self) -> int:
        return len(self.unique_reads)

    def base_array(self) -> np.ndarray:
        """(num_nodes,) unique-read index per node id."""
        return np.repeat(np.arange(self.num_unique, dtype=np.int32),
                         self.counts)


def dedup_reads(reads: list[str]):
    """First-occurrence-ordered (unique_reads, counts) — overlapGraphs.py:18-20."""
    counts: dict[str, int] = {}
    for r in reads:
        counts[r] = counts.get(r, 0) + 1
    unique = list(counts.keys())
    return unique, np.array([counts[r] for r in unique], dtype=np.int32)


def candidate_pairs(unique_reads: list[str], k: int) -> list[tuple[int, int]]:
    """Ordered candidate (source, target) unique-index pairs, in the exact
    enumeration order of the reference builder (overlapGraphs.py:30-53)."""
    if k < 0:
        raise ValueError("k-mer length must be non-negative")
    u_count = len(unique_reads)
    pairs: list[tuple[int, int]] = []
    if k > 0:
        prefix_index: dict[str, list[int]] = {}
        for u, read in enumerate(unique_reads):
            prefix = read[:k] if len(read) >= k else read
            prefix_index.setdefault(prefix, []).append(u)
        for ua, read_a in enumerate(unique_reads):
            suffix = read_a[-k:] if len(read_a) >= k else read_a
            for ub in prefix_index.get(suffix, []):
                if ua != ub:
                    pairs.append((ua, ub))
    else:
        for ua in range(u_count):
            for ub in range(u_count):
                if ua != ub:
                    pairs.append((ua, ub))
    return pairs


def candidate_pairs_arrays(unique_reads: list[str], k: int,
                           device="cuda"):
    """Ordered candidate pairs as (ia, ib) int32 index arrays.

    Same enumeration order as `candidate_pairs` (the reference's,
    overlapGraphs.py:30-53), vectorized: k=0 is a numpy meshgrid,
    1 <= k <= 31 the sort-join as torch ops on `device`
    (graph/candidates.py), larger k the dict join. `device` is a torch
    device spec ("cuda" by default; True and False as in the JAX package).
    """
    from .candidates import (
        MAX_JOIN_K,
        candidate_pairs_dense,
        candidate_pairs_device,
    )

    if k == 0:
        return candidate_pairs_dense(len(unique_reads))
    dev = dispatch.resolve_device(device)
    if 0 < k <= MAX_JOIN_K:
        return candidate_pairs_device(unique_reads, k, device=dev)
    pairs = candidate_pairs(unique_reads, k)
    ia = np.fromiter((p[0] for p in pairs), np.int32, len(pairs))
    ib = np.fromiter((p[1] for p in pairs), np.int32, len(pairs))
    return ia, ib


def _pairs_to_arrays(pairs):
    """Normalize a pair spec — list[(ua, ub)] or an (ia, ib) array tuple —
    to int32 index arrays."""
    if (isinstance(pairs, tuple) and len(pairs) == 2
            and isinstance(pairs[0], np.ndarray)):
        return (np.ascontiguousarray(pairs[0], dtype=np.int32),
                np.ascontiguousarray(pairs[1], dtype=np.int32))
    ia = np.fromiter((p[0] for p in pairs), np.int32, len(pairs))
    ib = np.fromiter((p[1] for p in pairs), np.int32, len(pairs))
    return ia, ib


def score_pairs(unique_reads: list[str], pairs, chunk: int = 16384,
                device="cuda"):
    """Score ordered unique-read pairs.

    `pairs` is a list of (ua, ub) tuples or an (ia, ib) index-array tuple.
    Returns (scores, end_positions) int32 numpy arrays aligned with `pairs`.

    On a CUDA device, up to `dense_max_u()` unique reads or at any U when
    the candidates are dense (>= 5% of U^2), the all-pairs kernel
    (ops/overlap_allpairs.py) scores every ordered pair of unique reads, at
    U x U exactly, and the requested entries are gathered on the device;
    otherwise (the sparse route) the pair-list kernel (ops/overlap.py)
    scores the requested pairs alone, in one launch. Either way the results
    come back to the host once. On a CPU device the C++ engine scores the
    pairs, as in the JAX package on a CPU backend, and on a CUDA device too
    when fewer than dispatch.MIN_DEVICE_PAIRS pairs are asked of reads
    that carry PAD (an N) inside their lengths: the JAX package's answer
    there (``core/dispatch.py``). `chunk` is the JAX package's pair batch of
    its sparse route (signature parity); every route here takes every pair
    at once.

    Feeds the global tracer's "score.pairs" stage, and inside it one of
    "score.pairs.host", "score.pairs.allpairs" or "score.pairs.pairlist",
    which names the route taken.
    """
    dev = dispatch.resolve_device(device)
    ia, ib = _pairs_to_arrays(pairs)
    with stage("score.pairs", items=len(ia)):
        return _score_pairs_impl(unique_reads, ia, ib, dev)


def _score_pairs_impl(unique_reads: list[str], ia, ib, dev: torch.device):
    n_pairs = len(ia)
    if n_pairs == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    u_count = len(unique_reads)
    left, lens = encode_batch(unique_reads, align="left")
    internal_pad = bool(
        ((left == PAD) & (np.arange(left.shape[1]) < lens[:, None])).any())
    if dispatch.use_host_pair_scoring(dev, n_pairs, internal_pad):
        from ..native import graphcore

        with stage("score.pairs.host", items=n_pairs):
            return graphcore.overlap_nogap_pairs(left, lens, ia, ib)
    codes = torch.from_numpy(left).to(dev)
    lengths = torch.from_numpy(lens).to(dev)
    if u_count > dense_max_u() and n_pairs * 20 < u_count * u_count:
        from ..ops.overlap import overlap_scores_pairs

        with stage("score.pairs.pairlist", items=n_pairs):
            s, e = overlap_scores_pairs(codes, lengths,
                                        torch.from_numpy(ia).to(dev),
                                        torch.from_numpy(ib).to(dev))
            both = torch.stack([s, e]).cpu().numpy()
        return both[0], both[1]
    from ..ops.overlap_allpairs import overlap_scores_all_pairs

    with stage("score.pairs.allpairs", items=n_pairs):
        s_mat, e_mat = overlap_scores_all_pairs(codes, lengths)
        ia_d = torch.from_numpy(ia.astype(np.int64)).to(dev)
        ib_d = torch.from_numpy(ib.astype(np.int64)).to(dev)
        both = torch.stack([s_mat[ia_d, ib_d],
                            e_mat[ia_d, ib_d]]).cpu().numpy()
    return both[0], both[1]


def fanout_edges(ia: np.ndarray, ib: np.ndarray, scores: np.ndarray,
                 ends: np.ndarray, counts: np.ndarray, offsets: np.ndarray):
    """Expand per-unique-pair edges to per-copy-pair edges, vectorized.

    Order matches the reference's add_edge order (overlapGraphs.py:55-60):
    pair enumeration order, then copy_a-major / copy_b-minor within each
    pair — edge r of pair p has ca = r // counts[ib[p]], cb = r % counts[ib[p]].
    """
    rep = counts[ia].astype(np.int64) * counts[ib].astype(np.int64)
    total = int(rep.sum())
    pair_of_edge = np.repeat(np.arange(len(ia), dtype=np.int64), rep)
    starts = np.cumsum(rep) - rep
    within = np.arange(total, dtype=np.int64) - starts[pair_of_edge]
    cb_count = counts[ib][pair_of_edge].astype(np.int64)
    ca = within // cb_count
    cb = within % cb_count
    src = (offsets[ia][pair_of_edge] + ca).astype(np.int32)
    dst = (offsets[ib][pair_of_edge] + cb).astype(np.int32)
    return (src, dst, scores[pair_of_edge].astype(np.int32),
            ends[pair_of_edge].astype(np.int32))


def build_overlap_graph(reads: list[str], k: int = 5,
                        device="cuda") -> OverlapGraph:
    """Full builder: dedup -> candidates -> scoring -> edge fanout.

    Edge order matches the reference's add_edge order exactly
    (overlapGraphs.py:43-60): pair enumeration order, then copy_a-major /
    copy_b-minor within each pair.
    """
    dev = dispatch.resolve_device(device)
    unique, counts = dedup_reads(reads)
    offsets = np.zeros(len(unique) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    ia, ib = candidate_pairs_arrays(unique, k, device=dev)
    scores, ends = score_pairs(unique, (ia, ib), device=dev)
    src, dst, weight, end_pos = fanout_edges(ia, ib, scores, ends,
                                             counts, offsets)
    return OverlapGraph(unique_reads=unique, counts=counts, offsets=offsets,
                        src=src, dst=dst, weight=weight, end_pos=end_pos)
