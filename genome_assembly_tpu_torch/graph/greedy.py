"""Fast non-parity layout: guarded greedy best-overlap chaining.

A copy of the JAX package's host module, around the port's `score_pairs`
(the pair-list kernel on a card for sparse candidates); `device` is a
torch device spec.

The reference's layout stack (overlapGraphs.py:106-193) is inherently
sequential: greedy weakest-edge cycle removal (one edge-DFS per deletion),
Kahn topo sort, then a per-node greedy walk. The exact-parity pipeline
reproduces it bit-for-bit (graph/cycles.py, graph/topo.py,
graph/layout.py + the C++ engine), but even the incremental C++ engine
leaves cycle removal as the dominant stage in the dense k=0 regime
(13.8 s of 22.7 s at C=30, DENSE_DEMO.json — VERDICT round 3, weak #2).

This module is the flagged alternative (`exact_parity=False`): classic
greedy best-overlap chaining over UNIQUE reads —

    keep candidate edges that pass the QUALITY GUARDS (below);
    sort kept edges by (score desc, enumeration order);
    accept an edge (u -> v) iff u has no successor yet, v has no
    predecessor yet, and u, v are not already on the same chain
    (union-find) — so accepted edges form simple chains;
    contigs = chains merged by end_pos; leftover reads that the chains
    already cover are suppressed; the survivors are consensus-polished
    by majority vote over the read pileup (graph/consensus.py).

Quality guards (VERDICT round 4, next-step #2 — the unguarded round-4
accept loop chained everything with score >= 1, and at C=30 a spurious
tail merge produced an N50 > genome-length chimera):

- `min_overlap`: an edge must overlap by at least this many bases.
  Random 4-letter sequences produce abundant short perfect overlaps
  (P(match) = 1/4 per base over N^2 pairs); length is the cheapest
  high-precision filter against them. The default (None) auto-scales to
  ceil(log4(100 * U^2)) — the length where the EXPECTED number of
  spurious perfect overlaps across all U^2 ordered pairs is <= 0.01 —
  clamped to [8, 64], and additionally capped at k when k > 0: the
  reference's k-mer prefilter (suffix k-mer == target's FIRST k chars,
  overlapGraphs.py:30-53) only surfaces overlaps of exactly k, so a
  longer guard would reject every candidate it can produce. True
  overlaps below the auto guard only occur in the k = 0 dense mode
  when coverage is so sparse that adjacent reads barely touch; callers
  in that regime pass an explicit `min_overlap`.
- `min_frac`: score >= min_frac * match_score * end_pos — an identity
  guard. True overlaps under the substitution-only error model score
  ~(1-2p) * match_score per base; spurious full-length overlaps sit
  near the random expectation (~0.25 identity, score/base ~1.75).
  The default 0.6 sits between the two populations for every p in the
  reference's grids (max p = 0.1 -> true score/base ~7.9).
- redundancy suppression: a leftover unchained read whose prefix is
  covered by a kept edge from a chained read and whose suffix is
  covered by a kept edge to a chained read (covered_prefix +
  covered_suffix >= len) duplicates sequence the chains already carry —
  emitting it only re-adds its private read errors (measured on the
  dense demo: the leftover singletons carry 2-6x the mean error rate,
  because greedy chaining preferentially consumed the low-error copies).
  Duplicate-read copies are suppressed the same way (they are exact
  duplicates of an emitted read) and instead contribute vote
  multiplicity to the consensus.

One O(E log E) numpy sort + one linear accept pass (C++
gc_greedy_chain, or the Python loop with `use_native=False`) replace the
whole cycle-removal/topo/walk stack. Results are NOT bit-identical to the
reference — the quality differential on the dense demo is recorded in
RESULTS.md — but the contract (reads in, contigs out) and the scoring
kernels are shared with the exact pipeline.
"""

from __future__ import annotations

import numpy as np


def greedy_chain_python(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                        order: np.ndarray):
    """Accept edges in `order`; returns (succ, chain_edge) int32/int64:
    succ[u] = accepted successor node of u (-1 if none), chain_edge[u] =
    the edge index that links u to succ[u]. Pure-Python fallback for the
    C++ accept loop (identical result by construction)."""
    succ = np.full(n_nodes, -1, np.int32)
    pred = np.full(n_nodes, -1, np.int32)
    chain_edge = np.full(n_nodes, -1, np.int64)
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, int(parent[x])
        return root

    for e in order:
        u, v = int(src[e]), int(dst[e])
        if succ[u] != -1 or pred[v] != -1 or u == v:
            continue
        ru, rv = find(u), find(v)
        if ru == rv:
            continue                      # would close a cycle
        parent[ru] = rv
        succ[u] = v
        pred[v] = u
        chain_edge[u] = int(e)
    return succ, chain_edge


def greedy_chain(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                 order: np.ndarray, use_native: bool = True):
    """The accept loop: the C++ engine, or `greedy_chain_python` when
    `use_native=False`. A failed build or load of the engine raises (the
    JAX package warns and runs the Python loop; ROADMAP §C)."""
    if not use_native:
        return greedy_chain_python(n_nodes, src, dst, order)
    from ..native import graphcore

    return graphcore.greedy_chain(n_nodes, src, dst, order)


def assemble_contigs_greedy(reads: list[str], k: int = 5,
                            device="cuda", use_native: bool = True,
                            min_score: int = 1,
                            min_overlap: int | None = None,
                            min_frac: float = 0.6,
                            drop_redundant: bool = True,
                            consensus: bool = True) -> list[str]:
    """Fast-layout assembly: dedup -> candidates -> device scoring ->
    guarded greedy chaining -> redundancy suppression -> consensus.

    Shares dedup/candidate/scoring code (and their device kernels) with
    the exact pipeline; only the layout differs. See the module
    docstring for the guard semantics. `min_overlap=0, min_frac=0,
    drop_redundant=False, consensus=False` reproduces the unguarded
    round-4 behavior (every score >= min_score edge chains, duplicate
    copies emitted as singletons). `device` is the torch device of the
    k-mer join and the pair scoring ("cuda" by default; True and False as
    in the JAX package; raises without a card).
    """
    from ..core.dispatch import resolve_device
    from ..utils.tracing import stage
    from .build import candidate_pairs_arrays, dedup_reads, score_pairs

    device = resolve_device(device)
    unique, counts = dedup_reads(reads)
    u_count = len(unique)
    if u_count == 0:
        return []
    if min_overlap is None:
        # expected spurious PERFECT overlaps over U^2 pairs <= 0.01 is
        # ceil(log4(100 U^2)); +6 margin because the identity guard
        # admits ~0.66-identity overlaps, which random pairs reach
        # exp(-0.37 j) of the time — measured on the dense demo: at
        # C=30 (U=1580) the margin-free guard (14) lets enough through
        # to misassemble, while +6 (20) reproduces the clean layout
        min_overlap = int(np.clip(
            np.ceil(np.log2(100.0 * u_count * u_count) / 2.0) + 6, 8, 64))
        if k > 0:
            # the k-mer prefilter (suffix k-mer == target's FIRST k
            # chars, overlapGraphs.py:30-53) only surfaces overlaps of
            # exactly k on non-periodic sequences, so a guard above k
            # would reject every candidate the filter can produce
            min_overlap = min(min_overlap, k)
    lens_u = np.fromiter((len(r) for r in unique), np.int64, u_count)
    with stage("greedy.candidates"):
        ia, ib = candidate_pairs_arrays(unique, k, device=device)
    scores, ends = score_pairs(unique, (ia, ib), device=device)
    with stage("greedy.chain", items=len(ia)):
        keep = scores >= min_score
        if min_overlap > 0:
            keep &= ends >= min_overlap
        if min_frac > 0.0:
            keep &= scores.astype(np.float64) >= min_frac * 10.0 * ends
        ia_k, ib_k = ia[keep], ib[keep]
        sc_k, en_k = scores[keep], ends[keep]
        # (score desc, enumeration order) via one stable argsort
        order = np.argsort(-sc_k.astype(np.int64), kind="stable")
        succ, chain_edge = greedy_chain(u_count, ia_k, ib_k, order,
                                        use_native=use_native)
    with stage("greedy.merge"):
        has_pred = np.zeros(u_count, bool)
        valid = succ >= 0
        has_pred[succ[valid]] = True
        in_chain = valid | has_pred

        # coverage of leftover reads by chained neighbors (redundancy):
        # an incoming kept edge w->u (w chained) covers u[0:end]; an
        # outgoing kept edge u->v (v chained) covers u's last
        # min(len_u, end) bases
        if drop_redundant and len(ia_k):
            cov_pref = np.zeros(u_count, np.int64)
            cov_suf = np.zeros(u_count, np.int64)
            src_ch = in_chain[ia_k]
            dst_ch = in_chain[ib_k]
            np.maximum.at(cov_pref, ib_k[src_ch],
                          en_k[src_ch].astype(np.int64))
            d_out = np.minimum(lens_u[ia_k], en_k.astype(np.int64))
            np.maximum.at(cov_suf, ia_k[dst_ch], d_out[dst_ch])
            redundant = ~in_chain & (cov_pref + cov_suf >= lens_u)
        else:
            redundant = np.zeros(u_count, bool)

        contigs: list[str] = []
        # read placements for the consensus vote: (unique idx, offset
        # within contig, contig idx)
        node_contig = np.full(u_count, -1, np.int64)
        node_off = np.zeros(u_count, np.int64)
        for start in range(u_count):
            if has_pred[start] or (redundant[start] and succ[start] < 0):
                continue
            node_contig[start] = len(contigs)
            node_off[start] = 0
            parts = [unique[start]]
            cur_len = lens_u[start]
            node = start
            while succ[node] >= 0:
                e = chain_edge[node]
                node = int(succ[node])
                node_contig[node] = len(contigs)
                node_off[node] = cur_len - int(en_k[e])
                parts.append(unique[node][int(en_k[e]):])
                cur_len += lens_u[node] - int(en_k[e])
            contigs.append("".join(parts))
        if not drop_redundant:
            # unguarded mode: duplicate-read copies emit as singletons
            # (the exact pipeline's copy semantics)
            for u in range(u_count):
                extra = int(counts[u]) - 1
                if extra > 0:
                    contigs.extend([unique[u]] * extra)
    if not consensus:
        return contigs
    with stage("greedy.consensus"):
        # suppressed reads still vote: place each at its best kept edge
        # to a placed node
        placed = node_contig >= 0
        if len(ia_k):
            e_sc = sc_k.astype(np.int64)
            en64 = en_k.astype(np.int64)
            cands = []
            # outgoing u->v, v placed: u starts at off_v + end - len_u
            out_e = np.nonzero(~placed[ia_k] & placed[ib_k])[0]
            if len(out_e):
                cands.append((ia_k[out_e].astype(np.int64),
                              node_contig[ib_k[out_e]],
                              node_off[ib_k[out_e]] + en64[out_e]
                              - lens_u[ia_k[out_e]],
                              e_sc[out_e]))
            # incoming w->u, w placed: u starts at off_w + len_w - end
            in_e = np.nonzero(placed[ia_k] & ~placed[ib_k])[0]
            if len(in_e):
                cands.append((ib_k[in_e].astype(np.int64),
                              node_contig[ia_k[in_e]],
                              node_off[ia_k[in_e]] + lens_u[ia_k[in_e]]
                              - en64[in_e],
                              e_sc[in_e]))
            if cands:
                nn = np.concatenate([c[0] for c in cands])
                cc = np.concatenate([c[1] for c in cands])
                oo = np.concatenate([c[2] for c in cands])
                ss = np.concatenate([c[3] for c in cands])
                o = np.lexsort((ss, nn))   # by node, then score asc
                # duplicate-index assignment: last (= best score) wins
                node_contig[nn[o]] = cc[o]
                node_off[nn[o]] = oo[o]
        sel = np.nonzero(node_contig >= 0)[0]
        from .consensus import polish_contigs

        polished = polish_contigs(
            contigs, unique, sel, node_off[sel], node_contig[sel],
            place_weight=counts[sel].astype(np.int64))
    return polished
