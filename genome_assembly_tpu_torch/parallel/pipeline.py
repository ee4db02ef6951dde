"""Pipeline-parallel stage overlap for the build path.

The JAX package's ``parallel/pipeline.py`` on ``torch.distributed``:
`pipelined_candidates_score` runs two stages on a 2-rank 'stage' mesh
axis. The rank at stage 0 runs the k-mer sort-join for row-block
microbatch t while the rank at stage 1 scores microbatch t - 1's candidate
pairs with the pair-list scorer (``ops/overlap.py::overlap_scores_pairs``:
the kernel on a card); each block of candidates hops from stage 0 to stage
1 by send/recv, so with M microbatches the stages overlap over M + 1
steps. What crosses stages or leaves the function is the compact (N, cap)
per-row layout. One sum over the axis replicates stage 1's result on both
ranks.
"""

from __future__ import annotations

import torch

from ..core.dispatch import resolve_device
from ..graph.candidates import _join_index, kmer_join_keys
from ..ops.overlap import overlap_scores_pairs
from . import _comm
from .mesh import Mesh

# The JAX package's device join packs a k-mer and its terminator into
# int32 lanes (graph/candidates.py MAX_DEVICE_K); this entry point takes
# the k it takes.
MAX_PIPELINE_K = 15


def _check_k(k: int) -> None:
    if not 0 < k <= MAX_PIPELINE_K:
        raise ValueError(f"k-mer prefilter size must lie in 1..{MAX_PIPELINE_K}"
                         f", got k={k}")


def _join(reads: torch.Tensor, lengths: torch.Tensor, k: int):
    pref, suf = kmer_join_keys(reads, lengths, k)
    return _join_index(pref, suf)


def _candidates(order, lo, hi, rows: torch.Tensor, cap: int):
    """(len(rows), cap) int32 candidate targets of `rows` in join order,
    -1 past each row's match count and on the row itself."""
    col = torch.arange(cap, device=rows.device)
    lo_b = lo[rows][:, None]
    cnt = (hi[rows] - lo[rows])[:, None]
    cand = order[(lo_b + col[None, :]).clamp(0, order.shape[0] - 1)]
    ok = (col[None, :] < cnt) & (cand != rows[:, None])
    return torch.where(ok, cand, -1).to(torch.int32)


def _score(reads, lengths, rows: torch.Tensor, cand: torch.Tensor):
    """Scores and ends of (row, candidate) pairs, (len(rows), cap) int32;
    the -1 slots are scored against read 0 (zeroed by the callers)."""
    cap = cand.shape[1]
    a_idx = rows.to(torch.int32).repeat_interleave(cap)
    b_idx = cand.reshape(-1).clamp(0, reads.shape[0] - 1)
    s, e = overlap_scores_pairs(reads, lengths, a_idx, b_idx.contiguous())
    return s.reshape(-1, cap), e.reshape(-1, cap)


def _zero_invalid(cand, scores, ends):
    valid = cand >= 0
    return (cand, torch.where(valid, scores, 0), torch.where(valid, ends, 0),
            valid)


def pipelined_candidates_score(mesh: Mesh, reads, lengths, k: int = 5,
                               cap: int = 32, n_micro: int = 4,
                               axis: str = "stage"):
    """Two pipeline stages of the k > 0 build path on a 2-rank `axis`:
    stage 0 joins k-mers for microbatch t while stage 1 scores microbatch
    t - 1's candidates.

    Args:
        reads: (N, L) int8 LEFT-aligned; N divisible by n_micro.
        lengths: (N,) int32.
        k: k-mer prefilter size (1..15).
        cap: per-row candidate capacity (rows with more matches truncate;
             the exact-parity build uses graph/candidates.py).

    Returns (cand, scores, ends, valid): (N, cap) int32 / int32 / int32 /
    bool on the mesh device, scores and ends 0 where ``cand`` is -1; None
    outside the mesh.
    """
    _check_k(k)
    n = reads.shape[0]
    if mesh.shape[axis] != 2:
        raise ValueError("pipeline runs on a 2-stage axis")
    if n % n_micro:
        raise ValueError(f"N={n} must be divisible by n_micro={n_micro}")
    if not mesh.member:
        return None
    dev = mesh.device
    r = torch.as_tensor(reads, dtype=torch.int8, device=dev)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    line = mesh.axis_line(axis)
    stage = mesh.axis_index(axis)
    mb = n // n_micro
    cand = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    ends = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    # the join index is replicated: both stages build it
    order, lo, hi = _join(r, ln, k)

    def rows(t):
        return torch.arange(t * mb, (t + 1) * mb, device=dev)

    if stage == 0:
        sent = None
        for t in range(n_micro):
            block = _candidates(order, lo, hi, rows(t), cap)
            if sent is not None:
                sent.wait()
            sent = _comm.isend(block, line, 1)
        sent.wait()
    else:
        pending = _comm.irecv((mb, cap), cand, line, 0)
        for t in range(n_micro):
            block = pending.wait()
            if t + 1 < n_micro:
                pending = _comm.irecv((mb, cap), cand, line, 0)
            s_blk, e_blk = _score(r, ln, rows(t), block)
            cand[t * mb:(t + 1) * mb] = block
            scores[t * mb:(t + 1) * mb] = s_blk
            ends[t * mb:(t + 1) * mb] = e_blk
    # the results live on stage 1; one sum replicates them on both ranks
    stacked = torch.stack([cand, scores, ends])
    if stage == 0:
        stacked.zero_()
    cand, scores, ends = _comm.psum(stacked, line)
    return _zero_invalid(cand, scores, ends)


def candidates_score_unpipelined(reads, lengths, k: int = 5, cap: int = 32,
                                 device="cuda"):
    """Single-device reference for `pipelined_candidates_score`, on
    `device` (the card by default)."""
    _check_k(k)
    dev = resolve_device(device)
    r = torch.as_tensor(reads, dtype=torch.int8, device=dev)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    order, lo, hi = _join(r, ln, k)
    rows = torch.arange(r.shape[0], device=dev)
    cand = _candidates(order, lo, hi, rows, cap)
    s, e = _score(r, ln, rows, cand)
    return _zero_invalid(cand, s, e)
