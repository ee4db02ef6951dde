"""Sequence-parallel Smith-Waterman: the genome axis sharded over a mesh.

The JAX package's ``parallel/seqpar.py`` on ``torch.distributed``. The
reference axis of the row scan (``ops/smith_waterman.py::local_align_batch``)
is cut into D blocks along a mesh axis, one a rank, and each DP row is
completed with two exchanges along the axis:

- a halo: cell (i, j) needs dp[i-1][j-1] and dp[i][j-1], so the first
  column of a block takes the left neighbour's last column (rank 0 reads
  the dp[.][0] = 0 boundary, the zero fill of the shift to the right); one
  shift of row i's last column serves as row i's left halo and row i+1's
  diagonal halo;
- the carry of the left chain dp[i][j] = max(..., dp[i][j-1] + indel), a
  max-plus prefix scan cummax(key)[j] + indel*j with key = c0[j] -
  indel*j: each block takes its local cummax, all-gathers its block total
  and folds in the maximum of the blocks left of it.

Each rank tracks the first strict maximum over its own columns; one gather
after the scan resolves the global winner by (value desc, row asc, rank
asc), the reference's row-major first maximum. The DP work between two
exchanges is ``ops/seqpar.py``'s: on a card a hand kernel
(``csrc/seqpar.cu``), two launches a DP row here and one a step of the
pipelined variant; on the CPU its plain torch version. Under gloo each
exchange goes through host memory.

``local_align_batch_seqpar_pipelined`` skews the ranks one block of R rows
apart (rank d works on row block t - d at step t): one (2, R, B) shift to
the right a step carries the R last columns and the R carries, so the
exchanges drop from 2 a row to n_pad / R + D - 1 in all. Its carry takes
the shift's zero fill as the identity of the max where the per-row variant
takes NEG. Both give the same rows for every indel, because the cummax of
the first block is never negative: for indel <= 0 every key is >= 0, and
for indel > 0 the key of column 1 is c0[1] - indel >= up[1] - indel =
dp[i-1][1] >= 0.

The traceback codes stay sharded, as in the JAX package, where each
device holds only its (n, B, G/D) slice of the global code tensor: every
member returns its own slice (``gather_codes`` assembles the global
tensor where it fits), while best, best_i and best_j are the global
results on every member.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encoding import PAD
from ..ops import seqpar as steps
from . import _comm
from .mesh import Mesh

# the identity of the carry's max in the per-row variant (the JAX
# package's NEG; the steps' own, ops/seqpar.py)
NEG = steps.NEG


class _Block:
    """One rank's block of the genome axis, its inputs on the rank's device
    and its running best fold."""

    def __init__(self, mesh: Mesh, axis: str, queries, q_len, genome_codes):
        dev = mesh.device
        self.queries = torch.as_tensor(queries, dtype=torch.int8,
                                       device=dev).contiguous()
        self.q_len = torch.as_tensor(q_len, dtype=torch.int32,
                                     device=dev).contiguous()
        genome = torch.as_tensor(genome_codes, dtype=torch.int8, device=dev)
        self.index = mesh.axis_index(axis)
        self.n_dev = mesh.shape[axis]
        self.gb = genome.shape[0] // self.n_dev
        self.off = self.index * self.gb
        self.genome = genome[self.off:self.off + self.gb].contiguous()
        self.line = mesh.axis_line(axis)
        b = self.queries.shape[0]
        self.best = torch.zeros(b, dtype=torch.int32, device=dev)
        self.bi = torch.zeros(b, dtype=torch.int32, device=dev)
        self.bj = torch.zeros(b, dtype=torch.int32, device=dev)

    def resolve(self):
        """The global row-major first strict maximum from every rank's
        candidate: the greatest value, then the smallest row, then the
        smallest rank (= smallest column). One gather."""
        cands = _comm.all_gather(
            torch.stack([self.best, self.bi, self.bj])[None], self.line)
        bests, bis, bjs = cands[:, 0], cands[:, 1], cands[:, 2]   # (D, B)
        g_best = bests.max(dim=0).values
        masked = torch.where(bests == g_best[None, :], bis, 2**30)
        d_win = torch.argmin(masked, dim=0)[None, :]              # first min
        bi = bis.gather(0, d_win)[0]
        bj = bjs.gather(0, d_win)[0]
        hit = g_best > 0
        return (g_best, torch.where(hit, bi, 0), torch.where(hit, bj, 0))


def _check_genome(mesh: Mesh, genome_codes, axis: str) -> None:
    gp = genome_codes.shape[0]
    n_dev = mesh.shape[axis]
    if gp % n_dev:
        raise ValueError(f"padded genome length {gp} not divisible by mesh "
                         f"axis '{axis}' size {n_dev}")


def local_align_batch_seqpar(mesh: Mesh, queries, q_len, genome_codes,
                             g_len: int, axis: str = "data",
                             match_score: int = 10, mismatch: int = -1,
                             indel: int = -1):
    """Sequence-parallel batched SW against ONE shared reference.

    Args:
        queries: (B, n_pad) int8 LEFT-aligned.
        q_len:   (B,) int32.
        genome_codes: (Gp,) int8, padded so the mesh axis divides Gp.
        g_len:   true genome length (<= Gp).

    Returns (best, best_i, best_j, codes) on the mesh device: best, best_i
    and best_j (B,) int32 exactly like ``ops.smith_waterman.
    local_align_batch`` on a replicated genome; codes this rank's
    (n_pad, B, Gp / D) uint8 slice of the global (n_pad, B, Gp) code
    tensor (no j = 0 column: the global codes[i-1, b, j-1] is the code of
    cell (i, j)). None outside the mesh. Two exchanges a DP row, around
    two launches (``ops/seqpar.py``: *pre*, *post*) on a card.
    """
    _check_genome(mesh, genome_codes, axis)
    if not mesh.member:
        return None
    blk = _Block(mesh, axis, queries, q_len, genome_codes)
    b, n_pad = blk.queries.shape
    steps.check_range(mesh.device, n_pad, genome_codes.shape[0], match_score,
                      mismatch, indel)
    dev = mesh.device
    pen = (match_score, mismatch, indel)
    prev = torch.zeros((b, blk.gb), dtype=torch.int32, device=dev)
    run = torch.empty_like(prev)
    halo = torch.zeros(b, dtype=torch.int32, device=dev)
    codes = torch.empty((n_pad, b, blk.gb), dtype=torch.uint8, device=dev)
    for i in range(1, n_pad + 1):
        total = steps.seqpar_row_pre(blk.queries, i, blk.genome, blk.off,
                                     g_len, prev, halo, run, *pen)
        totals = _comm.all_gather(total[None], blk.line)          # (D, B)
        # post derives this row's left halo from the carry; the shift of
        # the row's last column to the right is the next row's diagonal
        # halo
        last = steps.seqpar_row_post(
            blk.queries, blk.q_len, i, blk.genome, blk.off, g_len,
            blk.index, prev, halo, run, totals, codes[i - 1], blk.best,
            blk.bi, blk.bj, *pen)
        halo = _comm.ppermute_right(last, blk.line, blk.index)
    return (*blk.resolve(), codes)


def local_align_batch_seqpar_pipelined(mesh: Mesh, queries, q_len,
                                       genome_codes, g_len: int,
                                       rows_per_exchange: int = 8,
                                       axis: str = "data",
                                       match_score: int = 10,
                                       mismatch: int = -1,
                                       indel: int = -1):
    """Row-block-pipelined variant of `local_align_batch_seqpar`: one
    (2, R, B) exchange to the right neighbour a step of R rows, n_pad / R +
    D - 1 steps, each one launch (``ops/seqpar.py::seqpar_step``) on a card.
    Same outputs; the queries are padded with PAD to a multiple of R =
    `rows_per_exchange` rows, and so are the codes' rows (slice [:n_pad] to
    compare)."""
    _check_genome(mesh, genome_codes, axis)
    if not mesh.member:
        return None
    queries = torch.as_tensor(queries, dtype=torch.int8)
    b, n_pad = queries.shape
    rows = max(1, min(rows_per_exchange, n_pad))
    n_blocks = -(-n_pad // rows)
    steps.check_range(mesh.device, n_blocks * rows, genome_codes.shape[0],
                      match_score, mismatch, indel)
    pad = n_blocks * rows - n_pad
    if pad:
        queries = torch.cat([queries, torch.full(
            (b, pad), int(PAD), dtype=torch.int8, device=queries.device)],
            dim=1)
    blk = _Block(mesh, axis, queries, q_len, genome_codes)
    dev = mesh.device
    codes = torch.empty((n_blocks * rows, b, blk.gb), dtype=torch.uint8,
                        device=dev)
    prev = torch.zeros((b, blk.gb), dtype=torch.int32, device=dev)
    halo_diag0 = torch.zeros(b, dtype=torch.int32, device=dev)
    # (last columns, carries) of the block the left neighbour finished
    # last step; the rank at index 0 always holds zeros
    slab = torch.zeros((2, rows, b), dtype=torch.int32, device=dev)
    for t in range(n_blocks + blk.n_dev - 1):
        tb = t - blk.index
        if 0 <= tb < n_blocks:
            if tb == 0:                 # dp row 0 is the zero boundary
                prev.zero_()
                halo_diag0.zero_()
            out = steps.seqpar_step(
                blk.queries, blk.q_len, tb * rows, blk.genome, blk.off,
                g_len, prev, halo_diag0, slab, codes, blk.best, blk.bi,
                blk.bj, match_score, mismatch, indel)
        else:
            # an idle rank's right neighbour is idle at the next step too,
            # so what an idle rank sends is never read
            out = torch.zeros_like(slab)
        halo_diag0 = slab[0, rows - 1].clone()
        slab = _comm.ppermute_right(out, blk.line, blk.index)
    return (*blk.resolve(), codes)


def gather_codes(mesh: Mesh, codes: torch.Tensor,
                 axis: str = "data") -> torch.Tensor:
    """The global (n, B, Gp) code tensor from every member's (n, B, Gp/D)
    slice, on every member (one all-gather; D times the slice's memory on
    each rank). None outside the mesh."""
    if not mesh.member:
        return None
    n_dev = mesh.shape[axis]
    stacked = _comm.all_gather(codes.contiguous(), mesh.axis_line(axis))
    n, b, gb = codes.shape
    return stacked.reshape(n_dev, n, b, gb).permute(1, 2, 0, 3).reshape(
        n, b, n_dev * gb)


def traceback_host_seqpar(codes: np.ndarray, best_i: int, best_j: int,
                          query: str, reference: str):
    """Traceback over seq-par codes ((n_pad, Gp) for one item, no j=0
    column). Same contract as ops.smith_waterman.traceback_host."""
    i, j = int(best_i), int(best_j)
    aq: list[str] = []
    ar: list[str] = []
    while i > 0 and j > 0:
        code = int(codes[i - 1, j - 1])
        if code == 1:
            aq.append(query[i - 1])
            ar.append(reference[j - 1])
            i -= 1
            j -= 1
        elif code == 2:
            aq.append(query[i - 1])
            ar.append("-")
            i -= 1
        elif code == 3:
            aq.append("-")
            ar.append(reference[j - 1])
            j -= 1
        else:
            break
    return "".join(reversed(ar)), "".join(reversed(aq)), j
