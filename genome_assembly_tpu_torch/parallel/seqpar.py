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
asc), the reference's row-major first maximum. The per-row step is torch
ops on the rank's device, launch-bound, and under gloo each exchange goes
through host memory.

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
from . import _comm
from .mesh import Mesh

NEG = -(2**28)


def _cascade(diag, up, left) -> torch.Tensor:
    """The reference's cascade (aligners.py:122-132) as uint8 codes."""
    return torch.where(
        (diag >= up) & (diag >= left) & (diag >= 0), 1,
        torch.where((up >= left) & (up >= 0), 2,
                    torch.where(left >= 0, 3, 0))).to(torch.uint8)


class _Block:
    """One rank's block of the genome axis and the per-row arithmetic
    both variants share."""

    def __init__(self, mesh: Mesh, axis: str, queries, q_len, genome_codes,
                 g_len: int, match_score: int, mismatch: int, indel: int):
        dev = mesh.device
        self.queries = torch.as_tensor(queries, dtype=torch.int8, device=dev)
        self.q_len = torch.as_tensor(q_len, dtype=torch.int32, device=dev)
        genome = torch.as_tensor(genome_codes, dtype=torch.int8, device=dev)
        self.index = mesh.axis_index(axis)
        self.n_dev = mesh.shape[axis]
        gb = genome.shape[0] // self.n_dev
        self.off = self.index * gb
        self.ref = genome[self.off:self.off + gb][None, :]        # (1, Gb)
        self.jglob = (self.off + 1 + torch.arange(
            gb, dtype=torch.int32, device=dev))[None, :]          # 1-based
        self.valid = self.jglob <= g_len
        self.match, self.mismatch, self.indel = match_score, mismatch, indel
        self.line = mesh.axis_line(axis)
        b = self.queries.shape[0]
        self.best = torch.zeros(b, dtype=torch.int32, device=dev)
        self.bi = torch.zeros(b, dtype=torch.int32, device=dev)
        self.bj = torch.zeros(b, dtype=torch.int32, device=dev)

    def scan_row(self, prev, halo_diag, i: int):
        """(diag, up, cummax of key) of row i from the previous row and
        the diagonal halo."""
        qc = self.queries[:, i - 1:i]
        sub = torch.where(self.ref == qc, self.match,
                          self.mismatch).to(torch.int32)
        diag = torch.cat([halo_diag[:, None], prev[:, :-1]], dim=1) + sub
        up = prev + self.indel
        c0 = torch.clamp(torch.maximum(diag, up), min=0)
        c0 = torch.where(self.valid, c0, 0)
        run = torch.cummax(c0 - self.indel * self.jglob, dim=1).values
        return diag, up, run

    def row(self, run, cin):
        """Row i's dp from its local cummax and the carry from the left."""
        return torch.maximum(run, cin[:, None]) + self.indel * self.jglob

    def codes(self, diag, up, row, halo_left, i: int) -> torch.Tensor:
        """Row i's codes; folds its first strict maximum over this block's
        columns into the running best."""
        left = torch.cat([halo_left[:, None], row[:, :-1]], dim=1) + self.indel
        code = _cascade(diag, up, left)
        code = torch.where((row > 0) & self.valid, code, 0).to(torch.uint8)
        masked = torch.where(self.valid, row, -1)
        l_arg = torch.argmax(masked, dim=1)
        l_max = masked.gather(1, l_arg[:, None])[:, 0]
        improve = (l_max > self.best) & (i <= self.q_len)
        self.best = torch.where(improve, l_max, self.best)
        self.bi = torch.where(improve, i, self.bi)
        self.bj = torch.where(improve, self.off + 1 + l_arg.to(torch.int32),
                              self.bj)
        return code

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
    cell (i, j)). None outside the mesh. Two exchanges a DP row.
    """
    _check_genome(mesh, genome_codes, axis)
    if not mesh.member:
        return None
    blk = _Block(mesh, axis, queries, q_len, genome_codes, g_len,
                 match_score, mismatch, indel)
    b, n_pad = blk.queries.shape
    dev = mesh.device
    left_of_me = (torch.arange(blk.n_dev, device=dev) < blk.index)[:, None]
    prev = torch.zeros((b, blk.ref.shape[1]), dtype=torch.int32, device=dev)
    halo = torch.zeros(b, dtype=torch.int32, device=dev)
    codes = torch.empty((n_pad, b, blk.ref.shape[1]), dtype=torch.uint8,
                        device=dev)
    for i in range(1, n_pad + 1):
        diag, up, run = blk.scan_row(prev, halo, i)
        totals = _comm.all_gather(run[:, -1][None], blk.line)     # (D, B)
        cin = torch.where(left_of_me, totals, NEG).max(dim=0).values
        prev = blk.row(run, cin)
        # this row's last column goes right: the left halo of row i and
        # the diagonal halo of row i + 1
        halo = _comm.ppermute_right(prev[:, -1].contiguous(), blk.line,
                                    blk.index)
        codes[i - 1] = blk.codes(diag, up, prev, halo, i)
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
    D - 1 steps. Same outputs; the queries are padded with PAD to a
    multiple of R = `rows_per_exchange` rows, and so are the codes' rows
    (slice [:n_pad] to compare)."""
    _check_genome(mesh, genome_codes, axis)
    if not mesh.member:
        return None
    queries = torch.as_tensor(queries, dtype=torch.int8)
    b, n_pad = queries.shape
    rows = max(1, min(rows_per_exchange, n_pad))
    n_blocks = -(-n_pad // rows)
    pad = n_blocks * rows - n_pad
    if pad:
        queries = torch.cat([queries, torch.full(
            (b, pad), int(PAD), dtype=torch.int8, device=queries.device)],
            dim=1)
    blk = _Block(mesh, axis, queries, q_len, genome_codes, g_len,
                 match_score, mismatch, indel)
    dev = mesh.device
    gb = blk.ref.shape[1]
    codes = torch.empty((n_blocks * rows, b, gb), dtype=torch.uint8,
                        device=dev)
    prev = torch.zeros((b, gb), dtype=torch.int32, device=dev)
    halo_diag0 = torch.zeros(b, dtype=torch.int32, device=dev)
    # (last columns, carries) of the block the left neighbour finished
    # last step; the rank at index 0 always holds zeros
    slab = torch.zeros((2, rows, b), dtype=torch.int32, device=dev)
    for t in range(n_blocks + blk.n_dev - 1):
        tb = t - blk.index
        out = torch.zeros_like(slab)
        if 0 <= tb < n_blocks:
            if tb == 0:                 # dp row 0 is the zero boundary
                prev.zero_()
                halo_diag0.zero_()
            for r in range(rows):
                i = tb * rows + r + 1
                halo_diag = halo_diag0 if r == 0 else slab[0, r - 1]
                diag, up, run = blk.scan_row(prev, halo_diag, i)
                cin = slab[1, r]
                prev = blk.row(run, cin)
                codes[i - 1] = blk.codes(diag, up, prev, slab[0, r], i)
                out[0, r] = prev[:, -1]
                out[1, r] = torch.maximum(cin, run[:, -1])
        # an idle rank's right neighbour is idle at the next step too, so
        # what an idle rank sends is never read
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
