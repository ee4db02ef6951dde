"""The sequence-parallel Smith-Waterman's step functions
(``genome_assembly_tpu_torch/ops/seqpar.py``) and a numpy model of their
CUDA kernel (``csrc/seqpar.cu``), on the CPU.

- The plain steps, composed into both variants on one CPU rank, equal the
  JAX package's ``local_align_batch_seqpar(_pipelined)`` at mesh 1 on
  tests/test_seqpar.py's shapes; composed over a world of 2 and 4 ranks
  simulated in this process, they equal them too.
- ``KernelModel`` walks a row as the kernel does: an item's block cut into
  S segments (``ops/seqpar.py::plan``, or a given S), a step's segment
  resident as one tile or any segment walked in tiles, each thread's chunk
  of adjacent columns scanned, the chunk totals through warp scans by
  shuffles and one array of warp totals, the carry into a segment from
  the totals of the segments to its left (the step's look-back, *post*'s
  reads of the segment totals *pre* left in `run`), both halos derived
  from that carry, a chunk's first column by the reference's cascade and
  the others by the row's equality with diag or up, and the best folded by
  value, then column within a block and by value, then row, then column
  across segments. At every step of every rank of the simulated worlds the
  model's outputs equal the plain step's, its *post* reading the `run` its
  own *pre* left (and the plain *pre*'s too), on ties in one row and
  across rows, PAD inside the genome, rows past q_len, columns past g_len,
  widths no tile, chunk or segment count divides, indel +1, -1 and -3,
  R = 1, 3 and 8, with three resident segments and with two segments
  walking tiles; at S = 1 and at 5 segments that do not divide the block;
  with a segment wholly past g_len; on a tie across a segment boundary;
  and at the kernel's own geometry at phase 8f's widths. A model without
  the carry fold within a segment, without the carry across segments, or
  folding the segments' best by arrival order differs.
- In a spawned world of 4 CPU ranks (meshes 2 and 4, indel -1 and +1) the
  left halo that *post* derives (cin + indel * off, 0 on rank 0) equals the
  last column the exchange brings, row by row, on every rank.

JAX and the JAX package are imported inside the functions that need them,
so that the spawned ranks (which import this module) and the card-only
tests in tests/test_torch_kernel_gpu.py (which import its model and
harness on a machine without JAX) import neither.
"""

import random

import numpy as np
import pytest
import torch

from genome_assembly_tpu_torch.core.encoding import PAD, encode, encode_batch
from genome_assembly_tpu_torch.ops import seqpar as steps

I32_MAX = 2**31 - 1
WORLD_TIMEOUT_S = 240


def random_dna(r, length):
    return "".join(r.choice("ACGT") for _ in range(length))


def _setup(seed, n_q, g_len, q_max, pad_to=4):
    """tests/test_seqpar.py::_setup from random.Random(seed): planted local
    hits with mismatches and random queries; the genome padded with PAD to
    a multiple of `pad_to`."""
    rng = random.Random(seed)
    genome = random_dna(rng, g_len)
    queries = []
    for _ in range(n_q):
        if rng.random() < 0.6:
            start = rng.randint(0, g_len - q_max)
            q = genome[start:start + rng.randint(5, q_max)]
            q = "".join(c if rng.random() > 0.1 else rng.choice("ACGT")
                        for c in q)
        else:
            q = random_dna(rng, rng.randint(5, q_max))
        queries.append(q)
    q, ql = encode_batch(queries, align="left")
    gp = -(-g_len // pad_to) * pad_to
    g_pad = np.full((gp,), PAD, np.int8)
    g_pad[:g_len] = encode(genome)
    return q, ql, g_pad, g_len


A = _setup(12345, n_q=12, g_len=200, q_max=40)      # the per-row test's
B = _setup(54321, n_q=10, g_len=192, q_max=37)      # the pipelined test's


def _ties():
    """A genome of a repeated 7-base motif: the queries' best scores tie
    across the columns of a row; a query X + 40 N + X, whose alignments
    cannot bridge the Ns at indel <= -1, ties across rows."""
    motif = "ACGGTCA"
    genome = motif * 13                                   # 91 bases
    queries = [motif, motif[2:] + motif[:3], "GTC",
               "GTCA" + "N" * 40 + "GTCA", motif * 2, "A"]
    q, ql = encode_batch(queries, align="left")
    g_pad = np.full((96,), PAD, np.int8)
    g_pad[:91] = encode(genome)
    return q, ql, g_pad, 91


def _pad_inside():
    """PAD (N) inside the genome and rows past q_len, whose query PAD
    meets the genome's PAD: those cells match."""
    rs = np.random.RandomState(5)
    q = rs.randint(0, 4, size=(7, 23)).astype(np.int8)
    ql = np.array([23, 0, 1, 9, 17, 22, 5], np.int32)
    q[np.arange(23)[None, :] >= ql[:, None]] = PAD
    q[3, 4] = PAD                                 # an N inside a query
    g_pad = rs.randint(0, 4, size=120).astype(np.int8)
    g_pad[[3, 17, 18, 60, 61, 62, 99]] = PAD
    g_pad[110:] = PAD
    q[0, :10] = g_pad[50:60]                      # a planted hit
    return q, ql, g_pad, 110


def _past_g_len():
    """g_len far below the padded genome: at 4 ranks the last block lies
    wholly past it and the one before partly."""
    rs = np.random.RandomState(8)
    g_pad = np.full((80,), PAD, np.int8)
    g_pad[:50] = rs.randint(0, 4, size=50)
    q, ql = encode_batch(["".join("ACGT"[c] for c in g_pad[20:44]),
                          "ACGTTGCA", "".join("ACGT"[c] for c in g_pad[40:50])
                          + "ACGTACGT"], align="left")
    return q, ql, g_pad, 50


MODEL_CASES = {"ties": _ties(), "pad inside": _pad_inside(),
               "past g_len": _past_g_len()}


# ---------------------------------------------------------------------------
# a world of D ranks simulated in this process, over any step functions
# ---------------------------------------------------------------------------

class _Rank:
    def __init__(self, d, gb, genome, b, device):
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        self.index, self.off = d, d * gb
        self.genome = genome[self.off:self.off + gb].contiguous()
        self.prev, self.run = z(b, gb), z(b, gb)
        self.halo = z(b)
        self.best, self.bi, self.bj = z(b), z(b), z(b)


def _resolve(ranks):
    """JAX's post-scan resolution: (value desc, row asc, rank asc)."""
    bests = torch.stack([r.best for r in ranks])
    bis = torch.stack([r.bi for r in ranks])
    bjs = torch.stack([r.bj for r in ranks])
    g_best = bests.max(dim=0).values
    masked = torch.where(bests == g_best[None, :], bis, 2**30)
    d_win = torch.argmin(masked, dim=0)[None, :]
    hit = g_best > 0
    return [g_best, torch.where(hit, bis.gather(0, d_win)[0], 0),
            torch.where(hit, bjs.gather(0, d_win)[0], 0)]


def run_per_row(pre, post, n_dev, inputs, pen, device="cpu"):
    """The per-row variant's schedule over n_dev ranks in order: each DP
    row, *pre* on every rank, the all-gather of the totals, *post* on every
    rank, the shift of the last columns to the right. Returns best, best_i,
    best_j and the global codes as numpy arrays."""
    q, ql, g_pad, g_len = inputs
    queries = torch.as_tensor(q, device=device)
    q_len = torch.as_tensor(ql, device=device)
    genome = torch.as_tensor(g_pad, device=device)
    b, n_pad = q.shape
    gb = len(g_pad) // n_dev
    ranks = [_Rank(d, gb, genome, b, device) for d in range(n_dev)]
    codes = torch.zeros((n_dev, n_pad, b, gb), dtype=torch.uint8,
                        device=device)
    for i in range(1, n_pad + 1):
        totals = torch.stack([pre(queries, i, r.genome, r.off, g_len,
                                  r.prev, r.halo, r.run, *pen)
                              for r in ranks])
        lasts = [post(queries, q_len, i, r.genome, r.off, g_len, r.index,
                      r.prev, r.halo, r.run, totals, codes[r.index, i - 1],
                      r.best, r.bi, r.bj, *pen) for r in ranks]
        for r in ranks:
            r.halo = (lasts[r.index - 1] if r.index
                      else torch.zeros_like(r.halo))
    codes = codes.permute(1, 2, 0, 3).reshape(n_pad, b, n_dev * gb)
    return [x.cpu().numpy() for x in (*_resolve(ranks), codes)]


def run_pipelined(step, n_dev, inputs, rows, pen, device="cpu"):
    """The pipelined variant's skewed schedule over n_dev ranks: at step t
    rank d runs row block t - d, then every rank's outgoing slab shifts to
    its right neighbour. The queries padded with PAD to n_blocks * rows
    rows. Returns best, best_i, best_j and the global codes (every row)."""
    q, ql, g_pad, g_len = inputs
    b, n_pad = q.shape
    rows = max(1, min(rows, n_pad))
    n_blocks = -(-n_pad // rows)
    qp = np.full((b, n_blocks * rows), PAD, np.int8)
    qp[:, :n_pad] = q
    queries = torch.as_tensor(qp, device=device)
    q_len = torch.as_tensor(ql, device=device)
    genome = torch.as_tensor(g_pad, device=device)
    gb = len(g_pad) // n_dev
    ranks = [_Rank(d, gb, genome, b, device) for d in range(n_dev)]
    codes = torch.zeros((n_dev, n_blocks * rows, b, gb), dtype=torch.uint8,
                        device=device)
    slabs = [torch.zeros((2, rows, b), dtype=torch.int32, device=device)
             for _ in ranks]
    for t in range(n_blocks + n_dev - 1):
        outs = []
        for r in ranks:
            tb = t - r.index
            out = torch.zeros_like(slabs[r.index])
            if 0 <= tb < n_blocks:
                if tb == 0:
                    r.prev.zero_()
                    r.halo.zero_()
                out = step(queries, q_len, tb * rows, r.genome, r.off, g_len,
                           r.prev, r.halo, slabs[r.index], codes[r.index],
                           r.best, r.bi, r.bj, *pen)
            outs.append(out)
        for r in ranks:
            r.halo = slabs[r.index][0, rows - 1].clone()
        slabs = [outs[d - 1] if d else torch.zeros_like(outs[0])
                 for d in range(n_dev)]
    codes = codes.permute(1, 2, 0, 3).reshape(n_blocks * rows, b,
                                              n_dev * gb)
    return [x.cpu().numpy() for x in (*_resolve(ranks), codes)]


class Paired:
    """Step functions that run `other` on copies of the inputs and `ref`
    on the inputs, and count every step where an output or an updated
    state differs (`diffs`; `steps` counts the steps).

    `run` is the kernel's scratch between *pre* and *post* (ops/seqpar.py):
    *pre* is held by its totals alone, and `other`'s *post* reads the `run`
    its own *pre* left (`own_scratch`, as on a rank), or else the copy of
    `ref`'s."""

    def __init__(self, ref, other, own_scratch=True):
        self.ref, self.other = ref, other
        self.own_scratch = own_scratch
        self.scratch = {}
        self.diffs = self.steps = 0

    def _run(self, name, args, mutable, run=None):
        clones = [a.clone() if torch.is_tensor(a) else a for a in args]
        if run is not None and self.own_scratch \
                and id(args[run]) in self.scratch:
            clones[run] = self.scratch[id(args[run])]
        got = getattr(self.other, name)(*clones)
        want = getattr(self.ref, name)(*args)
        same = torch.equal(got.cpu(), want.cpu()) and all(
            torch.equal(clones[k].cpu(), args[k].cpu()) for k in mutable)
        self.steps += 1
        self.diffs += not same
        return want, clones

    def step(self, *args):
        # prev, codes, best, bi, bj
        return self._run("seqpar_step", args, (6, 9, 10, 11, 12))[0]

    def pre(self, *args):
        want, clones = self._run("seqpar_row_pre", args, ())
        self.scratch[id(args[7])] = clones[7]
        return want

    def post(self, *args):
        # prev, codes row, best, bi, bj
        return self._run("seqpar_row_post", args, (7, 11, 12, 13, 14),
                         run=9)[0]


class _Plain:
    seqpar_step = staticmethod(steps.seqpar_step_plain)
    seqpar_row_pre = staticmethod(steps.seqpar_row_pre_plain)
    seqpar_row_post = staticmethod(steps.seqpar_row_post_plain)


PLAIN = _Plain()


# ---------------------------------------------------------------------------
# the numpy model of csrc/seqpar.cu
# ---------------------------------------------------------------------------

def _cascade(diag, up, left):
    return np.where((diag >= up) & (diag >= left) & (diag >= 0), 1,
                    np.where((up >= left) & (up >= 0), 2,
                             np.where(left >= 0, 3, 0)))


class KernelModel:
    """The kernel's traversal in numpy, every item at once (the items'
    clusters are independent and take the same path).

    An item's block of Gb columns is cut into S segments of `seg` columns
    (``steps.plan``, or `segments` of them), one thread block each. A
    block's row is walked in chunks of adjacent columns, one a thread: a
    step's segment resident in shared memory as one tile of an odd
    ceil(seg / threads) columns a thread (seg <= threads * max_chunk), any
    other segment in tiles of threads * tile_chunk columns. Pass 1 scans a
    chunk's keys; the chunk totals join by warp scans by shuffles and one
    array of warp totals; the carry into a segment is the max of the totals
    of the segments left of it (the step's look-back through the cluster,
    *post*'s reads of `run`) and of the rank's carry; pass 2 writes the
    row, a chunk's first column by the reference's cascade and every other
    by the row's own equality with diag or up, and each thread's first
    strict maximum above the running best, which the block folds by value,
    then column. A segment's left halo is its carry + indel * (its first j
    - 1), its diagonal halo the one of the row before (the old row's at a
    step's first row). The segments' candidates are folded by value, then
    row, then column. `threads`, `tile_chunk`, `max_chunk` and `warp`: the
    kernel's kThreads, kTileChunk, kMaxChunk and the warp width; the tests
    also run smaller ones, so that small rows cross many segments, tiles,
    chunks and warps.

    Negative controls: `fold_carry=False` drops the fold of the threads and
    tiles before a chunk; `segment_carry=False` the totals of the segments
    to the left; `fold="arrival"` folds the segments' candidates in the
    order they come, a later equal value replacing an earlier one."""

    def __init__(self, threads=steps.THREADS, tile_chunk=steps.TILE_CHUNK,
                 max_chunk=steps.MAX_CHUNK, warp=32, segments=None,
                 fold_carry=True, segment_carry=True, fold="column"):
        assert threads % warp == 0 and threads // warp <= warp
        self.threads, self.warp = threads, warp
        self.tile_chunk, self.max_chunk = tile_chunk, max_chunk
        self.n_warps = threads // warp
        self.tile = threads * tile_chunk
        self.segments = segments
        self.fold_carry, self.segment_carry = fold_carry, segment_carry
        self.fold = fold

    # geometry

    def geometry(self, b, gb, step):
        """(S, seg, resident): the kernel's plan, or `segments` of them."""
        if self.segments is None:
            geo = steps.plan(b, gb, step)
            return geo.segments, geo.seg, geo.resident
        seg = -(-gb // min(self.segments, gb))
        return -(-gb // seg), seg, step and seg <= self.threads * \
            self.max_chunk

    def _tiles(self, n, resident):
        """(first column, width, columns a thread) of a segment's tiles."""
        if resident:
            return [(0, n, -(-n // self.threads) | 1)]
        return [(c, min(self.tile, n - c), self.tile_chunk)
                for c in range(0, n, self.tile)]

    # the warp-level folds

    def _shfl_up_scan(self, x):
        """Inclusive max scan over the last axis (a warp's lanes) by
        __shfl_up_sync steps d = 1, 2, 4, ...: each lane reads the value
        d lanes below as it was before the step."""
        d = 1
        while d < x.shape[-1]:
            y = x.copy()
            y[..., d:] = np.maximum(x[..., d:], x[..., :-d])
            x, d = y, d * 2
        return x

    def block_scan(self, tot):
        """block_scan: (B, threads) chunk totals -> each thread's exclusive
        prefix (NEG for thread 0) and the block's total."""
        b = tot.shape[0]
        incl = self._shfl_up_scan(tot.reshape(b, self.n_warps, self.warp))
        w = self._shfl_up_scan(incl[:, :, -1])
        excl = np.concatenate(
            [np.full((b, self.n_warps, 1), steps.NEG, np.int64),
             incl[:, :, :-1]], axis=2)
        prior = np.concatenate([np.full((b, 1), steps.NEG, np.int64),
                                w[:, :-1]], axis=1)
        return (np.maximum(excl, prior[:, :, None]).reshape(b, self.threads),
                w[:, -1])

    def block_best(self, bval, bcol):
        """block_best: __shfl_down_sync folds by (value desc, column asc)
        within each warp (a lane reading past the warp keeps its own),
        then thread 0 folds the warps in order."""
        b = bval.shape[0]
        v = bval.reshape(b, self.n_warps, self.warp)
        c = bcol.reshape(b, self.n_warps, self.warp)
        d = self.warp // 2
        while d:
            ov, oc = v.copy(), c.copy()
            ov[..., :-d], oc[..., :-d] = v[..., d:], c[..., d:]
            better = (ov > v) | ((ov == v) & (oc < c))
            v, c = np.where(better, ov, v), np.where(better, oc, c)
            d //= 2
        val, col = v[:, 0, 0], c[:, 0, 0]
        for w in range(1, self.n_warps):
            ov, oc = v[:, w, 0], c[:, w, 0]
            better = (ov > val) | ((ov == val) & (oc < col))
            val, col = np.where(better, ov, val), np.where(better, oc, col)
        return val, col

    # a tile: the chunks of the threads

    def _pass1(self, old, left_old, gen, qc, j, g_len, pen, cn):
        """Pass 1: diag, up, and each chunk's running key max (B, threads,
        cn), NEG past the tile."""
        match, mismatch, indel = pen
        b, n = old.shape
        sub = np.where(gen[None, :] == qc[:, None], match, mismatch)
        diag = np.concatenate([left_old[:, None], old[:, :-1]], axis=1) + sub
        up = old + indel
        c0 = np.where(j <= g_len, np.maximum(np.maximum(diag, up), 0), 0)
        key = np.full((b, self.threads * cn), steps.NEG, np.int64)
        key[:, :n] = c0 - indel * j
        return diag, up, np.maximum.accumulate(
            key.reshape(b, self.threads, cn), axis=2)

    def _segment_total(self, old, halo_diag, gen, qc, j, g_len, pen,
                       resident):
        """The totals sweep: the segment's key total of the row."""
        total = np.full(old.shape[0], steps.NEG, np.int64)
        for c, n, cn in self._tiles(old.shape[1], resident):
            left = halo_diag if c == 0 else old[:, c - 1]
            _, _, local = self._pass1(old[:, c:c + n], left, gen[c:c + n],
                                      qc, j[c:c + n], g_len, pen, cn)
            total = np.maximum(total, self.block_scan(local[:, :, -1])[1])
        return total

    def _segment_row(self, old, halo_diag, halo_left, cin, gen, qc, j,
                     g_len, pen, resident, thr, track):
        """The row sweep: the segment's row and codes, its key total, and
        the block's first strict maximum above `thr` where `track`, as
        (value, column) -- (thr, INT_MAX) where there is none."""
        indel = pen[2]
        b, width = old.shape
        row_out = np.empty_like(old)
        code_out = np.empty_like(old)
        carry = np.full(b, steps.NEG, np.int64)
        bval = np.repeat(thr[:, None], self.threads, axis=1)
        bcol = np.full((b, self.threads), I32_MAX, np.int64)
        for c, n, cn in self._tiles(width, resident):
            left_old = halo_diag if c == 0 else old[:, c - 1]
            jt, valid = j[c:c + n], j[c:c + n] <= g_len
            diag, up, local = self._pass1(old[:, c:c + n], left_old,
                                          gen[c:c + n], qc, jt, g_len, pen,
                                          cn)
            excl, tile_total = self.block_scan(local[:, :, -1])
            prefix = np.maximum(np.maximum(excl, carry[:, None]),
                                cin[:, None])
            if not self.fold_carry:
                prefix = np.repeat(cin[:, None], self.threads, axis=1)
            row = (np.maximum(local, prefix[:, :, None])
                   .reshape(b, -1)[:, :n] + indel * jt)
            firsts = np.arange(0, n, cn)
            m_init = prefix[:, firsts // cn] + indel * (jt[firsts] - 1)
            left = np.empty_like(row)
            left[:, 1:] = row[:, :-1] + indel
            left[:, firsts] = m_init + indel
            if c == 0:
                left[:, 0] = halo_left + indel
            first = np.zeros(n, bool)
            first[firsts] = True
            code = np.where(first, _cascade(diag, up, left),
                            np.where(diag == row, 1,
                                     np.where(up == row, 2, 3)))
            code_out[:, c:c + n] = np.where((row > 0) & valid, code, 0)
            row_out[:, c:c + n] = row
            # each thread's maximum over its chunk, searched when above
            # its running best
            rv = np.full((b, self.threads * cn), -1, np.int64)
            rv[:, :n] = np.where(valid, row, -1)
            rv = rv.reshape(b, self.threads, cn)
            tmax, targ = rv.max(axis=2), rv.argmax(axis=2)
            upd = track[:, None] & (tmax > bval)
            bval = np.where(upd, tmax, bval)
            bcol = np.where(upd, c + np.arange(self.threads) * cn + targ,
                            bcol)
            carry = np.maximum(carry, tile_total)
        val, col = self.block_best(bval, bcol)
        found = track & (val > thr)
        return (row_out, code_out, carry, np.where(found, val, thr),
                np.where(found, col, I32_MAX))

    def _better(self, ov, okey, v, key):
        """The fold of the segments' candidates: (value desc, then each key
        asc), or a later equal value replacing (`fold="arrival"`)."""
        if self.fold == "arrival":
            return ov >= v
        out = ov > v
        tie = ov == v
        for a, b in zip(okey, key):
            out |= tie & (a < b)
            tie &= a == b
        return out

    def _segments(self, gb, s_count, seg):
        return [(s * seg, min(seg, gb - s * seg)) for s in range(s_count)]

    def _carries(self, cin0, totals):
        """The carry into each segment: cin0 and the totals to its left."""
        out, acc = [], cin0.copy()
        for t in totals:
            out.append(acc.copy() if self.segment_carry else cin0.copy())
            acc = np.maximum(acc, t)
        return out

    # the three launch entries, with the plain versions' arguments

    def seqpar_step(self, queries, q_len, row0, genome, off, g_len, prev,
                    halo_diag0, slab, codes, best, bi, bj, *pen):
        t = _Numpy(queries=queries, q_len=q_len, genome=genome, prev=prev,
                   halo=halo_diag0, slab=slab, codes=codes, best=best,
                   bi=bi, bj=bj)
        rows = slab.shape[1]
        b, gb = t.prev.shape
        indel = pen[2]
        s_count, seg, resident = self.geometry(b, gb, True)
        segs = self._segments(gb, s_count, seg)
        j = off + 1 + np.arange(gb)
        flat = t.codes.reshape(-1)
        # the old value left of each segment, read before any is rewritten
        diag_halo = [t.halo.copy()] + [t.prev[:, c0 - 1].copy()
                                       for c0, _ in segs[1:]]
        best0 = t.best.copy()
        cand = [(best0.copy(), np.full(b, I32_MAX, np.int64),
                 np.full(b, I32_MAX, np.int64)) for _ in segs]
        out = np.zeros((2, rows, b), np.int64)
        for r in range(rows):
            i = row0 + r + 1
            qc = t.queries[:, i - 1]
            track = i <= t.q_len
            old = t.prev.copy()
            totals = [self._segment_total(
                old[:, c0:c0 + n], diag_halo[s], t.genome[c0:c0 + n], qc,
                j[c0:c0 + n], g_len, pen, resident)
                for s, (c0, n) in enumerate(segs)]
            cins = self._carries(t.slab[1, r], totals)
            for s, (c0, n) in enumerate(segs):
                halo_left = (t.slab[0, r] if s == 0
                             else cins[s] + indel * (off + c0))
                val, srow, scol = cand[s]
                row, code, _, v, col = self._segment_row(
                    old[:, c0:c0 + n], diag_halo[s], halo_left, cins[s],
                    t.genome[c0:c0 + n], qc, j[c0:c0 + n], g_len, pen,
                    resident, val, track)
                t.prev[:, c0:c0 + n] = row
                flat[(((i - 1) * b + np.arange(b))[:, None] * gb
                      + c0 + np.arange(n)[None, :])] = code
                upd = v > val
                cand[s] = (np.where(upd, v, val), np.where(upd, i, srow),
                           np.where(upd, c0 + col, scol))
                diag_halo[s] = halo_left
            carry = np.maximum(cins[-1], totals[-1])
            out[0, r], out[1, r] = carry + indel * (off + gb), carry
        v, row, col = best0.copy(), np.full(b, I32_MAX), np.full(b, I32_MAX)
        for ov, orow, ocol in cand:
            take = (ov > best0) & self._better(ov, (orow, ocol), v,
                                               (row, col))
            v, row, col = (np.where(take, ov, v), np.where(take, orow, row),
                           np.where(take, ocol, col))
        hit = v > best0
        t.best[:] = np.where(hit, v, best0)
        t.bi[:] = np.where(hit, row, t.bi)
        t.bj[:] = np.where(hit, off + 1 + col, t.bj)
        t.write_back(codes=flat.reshape(codes.shape))
        return torch.from_numpy(out.astype(np.int32))

    def seqpar_row_pre(self, queries, i, genome, off, g_len, prev,
                       halo_diag, run, *pen):
        t = _Numpy(queries=queries, genome=genome, prev=prev,
                   halo=halo_diag, run=run)
        b, gb = t.prev.shape
        s_count, seg, _ = self.geometry(b, gb, False)
        j = off + 1 + np.arange(gb)
        total = np.full(b, steps.NEG, np.int64)
        for c0, n in self._segments(gb, s_count, seg):
            halo = t.halo if c0 == 0 else t.prev[:, c0 - 1]
            seg_total = self._segment_total(
                t.prev[:, c0:c0 + n], halo, t.genome[c0:c0 + n],
                t.queries[:, i - 1], j[c0:c0 + n], g_len, pen, False)
            t.run[:, c0 + n - 1] = seg_total     # the only words written
            total = np.maximum(total, seg_total)
        t.write_back()
        return torch.from_numpy(total.astype(np.int32))

    def seqpar_row_post(self, queries, q_len, i, genome, off, g_len, index,
                        prev, halo_diag, run, totals, codes_row, best, bi,
                        bj, *pen):
        t = _Numpy(queries=queries, q_len=q_len, genome=genome, prev=prev,
                   halo=halo_diag, run=run, totals=totals, codes=codes_row,
                   best=best, bi=bi, bj=bj)
        b, gb = t.prev.shape
        indel = pen[2]
        s_count, seg, _ = self.geometry(b, gb, False)
        segs = self._segments(gb, s_count, seg)
        j = off + 1 + np.arange(gb)
        cin_rank = np.full(b, steps.NEG, np.int64)
        for d in range(index):
            cin_rank = np.maximum(cin_rank, t.totals[d])
        cins = self._carries(cin_rank, [t.run[:, c0 + n - 1]
                                        for c0, n in segs])
        old = t.prev.copy()
        track = i <= t.q_len
        best0 = t.best.copy()
        v, col = best0.copy(), np.full(b, I32_MAX, np.int64)
        for s, (c0, n) in enumerate(segs):
            if s:
                halo_left = cins[s] + indel * (off + c0)
            else:
                halo_left = (np.zeros(b, np.int64) if index == 0
                             else cin_rank + indel * off)
            halo = t.halo if s == 0 else old[:, c0 - 1]
            row, code, carry, sv, scol = self._segment_row(
                old[:, c0:c0 + n], halo, halo_left, cins[s],
                t.genome[c0:c0 + n], t.queries[:, i - 1], j[c0:c0 + n],
                g_len, pen, False, best0, track)
            t.prev[:, c0:c0 + n] = row
            t.codes[:, c0:c0 + n] = code
            take = (sv > best0) & self._better(sv, (c0 + scol,), v, (col,))
            v, col = np.where(take, sv, v), np.where(take, c0 + scol, col)
        last = np.maximum(cins[-1], carry) + indel * (off + gb)
        hit = v > best0
        t.best[:] = np.where(hit, v, best0)
        t.bi[:] = np.where(hit, i, t.bi)
        t.bj[:] = np.where(hit, off + 1 + col, t.bj)
        t.write_back()
        return torch.from_numpy(last.astype(np.int32))


class _Numpy:
    """int64 numpy copies of the named tensors, written back in place."""

    def __init__(self, **tensors):
        self._tensors = tensors
        for name, x in tensors.items():
            setattr(self, name, x.cpu().numpy().astype(np.int64))

    def write_back(self, **override):
        for name, x in self._tensors.items():
            if name in ("queries", "q_len", "genome", "halo", "slab",
                        "totals"):
                continue
            value = override.get(name, getattr(self, name))
            x.copy_(torch.from_numpy(np.asarray(value)).to(x.dtype))


# ---------------------------------------------------------------------------
# the JAX package's answers (imported here only: see the module docstring)
# ---------------------------------------------------------------------------

_JAX = {}


def jax_seqpar(name, inputs_key, indel=-1, rows=None):
    """The JAX package's variant at mesh 1 on the named inputs."""
    key = (name, inputs_key, indel, rows)
    if key not in _JAX:
        import jax.numpy as jnp

        from genome_assembly_tpu.parallel import mesh as jmesh
        from genome_assembly_tpu.parallel import seqpar as jseqpar

        q, ql, g_pad, g_len = {"A": A, "B": B, **MODEL_CASES}[inputs_key]
        kw = {"indel": indel}
        if rows is not None:
            kw["rows_per_exchange"] = rows
        out = getattr(jseqpar, name)(
            jmesh.make_mesh(1), jnp.asarray(q), jnp.asarray(ql),
            jnp.asarray(g_pad), g_len, **kw)
        _JAX[key] = [np.asarray(x) for x in out]
    return _JAX[key]


def _assert_equal(got, want, name, rows=None):
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 3 and rows is not None:
            g, w = g[:rows], w[:rows]
        np.testing.assert_array_equal(g, w, err_msg=f"{name}[{k}]")


PER_ROW = "local_align_batch_seqpar"
PIPELINED = "local_align_batch_seqpar_pipelined"


# ---------------------------------------------------------------------------
# the plain steps against the JAX package
# ---------------------------------------------------------------------------

def test_plain_steps_compose_to_jax_per_row_on_one_cpu_rank():
    from genome_assembly_tpu_torch import parallel

    mesh = parallel.make_mesh(1, device="cpu")
    q, ql, g_pad, g_len = A
    steps.row_launches = 0
    got = parallel.local_align_batch_seqpar(mesh, q, ql, g_pad, g_len)
    want = jax_seqpar(PER_ROW, "A")
    _assert_equal([x.numpy() for x in got], want, "variant, mesh 1")
    assert steps.row_launches == 0               # the plain steps ran
    _assert_equal(run_per_row(steps.seqpar_row_pre_plain,
                              steps.seqpar_row_post_plain, 1, A,
                              (10, -1, -1)), want, "plain steps, 1 rank")


@pytest.mark.parametrize("rows", [4, 3])
def test_plain_steps_compose_to_jax_pipelined_on_one_cpu_rank(rows):
    """Equal to the JAX package's pipelined variant at mesh 1 on every row,
    the PAD-padded rows included (R = 3 pads 37 rows to 39)."""
    from genome_assembly_tpu_torch import parallel

    mesh = parallel.make_mesh(1, device="cpu")
    q, ql, g_pad, g_len = B
    steps.step_launches = 0
    got = parallel.local_align_batch_seqpar_pipelined(
        mesh, q, ql, g_pad, g_len, rows_per_exchange=rows)
    want = jax_seqpar(PIPELINED, "B", rows=rows)
    _assert_equal([x.numpy() for x in got], want, f"variant, R = {rows}")
    assert steps.step_launches == 0
    _assert_equal(run_pipelined(steps.seqpar_step_plain, 1, B, rows,
                                (10, -1, -1)), want, "plain steps, 1 rank")


@pytest.mark.parametrize("n_dev", [2, 4])
def test_plain_steps_over_a_simulated_world_equal_jax(n_dev):
    """The steps composed over n_dev ranks (the exchanges simulated in
    order) give the JAX package's answers: both variants, R = 8."""
    pen = (10, -1, -1)
    _assert_equal(run_per_row(steps.seqpar_row_pre_plain,
                              steps.seqpar_row_post_plain, n_dev, A, pen),
                  jax_seqpar(PER_ROW, "A"), f"per-row, {n_dev} ranks")
    _assert_equal(run_pipelined(steps.seqpar_step_plain, n_dev, B, 8, pen),
                  jax_seqpar(PER_ROW, "B"), f"pipelined, {n_dev} ranks",
                  rows=B[0].shape[1])


def test_wrappers_take_the_plain_versions_on_the_cpu_and_refuse_nothing():
    """A CPU tensor runs the plain version; check_range refuses only on a
    CUDA device (no card is touched to decide it)."""
    q, ql, g_pad, g_len = _ties()
    pen = (10, -1, -1)
    steps.step_launches = steps.row_launches = 0
    a = run_per_row(steps.seqpar_row_pre, steps.seqpar_row_post, 2,
                    (q, ql, g_pad, g_len), pen)
    b = run_per_row(steps.seqpar_row_pre_plain, steps.seqpar_row_post_plain,
                    2, (q, ql, g_pad, g_len), pen)
    c = run_pipelined(steps.seqpar_step, 2, (q, ql, g_pad, g_len), 3, pen)
    _assert_equal(a, b, "wrappers on the CPU")
    _assert_equal(c, b, "pipelined wrapper on the CPU", rows=q.shape[1])
    assert steps.step_launches == steps.row_launches == 0
    steps.check_range("cpu", 256, 2**26, 10, -1, -1)
    steps.check_range("cuda", 256, 50_000, 10, -1, -1)
    with pytest.raises(ValueError, match="exact range"):
        steps.check_range("cuda", 256, 2**26, 10, -1, -1)
    with pytest.raises(ValueError, match="exact range"):
        steps.check_range(torch.device("cuda", 0), 10, 100, 10, -1, -2**25)


# ---------------------------------------------------------------------------
# the kernel's model against the plain steps
# ---------------------------------------------------------------------------

# two small geometries: three segments resident in shared memory, chunks
# of up to 5 columns a thread; two segments walking tiles of 4 columns
GEOMETRIES = {
    "resident S=3": {"threads": 4, "warp": 2, "tile_chunk": 3,
                     "max_chunk": 5, "segments": 3},
    "tiled S=2": {"threads": 4, "warp": 2, "tile_chunk": 1, "max_chunk": 1,
                  "segments": 2},
}
DEVICES = {"ties": 4, "pad inside": 3, "past g_len": 4}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("indel", [1, -1, -3])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_step_equals_plain_step(case, rows, indel, geometry):
    """At every active step of every rank of a simulated world, the
    model's step writes what the plain step writes; the variant equals the
    JAX package's per-row answer on the query rows."""
    n_dev = DEVICES[case]
    pen = (10, -1, indel)
    pair = Paired(PLAIN, KernelModel(**GEOMETRIES[geometry]))
    got = run_pipelined(pair.step, n_dev, MODEL_CASES[case], rows, pen)
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    _assert_equal(got, jax_seqpar(PER_ROW, case, indel=indel),
                  f"{case}, R = {rows}", rows=MODEL_CASES[case][0].shape[1])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("indel", [1, -1, -3])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_row_equals_plain_row(case, indel, geometry):
    """The model's pre and post write what the plain ones write, on every
    row of every rank, its post reading the `run` its pre left; the
    variant equals the JAX package's."""
    pen = (10, -1, indel)
    pair = Paired(PLAIN, KernelModel(**GEOMETRIES[geometry]))
    got = run_per_row(pair.pre, pair.post, DEVICES[case], MODEL_CASES[case],
                      pen)
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    _assert_equal(got, jax_seqpar(PER_ROW, case, indel=indel), case)


def _run_variant(variant, step_fns, n_dev, inputs, pen, rows=8):
    if variant == "per-row":
        return run_per_row(step_fns.pre, step_fns.post, n_dev, inputs, pen)
    return run_pipelined(step_fns.step, n_dev, inputs, rows, pen)


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_post_takes_the_plain_versions_run_too(variant):
    """The model's post on the copy of the plain pre's `run` (the whole
    local cummax) writes what it writes on its own pre's (the segment
    totals at the segments' last columns)."""
    pair = Paired(PLAIN, KernelModel(**GEOMETRIES["resident S=3"]),
                  own_scratch=False)
    _run_variant(variant, pair, 2, _ties(), (10, -1, -1))
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)


def _two_tiles():
    """Two ranks of 4,995 columns: the kernel's own geometry takes four
    segments of 1,249 columns a rank."""
    return _setup(777, n_q=4, g_len=9_990, q_max=24, pad_to=2)


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_kernel_model_at_the_kernels_geometry(variant):
    inputs = _two_tiles()
    assert steps.plan(4, 4_995, variant == "pipelined")[:3] == (
        4, 1_249, variant == "pipelined")
    pair = Paired(PLAIN, KernelModel())
    _run_variant(variant, pair, 2, inputs, (10, -1, -1))
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)


# phase 8f's widths: the 50 kb genome on one rank, and a rank's block of it
# at meshes 4 and 8, each with 64 items
WIDTHS_8F = {50_000: 6, 12_500: 6, 6_250: 6}


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
@pytest.mark.parametrize("width", sorted(WIDTHS_8F))
def test_kernel_model_at_the_kernels_own_s_at_the_8f_widths(width, variant):
    """64 items against one rank of each 8f width: the kernel's own plan
    (S = 6 segments, resident steps, tiles of 3,840 columns per-row),
    short queries (a few rows)."""
    geo = steps.plan(64, width, variant == "pipelined")
    assert geo.segments == WIDTHS_8F[width]
    assert geo.resident == (variant == "pipelined")
    inputs = _setup(8_000 + width, n_q=64, g_len=width, q_max=6, pad_to=1)
    pair = Paired(PLAIN, KernelModel())
    _run_variant(variant, pair, 1, inputs, (10, -1, -1))
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)


SEGMENT_CASE = {"threads": 4, "warp": 2, "tile_chunk": 3, "max_chunk": 7}


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
@pytest.mark.parametrize("segments", [1, 5])
def test_kernel_model_segments_that_do_not_divide_the_block(segments,
                                                           variant):
    """One rank of 96 columns in 5 segments (four of 20 and one of 16),
    and in one (a step's segment of 96 walks tiles, past 4 x 7 columns)."""
    pair = Paired(PLAIN, KernelModel(**SEGMENT_CASE, segments=segments))
    got = _run_variant(variant, pair, 1, _ties(), (10, -1, -1), rows=3)
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    _assert_equal(got, jax_seqpar(PER_ROW, "ties"), "ties, mesh 1",
                  rows=_ties()[0].shape[1])


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_kernel_model_segment_wholly_past_g_len(variant):
    """One rank of 80 columns, g_len 50, in 4 segments: the last lies
    wholly past g_len, the one before partly."""
    pair = Paired(PLAIN, KernelModel(**SEGMENT_CASE, segments=4))
    got = _run_variant(variant, pair, 1, _past_g_len(), (10, -1, -1))
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    _assert_equal(got, jax_seqpar(PER_ROW, "past g_len"), "past g_len",
                  rows=_past_g_len()[0].shape[1])


def _tie_rows(inputs, segments):
    """(item, row) pairs where the plain row scan's maximum over a rank of
    the whole block lies in more than one of `segments` segments."""
    q, ql, g_pad, g_len = inputs
    b, n_pad = q.shape
    prev = torch.zeros((b, len(g_pad)), dtype=torch.int32)
    seg = -(-len(g_pad) // segments)
    found = []
    for i in range(1, n_pad + 1):
        run = torch.empty_like(prev)
        total = steps.seqpar_row_pre_plain(
            torch.as_tensor(q), i, torch.as_tensor(g_pad), 0, g_len, prev,
            torch.zeros(b, dtype=torch.int32), run)
        steps.seqpar_row_post_plain(
            torch.as_tensor(q), torch.as_tensor(ql), i,
            torch.as_tensor(g_pad), 0, g_len, 0, prev,
            torch.zeros(b, dtype=torch.int32), run, total[None],
            torch.empty((b, len(g_pad)), dtype=torch.uint8),
            *(torch.zeros(b, dtype=torch.int32) for _ in range(3)))
        row = prev[:, :g_len].numpy()
        for item in range(b):
            cols = np.flatnonzero(row[item] == row[item].max())
            if row[item].max() > 0 and len(set(cols // seg)) > 1:
                found.append((item, i))
    return found


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_kernel_model_tie_across_segments_takes_the_smaller_column(variant):
    """The ties case on one rank in 4 segments of 24 columns: a row's best
    score ties across segment boundaries, and the fold by value, then row,
    then column equals the plain steps; folding by arrival differs."""
    assert _tie_rows(_ties(), 4)
    pair = Paired(PLAIN, KernelModel(**SEGMENT_CASE, segments=4))
    got = _run_variant(variant, pair, 1, _ties(), (10, -1, -1))
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    _assert_equal(got, jax_seqpar(PER_ROW, "ties"), "ties, 4 segments",
                  rows=_ties()[0].shape[1])
    arrival = Paired(PLAIN, KernelModel(**SEGMENT_CASE, segments=4,
                                        fold="arrival"))
    _run_variant(variant, arrival, 1, _ties(), (10, -1, -1))
    assert arrival.diffs > 0


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_model_without_the_carry_fold_differs(variant):
    """Negative control: without folding the threads and tiles before a
    chunk into it, the model's steps differ from the plain ones."""
    pair = Paired(PLAIN, KernelModel(**GEOMETRIES["resident S=3"],
                                     fold_carry=False))
    _run_variant(variant, pair, 2, A, (10, -1, -1))
    assert pair.diffs > 0


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_model_without_the_segment_carry_differs(variant):
    """Negative control: a segment that ignores the totals of the segments
    to its left (the carry across segment boundaries) differs."""
    pair = Paired(PLAIN, KernelModel(**GEOMETRIES["resident S=3"],
                                     segment_carry=False))
    _run_variant(variant, pair, 2, A, (10, -1, -1))
    assert pair.diffs > 0


def test_model_block_best_breaks_ties_by_column_not_thread():
    """A tie held by a later thread at a smaller column wins."""
    m = KernelModel(threads=8, warp=4)
    val = np.array([[5, 7, 7, 2, 7, 1, 0, 7]], np.int64)
    col = np.array([[0, 40, 17, 3, 9, 5, 6, 30]], np.int64)
    v, c = m.block_best(val, col)
    assert (int(v[0]), int(c[0])) == (7, 9)


@pytest.mark.parametrize("step", [True, False])
def test_plan_fills_the_card_and_leaves_no_segment_empty(step):
    """The launch geometry: S = 6 for 64 items at every 8f width (384
    blocks, three an SM); 8 segments for one item; 2 for 150 items, unless
    a step's segment would not fit in shared memory; one past 396 items; a
    step's segment resident up to MAX_RESIDENT columns and tiled past it;
    every segment non-empty, S <= 8, B * S within BLOCKS_AN_SM blocks an SM
    where S > 1 (one wave), the block's shared memory within 227 KB."""
    for width in WIDTHS_8F:
        assert steps.plan(64, width, step).segments == 6
    assert steps.plan(1, 50_000, step).segments == 8
    assert steps.plan(150, 12_500, step).segments == 2
    assert steps.plan(150, 50_000, step).segments == (4 if step else 2)
    assert steps.plan(400, 12_500, step).segments == 1
    wide = steps.plan(2, 140_000, step)
    assert (wide.segments, wide.resident) == (8, False)
    for b in (1, 2, 7, 33, 64, 131, 132, 133, 200, 264, 265, 1000):
        for gb in (1, 2, 5, 24, 1_023, 1_024, 2_049, 4_995, 6_250, 12_500,
                   16_128, 16_129, 50_000, 129_024, 129_025, 140_000):
            geo = steps.plan(b, gb, step)
            assert 1 <= geo.segments <= steps.MAX_CLUSTER
            assert (geo.segments - 1) * geo.seg < gb <= geo.segments * geo.seg
            assert geo.resident == (step and geo.seg <= steps.MAX_RESIDENT)
            assert geo.blocks == b * geo.segments
            assert geo.smem <= 227 * 1024
            fit = min(steps.MAX_CLUSTER, -(-gb // steps.MAX_RESIDENT))
            if geo.segments > 1 and not (step and geo.segments == fit):
                assert geo.blocks <= steps.BLOCKS_AN_SM * steps.SMS


# ---------------------------------------------------------------------------
# post's derived halo against the exchange, in a spawned world
# ---------------------------------------------------------------------------

def halo_worker(cases):
    """A rank's entry: for each (n_dev, indel) runs the per-row variant on
    A, recording the totals *post* receives and the last column each
    exchange brings, row by row. Imports no JAX."""
    from genome_assembly_tpu_torch import parallel
    from genome_assembly_tpu_torch.parallel import _comm
    from genome_assembly_tpu_torch.parallel import seqpar as variants

    q, ql, g_pad, g_len = A
    out = {}
    post, shift = steps.seqpar_row_post, _comm.ppermute_right
    for n_dev, indel in cases:
        mesh = parallel.make_mesh(n_dev, device="cpu")
        seen = {"totals": [], "exchanged": [], "derived": []}

        def recording_post(*args):
            off, index, totals = args[4], args[6], args[10]
            seen["totals"].append((off, index, totals.clone()))
            seen["derived"].append(steps.left_halo(
                steps.fold_carry(totals, index), index, off, indel))
            return post(*args)

        def recording_shift(x, line, index):
            y = shift(x, line, index)
            seen["exchanged"].append(y.clone())
            return y

        steps.seqpar_row_post = recording_post
        _comm.ppermute_right = recording_shift
        try:
            res = variants.local_align_batch_seqpar(mesh, q, ql, g_pad,
                                                    g_len, indel=indel)
        finally:
            steps.seqpar_row_post = post
            _comm.ppermute_right = shift
        if res is None:
            out[n_dev, indel] = None
            continue
        off, index = seen["totals"][0][:2]
        out[n_dev, indel] = {
            "index": index, "off": off,
            "totals": np.stack([t.numpy() for _, _, t in seen["totals"]]),
            "derived": np.stack([h.numpy() for h in seen["derived"]]),
            "exchanged": np.stack([h.numpy() for h in seen["exchanged"]]),
            "best": [x.numpy() for x in res[:3]]}
    return out


HALO_CASES = [(2, -1), (2, 1), (4, -1), (4, 1)]


@pytest.fixture(scope="module")
def halo_world(tmp_path_factory):
    from genome_assembly_tpu_torch.parallel.spawn import spawn

    return spawn(halo_worker, 4, args=(HALO_CASES,), device="cpu",
                 timeout_s=WORLD_TIMEOUT_S,
                 workdir=str(tmp_path_factory.mktemp("halo")))


@pytest.mark.parametrize("n_dev,indel", HALO_CASES)
def test_post_derives_the_left_halo_the_exchange_brings(halo_world, n_dev,
                                                        indel):
    """Row by row on every rank: cin + indel * off (0 on rank 0), cin the
    max of the totals of the blocks to the left, equals the left
    neighbour's last column that the exchange after the row brings; the
    port's left_halo(fold_carry(...)) gives the same."""
    members = [r[n_dev, indel] for r in halo_world[:n_dev]]
    assert all(r[n_dev, indel] is None for r in halo_world[n_dev:])
    n_pad = A[0].shape[1]
    for rec in members:
        index, off = rec["index"], rec["off"]
        assert rec["totals"].shape == (n_pad, n_dev, A[0].shape[0])
        if index == 0:
            want = np.zeros_like(rec["exchanged"])
        else:
            cin = rec["totals"][:, :index].max(axis=1).astype(np.int64)
            want = cin + indel * off
        np.testing.assert_array_equal(rec["exchanged"], want)
        np.testing.assert_array_equal(rec["derived"], want)
    want = jax_seqpar(PER_ROW, "A", indel=indel)[:3]
    for rec in members:
        _assert_equal(rec["best"], want, f"mesh {n_dev}, indel {indel}")
