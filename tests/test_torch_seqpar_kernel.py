"""The sequence-parallel Smith-Waterman's step functions
(``genome_assembly_tpu_torch/ops/seqpar.py``) and a numpy model of their
CUDA kernel (``csrc/seqpar.cu``), on the CPU.

- The plain steps, composed into both variants on one CPU rank, equal the
  JAX package's ``local_align_batch_seqpar(_pipelined)`` at mesh 1 on
  tests/test_seqpar.py's shapes; composed over a world of 2 and 4 ranks
  simulated in this process, they equal them too.
- ``KernelModel`` walks a row as the kernel does: tiles of threads x chunk
  columns, each thread scanning its chunk of adjacent columns, the chunk
  totals through warp scans by shuffles and one array of warp totals, the
  exclusive prefix and the tiles' carry folded into each chunk, the row and
  its codes thread-strided with the old dp row kept in place for the next
  tile, each code written at the kernel's flat offset, and the best folded
  by value, then the smaller column. At every step of every rank of the
  simulated worlds the model's outputs equal the plain step's, on ties in
  one row and across rows, PAD inside the genome, rows past q_len, columns
  past g_len (a whole block past it), block widths no tile or chunk count
  divides, indel +1, -1 and -3, and R = 1, 3 and 8; once at the kernel's
  own geometry across two tiles. A model without the carry fold differs.
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

I32_MIN = -(2**31)
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
    state differs (`diffs`; `steps` counts the steps)."""

    def __init__(self, ref, other):
        self.ref, self.other = ref, other
        self.diffs = self.steps = 0

    def _run(self, name, args, mutable):
        clones = [a.clone() if torch.is_tensor(a) else a for a in args]
        got = getattr(self.other, name)(*clones)
        want = getattr(self.ref, name)(*args)
        same = torch.equal(got.cpu(), want.cpu()) and all(
            torch.equal(clones[k].cpu(), args[k].cpu()) for k in mutable)
        self.steps += 1
        self.diffs += not same
        return want

    def step(self, *args):
        # prev, codes, best, bi, bj
        return self._run("seqpar_step", args, (6, 9, 10, 11, 12))

    def pre(self, *args):
        return self._run("seqpar_row_pre", args, (7,))         # run

    def post(self, *args):
        # prev, codes row, best, bi, bj
        return self._run("seqpar_row_post", args, (7, 11, 12, 13, 14))


class _Plain:
    seqpar_step = staticmethod(steps.seqpar_step_plain)
    seqpar_row_pre = staticmethod(steps.seqpar_row_pre_plain)
    seqpar_row_post = staticmethod(steps.seqpar_row_post_plain)


PLAIN = _Plain()


# ---------------------------------------------------------------------------
# the numpy model of csrc/seqpar.cu
# ---------------------------------------------------------------------------

class KernelModel:
    """The kernel's traversal in numpy, every item's block at once (the
    blocks are independent and take the same path). `threads`, `chunk`
    and `warp`: the kernel's kThreads, kChunk and the warp width; the
    tests also run smaller ones, so that small rows cross many tiles,
    chunks and warps. `fold_carry=False` drops the fold of the threads
    and tiles before a chunk (the negative control)."""

    def __init__(self, threads=steps.THREADS, chunk=steps.CHUNK, warp=32,
                 fold_carry=True):
        assert threads % warp == 0 and threads // warp <= warp
        self.threads, self.chunk, self.warp = threads, chunk, warp
        self.n_warps = threads // warp
        self.tile = threads * chunk
        self.fold_carry = fold_carry

    def _shfl_up_scan(self, x):
        """Inclusive max scan over the last axis (a warp's lanes) by
        __shfl_up_sync steps d = 1, 2, 4, ...: each lane reads the value
        d lanes below as it was before the step."""
        d = 1
        while d < self.warp:
            y = x.copy()
            y[..., d:] = np.maximum(x[..., d:], x[..., :-d])
            x, d = y, d * 2
        return x

    def scan_tile(self, s_prev, ref, qc, j0, g_len, pen, carry):
        """scan_tile: the tile's cummax of the key with the carry of the
        tiles before it folded in, and the carry through the tile."""
        match, mismatch, indel = pen
        b, n = s_prev.shape[0], ref.shape[0]
        j = j0 + np.arange(n)
        sub = np.where(ref[None, :] == qc[:, None], match, mismatch)
        diag = s_prev[:, :-1] + sub
        up = s_prev[:, 1:] + indel
        c = np.where(j <= g_len, np.maximum(np.maximum(diag, up), 0), 0)
        key = np.full((b, self.tile), I32_MIN, np.int64)
        key[:, :n] = c - indel * j
        local = np.maximum.accumulate(
            key.reshape(b, self.threads, self.chunk), axis=2)
        incl = self._shfl_up_scan(
            local[:, :, -1].reshape(b, self.n_warps, self.warp))
        lanes = np.full((b, self.warp), I32_MIN, np.int64)
        lanes[:, :self.n_warps] = incl[:, :, -1]
        warp_incl = self._shfl_up_scan(lanes)[:, :self.n_warps]
        excl = np.concatenate(
            [np.full((b, self.n_warps, 1), I32_MIN, np.int64),
             incl[:, :, :-1]], axis=2)
        prior = np.concatenate([np.full((b, 1), I32_MIN, np.int64),
                                warp_incl[:, :-1]], axis=1)
        before = np.maximum(np.maximum(excl, prior[:, :, None]),
                            carry[:, None, None])
        if self.fold_carry:
            local = np.maximum(local, before.reshape(b, self.threads, 1))
        run = local.reshape(b, self.tile)[:, :n]
        return run, np.maximum(carry, warp_incl[:, -1])

    def emit_tile(self, s_prev, run, ref, qc, c0, j0, g_len, pen, cin,
                  left_new, bval, bcol):
        """emit_tile: the row, its codes, and each thread's first strict
        maximum over its columns (thread k mod threads), in its order."""
        match, mismatch, indel = pen
        n = run.shape[1]
        j = j0 + np.arange(n)
        row = np.maximum(run, cin[:, None]) + indel * j
        left = np.concatenate(
            [left_new[:, None],
             np.maximum(run[:, :-1], cin[:, None]) + indel * j[:-1]],
            axis=1) + indel
        sub = np.where(ref[None, :] == qc[:, None], match, mismatch)
        diag = s_prev[:, :-1] + sub
        up = s_prev[:, 1:] + indel
        code = np.where((diag >= up) & (diag >= left) & (diag >= 0), 1,
                        np.where((up >= left) & (up >= 0), 2,
                                 np.where(left >= 0, 3, 0)))
        valid = j <= g_len
        code = np.where((row > 0) & valid, code, 0)
        for first in range(0, n, self.threads):
            ks = first + np.arange(self.threads)
            ok = ks < n
            kc = np.minimum(ks, n - 1)
            vals = row[:, kc]
            upd = ok & valid[kc] & (vals > bval)
            bval = np.where(upd, vals, bval)
            bcol = np.where(upd, c0 + kc, bcol)
        return row, code, bval, bcol

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

    def _tiles(self, gb):
        for c0 in range(0, gb, self.tile):
            yield c0, min(self.tile, gb - c0)

    def _fold_best(self, bval, bcol, i, q_len, off, best, bi, bj):
        val, col = self.block_best(bval, bcol)
        improve = (val > best) & (i <= q_len)
        best[:] = np.where(improve, val, best)
        bi[:] = np.where(improve, i, bi)
        bj[:] = np.where(improve, off + 1 + col, bj)

    def _new_best(self, b):
        return (np.full((b, self.threads), -1, np.int64),
                np.full((b, self.threads), I32_MAX, np.int64))

    def full_row(self, queries, q_len, i, genome, off, g_len, prev, codes,
                 halo_diag, halo_left, cin, best, bi, bj, pen):
        """full_row (the step's row): scan and emit tile by tile, the row
        over prev in place, each code at its flat offset ((i - 1) * B +
        b) * Gb + c of `codes` (flat); returns (last, carry)."""
        b, gb = prev.shape
        qc = queries[:, i - 1]
        left_old, left_new = halo_diag.copy(), halo_left.copy()
        carry = np.full(b, I32_MIN, np.int64)
        bval, bcol = self._new_best(b)
        for c0, n in self._tiles(gb):
            j0 = off + 1 + c0
            s_prev = np.concatenate([left_old[:, None], prev[:, c0:c0 + n]],
                                    axis=1)
            run, carry = self.scan_tile(s_prev, genome[c0:c0 + n], qc, j0,
                                        g_len, pen, carry)
            row, code, bval, bcol = self.emit_tile(
                s_prev, run, genome[c0:c0 + n], qc, c0, j0, g_len, pen, cin,
                left_new, bval, bcol)
            prev[:, c0:c0 + n] = row
            flat = (((i - 1) * b + np.arange(b))[:, None] * gb
                    + c0 + np.arange(n)[None, :])
            codes[flat] = code
            left_old = s_prev[:, n]
            left_new = np.maximum(run[:, n - 1], cin) + pen[2] * (j0 + n - 1)
        self._fold_best(bval, bcol, i, q_len, off, best, bi, bj)
        return left_new, carry

    # the three launch entries, with the plain versions' arguments

    def seqpar_step(self, queries, q_len, row0, genome, off, g_len, prev,
                    halo_diag0, slab, codes, best, bi, bj, *pen):
        t = _Numpy(queries=queries, q_len=q_len, genome=genome, prev=prev,
                   halo=halo_diag0, slab=slab, codes=codes, best=best,
                   bi=bi, bj=bj)
        rows, b = slab.shape[1], prev.shape[0]
        flat = t.codes.reshape(-1)
        out = np.zeros((2, rows, b), np.int64)
        for r in range(rows):
            halo_diag = t.halo if r == 0 else t.slab[0, r - 1]
            cin = t.slab[1, r]
            last, carry = self.full_row(
                t.queries, t.q_len, row0 + r + 1, t.genome, off, g_len,
                t.prev, flat, halo_diag, t.slab[0, r], cin, t.best, t.bi,
                t.bj, pen)
            out[0, r], out[1, r] = last, np.maximum(cin, carry)
        t.write_back(codes=flat.reshape(codes.shape))
        return torch.from_numpy(out.astype(np.int32))

    def seqpar_row_pre(self, queries, i, genome, off, g_len, prev,
                       halo_diag, run, *pen):
        t = _Numpy(queries=queries, genome=genome, prev=prev,
                   halo=halo_diag, run=run)
        b = t.prev.shape[0]
        left_old = t.halo.copy()
        carry = np.full(b, I32_MIN, np.int64)
        for c0, n in self._tiles(t.prev.shape[1]):
            s_prev = np.concatenate([left_old[:, None],
                                     t.prev[:, c0:c0 + n]], axis=1)
            t.run[:, c0:c0 + n], carry = self.scan_tile(
                s_prev, t.genome[c0:c0 + n], t.queries[:, i - 1],
                off + 1 + c0, g_len, pen, carry)
            left_old = s_prev[:, n]
        t.write_back()
        return torch.from_numpy(carry.astype(np.int32))

    def seqpar_row_post(self, queries, q_len, i, genome, off, g_len, index,
                        prev, halo_diag, run, totals, codes_row, best, bi,
                        bj, *pen):
        t = _Numpy(queries=queries, q_len=q_len, genome=genome, prev=prev,
                   halo=halo_diag, run=run, totals=totals, codes=codes_row,
                   best=best, bi=bi, bj=bj)
        b, gb = t.prev.shape
        cin = np.full(b, steps.NEG, np.int64)
        for d in range(index):
            cin = np.maximum(cin, t.totals[d])
        left_new = (np.zeros(b, np.int64) if index == 0
                    else cin + pen[2] * off)
        left_old = t.halo.copy()
        qc = t.queries[:, i - 1]
        bval, bcol = self._new_best(b)
        flat = t.codes.reshape(-1)
        for c0, n in self._tiles(gb):
            j0 = off + 1 + c0
            s_prev = np.concatenate([left_old[:, None],
                                     t.prev[:, c0:c0 + n]], axis=1)
            run_t = t.run[:, c0:c0 + n]
            row, code, bval, bcol = self.emit_tile(
                s_prev, run_t, t.genome[c0:c0 + n], qc, c0, j0, g_len, pen,
                cin, left_new, bval, bcol)
            t.prev[:, c0:c0 + n] = row
            flat[(np.arange(b)[:, None] * gb + c0
                  + np.arange(n)[None, :])] = code
            left_old = s_prev[:, n]
            left_new = np.maximum(run_t[:, n - 1], cin) + pen[2] * (j0 + n
                                                                   - 1)
        self._fold_best(bval, bcol, i, t.q_len, off, t.best, t.bi, t.bj)
        t.write_back(codes=flat.reshape(codes_row.shape))
        return torch.from_numpy(left_new.astype(np.int32))


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

SMALL = {"threads": 8, "chunk": 3, "warp": 4}     # tiles of 24 columns
DEVICES = {"ties": 4, "pad inside": 3, "past g_len": 4}


@pytest.mark.parametrize("indel", [1, -1, -3])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_step_equals_plain_step(case, rows, indel):
    """At every active step of every rank of a simulated world, the
    model's step writes what the plain step writes; the variant equals the
    JAX package's per-row answer on the query rows."""
    n_dev = DEVICES[case]
    pen = (10, -1, indel)
    pair = Paired(PLAIN, KernelModel(**SMALL))
    got = run_pipelined(pair.step, n_dev, MODEL_CASES[case], rows, pen)
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    _assert_equal(got, jax_seqpar(PER_ROW, case, indel=indel),
                  f"{case}, R = {rows}", rows=MODEL_CASES[case][0].shape[1])


@pytest.mark.parametrize("indel", [1, -1, -3])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_row_equals_plain_row(case, indel):
    """The model's pre and post write what the plain ones write, on every
    row of every rank; the variant equals the JAX package's."""
    pen = (10, -1, indel)
    pair = Paired(PLAIN, KernelModel(**SMALL))
    got = run_per_row(pair.pre, pair.post, DEVICES[case], MODEL_CASES[case],
                      pen)
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    _assert_equal(got, jax_seqpar(PER_ROW, case, indel=indel), case)


def _two_tiles():
    """Two ranks of 5,000 columns: the kernel's own geometry (tiles of
    4,608) crosses a tile inside each block."""
    return _setup(777, n_q=4, g_len=9_990, q_max=24, pad_to=2)


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_kernel_model_at_the_kernels_geometry(variant):
    inputs = _two_tiles()
    pen = (10, -1, -1)
    pair = Paired(PLAIN, KernelModel())
    if variant == "per-row":
        run_per_row(pair.pre, pair.post, 2, inputs, pen)
    else:
        run_pipelined(pair.step, 2, inputs, 8, pen)
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)


@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_model_without_the_carry_fold_differs(variant):
    """Negative control: without folding the threads and tiles before a
    chunk into it, the model's steps differ from the plain ones."""
    pen = (10, -1, -1)
    pair = Paired(PLAIN, KernelModel(**SMALL, fold_carry=False))
    if variant == "per-row":
        run_per_row(pair.pre, pair.post, 2, A, pen)
    else:
        run_pipelined(pair.step, 2, A, 8, pen)
    assert pair.diffs > 0


def test_model_block_best_breaks_ties_by_column_not_thread():
    """A tie held by a later thread at a smaller column wins."""
    m = KernelModel(**SMALL)
    val = np.array([[5, 7, 7, 2, 7, 1, 0, 7]], np.int64)
    col = np.array([[0, 40, 17, 3, 9, 5, 6, 30]], np.int64)
    v, c = m.block_best(val, col)
    assert (int(v[0]), int(c[0])) == (7, 9)


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
