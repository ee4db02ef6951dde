"""One rank's DP work of the sequence-parallel Smith-Waterman between two
exchanges: a hand-written CUDA kernel for Hopper and its plain PyTorch
version.

``parallel/seqpar.py`` cuts the reference axis of the row scan into D
blocks, one a rank, and completes each DP row with exchanges along the mesh
axis. Between two exchanges a rank runs one of three steps, each here as a
launch entry of ``csrc/seqpar.cu`` (built with ``nvcc`` at first use) and a
plain version with the same arguments and results:

- ``seqpar_step``: the pipelined variant's step, R rows of the rank's
  block from the incoming (2, R, B) slab of left halos and carries; writes
  the R rows' codes, the outgoing slab, the last row and the best fold
  (replaces JAX ``parallel/seqpar.py:193`` ``_seqpar_body_pipelined``'s
  ``row_step`` scan);
- ``seqpar_row_pre`` / ``seqpar_row_post``: the per-row variant's two
  halves around the all-gather of the block totals (replace
  ``parallel/seqpar.py:49`` ``_seqpar_body``'s ``step``). *pre* leaves the
  local cummax of the left chain's key in the scratch ``run`` and returns
  the block's total; *post* folds the gathered totals of the blocks left
  of the rank into the carry, writes the row, its codes and the best fold,
  and returns the row's last column for the exchange.

The kernel cuts an item's block into S segments, one thread block each,
the S blocks of an item one cluster (``plan`` picks S and whether a
step's segment stays in shared memory). ``run`` is the kernel's scratch
between *pre* and *post*: the plain *pre* writes the whole local cummax
there, the kernel only each segment's key total at the segment's last
column, and *post* reads only those columns. The max of the totals of the
segments left of a segment is the local cummax at the column before it, so
the kernel's *post* gives the same row from either.

*post* derives the row's left halo instead of waiting for the exchange
that follows the row (``left_halo``): for a rank at index d >= 1 the left
neighbour's last value is max(its cummax total, its carry) + indel*off =
cin + indel*off exactly, because cin is the max of every key left of the
block and, inside ``check_range``'s range, every key lies above NEG, the
identity of the max; rank 0 reads the dp[.][0] = 0 boundary. The exchange
still runs, and its result is the next row's diagonal halo.

On a CUDA tensor each wrapper launches its kernel on the current stream,
without a synchronisation, and raises when the build or the launch fails;
on a CPU tensor it runs the plain version. There is no fallback between
the two. ``step_launches`` and ``row_launches`` count the launches (pre and
post one each).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from .._build import build_shared_library
from .overlap_allpairs import NVCC_FLAGS, _nvcc

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "seqpar.cu")
BUILD_TIMEOUT_S = 300
NEG = -(2**28)
# csrc/seqpar.cu's geometry: a block of THREADS threads takes one segment;
# each thread scans adjacent columns of it: TILE_CHUNK of a tile of TILE
# columns walked through global memory, or up to MAX_CHUNK of a segment of
# up to MAX_RESIDENT columns held in shared memory for a whole step. An
# item's S <= MAX_CLUSTER segments are one cluster; RING rows of carries
# between cluster barriers.
THREADS = 256
TILE_CHUNK = 15
TILE = THREADS * TILE_CHUNK
MAX_CHUNK = 63
MAX_RESIDENT = THREADS * MAX_CHUNK
MAX_CLUSTER = 8
RING = 16
# plan: B * S blocks fit BLOCKS_AN_SM blocks on each of the H100's SMS
# streaming multiprocessors, each segment at least MIN_SEGMENT columns. The
# step kernel is built for four blocks an SM (csrc kStepBlocksAnSm); three
# leave room for the clusters' packing into GPCs, so all of an 8f call's
# clusters fit at once.
SMS = 132
BLOCKS_AN_SM = 3
MIN_SEGMENT = 1024
# The kernel is exact while every dp value and key stays inside
# (-RANGE, RANGE), well above NEG (check_range).
RANGE = 2**27

# Kernel launches since the last reset; set to 0 to start counting.
step_launches = 0
row_launches = 0

_LIB = None


class Geometry(NamedTuple):
    """A launch's geometry: `segments` (S) blocks of THREADS threads and
    `seg` columns an item (the last one narrower), one cluster an item, B *
    S `blocks`; `resident`: a step's segment stays in shared memory (else
    it walks tiles); `smem`: dynamic shared memory a block, bytes."""

    segments: int
    seg: int
    resident: bool
    blocks: int
    smem: int


def _align16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(resident: bool, seg: int) -> int:
    """csrc smem_bytes: a resident segment's dp row, genome codes and code
    staging, or a streamed block's two tiles and staging; each region holds
    its global data at the same address mod 16."""
    if resident:
        return _align16(4 * seg + 16) + 2 * _align16(seg + 16)
    return 2 * (_align16(4 * TILE + 16) + _align16(TILE + 16)) \
        + _align16(TILE + 16)


def plan(b: int, gb: int, step: bool) -> Geometry:
    """The kernel's geometry for B items on a block of Gb columns: the most
    segments S <= MAX_CLUSTER, and <= Gb // MIN_SEGMENT, for which the B * S
    blocks fit BLOCKS_AN_SM to a streaming multiprocessor (one wave), and
    at least one; a step (`step`) takes enough segments for one to fit in
    shared memory where MAX_CLUSTER of them can, and is resident when it
    does."""
    s = BLOCKS_AN_SM * SMS // max(b, 1)
    s = max(1, min(MAX_CLUSTER, s, gb // MIN_SEGMENT))
    if step:
        s = max(s, min(MAX_CLUSTER, -(-gb // MAX_RESIDENT)))
    seg = max(1, -(-gb // s))
    s = max(1, -(-gb // seg))                # none empty
    resident = step and seg <= MAX_RESIDENT
    return Geometry(s, seg, resident, b * s, smem_bytes(resident, seg))


def load_kernel():
    """Build (if needed) and load the kernel library; raises RuntimeError
    with nvcc's output when the build fails."""
    global _LIB
    if _LIB is None:
        path = build_shared_library("seqpar", SOURCE,
                                    [_nvcc(), *NVCC_FLAGS],
                                    timeout=BUILD_TIMEOUT_S)
        lib = ctypes.CDLL(path)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        head = [vp, ll, vp,      # queries, q_stride, q_len
                vp, i, i, i,     # genome block, Gb, off, g_len
                i, i]            # B, first row (1-based)
        pen = [i, i, i]          # match, mismatch, indel
        tail = [vp, i]           # stream, device index
        lib.seqpar_step_launch.argtypes = head + [
            i, i, i, i,          # R, S, seg, resident
            vp, vp, vp, vp,      # prev, halo_diag0, slab in, slab out
            vp,                  # codes (rows of the step)
            vp, vp, vp] + pen + tail     # best, best_i, best_j
        lib.seqpar_row_pre_launch.argtypes = head + [
            i, i,                # S, seg
            vp, vp, vp, vp] + pen + tail  # prev, halo_diag, run, total
        lib.seqpar_row_post_launch.argtypes = head + [
            i, i,                # S, seg
            vp, vp, vp,          # prev, halo_diag, run
            vp, i, i,            # totals (D, B), D, index
            vp, vp,              # codes row, last column out
            vp, vp, vp] + pen + tail
        lib.seqpar_constants.argtypes = [vp]
        lib.seqpar_max_active_clusters.argtypes = [i, i, i, i, i, vp]
        for fn in (lib.seqpar_step_launch, lib.seqpar_row_pre_launch,
                   lib.seqpar_row_post_launch, lib.seqpar_constants,
                   lib.seqpar_max_active_clusters):
            fn.restype = i
        _LIB = lib
    return _LIB


def max_active_clusters(kind: str, geo: Geometry, device: int = 0) -> int:
    """How many clusters of `geo` the card holds at once for the kernel of
    `kind` ("step", "pre" or "post"; cudaOccupancyMaxActiveClusters)."""
    out = ctypes.c_int(0)
    err = load_kernel().seqpar_max_active_clusters(
        ("step", "pre", "post").index(kind), geo.segments, int(geo.resident),
        geo.seg, device, ctypes.byref(out))
    _raise_on(err, f"{kind} occupancy")
    return out.value


def check_range(device, n_pad: int, gp: int, match_score: int,
                mismatch: int, indel: int) -> None:
    """Refuse, on a CUDA device, penalties and lengths outside the range on
    which the kernel is exact: max(|match|, |mismatch|, |indel|) * (n_pad +
    2 * gp + 2) < 2**27 bounds every dp value, key and carry well above
    NEG = -2**28. The plain versions follow the JAX package and refuse
    nothing."""
    if torch.device(device).type != "cuda":
        return
    m = max(abs(match_score), abs(mismatch), abs(indel))
    if m * (n_pad + 2 * gp + 2) >= RANGE:
        raise ValueError(
            f"seqpar scores of penalties ({match_score}, {mismatch}, "
            f"{indel}) over {n_pad} rows and {gp} columns leave the "
            f"kernel's exact range (< 2**27)")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the JAX bodies' arithmetic)
# ---------------------------------------------------------------------------

def _columns(genome, off: int, g_len: int):
    """(1, Gb) 1-based global columns of the block and their validity."""
    jglob = (off + 1 + torch.arange(genome.shape[0], dtype=torch.int32,
                                    device=genome.device))[None, :]
    return jglob, jglob <= g_len


def _diag_up(queries, i: int, genome, prev, halo_diag, match_score,
             mismatch, indel):
    """Row i's diagonal and up moves from the row above."""
    qc = queries[:, i - 1:i]
    sub = torch.where(genome[None, :] == qc, match_score,
                      mismatch).to(torch.int32)
    diag = torch.cat([halo_diag[:, None], prev[:, :-1]], dim=1) + sub
    return diag, prev + indel


def _scan(queries, i: int, genome, jglob, valid, prev, halo_diag,
          match_score, mismatch, indel):
    """(diag, up, local cummax of the key) of row i."""
    diag, up = _diag_up(queries, i, genome, prev, halo_diag, match_score,
                        mismatch, indel)
    c0 = torch.clamp(torch.maximum(diag, up), min=0)
    c0 = torch.where(valid, c0, 0)
    run = torch.cummax(c0 - indel * jglob, dim=1).values
    return diag, up, run


def _cascade(diag, up, left) -> torch.Tensor:
    """The reference's cascade (aligners.py:122-132) as uint8 codes."""
    return torch.where(
        (diag >= up) & (diag >= left) & (diag >= 0), 1,
        torch.where((up >= left) & (up >= 0), 2,
                    torch.where(left >= 0, 3, 0))).to(torch.uint8)


def _emit(diag, up, row, halo_left, valid, jglob, i: int, q_len, best, bi,
          bj, indel) -> torch.Tensor:
    """Row i's codes; folds its first strict maximum over the block's
    columns into best, bi and bj in place."""
    left = torch.cat([halo_left[:, None], row[:, :-1]], dim=1) + indel
    code = _cascade(diag, up, left)
    code = torch.where((row > 0) & valid, code, 0).to(torch.uint8)
    masked = torch.where(valid, row, -1)
    l_arg = torch.argmax(masked, dim=1)
    l_max = masked.gather(1, l_arg[:, None])[:, 0]
    improve = (l_max > best) & (i <= q_len)
    best.copy_(torch.where(improve, l_max, best))
    bi.copy_(torch.where(improve, i, bi))
    bj.copy_(torch.where(improve, jglob[0, l_arg], bj))
    return code


def fold_carry(totals, index: int):
    """The carry into the block at `index`: the max of the (D, B) block
    totals left of it, NEG where there are none (JAX `_seqpar_body`)."""
    left_of_me = (torch.arange(totals.shape[0], device=totals.device)
                  < index)[:, None]
    return torch.where(left_of_me, totals, NEG).max(dim=0).values


def left_halo(cin, index: int, off: int, indel: int):
    """The row's left halo, the left neighbour's last dp value of the row:
    cin + indel * off, and 0 at index 0 (the module docstring)."""
    if index == 0:
        return torch.zeros_like(cin)
    return cin + indel * off


def seqpar_step_plain(queries, q_len, row0: int, genome, off: int,
                      g_len: int, prev, halo_diag0, slab, codes, best, bi,
                      bj, match_score=10, mismatch=-1, indel=-1):
    """`seqpar_step` as torch ops: rows row0 + 1 .. row0 + R, R =
    slab.shape[1]."""
    jglob, valid = _columns(genome, off, g_len)
    out = torch.empty_like(slab)
    row = prev
    for r in range(slab.shape[1]):
        i = row0 + r + 1
        halo_diag = halo_diag0 if r == 0 else slab[0, r - 1]
        diag, up, run = _scan(queries, i, genome, jglob, valid, row,
                              halo_diag, match_score, mismatch, indel)
        cin = slab[1, r]
        row = torch.maximum(run, cin[:, None]) + indel * jglob
        codes[i - 1] = _emit(diag, up, row, slab[0, r], valid, jglob, i,
                             q_len, best, bi, bj, indel)
        out[0, r] = row[:, -1]
        out[1, r] = torch.maximum(cin, run[:, -1])
    prev.copy_(row)
    return out


def seqpar_row_pre_plain(queries, i: int, genome, off: int, g_len: int,
                         prev, halo_diag, run, match_score=10, mismatch=-1,
                         indel=-1):
    """`seqpar_row_pre` as torch ops."""
    jglob, valid = _columns(genome, off, g_len)
    _, _, local = _scan(queries, i, genome, jglob, valid, prev, halo_diag,
                        match_score, mismatch, indel)
    run.copy_(local)
    return run[:, -1].clone()


def seqpar_row_post_plain(queries, q_len, i: int, genome, off: int,
                          g_len: int, index: int, prev, halo_diag, run,
                          totals, codes_row, best, bi, bj, match_score=10,
                          mismatch=-1, indel=-1):
    """`seqpar_row_post` as torch ops."""
    jglob, valid = _columns(genome, off, g_len)
    diag, up = _diag_up(queries, i, genome, prev, halo_diag, match_score,
                        mismatch, indel)
    cin = fold_carry(totals, index)
    row = torch.maximum(run, cin[:, None]) + indel * jglob
    codes_row.copy_(_emit(diag, up, row, left_halo(cin, index, off, indel),
                          valid, jglob, i, q_len, best, bi, bj, indel))
    prev.copy_(row)
    return row[:, -1].clone()


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

def _check(queries, q_len, genome, off, g_len, state, int32s, match_score,
           mismatch, indel):
    """Raise on inputs the kernel does not take. Returns the CUDA device,
    or None on the CPU. `q_len` may be None; `state`: the (B, Gb) int32
    tensors; `int32s`: the other int32 tensors."""
    if queries.dim() != 2 or queries.dtype != torch.int8:
        raise ValueError("queries must be a (B, n_pad) int8 matrix")
    if genome.dim() != 1 or genome.dtype != torch.int8:
        raise ValueError("the genome block must be a (Gb,) int8 vector")
    b, n_pad = queries.shape
    gb = genome.shape[0]
    if q_len is not None and (tuple(q_len.shape) != (b,)
                              or q_len.dtype != torch.int32):
        raise ValueError("q_len must be a (B,) int32 vector")
    for t in state:
        if tuple(t.shape) != (b, gb) or t.dtype != torch.int32:
            raise ValueError(f"dp rows must be ({b}, {gb}) int32")
    for t in int32s:
        if t.dtype != torch.int32 or t.shape[-1] != b:
            raise ValueError("halos, carries, totals and the best fold "
                             "must be int32 over the B items")
    tensors = (queries, genome, *state, *int32s,
               *(() if q_len is None else (q_len,)))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on more than one device: {devices}")
    dev = queries.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    check_range(dev, n_pad, off + gb, match_score, mismatch, indel)
    if g_len < 0:
        raise ValueError(f"g_len must be >= 0, got {g_len}")
    return dev


def _stream(dev):
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch.cuda.current_stream(dev).cuda_stream, index


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"seqpar {name} kernel launch failed: cudaError "
                           f"{err}")


def seqpar_step(queries, q_len, row0: int, genome, off: int, g_len: int,
                prev, halo_diag0, slab, codes, best, bi, bj,
                match_score=10, mismatch=-1, indel=-1):
    """The pipelined variant's step: rows row0 + 1 .. row0 + R (R =
    slab.shape[1]) of the rank's block.

    Args:
        queries: (B, n_pad_R) int8 PAD-padded queries; q_len (B,) int32.
        genome: (Gb,) int8, the rank's block, whose first column is global
            column off + 1; g_len the true genome length.
        prev: (B, Gb) int32, row row0's dp on the block; updated in place
            to row row0 + R.
        halo_diag0: (B,) int32, the left neighbour's last dp of row row0.
        slab: (2, R, B) int32, the left neighbour's last columns and
            carries of these rows.
        codes: (n_rows, B, Gb) uint8; rows row0 .. row0 + R - 1 written.
        best, bi, bj: (B,) int32 running best fold, updated in place.

    Returns the outgoing (2, R, B) slab: each row's last dp value and
    max(carry, the block's cummax total).
    """
    global step_launches
    rows = slab.shape[1]
    if slab.dim() != 3 or slab.shape[0] != 2:
        raise ValueError("slab must be (2, R, B)")
    if codes.dim() != 3 or codes.dtype != torch.uint8 \
            or tuple(codes.shape[1:]) != (queries.shape[0], genome.shape[0]) \
            or row0 < 0 or row0 + rows > min(codes.shape[0],
                                             queries.shape[1]):
        raise ValueError("codes must be (n_rows, B, Gb) uint8 holding rows "
                         "row0 .. row0 + R - 1 of the queries")
    dev = _check(queries, q_len, genome, off, g_len, (prev,),
                 (halo_diag0, slab, best, bi, bj), match_score, mismatch,
                 indel)
    if dev is None:
        return seqpar_step_plain(queries, q_len, row0, genome, off, g_len,
                                 prev, halo_diag0, slab, codes, best, bi, bj,
                                 match_score, mismatch, indel)
    if not codes.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    out = torch.empty_like(slab)
    b, gb = prev.shape
    if b == 0 or rows == 0:
        return out.zero_()
    stream, index = _stream(dev)
    geo = plan(b, gb, step=True)
    err = load_kernel().seqpar_step_launch(
        queries.data_ptr(), queries.shape[1], q_len.data_ptr(),
        genome.data_ptr(), gb, off, g_len, b, row0 + 1, rows, geo.segments,
        geo.seg, int(geo.resident), prev.data_ptr(), halo_diag0.data_ptr(),
        slab.data_ptr(), out.data_ptr(), codes.data_ptr(), best.data_ptr(),
        bi.data_ptr(), bj.data_ptr(), match_score, mismatch, indel, stream,
        index)
    _raise_on(err, "step")
    step_launches += 1
    return out


def seqpar_row_pre(queries, i: int, genome, off: int, g_len: int, prev,
                   halo_diag, run, match_score=10, mismatch=-1, indel=-1):
    """The per-row variant's first half for row i: the local cummax of the
    left chain's key c0 - indel*j into the scratch `run` (B, Gb) int32, in
    place (the kernel: each segment's total at its last column only; the
    module docstring). Returns the block totals, the plain run[:, -1], (B,)
    for the all-gather."""
    global row_launches
    if not 1 <= i <= queries.shape[1]:
        raise ValueError(f"row {i} outside 1..{queries.shape[1]}")
    dev = _check(queries, None, genome, off, g_len, (prev, run),
                 (halo_diag,), match_score, mismatch, indel)
    if dev is None:
        return seqpar_row_pre_plain(queries, i, genome, off, g_len, prev,
                                    halo_diag, run, match_score, mismatch,
                                    indel)
    b, gb = prev.shape
    total = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return total
    stream, index = _stream(dev)
    geo = plan(b, gb, step=False)
    err = load_kernel().seqpar_row_pre_launch(
        queries.data_ptr(), queries.shape[1], None, genome.data_ptr(), gb,
        off, g_len, b, i, geo.segments, geo.seg, prev.data_ptr(),
        halo_diag.data_ptr(), run.data_ptr(), total.data_ptr(), match_score,
        mismatch, indel, stream, index)
    _raise_on(err, "row pre")
    row_launches += 1
    return total


def seqpar_row_post(queries, q_len, i: int, genome, off: int, g_len: int,
                    index: int, prev, halo_diag, run, totals, codes_row,
                    best, bi, bj, match_score=10, mismatch=-1, indel=-1):
    """The per-row variant's second half for row i, after the all-gather:
    folds the (D, B) `totals` of the blocks left of `index` into the carry,
    with what *pre* left in `run`, writes the row into `prev` and its codes
    into `codes_row` (B, Gb) uint8, and folds the best in place. Returns
    the row's last column (B,) for the exchange to the right."""
    global row_launches
    if not 1 <= i <= queries.shape[1]:
        raise ValueError(f"row {i} outside 1..{queries.shape[1]}")
    if totals.dim() != 2 or not 0 <= index < totals.shape[0]:
        raise ValueError("totals must be (D, B) with 0 <= index < D")
    if tuple(codes_row.shape) != tuple(prev.shape) \
            or codes_row.dtype != torch.uint8:
        raise ValueError("codes_row must be (B, Gb) uint8")
    dev = _check(queries, q_len, genome, off, g_len, (prev, run),
                 (halo_diag, totals, best, bi, bj), match_score, mismatch,
                 indel)
    if dev is None:
        return seqpar_row_post_plain(queries, q_len, i, genome, off, g_len,
                                     index, prev, halo_diag, run, totals,
                                     codes_row, best, bi, bj, match_score,
                                     mismatch, indel)
    if not codes_row.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    b, gb = prev.shape
    last = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return last
    stream, dev_index = _stream(dev)
    geo = plan(b, gb, step=False)
    err = load_kernel().seqpar_row_post_launch(
        queries.data_ptr(), queries.shape[1], q_len.data_ptr(),
        genome.data_ptr(), gb, off, g_len, b, i, geo.segments, geo.seg,
        prev.data_ptr(), halo_diag.data_ptr(), run.data_ptr(),
        totals.data_ptr(),
        totals.shape[0], index, codes_row.data_ptr(), last.data_ptr(),
        best.data_ptr(), bi.data_ptr(), bj.data_ptr(), match_score,
        mismatch, indel, stream, dev_index)
    _raise_on(err, "row post")
    row_launches += 1
    return last
