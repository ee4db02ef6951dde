"""Batched Smith-Waterman local alignment (contig/read -> reference genome):
two hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Reference semantics (aligners.py:85-167): dp clamped at 0, tie-break cascade
diag>=up>=left with each candidate additionally required >= 0, global best
tracked with strict > in row-major order (first maximum wins), traceback from
the best cell until score 0 / matrix edge / code 0. Bases compare with ``==``
on their codes, so ``N`` (code 4) matches ``N``.

The plain versions keep the JAX package's contracts (shapes, dtypes,
``(best, best_i, best_j, ops, start_j)``): ``local_align_batch`` scans the
query rows, solving the left chain of each row as a max-plus prefix scan,
``dp[j] = cummax_j(c0[j] - indel*j) + indel*j``; ``traceback_device`` walks
the code tensor; ``local_align_batch_banded`` restricts the scan to a
diagonal band.

The kernels (``csrc/smith_waterman.cu``, built with ``nvcc`` at first use)
take the C++ engine's contracts instead: every item aligns against a window
of ONE genome, so the genome is read once, never copied per item.

- ``sw_full_width``: each query against the suffix ``genome[m - w_len:]``
  (the whole genome, or the tail window of a short contig);
- ``sw_banded``: each query against the genome within the band
  ``|j - i - d0| <= band``.

On a CUDA tensor each launches its kernel (on the current stream, not
synchronised); on a CPU tensor each runs its plain version
(``sw_full_width_plain``, ``sw_banded_plain``). There is no fallback
between the two. Both return ``(best, best_i, best_j, ops, start_j)`` with
``ops`` as (B, steps) uint8, the transpose of the JAX op stream.

The host seed helpers of the banded metrics pass (``seed_diagonal``,
``genome_kmer_index``, ``genome_hash_index``, ``seed_diagonals_batch``) and
the host replays are numpy, copied from the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .._build import build_shared_library
from ..core.encoding import encode, encode_batch
from .overlap_allpairs import NVCC_FLAGS, _nvcc

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "smith_waterman.cu")
BUILD_TIMEOUT_S = 300
NEG = -(2**28)
# Device scratch (2-bit traceback codes and row buffers) of one launch; a
# call whose items need more launches over chunks of items.
SCRATCH_BUDGET_BYTES = 1 << 30
# The kernels keep scores in int32; every intermediate must stay below.
_INT32_GUARD = 2**30
# PAD codes on each side of the kernels' copy of the genome, so that their
# word loads around a window's ends stay in bounds (csrc kGenomePad).
GENOME_PAD = 64

# Warps a block gives one item's strips (csrc kW): the instantiations the
# launch entries accept.
WARPS_PER_ITEM = (1, 2, 4, 8)
# Warps of the kernels resident on one SM: 65,536 registers over 96 a
# thread hold 21 warps, 20 in blocks of 4.
RESIDENT_WARPS_PER_SM = 20

# Kernel launches since the last reset; set to 0 to start counting.
full_width_launches = 0
banded_launches = 0

_LIB = None


def load_kernel():
    """Build (if needed) and load the kernel library; raises RuntimeError
    with nvcc's output when the build fails."""
    global _LIB
    if _LIB is None:
        path = build_shared_library("smith_waterman", SOURCE,
                                    [_nvcc(), *NVCC_FLAGS],
                                    timeout=BUILD_TIMEOUT_S)
        lib = ctypes.CDLL(path)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        head = [vp, ll, vp,      # queries, q_stride, q_len
                vp, i, vp]       # genome, m, w_len | d0
        tail = [vp, vp, i,       # order, scratch offsets, n_items
                vp,              # scratch
                i, i, i,         # match, mismatch, indel
                ll,              # ops_stride
                vp, vp, vp, vp,  # best, best_i, best_j, start_j out
                vp,              # ops out
                vp, i,           # stream, device index
                i]               # warps to an item (1, 2, 4 or 8)
        lib.sw_full_launch.argtypes = head + tail
        lib.sw_banded_launch.argtypes = head + [i] + tail    # + band
        lib.sw_full_launch.restype = i
        lib.sw_banded_launch.restype = i
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# plain PyTorch versions (the JAX package's contracts)
# ---------------------------------------------------------------------------

def local_align_batch(queries: torch.Tensor, q_len: torch.Tensor,
                      refs: torch.Tensor, r_len: torch.Tensor,
                      match_score: int = 10, mismatch: int = -1,
                      indel: int = -1):
    """Batched local alignment (the JAX package's row scan).

    Args:
        queries: (B, n_pad) int8, LEFT-aligned.
        q_len:   (B,) int32.
        refs:    (B, m_pad) int8, LEFT-aligned per-item reference windows.
        r_len:   (B,) int32.

    Returns:
        best:   (B,) int32 best score (0 if no positive cell).
        best_i: (B,) int32 query end row (1-based; 0 if none).
        best_j: (B,) int32 reference end column = end position.
        codes:  (n_pad, B, m_pad+1) uint8 traceback codes, codes[i-1, b, j]
                is the code of cell (i, j); 0 encodes "stop" (dp == 0).
    """
    B, n_pad = queries.shape
    m_pad = refs.shape[1]
    dev = queries.device
    q_len = q_len.to(device=dev, dtype=torch.int32)
    r_len = r_len.to(device=dev, dtype=torch.int32)
    jcol = torch.arange(m_pad + 1, dtype=torch.int32, device=dev)[None, :]
    neg_indel = -indel
    valid_j = (jcol >= 1) & (jcol <= r_len[:, None])
    ref_chars = torch.cat([torch.full((B, 1), 127, dtype=refs.dtype,
                                      device=dev), refs], dim=1)
    prev = torch.zeros((B, m_pad + 1), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    bj = torch.zeros(B, dtype=torch.int32, device=dev)
    codes = torch.zeros((n_pad, B, m_pad + 1), dtype=torch.uint8, device=dev)
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(1, n_pad + 1):
        qc = queries[:, i - 1:i]
        sub = torch.where(ref_chars == qc, match_score, mismatch).to(
            torch.int32)
        diag = torch.roll(prev, 1, dims=1) + sub
        diag = torch.where(jcol == 0, neg, diag)
        up = prev + indel
        c0 = torch.maximum(torch.maximum(diag, up), zero)
        c0 = torch.where(valid_j, c0, zero)
        key = c0 + neg_indel * jcol
        run = torch.cummax(key, dim=1).values
        row = run - neg_indel * jcol
        row = torch.where(jcol == 0, zero, row)
        left = torch.roll(row, 1, dims=1) + indel
        left = torch.where(jcol == 0, neg, left)
        code = _cascade(diag, up, left)
        code = torch.where((row > 0) & valid_j, code, 0).to(torch.uint8)
        codes[i - 1] = code
        row_masked = torch.where(valid_j, row, -1)
        r_arg = torch.argmax(row_masked, dim=1).to(torch.int32)
        r_max = torch.gather(row_masked, 1, r_arg[:, None].long())[:, 0]
        improve = (r_max > best) & (i <= q_len)
        best = torch.where(improve, r_max, best)
        bi = torch.where(improve, i, bi)
        bj = torch.where(improve, r_arg, bj)
        prev = row
    return best, bi, bj, codes


def _cascade(diag, up, left):
    """Exact reference cascade (aligners.py:122-132) as int32 codes."""
    return torch.where(
        (diag >= up) & (diag >= left) & (diag >= 0), 1,
        torch.where((up >= left) & (up >= 0), 2,
                    torch.where(left >= 0, 3, 0))).to(torch.int32)


# the plain walks check for a finished batch once every this many steps
_WALK_CHECK = 64


def traceback_device(codes: torch.Tensor, best_i: torch.Tensor,
                     best_j: torch.Tensor, max_steps: int):
    """Walk the traceback on the codes' device, emitting a per-step op
    stream.

    Args:
        codes:  (n_pad, B, m_pad+1) uint8 from `local_align_batch`.
        best_i: (B,) int32 1-based best row.
        best_j: (B,) int32 best column.
        max_steps: walk bound (n_pad + m_pad covers any path).

    Returns:
        ops:     (max_steps, B) uint8 — codes along the path from the best
                 cell backwards; 0 marks the stop (and everything after).
        start_j: (B,) int32 — the reference column where the walk stopped.
    """
    B = codes.shape[1]
    dev = codes.device
    lane = torch.arange(B, device=dev)
    i = best_i.to(torch.int64).clone()
    j = best_j.to(torch.int64).clone()
    active = torch.ones(B, dtype=torch.bool, device=dev)
    ops = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    for step in range(max_steps if codes.shape[0] else 0):
        if step % _WALK_CHECK == 0 and not bool(active.any()):
            break                       # every later op is 0
        c = codes[(i - 1).clamp(min=0), lane, j.clamp(min=0)]
        c = torch.where(active & (i > 0) & (j > 0), c, 0).to(torch.uint8)
        i = i - ((c == 1) | (c == 2)).to(torch.int64)
        j = j - ((c == 1) | (c == 3)).to(torch.int64)
        active = active & (c != 0)
        ops[step] = c
    return ops, j.to(torch.int32)


def local_align_batch_ops(queries: torch.Tensor, q_len: torch.Tensor,
                          refs: torch.Tensor, r_len: torch.Tensor,
                          match_score: int = 10, mismatch: int = -1,
                          indel: int = -1):
    """Batched local alignment + traceback walk, on the inputs' device.
    Returns (best, best_i, best_j, ops (n_pad + m_pad, B), start_j) — see
    `traceback_device`."""
    best, bi, bj, codes = local_align_batch(
        queries, q_len, refs, r_len, match_score=match_score,
        mismatch=mismatch, indel=indel)
    ops, start_j = traceback_device(
        codes, bi, bj, max_steps=queries.shape[1] + refs.shape[1])
    return best, bi, bj, ops, start_j


def local_align_batch_banded(queries: torch.Tensor, q_len: torch.Tensor,
                             refs: torch.Tensor, r_len: torch.Tensor,
                             d0: torch.Tensor, band: int,
                             match_score: int = 10, mismatch: int = -1,
                             indel: int = -1):
    """Banded batched local alignment + traceback walk.

    Restricts the DP to the diagonal band |j - i - d0| <= band around a
    per-item center diagonal `d0`. Because SW cells are clamped at 0, the
    out-of-band boundary behaves exactly like a fresh local-alignment
    start, so this is full SW restricted to paths inside the band. Codes
    are (n_pad, B, 2*band+1); the walk bound is 2*n_pad + 2*band + 1.

    Args:
        refs: (B, m_pad) per-item windows, or (1, m_pad) shared by all.
        d0: (B,) int32 — center diagonal (j - i) per item.
        band: half-width; band width is 2*band + 1.

    Returns:
        (best, best_i, best_j, ops (2*n_pad + 2*band + 1, B), start_j) —
        global coordinates, as `local_align_batch_ops`.
    """
    B, n_pad = queries.shape
    m_pad = refs.shape[1]
    dev = queries.device
    shared_ref = refs.shape[0] == 1 and B > 1
    wb = 2 * band + 1
    t = torch.arange(wb, dtype=torch.int32, device=dev)[None, :]
    neg_indel = -indel
    q_len = q_len.to(device=dev, dtype=torch.int32)
    r_len = r_len.to(device=dev, dtype=torch.int32)
    d0 = d0.to(device=dev, dtype=torch.int32)
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    prev = torch.zeros((B, wb), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    bt = torch.zeros(B, dtype=torch.int32, device=dev)
    codes = torch.zeros((n_pad, B, wb), dtype=torch.uint8, device=dev)
    for i in range(1, n_pad + 1):
        jlo = d0 - band + i
        j = jlo[:, None] + t
        valid_j = ((j >= 1) & (j <= r_len[:, None])
                   & (i <= q_len)[:, None])
        jc = (j - 1).clamp(0, m_pad - 1).long()
        rc = refs[0][jc] if shared_ref else torch.gather(refs, 1, jc)
        qc = queries[:, i - 1:i]
        sub = torch.where(rc == qc, match_score, mismatch).to(torch.int32)
        diag = prev + sub
        up = torch.cat([prev[:, 1:], neg_col], dim=1) + indel
        c0 = torch.maximum(torch.maximum(diag, up), zero)
        c0 = torch.where(valid_j, c0, zero)
        key = c0 + neg_indel * t
        run = torch.cummax(key, dim=1).values
        row = run - neg_indel * t
        left = torch.cat([neg_col, row[:, :-1]], dim=1) + indel
        code = _cascade(diag, up, left)
        codes[i - 1] = torch.where((row > 0) & valid_j, code, 0).to(
            torch.uint8)
        row = torch.where(valid_j, row, zero)
        row_masked = torch.where(valid_j, row, -1)
        r_arg = torch.argmax(row_masked, dim=1).to(torch.int32)
        r_max = torch.gather(row_masked, 1, r_arg[:, None].long())[:, 0]
        improve = r_max > best
        best = torch.where(improve, r_max, best)
        bi = torch.where(improve, i, bi)
        bt = torch.where(improve, r_arg, bt)
        prev = row
    hit = best > 0
    best_j = torch.where(hit, d0 - band + bi + bt, 0)

    # band-coordinate walk: diag (1) -> (i-1, t); up (2) -> (i-1, t+1);
    # left (3) -> (i, t-1). Codes at band edges were masked, so t stays in
    # range whenever the code is nonzero. Bound: #diag + #up <= n_pad and
    # #left <= #up + band width, so 2*n_pad + 2*band + 1 steps.
    lane = torch.arange(B, device=dev)
    max_steps = 2 * n_pad + 2 * band + 1
    wi = bi.to(torch.int64).clone()
    wt = bt.to(torch.int64).clone()
    base = (d0 - band).to(torch.int64)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    ops = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    for step in range(max_steps if n_pad else 0):
        if step % _WALK_CHECK == 0 and not bool(active.any()):
            break
        c = codes[(wi - 1).clamp(min=0), lane, wt.clamp(0, wb - 1)]
        jg = base + wi + wt
        c = torch.where(active & (wi > 0) & (jg > 0), c, 0).to(torch.uint8)
        wi = wi - ((c == 1) | (c == 2)).to(torch.int64)
        wt = wt + (c == 2).to(torch.int64) - (c == 3).to(torch.int64)
        active = active & (c != 0)
        ops[step] = c
    start_j = torch.where(hit, (base + wi + wt).to(torch.int32), 0)
    return best, torch.where(hit, bi, 0), best_j, ops, start_j


# ---------------------------------------------------------------------------
# the kernels' wrappers (one shared genome) and their plain versions
# ---------------------------------------------------------------------------

def _check_common(queries, q_len, genome, per_item, match_score, mismatch,
                  indel):
    if queries.dim() != 2:
        raise ValueError("queries must be a (B, n_pad) matrix")
    if genome.dim() != 1:
        raise ValueError("genome must be a (m,) vector")
    B, n_pad = queries.shape
    if tuple(q_len.shape) != (B,) or tuple(per_item.shape) != (B,):
        raise ValueError("q_len and the per-item vector must be (B,)")
    if queries.dtype != torch.int8 or genome.dtype != torch.int8:
        raise ValueError("queries and genome must be int8 codes")
    if q_len.dtype != torch.int32 or per_item.dtype != torch.int32:
        raise ValueError("q_len and the per-item vector must be int32")
    devices = {t.device for t in (queries, q_len, genome, per_item)}
    if len(devices) != 1:
        raise ValueError(f"inputs on more than one device: {devices}")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")
    if indel > 0:
        raise ValueError(f"indel must be <= 0, got {indel}")
    m = genome.shape[0]
    if max(abs(match_score), abs(mismatch), abs(indel)) * (n_pad + m + 2) \
            >= _INT32_GUARD:
        raise ValueError("scores of these penalties and lengths overflow "
                         "int32")
    if B and bool(((q_len < 0) | (q_len > n_pad)).any()):
        raise ValueError(f"query lengths must lie in [0, {n_pad}]")


def _kernel_device(tensors):
    """The CUDA device of checked inputs, None on the CPU."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return None
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev


def _scratch_words(strips: np.ndarray, steps: np.ndarray) -> np.ndarray:
    """int32 words of one item's scratch, as the kernels lay it out: 2-bit
    codes, 16 steps to a word per lane, for each strip of 32 rows, then two
    row buffers of the strip's steps + 48 values rounded up to 32."""
    return (strips * ((steps + 15) // 16) * 32
            + 2 * ((steps + 48 + 31) // 32 * 32))


def _launch_chunks(words: np.ndarray, work: np.ndarray, budget_words: int):
    """Items longest first, cut into launches whose scratch fits the
    budget (an item larger than the budget gets a launch of its own).
    Returns (order, offsets) int arrays per launch."""
    order = np.argsort(-work, kind="stable")
    sizes = words[order]
    ends = np.cumsum(sizes)
    chunks, start, base = [], 0, 0
    while start < len(order):
        # the last item whose scratch still ends inside this launch's budget
        stop = max(int(np.searchsorted(ends, base + budget_words, "right")),
                   start + 1)
        sel = slice(start, stop)
        chunks.append((order[sel], ends[sel] - sizes[sel] - base))
        base = int(ends[stop - 1])
        start = stop
    return chunks


def _warps_per_item(strips: np.ndarray, sms: int) -> int:
    """Warps of the block that aligns one item of a launch, from the
    launch's strip counts and the card's SM count: the larger of
    - the most warps an item that still let every item's block be resident
      at once (`RESIDENT_WARPS_PER_SM` on each SM): more blocks than the
      card holds run in waves, and a wave costs more than a longer chain;
    - the fewest warps that bring the longest item's chain of strips down
      to the larger of the mean item's strips and the strips each resident
      warp takes on in the launch: below that the launch waits on its
      longest item.
    """
    busy = strips[strips > 0]
    if len(busy) == 0:
        return 1
    resident = RESIDENT_WARPS_PER_SM * sms
    fill = [w for w in WARPS_PER_ITEM if len(busy) * w <= resident]
    load = max(busy.mean(), busy.sum() / resident)
    tail = [w for w in WARPS_PER_ITEM if -(-int(busy.max()) // w) <= load]
    return max(fill[-1] if fill else 1, tail[0] if tail else 8)


def _run_kernel(name, queries, q_len, genome, per_item, band, words, work,
                strips, match_score, mismatch, indel, ops_stride, dev):
    """Launch the library's C entry point `name` over every item, in
    launches whose scratch fits the budget, each with the warps a block
    `_warps_per_item` gives its items; returns the outputs and the number
    of launches."""
    B = queries.shape[0]
    outs = [torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(4)]
    ops = torch.zeros((B, ops_stride), dtype=torch.uint8, device=dev)
    if B == 0:
        return (*outs, ops), 0
    fn = getattr(load_kernel(), name)
    budget = SCRATCH_BUDGET_BYTES // 4
    chunks = _launch_chunks(words, work, budget)
    scratch = torch.empty(max(1, max(int(words[o].sum()) for o, _ in chunks)),
                          dtype=torch.int32, device=dev)
    padded = torch.full((genome.shape[0] + 2 * GENOME_PAD,), 4,
                        dtype=torch.int8, device=dev)
    padded[GENOME_PAD:GENOME_PAD + genome.shape[0]] = genome
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    extra = () if band is None else (band,)
    for order, off in chunks:
        order_d = torch.from_numpy(order.astype(np.int32)).to(dev)
        off_d = torch.from_numpy(off.astype(np.int64)).to(dev)
        err = fn(queries.data_ptr(), queries.shape[1], q_len.data_ptr(),
                 padded.data_ptr() + GENOME_PAD, genome.shape[0],
                 per_item.data_ptr(),
                 *extra, order_d.data_ptr(), off_d.data_ptr(), len(order),
                 scratch.data_ptr(), match_score, mismatch, indel,
                 ops_stride, *(o.data_ptr() for o in outs), ops.data_ptr(),
                 stream, index, _warps_per_item(strips[order], sms))
        if err != 0:
            raise RuntimeError(f"smith_waterman kernel launch failed: "
                               f"cudaError {err}")
    return (outs[0], outs[1], outs[2], ops, outs[3]), len(chunks)


def sw_full_width(queries: torch.Tensor, q_len: torch.Tensor,
                  genome: torch.Tensor, w_len: torch.Tensor,
                  match_score: int = 10, mismatch: int = -1,
                  indel: int = -1):
    """Local alignment of each query against a suffix window of one genome.

    Args:
        queries: (B, n_pad) int8 LEFT-aligned query codes.
        q_len:   (B,) int32 query lengths, in [0, n_pad].
        genome:  (m,) int8 genome codes.
        w_len:   (B,) int32 window lengths, in [0, m]: item b aligns
                 against genome[m - w_len[b]:], in window coordinates.

    Returns:
        (best, best_i, best_j, ops, start_j): (B,) int32 vectors and the
        (B, n_pad + m) uint8 op streams (backwards from the best cell,
        zero after the stop), the transpose of `local_align_batch_ops`'s.

    CUDA tensors go to the kernel; CPU tensors to `sw_full_width_plain`.
    """
    global full_width_launches
    _check_common(queries, q_len, genome, w_len, match_score, mismatch,
                  indel)
    m = genome.shape[0]
    if queries.shape[0] and bool(((w_len < 0) | (w_len > m)).any()):
        raise ValueError(f"window lengths must lie in [0, {m}]")
    dev = _kernel_device((queries, q_len, genome, w_len))
    if dev is None:
        return sw_full_width_plain(queries, q_len, genome, w_len,
                                   match_score, mismatch, indel)
    n = q_len.cpu().numpy().astype(np.int64)
    w = w_len.cpu().numpy().astype(np.int64)
    strips = np.where((n > 0) & (w > 0), (n + 31) // 32, 0)
    words = np.where(strips > 0, _scratch_words(strips, w + 31), 0)
    out, n_launches = _run_kernel(
        "sw_full_launch",
        queries, q_len, genome, w_len, None, words, strips * (w + 31),
        strips, match_score, mismatch, indel, queries.shape[1] + m, dev)
    full_width_launches += n_launches
    return out


def sw_full_width_plain(queries, q_len, genome, w_len, match_score=10,
                        mismatch=-1, indel=-1):
    """`sw_full_width` in plain PyTorch: the suffix windows as (B, m)
    reference rows through `local_align_batch_ops`."""
    B = queries.shape[0]
    m = genome.shape[0]
    dev = queries.device
    col = torch.arange(m, device=dev)[None, :]
    src = (m - w_len.to(torch.int64))[:, None] + col
    refs = torch.where(col < w_len[:, None].to(torch.int64),
                       genome[src.clamp(max=max(m - 1, 0))],
                       torch.tensor(4, dtype=torch.int8, device=dev)) \
        if m else torch.zeros((B, 0), dtype=torch.int8, device=dev)
    best, bi, bj, ops, start = local_align_batch_ops(
        queries, q_len, refs, w_len, match_score, mismatch, indel)
    return best, bi, bj, ops.T.contiguous(), start


def sw_banded(queries: torch.Tensor, q_len: torch.Tensor,
              genome: torch.Tensor, d0: torch.Tensor, band: int,
              match_score: int = 10, mismatch: int = -1, indel: int = -1):
    """Banded local alignment of each query against one genome.

    Args:
        queries: (B, n_pad) int8 LEFT-aligned query codes.
        q_len:   (B,) int32 query lengths, in [0, n_pad].
        genome:  (m,) int8 genome codes.
        d0:      (B,) int32 center diagonal (j - i) per item; the band may
                 lie partly or wholly outside [1, m].
        band:    half-width (>= 0); 2*band + 1 cells per row.

    Returns:
        (best, best_i, best_j, ops, start_j) in genome coordinates, ops
        (B, 2*n_pad + 2*band + 1) uint8 in band moves (1 diag, 2 up,
        3 left), the transpose of `local_align_batch_banded`'s.

    CUDA tensors go to the kernel; CPU tensors to `sw_banded_plain`.
    """
    global banded_launches
    _check_common(queries, q_len, genome, d0, match_score, mismatch, indel)
    if band < 0 or 2 * band + 1 >= _INT32_GUARD // 4:
        raise ValueError(f"band must lie in [0, {_INT32_GUARD // 8}), "
                         f"got {band}")
    dev = _kernel_device((queries, q_len, genome, d0))
    if dev is None:
        return sw_banded_plain(queries, q_len, genome, d0, band,
                               match_score, mismatch, indel)
    m = genome.shape[0]
    n = q_len.cpu().numpy().astype(np.int64)
    wb = 2 * band + 1
    strips = np.where((n > 0) & (m > 0), (n + 31) // 32, 0)
    words = np.where(strips > 0, _scratch_words(strips, wb + 62), 0)
    out, n_launches = _run_kernel(
        "sw_banded_launch",
        queries, q_len, genome, d0, band, words, strips, strips,
        match_score, mismatch, indel, 2 * queries.shape[1] + 2 * band + 1,
        dev)
    banded_launches += n_launches
    return out


def sw_banded_plain(queries, q_len, genome, d0, band, match_score=10,
                    mismatch=-1, indel=-1):
    """`sw_banded` in plain PyTorch: `local_align_batch_banded` with the
    genome as one shared reference row."""
    m = genome.shape[0]
    r_len = torch.full_like(q_len, m)
    if m == 0:
        genome = torch.full((1,), 4, dtype=torch.int8, device=genome.device)
    best, bi, bj, ops, start = local_align_batch_banded(
        queries, q_len, genome[None, :], r_len, d0, band, match_score,
        mismatch, indel)
    return best, bi, bj, ops.T.contiguous(), start


# ---------------------------------------------------------------------------
# host seeding for the banded metrics pass (numpy)
# ---------------------------------------------------------------------------

def seed_diagonal(query: str, genome_index: dict, genome_len: int,
                  k: int = 15) -> int | None:
    """Vote the dominant alignment diagonal d = ref_pos - query_pos from
    exact k-mer hits (host). Returns None when the query has no k-mer hit
    at all (caller falls back to full-width alignment)."""
    n = len(query)
    if n < k:
        return None
    votes: dict[int, int] = {}
    for u in range(0, n - k + 1):
        for pos in genome_index.get(query[u:u + k], ()):
            d = pos - u
            votes[d] = votes.get(d, 0) + 1
    if not votes:
        return None
    return max(votes.items(), key=lambda kv: (kv[1], -abs(kv[0])))[0]


@functools.lru_cache(maxsize=4)
def genome_kmer_index(genome: str, k: int = 15) -> dict:
    """{k-mer: (positions...)} over the genome (host, cached per genome);
    the single-query companion of `seed_diagonal`."""
    idx: dict[str, list[int]] = {}
    for pos in range(len(genome) - k + 1):
        idx.setdefault(genome[pos:pos + k], []).append(pos)
    return {km: tuple(ps) for km, ps in idx.items()}


@functools.lru_cache(maxsize=4)
def genome_hash_index(genome: str, k: int = 15):
    """Sorted base-4 k-mer hash index over the genome, vectorized.

    Returns (hashes, positions): int64/int32 arrays sorted by (hash, pos).
    k <= 31 keeps 4**k in int64.
    """
    assert 0 < k <= 31, "base-4 hash needs k <= 31 for int64"
    codes = encode(genome).astype(np.int64)
    n_win = len(genome) - k + 1
    if n_win <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    pw = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    h = np.zeros(n_win, np.int64)
    for t in range(k):
        h += codes[t:t + n_win] * pw[t]
    # windows touching a non-ACGT code (>= 4) are not real k-mers
    bad = codes >= 4
    if bad.any():
        w = np.zeros(n_win, bool)
        for t in range(k):
            w |= bad[t:t + n_win]
        keep = ~w
        h, pos = h[keep], np.nonzero(keep)[0].astype(np.int32)
    else:
        pos = np.arange(n_win, dtype=np.int32)
    order = np.argsort(h, kind="stable")   # stable: ascending pos per hash
    return h[order], pos[order]


def seed_diagonals_batch(contigs: list[str], genome: str, k: int = 15,
                         chunk_elems: int = 4_000_000):
    """Batched k-mer diagonal seeding for the metrics pass (numpy).

    For every contig, finds all exact k-mer hits against the genome and
    aggregates them per diagonal d = genome_pos - contig_pos. Returns
    (d0, d_lo, d_hi, has_hit):

      d0:      (U,) int32 — the vote-winning diagonal (most hits; ties
               break to smallest |d|, then smallest d);
      d_lo/hi: (U,) int32 — min/max diagonal over all hits;
      has_hit: (U,) bool — False where the contig has no k-mer hit.

    Contigs are processed in length-sorted chunks so the (rows, windows)
    hash matrix stays under `chunk_elems` elements.
    """
    u_count = len(contigs)
    d0 = np.zeros(u_count, np.int32)
    d_lo = np.zeros(u_count, np.int32)
    d_hi = np.zeros(u_count, np.int32)
    has = np.zeros(u_count, bool)
    if u_count == 0:
        return d0, d_lo, d_hi, has
    gh, gpos = genome_hash_index(genome, k)
    if len(gh) == 0:
        return d0, d_lo, d_hi, has
    lens = np.array([len(c) for c in contigs], np.int64)
    by_len = np.argsort(lens, kind="stable")
    pw = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)

    lo = 0
    while lo < u_count:
        hi = lo + 1
        width = int(lens[by_len[lo]])
        while hi < u_count:
            w = int(lens[by_len[hi]])
            if w >= k and (hi - lo + 1) * (w - k + 1) > chunk_elems:
                break
            width = w
            hi += 1
        idx = by_len[lo:hi]
        lo = hi
        if width < k:
            continue                       # every contig here is too short
        rows = [contigs[i] for i in idx]
        mat, rlen = encode_batch(rows, width=width)
        n_win = width - k + 1
        h = np.zeros((len(rows), n_win), np.int64)
        m64 = mat.astype(np.int64)
        for t in range(k):
            h += m64[:, t:t + n_win] * pw[t]
        u_col = np.arange(n_win, dtype=np.int64)[None, :]
        valid = u_col <= (rlen[:, None].astype(np.int64) - k)
        h = np.where(valid, h, np.int64(-1))          # -1 < all genome hashes
        flat = h.ravel()
        s_lo = np.searchsorted(gh, flat, side="left")
        s_hi = np.searchsorted(gh, flat, side="right")
        cnt = s_hi - s_lo
        total = int(cnt.sum())
        if total == 0:
            continue
        starts = np.cumsum(cnt) - cnt
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
        hit_pos = gpos[np.repeat(s_lo, cnt) + within].astype(np.int64)
        flat_idx = np.repeat(np.arange(flat.size, dtype=np.int64), cnt)
        hit_row = flat_idx // n_win                    # chunk-local row
        hit_u = flat_idx % n_win
        d = hit_pos - hit_u                            # diagonal
        # vote per (row, d): encode as one key, count with np.unique
        off = np.int64(n_win)                          # d >= -(n_win - 1)
        mod = np.int64(len(genome) + n_win + 1)
        uk, ucnt = np.unique(hit_row * mod + (d + off), return_counts=True)
        uk_row = uk // mod
        uk_d = uk % mod - off
        # winner per row: most votes, then smallest |d|, then smallest d
        order = np.lexsort((uk_d, np.abs(uk_d), -ucnt, uk_row))
        row_sorted = uk_row[order]
        first = np.ones(len(order), bool)
        first[1:] = row_sorted[1:] != row_sorted[:-1]
        win_rows = row_sorted[first]
        g_idx = idx[win_rows]
        d0[g_idx] = uk_d[order[first]].astype(np.int32)
        has[g_idx] = True
        # d range per row: uk is sorted by (row, d+off) already
        fr = np.ones(len(uk), bool)
        fr[1:] = uk_row[1:] != uk_row[:-1]
        starts_r = np.nonzero(fr)[0]
        ends_r = np.r_[starts_r[1:], len(uk)] - 1
        rng_idx = idx[uk_row[starts_r]]
        d_lo[rng_idx] = uk_d[starts_r].astype(np.int32)
        d_hi[rng_idx] = uk_d[ends_r].astype(np.int32)
    return d0, d_lo, d_hi, has


# ---------------------------------------------------------------------------
# host replays
# ---------------------------------------------------------------------------

def replay_ops_host(ops_col: np.ndarray, best_i: int, best_j: int,
                    query: str, reference: str):
    """Rebuild the aligned strings from a traceback op stream.

    Reference aligners.py:139-161 semantics: ops are emitted backwards from
    the best cell (1 = diagonal, 2 = up, 3 = left, 0 = stop). Returns
    (aligned_ref, aligned_query, start_j).
    """
    ops = np.asarray(ops_col)
    stop = np.nonzero(ops == 0)[0]
    n = int(stop[0]) if len(stop) else len(ops)
    if n == 0:
        return "", "", int(best_j)
    c = ops[:n]
    qmove = (c == 1) | (c == 2)              # consumes a query char
    rmove = (c == 1) | (c == 3)              # consumes a reference char
    # positions consumed at each (backwards) step: exclusive prefix counts
    qpos = int(best_i) - 1 - (np.cumsum(qmove) - qmove)
    rpos = int(best_j) - 1 - (np.cumsum(rmove) - rmove)
    qb = np.frombuffer(query.encode("ascii"), np.uint8)
    rb = np.frombuffer(reference.encode("ascii"), np.uint8)
    dash = np.uint8(ord("-"))
    aq = np.where(qmove, qb[np.clip(qpos, 0, max(len(qb) - 1, 0))], dash)
    ar = np.where(rmove, rb[np.clip(rpos, 0, max(len(rb) - 1, 0))], dash)
    start_j = int(best_j) - int(rmove.sum())
    return (ar[::-1].tobytes().decode("ascii"),
            aq[::-1].tobytes().decode("ascii"), start_j)


def traceback_host(codes: np.ndarray, best_i: int, best_j: int,
                   query: str, reference: str):
    """Rebuild the aligned strings from traceback codes.

    codes: (n_pad, m_pad+1) uint8 for one item (codes[i-1, j] = cell (i,j)).
    Returns (aligned_ref, aligned_query, start_pos) — reference
    aligners.py:139-161 semantics (code 0 stops, start = final j).
    """
    i, j = int(best_i), int(best_j)
    aq: list[str] = []
    ar: list[str] = []
    while i > 0 and j > 0:
        code = int(codes[i - 1, j])
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


def local_align_one(query: str, reference: str, match_score: int = 10,
                    mismatch: int = -1, indel: int = -1, device="cuda"):
    """Single-pair convenience wrapper: the full-width kernel (its plain
    version on device="cpu") and a host replay of its op stream.

    Returns (aligned_ref, aligned_query, score, start, end) like the oracle.
    """
    from ..core.dispatch import resolve_device

    dev = resolve_device(device)
    n, m = len(query), len(reference)
    if n == 0 or m == 0:
        return "", "", 0, 0, 0
    q = torch.from_numpy(encode(query)[None, :].copy()).to(dev)
    g = torch.from_numpy(encode(reference).copy()).to(dev)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    best, bi, bj, ops, _ = sw_full_width(
        q, lens, g, torch.tensor([m], dtype=torch.int32, device=dev),
        match_score=match_score, mismatch=mismatch, indel=indel)
    ar, aq, start = replay_ops_host(ops[0].cpu().numpy(), int(bi[0]),
                                    int(bj[0]), query, reference)
    return ar, aq, int(best[0]), start, int(bj[0])
