"""Read-layout ops and the pair-list overlap scorer.

``overlap_scores_pairs`` is the counterpart of the JAX package's
``ops/overlap.py::overlap_scores``, the scorer of ``score_pairs``' sparse
route, at the port's interface: the read matrix and the pair indices in
place of the gathered operands. For each pair (a, b) = (ia[p], ib[p]) and
j = 0 .. len(b), with d = min(len(a), j), score(j) sums the d aligned cells
of a's suffix against b's prefix ending at j: ``match_score`` for two equal
bases, ``mismatch`` for two different bases, 0 where either side is PAD or
N (any code outside 0..3; ``overlap_scores``' validity channel). The result
is the first strict maximum over j (score 0 at j = 0) and its j.

On a CUDA tensor it launches ``csrc/overlap_pairs.cu`` (built with ``nvcc``
at first use), on a CPU tensor it runs ``overlap_scores_pairs_plain``.
There is no fallback between the two. One call of the launch entry
``overlap_pairs_launch`` runs two kernels on the current stream: one packs
every read into bit planes in a scratch tensor that the wrapper allocates
(``scratch_words``), the other scores the pairs, a warp walking
``PAIRS_A_WARP`` consecutive pairs and keeping the source read's planes
while ``ia`` repeats. ``launches`` counts one a call, for both.
``overlap_scores`` takes the JAX function's operands (a right-aligned and
b, one pair a row) and scores them through ``overlap_scores_pairs``.

``overlap_align_full`` is the gapped overlap DP for arbitrary penalties
(the JAX package's XLA program of that name, on no assembly path), as
torch ops on the inputs' device; ``overlap_scores_host`` is the JAX
package's numpy no-gap scorer, copied.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .._build import build_shared_library
from ..core.encoding import PAD

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "overlap_pairs.cu")
BUILD_TIMEOUT_S = 300
# the kernel's shared memory (three bit planes of a's read and b's double
# buffer, 8 warps a block) stays under 48 KB up to this padded width
MAX_W = 4096
# consecutive pairs a warp walks, in list order (kPairsAWarp)
PAIRS_A_WARP = 32
# up to this padded width (8 words a plane) the planes sit in registers
REG_MAX_W = 256
# cells (pairs x W x (W + 1)) the plain version holds at once: about
# 0.8 GB of temporaries a chunk
PLAIN_CELLS = 1 << 26

# Kernel launches since the last reset; set to 0 to start counting.
launches = 0

_LIB = None


def right_align(reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Shift each left-aligned padded read to the right edge of its slot.

    (N, L) int8 + (N,) lengths -> (N, L) int8 with PAD on the left:
    out[i, p] = reads[i, p - (L - len_i)] for p >= L - len_i.
    """
    n, l = reads.shape
    shift = (l - lengths.to(torch.int64))[:, None]               # (N, 1)
    src = torch.arange(l, device=reads.device)[None, :] - shift  # (N, L)
    gathered = torch.gather(reads, 1, src.clamp(0, max(l - 1, 0)))
    return torch.where(src >= 0, gathered,
                       torch.tensor(int(PAD), dtype=reads.dtype,
                                    device=reads.device))


def left_align(right: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Inverse of `right_align`: (N, L) int8 reads right-aligned in their
    slots -> left-aligned, PAD on the right."""
    l = right.shape[1]
    src = (torch.arange(l, device=right.device)[None, :]
           + (l - lengths.to(torch.int64))[:, None])
    gathered = torch.gather(right, 1, src.clamp(0, max(l - 1, 0)))
    return torch.where(src < l, gathered,
                       torch.tensor(int(PAD), dtype=right.dtype,
                                    device=right.device))


def plane_stride(w: int) -> int:
    """Words a bit plane of a read takes in the scratch: a zero word, the
    ceil(w / 32) words of 32 positions, a zero word, padded to a multiple
    of four so that each read's planes start on 16 bytes."""
    return ((w + 31) // 32 + 2 + 3) // 4 * 4


def scratch_words(n_reads: int, w: int) -> int:
    """int32 words of the kernel's scratch: three planes and a length word
    (length | 1 << 16 when every position below it is a base) a read."""
    return n_reads * (3 * plane_stride(w) + 1)


def load_kernel():
    """Build (if needed) and load the kernel library; raises RuntimeError
    with nvcc's output when the build fails."""
    global _LIB
    if _LIB is None:
        from .overlap_allpairs import NVCC_FLAGS, _nvcc

        path = build_shared_library("overlap_pairs", SOURCE,
                                    [_nvcc(), *NVCC_FLAGS],
                                    timeout=BUILD_TIMEOUT_S)
        lib = ctypes.CDLL(path)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.overlap_pairs_launch.restype = i
        lib.overlap_pairs_launch.argtypes = [
            vp, vp, i, i,        # codes (U, W), lengths, U, W
            vp, vp, ll,          # ia, ib, pairs
            i, i,                # match, mismatch
            vp, vp,              # score out, end out
            vp, ll,              # scratch, its int32 words
            vp, i,               # stream, device index
        ]
        _LIB = lib
    return _LIB


def _check_pairs(codes, lengths, ia, ib, match_score, mismatch):
    """Raise on inputs that the kernel does not take; both devices refuse
    the same inputs."""
    if codes.dim() != 2 or codes.dtype != torch.int8:
        raise ValueError("codes must be an (U, W) int8 matrix")
    u, w = codes.shape
    if tuple(lengths.shape) != (u,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be a (U,) int32 vector")
    if (ia.dim() != 1 or ia.shape != ib.shape
            or ia.dtype != torch.int32 or ib.dtype != torch.int32):
        raise ValueError("ia and ib must be (P,) int32 vectors")
    devices = {t.device for t in (codes, lengths, ia, ib)}
    if len(devices) != 1:
        raise ValueError(f"inputs on more than one device: {devices}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    if w > MAX_W:
        raise ValueError(f"padded width {w} exceeds {MAX_W}; chunk reads")
    if (abs(match_score - mismatch) + abs(mismatch)) * w >= 2**31:
        raise ValueError(f"scores overflow int32 for match={match_score}, "
                         f"mismatch={mismatch}, W={w}")
    # the kernel would read outside the rows: refuse on both devices (one
    # sync on a card for the three range tests)
    bad = torch.stack([((lengths < 0) | (lengths > w)).any(),
                       ((ia < 0) | (ia >= u)).any(),
                       ((ib < 0) | (ib >= u)).any()])
    if bool(bad.any()):
        bad_lengths, bad_ia, _ = bad.tolist()
        if bad_lengths:
            raise ValueError(f"lengths must lie in [0, {w}]")
        raise ValueError(f"{'ia' if bad_ia else 'ib'} must lie in [0, {u})")


def overlap_scores_pairs(codes: torch.Tensor, lengths: torch.Tensor,
                         ia: torch.Tensor, ib: torch.Tensor,
                         match_score: int = 10, mismatch: int = -1):
    """Score the listed ordered pairs (codes[ia[p]], codes[ib[p]]).

    Args:
        codes:   (U, W) int8 LEFT-aligned reads (PAD-padded).
        lengths: (U,) int32 true lengths, in [0, W].
        ia, ib:  (P,) int32 source and target read indices, in [0, U).

    Returns:
        (scores, ends): (P,) int32 tensors on the inputs' device.

    CUDA tensors go to the kernel (launched on the current stream, not
    synchronised); CPU tensors to ``overlap_scores_pairs_plain``.
    """
    global launches
    _check_pairs(codes, lengths, ia, ib, match_score, mismatch)
    dev = codes.device
    if dev.type == "cpu":
        return overlap_scores_pairs_plain(codes, lengths, ia, ib,
                                          match_score, mismatch)
    for name, t in (("codes", codes), ("lengths", lengths), ("ia", ia),
                    ("ib", ib)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = launch(codes, lengths, ia, ib, match_score, mismatch)
    if ia.numel():
        launches += 1
    return out


def overlap_scores(a_right: torch.Tensor, a_len: torch.Tensor,
                   b: torch.Tensor, b_len: torch.Tensor,
                   match_score: int = 10, mismatch: int = -1):
    """Score a batch of read pairs, one pair a row: the JAX package's
    ``ops/overlap.py::overlap_scores``, with its operands and contract.

    Args:
        a_right: (B, L) int8 source reads, RIGHT-aligned (PAD on the left).
        a_len:   (B,) int32 true lengths of a.
        b:       (B, L) int8 target reads, LEFT-aligned.
        b_len:   (B,) int32 true lengths of b.

    Returns:
        (score, end_pos): (B,) int32 tensors on the inputs' device, the
        first strict maximum over j = 0 .. len(b) and its j; a PAD (or N)
        cell scores 0.

    Row p of a is left-aligned and stacked over b, and pair p is scored as
    rows (p, B + p) of that (2B, L) matrix by `overlap_scores_pairs`: the
    kernel on a CUDA tensor, the plain version on a CPU tensor. Refuses the
    penalties and widths that the JAX function asserts against.
    """
    n, l = a_right.shape
    if max(abs(match_score - mismatch),
           abs(match_score + 3 * mismatch)) > 256:
        raise ValueError("channel weights must be bf16-exact integers "
                         "(|match - mismatch|, |match + 3 mismatch| <= 256)")
    if 4 * max(abs(match_score), abs(mismatch)) * l >= 2**24:
        raise ValueError("4*score exceeds the f32 exact-integer range; "
                         "chunk reads")
    codes = torch.cat([left_align(a_right, a_len), b])
    lengths = torch.cat([a_len, b_len])
    ia = torch.arange(n, dtype=torch.int32, device=a_right.device)
    return overlap_scores_pairs(codes, lengths, ia, ia + n, match_score,
                                mismatch)


def launch(codes, lengths, ia, ib, match_score=10, mismatch=-1):
    """The launch entry on CUDA tensors that ``overlap_scores_pairs`` has
    checked: allocates the outputs and the scratch and launches both
    kernels; not counted in ``launches``. Raises when a launch fails."""
    dev = codes.device
    n_pairs = ia.numel()
    scores = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    ends = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    if n_pairs == 0:
        return scores, ends
    u, w = codes.shape
    scratch = torch.empty(scratch_words(u, w), dtype=torch.int32, device=dev)
    err = load_kernel().overlap_pairs_launch(
        codes.data_ptr(), lengths.data_ptr(), u, w,
        ia.data_ptr(), ib.data_ptr(), n_pairs, match_score, mismatch,
        scores.data_ptr(), ends.data_ptr(), scratch.data_ptr(),
        scratch.numel(), torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device())
    if err != 0:
        raise RuntimeError(f"overlap_pairs kernel launch failed: "
                           f"cudaError {err}")
    return scores, ends


def overlap_scores_pairs_plain(codes: torch.Tensor, lengths: torch.Tensor,
                               ia: torch.Tensor, ib: torch.Tensor,
                               match_score: int = 10, mismatch: int = -1):
    """The same function in plain PyTorch, the layout of ``overlap_scores``:
    a right-aligned in its slot of width W, and score(j) the sum of the
    int32 cell scores on the diagonal slot u against b[u + j - W]. Runs on
    any device, in chunks of at most PLAIN_CELLS cells; the CPU tests and
    the kernel's checks on the card use it."""
    dev = codes.device
    w = codes.shape[1]
    n_pairs = ia.numel()
    scores = torch.zeros(n_pairs, dtype=torch.int32, device=dev)
    ends = torch.zeros(n_pairs, dtype=torch.int32, device=dev)
    if n_pairs == 0 or w == 0:
        return scores, ends
    lengths = lengths.to(torch.int64)
    pos = torch.arange(w, device=dev)
    is_base = (codes >= 0) & (codes < 4) & (pos[None, :] < lengths[:, None])
    slot = pos[:, None]                                   # (W, 1)
    j = torch.arange(w + 1, device=dev)                   # (W+1,)
    b_idx = slot + j[None, :] - w                         # (W, W+1)
    in_b = b_idx >= 0
    b_idx = b_idx.clamp(min=0)
    match = torch.tensor(match_score, dtype=torch.int32, device=dev)
    miss = torch.tensor(mismatch, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    step = max(1, PLAIN_CELLS // (w * (w + 1)))
    for lo in range(0, n_pairs, step):
        a_i = ia[lo:lo + step].to(torch.int64)
        b_i = ib[lo:lo + step].to(torch.int64)
        # a right-aligned: slot s holds a[s - (W - len a)]
        src = pos[None, :] - (w - lengths[a_i])[:, None]  # (B, W)
        in_a = src >= 0
        src = src.clamp(min=0)
        a_codes = codes[a_i].gather(1, src)
        a_base = is_base[a_i].gather(1, src) & in_a
        b_codes = codes[b_i][:, b_idx]                    # (B, W, W+1)
        b_base = is_base[b_i][:, b_idx] & in_b
        both = a_base[:, :, None] & b_base
        cell = torch.where(both, torch.where(
            a_codes[:, :, None] == b_codes, match, miss), zero)
        per_j = cell.sum(dim=1, dtype=torch.int32)        # (B, W+1)
        over = j[None, :] > lengths[b_i][:, None]
        per_j = per_j.masked_fill(over, -(2**31) + 1)
        best = per_j.argmax(dim=1)                        # first maximum
        scores[lo:lo + step] = per_j.gather(1, best[:, None])[:, 0]
        ends[lo:lo + step] = best.to(torch.int32)
    return scores, ends


def overlap_align_full(a: torch.Tensor, a_len: torch.Tensor,
                       b: torch.Tensor, b_len: torch.Tensor,
                       match_score: int = 10, mismatch: int = -1,
                       indel: int = -2):
    """Full overlap DP (gaps allowed) via an anti-diagonal wavefront, as
    torch ops on the inputs' device (the JAX package's
    ``ops/overlap.py::overlap_align_full``).

    Exact tie-break cascade of the reference (aligners.py:40-48):
    diag if diag>=up and diag>=left; elif up>=left -> up; else left.
    `indel` is clamped to -2**24 — values below that are numerically
    indistinguishable from "never choose a gap" (dp is bounded by ±10*L)
    and clamping keeps all arithmetic exactly representable in int32.

    Args:
        a: (B, L) int8 LEFT-aligned source reads.
        a_len: (B,) int32 true lengths of a, in [0, L].
        b: (B, L) int8 LEFT-aligned target reads.
        b_len: (B,) int32, in [0, L].

    Returns (score, end_pos) — (B,) int32 each: the first maximum of the
    last row dp[len a][j] over j = 0 .. len b, and its j.
    """
    if a.dim() != 2 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"a and b must be (B, L) of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, L = a.shape
    dev = a.device
    if L == 0:
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        return zeros, zeros.clone()
    indel_c = max(int(indel), -(2**24))
    # cells outside the (len a + 1) x (len b + 1) rectangle never win a max
    neg = -(2**28)
    i_idx = torch.arange(L + 1, device=dev)[None, :]           # (1, L+1)
    n = a_len.to(torch.int64)[:, None]                          # (B, 1)
    m = b_len.to(torch.int64)[:, None]
    # a[i-1] on every slot i of a diagonal (slot 0 is a boundary cell)
    a_i = a[:, (i_idx[0] - 1).clamp(0, L - 1)]                  # (B, L+1)
    b_rows = torch.arange(B, device=dev)[:, None]

    def valid(d):
        j = d - i_idx
        return (i_idx <= n) & (j <= m) & (j >= 0)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    neg_t = torch.full((), neg, dtype=torch.int32, device=dev)
    dm2 = torch.where(i_idx == 0, zero, neg_t).expand(B, L + 1)  # d = 0
    dm1 = torch.where((i_idx <= 1) & valid(1), zero, neg_t)     # d = 1
    # dp[len a][d - len a] for every diagonal d: slot len a of diagonal d
    at_n = [dm2.gather(1, n), dm1.gather(1, n)]
    for d in range(2, 2 * L + 1):
        b_j = b[:, (d - i_idx[0] - 1).clamp(0, L - 1)]
        sub = torch.where(a_i == b_j, match_score, mismatch).to(torch.int32)
        diag = torch.roll(dm2, 1, dims=1) + sub                 # dp[i-1][j-1]
        up = torch.roll(dm1, 1, dims=1) + indel_c               # dp[i-1][j]
        left = dm1 + indel_c                                    # dp[i][j-1]
        take_diag = (diag >= up) & (diag >= left)
        val = torch.where(take_diag, diag, torch.where(up >= left, up, left))
        # boundaries: dp[0][j] = 0 and dp[i][0] = 0
        val = torch.where((i_idx == 0) | (i_idx == d), zero, val)
        val = torch.where(valid(d), val, neg_t)
        at_n.append(val.gather(1, n))
        dm2, dm1 = dm1, val
    per_d = torch.cat(at_n, dim=1)                              # (B, 2L+1)
    j = torch.arange(L + 1, device=dev)[None, :]
    last_row = per_d.gather(1, (n + j).clamp(0, 2 * L))         # (B, L+1)
    masked = torch.where(j <= m, last_row, neg_t)
    end_pos = masked.argmax(dim=1)                              # first max
    score = masked[b_rows[:, 0], end_pos]
    return score.to(torch.int32), end_pos.to(torch.int32)


def overlap_scores_host(pairs_a: np.ndarray, pairs_b: np.ndarray,
                        len_a: np.ndarray, len_b: np.ndarray,
                        match_score: int = 10, mismatch: int = -1):
    """Pure-numpy no-gap scorer (same math as `overlap_scores_pairs`, one
    pair a row of the two operand matrices), used as a mid-level
    cross-check between the Python oracle and the kernels."""
    B, L = pairs_a.shape
    scores = np.zeros((B,), dtype=np.int32)
    ends = np.zeros((B,), dtype=np.int32)
    for p in range(B):
        n, m = int(len_a[p]), int(len_b[p])
        s = pairs_a[p, :n]
        t = pairs_b[p, :m]
        best, bj = -np.inf, 0
        for j in range(m + 1):
            d = min(n, j)
            if d == 0:
                v = 0
            else:
                seg_s = s[n - d:]
                seg_t = t[j - d:j]
                eq = seg_s == seg_t
                v = int(match_score * eq.sum() + mismatch * (~eq).sum())
            if v > best:
                best, bj = v, j
        scores[p] = best
        ends[p] = bj
    return scores, ends
