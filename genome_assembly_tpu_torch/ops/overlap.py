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
while ``ia`` repeats. ``launches`` counts one a call, for both. The gapped
``overlap_align_full`` (ROADMAP A9) is not ported.
"""

from __future__ import annotations

import ctypes
import os

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
