"""All-pairs / block overlap scoring: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

For every ordered pair (a_i, b_t) of reads, the no-gap overlap score of a's
suffix against b's prefix ending at j (reference ``aligners.py:6-82``
semantics with the default penalties, where gaps are never selected):

    d        = min(len(a_i), j)
    score(j) = (match - mismatch) * matches(a_i[-d:], b_t[j-d:j]) + mismatch * d

and the first strict maximum over j = 0 .. len(b_t) (score 0 at j = 0).
Returns (score, end) (Na, Nb) int32 matrices.

``overlap_scores_block`` is the counterpart of the JAX package's Pallas
``overlap_scores_block``. It drops the TPU tiling arguments (``tm``, ``tn``,
``jc``, ``interpret``, ``shift``): on a CUDA tensor it launches
``csrc/overlap_allpairs.cu`` (built with ``nvcc`` at first use), on a CPU
tensor it runs ``overlap_scores_block_plain``, the counterpart of
``overlap_scores_block_xla`` (which is its other name here). There is no
fallback between the two.
``overlap_scores_all_pairs_xla`` (the plain version) and
``overlap_scores_all_pairs_auto`` (the route on a device it resolves, the
card by default) carry the JAX package's entry-point names, and
``overlap_scores_all_pairs_host`` is its numpy oracle, copied.

The kernel counts matches on the tensor cores: bases as one-hot bytes, one
int8 product (``wgmma``) per j over only the positions that j aligns, and a
running max of one int32 key, score * 1024 + (1023 - j), per pair. PAD and
N match nothing, as in ``overlap_scores_block_xla``.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import torch

from .._build import build_shared_library
from ..core.dispatch import resolve_device
from .overlap import right_align

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "overlap_allpairs.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
BUILD_TIMEOUT_S = 300
MAX_L = 1023          # the JAX kernel's packed end-position field
# The kernel counts rows in int32. Its tiles (128 x 128 pairs, or 128 x 16
# for long reads) lie on grid.x, whose 2**31 - 1 blocks outlast any output
# that fits in device memory.
MAX_ROWS = 2**31 - 1

# A base comparison is exact integer matching on int8 codes: as the JAX
# kernel's 3-channel +-1 product (exact in int8, int32 accumulation) it is
# a multiply-add per channel, 6 ops (the useful work of a sweep, priced at
# the card's int8 peak).
OPS_PER_COMPARISON = 6

# Kernel launches since the last reset; set to 0 to start counting.
launches = 0

_LIB = None


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def load_kernel():
    """Build (if needed) and load the kernel library; raises RuntimeError
    with nvcc's output when the build fails."""
    global _LIB
    if _LIB is None:
        path = build_shared_library("overlap_allpairs", SOURCE,
                                    [_nvcc(), *NVCC_FLAGS],
                                    timeout=BUILD_TIMEOUT_S)
        lib = ctypes.CDLL(path)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.overlap_allpairs_launch.restype = i
        lib.overlap_allpairs_launch.argtypes = [
            vp, vp, ll,          # a codes, a_len, na
            vp, vp, ll,          # b codes, b_len, nb
            i, i, i,             # L, match, mismatch
            vp, vp,              # score out, end out
            vp, i,               # stream, device index
        ]
        _LIB = lib
    return _LIB


def _check_inputs(a_codes, a_len, b_codes, b_len, match_score, mismatch):
    """Raise on inputs that the kernel (or the JAX kernel) does not take."""
    if a_codes.dim() != 2 or b_codes.dim() != 2:
        raise ValueError("a_codes and b_codes must be (N, L) matrices")
    na, l = a_codes.shape
    nb, lb = b_codes.shape
    if l != lb:
        raise ValueError(
            f"source and target reads must share the padded width: {l} != {lb}")
    if tuple(a_len.shape) != (na,) or tuple(b_len.shape) != (nb,):
        raise ValueError("a_len / b_len must be (Na,) / (Nb,) vectors")
    if a_codes.dtype != torch.int8 or b_codes.dtype != torch.int8:
        raise ValueError("read codes must be int8")
    if a_len.dtype != torch.int32 or b_len.dtype != torch.int32:
        raise ValueError("lengths must be int32")
    devices = {t.device for t in (a_codes, a_len, b_codes, b_len)}
    if len(devices) != 1:
        raise ValueError(f"inputs on more than one device: {devices}")
    if a_codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a_codes.device}")
    # the same limits as the JAX kernel (its packed f32 running max), so
    # that both packages accept the same inputs
    if max(match_score, -mismatch) * l * 4096 + 1023 >= 2**24:
        raise ValueError(
            f"score/end packing of the reference kernel is not exact for "
            f"match={match_score}, mismatch={mismatch}, L={l}")
    if l > MAX_L:
        raise ValueError(f"padded width {l} exceeds {MAX_L}; chunk reads")
    # the kernel would clamp a length outside [0, L] where the plain
    # version reads it as given: refuse both (one sync on a card)
    for name, t in (("a_len", a_len), ("b_len", b_len)):
        if t.numel() and bool(((t < 0) | (t > l)).any()):
            raise ValueError(f"{name} must lie in [0, {l}]")


def overlap_scores_block(a_codes: torch.Tensor, a_len: torch.Tensor,
                         b_codes: torch.Tensor, b_len: torch.Tensor,
                         match_score: int = 10, mismatch: int = -1):
    """Score the (Na x Nb) block of ordered pairs (a_i, b_t).

    Args:
        a_codes: (Na, L) int8 LEFT-aligned source reads (PAD-padded).
        a_len:   (Na,) int32 true lengths, in [0, L].
        b_codes: (Nb, L) int8 LEFT-aligned target reads.
        b_len:   (Nb,) int32, in [0, L].

    Returns:
        (score, end_pos): (Na, Nb) int32 tensors on the inputs' device.
        Self/duplicate pairs are NOT excluded here (callers do).

    CUDA tensors go to the kernel (launched on the current stream, not
    synchronised); CPU tensors to ``overlap_scores_block_plain``.
    """
    global launches
    _check_inputs(a_codes, a_len, b_codes, b_len, match_score, mismatch)
    dev = a_codes.device
    if dev.type == "cpu":
        return overlap_scores_block_plain(a_codes, a_len, b_codes, b_len,
                                          match_score, mismatch)
    for name, t in (("a_codes", a_codes), ("a_len", a_len),
                    ("b_codes", b_codes), ("b_len", b_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    na, l = a_codes.shape
    nb = b_codes.shape[0]
    if max(na, nb) > MAX_ROWS:
        raise ValueError(f"{max(na, nb)} rows exceed the kernel's {MAX_ROWS}")
    # the kernel's int32 key, score * 1024 + 1023 - j, and its terms
    if ((abs(match_score - mismatch) + abs(mismatch)) * l * 1024 + 1023
            >= 2**31):
        raise ValueError(
            f"the kernel's int32 key overflows for match={match_score}, "
            f"mismatch={mismatch}, L={l}")
    score = torch.empty((na, nb), dtype=torch.int32, device=dev)
    end = torch.empty((na, nb), dtype=torch.int32, device=dev)
    if na == 0 or nb == 0:
        return score, end
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.overlap_allpairs_launch(
        a_codes.data_ptr(), a_len.data_ptr(), na,
        b_codes.data_ptr(), b_len.data_ptr(), nb,
        l, match_score, mismatch, score.data_ptr(), end.data_ptr(),
        stream, dev.index if dev.index is not None
        else torch.cuda.current_device())
    if err != 0:
        raise RuntimeError(f"overlap_allpairs kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return score, end


def overlap_scores_all_pairs(codes: torch.Tensor, lengths: torch.Tensor,
                             match_score: int = 10, mismatch: int = -1):
    """Square all-pairs case of `overlap_scores_block` (same read set as
    both source and target, i == t diagonal included)."""
    return overlap_scores_block(codes, lengths, codes, lengths,
                                match_score=match_score, mismatch=mismatch)


def overlap_scores_all_pairs_xla(codes: torch.Tensor, lengths: torch.Tensor,
                                 match_score: int = 10, mismatch: int = -1):
    """Square all-pairs case of `overlap_scores_block_plain`, the plain
    version, on whichever device the tensors lie (the JAX package's
    ``overlap_scores_all_pairs_xla`` is its plain reference too)."""
    return overlap_scores_block_plain(codes, lengths, codes, lengths,
                                      match_score=match_score,
                                      mismatch=mismatch)


def overlap_scores_all_pairs_auto(codes, lengths, match_score: int = 10,
                                  mismatch: int = -1, device="cuda"):
    """Device-dispatching all-pairs entry point: moves ``codes`` and
    ``lengths`` (tensors or numpy arrays) to ``device`` (``resolve_device``:
    the card by default, RuntimeError without one) and runs
    `overlap_scores_all_pairs` there, the kernel on a card and the plain
    version on the CPU."""
    dev = resolve_device(device)
    return overlap_scores_all_pairs(torch.as_tensor(codes, device=dev),
                                    torch.as_tensor(lengths, device=dev),
                                    match_score=match_score,
                                    mismatch=mismatch)


def overlap_scores_all_pairs_host(codes: np.ndarray, lengths: np.ndarray,
                                  match_score: int = 10, mismatch: int = -1):
    """Numpy oracle for the all-pairs kernel (slow; tests only)."""
    from .overlap import overlap_scores_host

    n = codes.shape[0]
    ia, ib = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    s, e = overlap_scores_host(codes[ia.ravel()], codes[ib.ravel()],
                               lengths[ia.ravel()], lengths[ib.ravel()],
                               match_score=match_score, mismatch=mismatch)
    return s.reshape(n, n), e.reshape(n, n)


def comparisons(a_len, b_len, L: int) -> int:
    """sum over pairs of sum_{j=1}^{len_b} min(len_a, j): the base
    comparisons the function needs for these lengths (the useful work of
    `overlap_scores_block`, OPS_PER_COMPARISON int8 ops each)."""
    n = np.arange(L + 1, dtype=np.int64)[:, None]
    m = np.arange(L + 1, dtype=np.int64)[None, :]
    f = np.where(m <= n, m * (m + 1) // 2, n * (n + 1) // 2 + n * (m - n))
    ca = np.bincount(np.asarray(a_len), minlength=L + 1).astype(np.int64)
    cb = np.bincount(np.asarray(b_len), minlength=L + 1).astype(np.int64)
    return int(ca @ f @ cb)


def tensor_core_ops(a_len, b_len) -> int:
    """int8 ops the kernel performs on the tensor cores: per pair, j runs
    ceil(j/8) k-steps of 8 positions x 4 channels, a multiply-add each
    (the executed work of a launch)."""
    n = np.asarray(b_len, np.int64)
    k = (n + 7) // 8                       # sum_{j<=n} 8 ceil(j/8)
    per_b = 8 * (8 * (k - 1) * k // 2 + k * (n - 8 * (k - 1)))
    return 2 * 4 * len(a_len) * int(per_b.sum())


def _one_hot4(codes: torch.Tensor) -> torch.Tensor:
    """(..., L) int8 -> (..., L, 4) float32 one-hot; PAD (4) -> zeros."""
    return (codes[..., None].to(torch.int64)
            == torch.arange(4, device=codes.device)).to(torch.float32)


def overlap_scores_block_plain(a_codes: torch.Tensor, a_len: torch.Tensor,
                               b_codes: torch.Tensor, b_len: torch.Tensor,
                               match_score: int = 10, mismatch: int = -1):
    """The same function in plain PyTorch, mirroring the JAX package's
    ``overlap_scores_block_xla``: for each j a float32 one-hot product
    (Na, 4L) @ (4L, Nb) counts the matches, with TF32 off so the counts
    are exact. Runs on any device; the CPU tests and the kernel's checks
    on the card use it."""
    na, l = a_codes.shape
    nb = b_codes.shape[0]
    dev = a_codes.device
    a_len = a_len.to(torch.int32)
    b_len = b_len.to(torch.int32)
    a_flat = _one_hot4(right_align(a_codes, a_len)).reshape(na, 4 * l)
    oh_b = _one_hot4(b_codes)                                  # (nb, l, 4)
    best = torch.zeros((na, nb), dtype=torch.int32, device=dev)
    end = torch.zeros((na, nb), dtype=torch.int32, device=dev)
    pos = torch.arange(l, device=dev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for j in range(1, l + 1):
            src = pos + j - l
            in_win = (src >= 0).to(torch.float32)[None, :, None]
            bsh = (oh_b[:, src.clamp(0, l - 1), :] * in_win).reshape(nb, 4 * l)
            matches = torch.round(a_flat @ bsh.T).to(torch.int32)
            d = torch.clamp(a_len[:, None], max=j)
            score = (match_score - mismatch) * matches + mismatch * d
            upd = (j <= b_len)[None, :] & (score > best)
            best = torch.where(upd, score, best)
            end = torch.where(upd, torch.full_like(end, j), end)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return best, end


# The JAX package's name for the plain one-hot contraction.
overlap_scores_block_xla = overlap_scores_block_plain
