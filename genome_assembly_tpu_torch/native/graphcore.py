"""ctypes loader for the C++ graph engine (libgraphcore.so).

``graphcore.cpp`` is a copy of the JAX package's engine. The library is
built at first use with one ``g++`` call into the port's own build
directory (``genome_assembly_tpu_torch/build/``). A failed build or load
raises with the compiler's output: the port has no pure-Python fallback,
because the Python cycle removal is orders of magnitude slower and would
let a run overrun any time limit without an error.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .._build import build_shared_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "graphcore.cpp")
GXX = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
BUILD_TIMEOUT_S = 300

_LIB = None


def _declare(lib) -> None:
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    ll = ctypes.c_longlong
    for name in ("gc_remove_cycles_v2", "gc_remove_cycles"):
        fn = getattr(lib, name)
        fn.restype = ll
        fn.argtypes = [
            ll, ll,             # num_nodes, num_edges
            i32, i32, i32,      # src, dst, weight
            u8,                 # alive (in/out)
        ]
    lib.gc_overlap_nogap_pairs.restype = ll
    lib.gc_overlap_nogap_pairs.argtypes = [
        ll, ll,                 # n_pairs, stride (width)
        i8, i32,                # reads (U, W), lens
        i32, i32,               # ia, ib
        ll, ll,                 # match, mismatch
        i32, i32,               # score out, end out
        ll,                     # n_threads
    ]
    lib.gc_local_align_batch.restype = ll
    lib.gc_local_align_batch.argtypes = [
        ll, ll,                 # B, q_stride
        i8, i32,                # q codes (B, qs), q_len
        ll, i8,                 # m (genome len), genome codes (m,)
        i32,                    # w_len (suffix window per item)
        ll, ll, ll,             # match, mismatch, indel
        ll,                     # ops_stride
        i32, i32, i32, i32,     # score, bi, bj, steps out
        u8,                     # ops out (B, ops_stride)
        ll,                     # n_threads
    ]
    lib.gc_local_align_banded_batch.restype = ll
    lib.gc_local_align_banded_batch.argtypes = [
        ll, ll,                 # B, q_stride
        i8, i32,                # q codes (B, qs), q_len
        ll, i8,                 # m (genome len), genome codes (m,)
        i32, ll,                # d0 (center diagonal per item), band
        ll, ll, ll,             # match, mismatch, indel
        ll,                     # ops_stride
        i32, i32, i32, i32,     # score, bi, bj, steps out
        u8,                     # ops out (B, ops_stride)
        ll,                     # n_threads
    ]
    lib.gc_overlap_baseline_batch.restype = ll
    lib.gc_overlap_baseline_batch.argtypes = [
        ll, ll,                 # B, L
        i8, i32,                # a codes (B, L), a_len
        i8, i32,                # b codes (B, L), b_len
        ll, ll, ll,             # match, mismatch, indel
        i32, i32,               # score out, end out
    ]
    lib.gc_local_align.restype = ll
    lib.gc_local_align.argtypes = [
        ll, ll,                 # n (query length), m (reference length)
        i8, i8,                 # query codes, reference codes
        ll, ll, ll,             # match, mismatch, indel
        i32, i32, i32,          # score, bi, bj out
        u8,                     # ops out (n + m)
    ]
    lib.gc_greedy_chain.restype = ll
    lib.gc_greedy_chain.argtypes = [
        ll, ll,                 # n_nodes, n_edges
        i32, i32, i64,          # src, dst, order
        i32, i32, i64,          # succ, pred, chain_edge out
    ]


def load():
    """Build (if needed) and load the engine; raises RuntimeError or
    OSError when either fails."""
    global _LIB
    if _LIB is None:
        path = build_shared_library("graphcore", SOURCE, GXX,
                                    timeout=BUILD_TIMEOUT_S)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the engine builds and loads here. A failure is not hidden:
    `load` raises it again at the next use."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def _n_threads(n_threads: int | None = None) -> int:
    return min(os.cpu_count() or 1, 8) if n_threads is None else n_threads


def remove_cycles(g, legacy: bool | None = None) -> int:
    """C++ weakest-edge cycle removal; mutates g.alive. Returns #removed.

    Uses the incremental-resume engine (gc_remove_cycles_v2: the same
    removals in the same order, one DFS prefix instead of one per cycle)
    unless `legacy=True`, or `legacy=None` with GA_TPU_CYCLES_LEGACY=1,
    selects the full-restart loop (gc_remove_cycles)."""
    lib = load()
    if legacy is None:
        legacy = os.environ.get("GA_TPU_CYCLES_LEGACY") == "1"
    alive = np.ascontiguousarray(g.alive, dtype=np.uint8)
    src = np.ascontiguousarray(g.src, dtype=np.int32)
    dst = np.ascontiguousarray(g.dst, dtype=np.int32)
    weight = np.ascontiguousarray(g.weight, dtype=np.int32)
    fn = lib.gc_remove_cycles if legacy else lib.gc_remove_cycles_v2
    removed = fn(g.num_nodes, len(src), src, dst, weight, alive)
    g.alive[:] = alive.astype(bool)
    return int(removed)


def overlap_nogap_pairs(reads_mat, lens, ia, ib, match_score: int = 10,
                        mismatch: int = -1, n_threads: int | None = None):
    """C++ no-gap overlap scoring over candidate index pairs.

    reads_mat: (U, W) int8 LEFT-aligned unique-read codes; lens: (U,)
    int32; ia/ib: (P,) int32 pair indices. Returns (score, end) int32 (P,)
    arrays — the same function as the all-pairs kernel, per pair.
    `n_threads` defaults to min(os.cpu_count(), 8)."""
    lib = load()
    reads_mat = np.ascontiguousarray(reads_mat, dtype=np.int8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    ia = np.ascontiguousarray(ia, dtype=np.int32)
    ib = np.ascontiguousarray(ib, dtype=np.int32)
    n_pairs = len(ia)
    score = np.empty(n_pairs, np.int32)
    end = np.empty(n_pairs, np.int32)
    if n_pairs:
        lib.gc_overlap_nogap_pairs(n_pairs, reads_mat.shape[1], reads_mat,
                                   lens, ia, ib, match_score, mismatch,
                                   score, end, _n_threads(n_threads))
    return score, end


def greedy_chain(n_nodes: int, src, dst, order):
    """C++ greedy best-overlap chain acceptance (the fast layout).

    Returns (succ, chain_edge): succ[u] = accepted successor (-1 none),
    chain_edge[u] = accepted edge index for the u -> succ[u] link.
    Identical by construction to graph.greedy.greedy_chain_python.
    """
    lib = load()
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    succ = np.empty(n_nodes, np.int32)
    pred = np.empty(n_nodes, np.int32)
    chain_edge = np.empty(n_nodes, np.int64)
    lib.gc_greedy_chain(n_nodes, len(order), src, dst, order, succ, pred,
                        chain_edge)
    return succ, chain_edge


def local_align_batch_suffix_windows(queries: list[str], genome_codes,
                                     w_len, match_score: int = 10,
                                     mismatch: int = -1, indel: int = -1,
                                     n_threads: int | None = None):
    """Batched C++ Smith-Waterman of queries against per-item SUFFIX
    windows of one genome (the two window shapes of the metrics pass:
    full genome, or the tail window genome[-n:]).

    Returns (score, bi, bj, steps, ops): int32 arrays (B,) and the
    (B, ops_stride) uint8 op-stream matrix; item p's path is
    ops[p, :steps[p]] in backwards order, coordinates LOCAL to the window
    (the caller adds the m - w offset)."""
    from ..core.encoding import encode_batch

    lib = load()
    B = len(queries)
    genome = np.ascontiguousarray(genome_codes, dtype=np.int8)
    m = len(genome)
    q_mat, q_len = encode_batch(queries)
    q_mat = np.ascontiguousarray(q_mat, dtype=np.int8)
    wl = np.ascontiguousarray(w_len, dtype=np.int32)
    q_stride = q_mat.shape[1] if B else 0
    ops_stride = q_stride + m
    score = np.empty(B, np.int32)
    bi = np.empty(B, np.int32)
    bj = np.empty(B, np.int32)
    steps = np.empty(B, np.int32)
    ops = np.empty((max(B, 1), max(ops_stride, 1)), np.uint8)
    if B:
        lib.gc_local_align_batch(B, q_stride, q_mat, q_len, m, genome, wl,
                                 match_score, mismatch, indel, ops.shape[1],
                                 score, bi, bj, steps, ops,
                                 _n_threads(n_threads))
    return score, bi, bj, steps, ops


def local_align_banded_batch(queries: list[str], genome_codes, d0,
                             band: int, match_score: int = 10,
                             mismatch: int = -1, indel: int = -1,
                             n_threads: int | None = None):
    """Batched C++ diagonal-banded SW against one shared genome
    (ops/smith_waterman.py local_align_batch_banded semantics).

    d0: (B,) int32 center diagonal per item. Returns
    (score, bi, bj, steps, ops) with bj in GLOBAL genome coordinates and
    ops[p, :steps[p]] the backwards path stream (replay with
    replay_ops_host against the full genome)."""
    from ..core.encoding import encode_batch

    lib = load()
    B = len(queries)
    genome = np.ascontiguousarray(genome_codes, dtype=np.int8)
    m = len(genome)
    q_mat, q_len = encode_batch(queries)
    q_mat = np.ascontiguousarray(q_mat, dtype=np.int8)
    d0 = np.ascontiguousarray(d0, dtype=np.int32)
    q_stride = q_mat.shape[1] if B else 0
    ops_stride = 2 * q_stride + 2 * band + 1
    score = np.empty(B, np.int32)
    bi = np.empty(B, np.int32)
    bj = np.empty(B, np.int32)
    steps = np.empty(B, np.int32)
    ops = np.empty((max(B, 1), max(ops_stride, 1)), np.uint8)
    if B:
        lib.gc_local_align_banded_batch(B, q_stride, q_mat, q_len, m,
                                        genome, d0, band, match_score,
                                        mismatch, indel, ops.shape[1],
                                        score, bi, bj, steps, ops,
                                        _n_threads(n_threads))
    return score, bi, bj, steps, ops


def local_align(query: str, reference: str, match_score: int = 10,
                mismatch: int = -1, indel: int = -1):
    """C++ Smith-Waterman with reference semantics (aligners.py:85-167).

    Returns (aligned_ref, aligned_query, score, start, end) like the
    Python oracle (ops/oracle.py local_align_oracle)."""
    from ..core.encoding import encode
    from ..ops.smith_waterman import replay_ops_host

    lib = load()
    n, m = len(query), len(reference)
    if n == 0 or m == 0:
        return "", "", 0, 0, 0
    q = np.ascontiguousarray(encode(query), dtype=np.int8)
    r = np.ascontiguousarray(encode(reference), dtype=np.int8)
    score = np.zeros(1, np.int32)
    bi = np.zeros(1, np.int32)
    bj = np.zeros(1, np.int32)
    ops = np.zeros(n + m, np.uint8)
    steps = lib.gc_local_align(n, m, q, r, match_score, mismatch, indel,
                               score, bi, bj, ops)
    ar, aq, start = replay_ops_host(ops[:steps], int(bi[0]), int(bj[0]),
                                    query, reference)
    return ar, aq, int(score[0]), start, int(bj[0])


def overlap_baseline_batch(a_codes, a_len, b_codes, b_len, match_score=10,
                           mismatch=-1, indel=-(2**31)):
    """Reference-faithful full-DP overlap alignment on a batch of pairs
    (compiled C++, the Numba-baseline stand-in — see graphcore.cpp).

    Args: a_codes/b_codes (B, L) int8 LEFT-aligned, a_len/b_len (B,) int32.
    Returns (score, end_pos) int32 arrays of shape (B,).
    """
    lib = load()
    a = np.ascontiguousarray(a_codes, dtype=np.int8)
    b = np.ascontiguousarray(b_codes, dtype=np.int8)
    al = np.ascontiguousarray(a_len, dtype=np.int32)
    bl = np.ascontiguousarray(b_len, dtype=np.int32)
    B, L = a.shape
    score = np.empty((B,), dtype=np.int32)
    end = np.empty((B,), dtype=np.int32)
    lib.gc_overlap_baseline_batch(B, L, a, al, b, bl, match_score, mismatch,
                                  indel, score, end)
    return score, end
