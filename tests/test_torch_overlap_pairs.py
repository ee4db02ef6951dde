"""The pair-list overlap scorer of the sparse route against the JAX package.

- the plain ``overlap_scores_pairs`` equals JAX ``ops/overlap.py::
  overlap_scores`` on the right-aligned gathered operands (ragged lengths
  0, 1, W - 1 and W; W = 150, 256, 257 and 1,023; internal PAD; penalties
  5/-4; ia == ib and repeated pairs; sorted join pairs), and the C++ ``gc_overlap_nogap_pairs`` on
  reads without an N;
- an N inside a read: ``overlap_scores`` (and the port's pair scorer) give
  58 where the C++ scorer gives 57 (ROADMAP §C 3);
- a numpy model of the CUDA kernels' arithmetic (every read packed once
  into bit planes with the padded stride, a warp a chunk of pairs with a's
  planes kept while ia repeats, warp-uniform word-steps with clamped
  funnel shifts, the one-popcount path for reads without an N beside the
  two-popcount path, the lanes' first maxima and the warp's fold) equals
  the plain version, also on sorted pairs of the port's own join, on one
  run mixing clean reads and reads with an N, and at W = 256 and 257; the
  same model with the fast path forced on reads with an N must differ
  (a negative control). The kernels run only on a card
  (tests/test_torch_kernel_gpu.py);
- ``score_pairs``' sparse route on CPU tensors (the plain version, with
  DENSE_MAX_U set low) equals the JAX package's route.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.graph.build import (
    build_overlap_graph as jax_build_overlap_graph,
    dedup_reads as jax_dedup_reads,
    score_pairs as jax_score_pairs,
)
from genome_assembly_tpu.native import graphcore as jax_graphcore
from genome_assembly_tpu.ops.overlap import (
    overlap_scores as jax_overlap_scores,
    right_align as jax_right_align,
)
from genome_assembly_tpu.ops.overlap_allpairs import (
    overlap_scores_block_xla as jax_block_xla,
)
from genome_assembly_tpu_torch.core import dispatch
from genome_assembly_tpu_torch.core.encoding import encode_batch
from genome_assembly_tpu_torch.graph import build as port_build
from genome_assembly_tpu_torch.ops import overlap as op


def _batch(rs, n, w, lengths=None):
    if lengths is None:
        lengths = rs.randint(0, w + 1, size=n)
    lengths = np.asarray(lengths, np.int32)
    codes = rs.randint(0, 4, size=(n, w)).astype(np.int8)
    codes[np.arange(w)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def _with_n(rs, codes, lengths):
    for r in range(0, len(codes), 2):
        if lengths[r] > 0:
            codes[r, rs.randint(0, lengths[r], size=3)] = 4


def _case(name):
    """(codes, lengths, ia, ib, match, mismatch) from a seed."""
    rs = np.random.RandomState(7)
    if name == "ragged W=150":
        codes, lens = _batch(rs, 60, 150)
        p = 400
    elif name == "lengths 0, 1, W-1, W":
        codes, lens = _batch(rs, 40, 150, rs.choice([0, 1, 149, 150], 40))
        p = 300
    elif name == "wide W=1023":
        codes, lens = _batch(rs, 12, 1023, rs.randint(900, 1024, size=12))
        p = 20
    elif name == "internal PAD":
        codes, lens = _batch(rs, 60, 150)
        _with_n(rs, codes, lens)
        p = 400
    elif name == "penalties 5/-4":
        codes, lens = _batch(rs, 50, 60)
        ia = rs.randint(0, 50, 300).astype(np.int32)
        return codes, lens, ia, rs.randint(0, 50, 300).astype(np.int32), 5, -4
    elif name == "ia == ib and repeated pairs":
        codes, lens = _batch(rs, 30, 150)
        ia = np.r_[np.arange(30), [3] * 10, [5, 5, 5]].astype(np.int32)
        ib = np.r_[np.arange(30), [7] * 10, [5, 9, 5]].astype(np.int32)
        return codes, lens, ia, ib, 10, -1
    elif name == "join pairs, sorted runs":
        return (*_join_window(), 10, -1)
    elif name == "one run, clean and N reads":
        # a clean source read, then one with an N, each against a run of
        # targets that alternate clean and N reads, across a chunk boundary
        codes, lens = _batch(rs, 40, 150, rs.randint(120, 151, size=40))
        _with_n(rs, codes, lens)            # N in the even reads
        ib = rs.permutation(np.r_[1:40])[:37]
        ia = np.r_[[1] * 37, [0] * 37].astype(np.int32)
        return codes, lens, ia, np.r_[ib, ib].astype(np.int32), 10, -1
    elif name in ("W=256", "W=257"):
        w = int(name[2:])
        codes, lens = _batch(rs, 24, w, rs.choice([0, 1, w - 33, w - 1, w],
                                                  24))
        _with_n(rs, codes[:8], lens[:8])
        ia = np.sort(rs.randint(0, 24, 45)).astype(np.int32)
        return codes, lens, ia, rs.randint(0, 24, 45).astype(np.int32), 10, -1
    else:
        raise KeyError(name)
    u = len(codes)
    return (codes, lens, rs.randint(0, u, p).astype(np.int32),
            rs.randint(0, u, p).astype(np.int32), 10, -1)


CASES = ["ragged W=150", "lengths 0, 1, W-1, W", "wide W=1023",
         "internal PAD", "penalties 5/-4", "ia == ib and repeated pairs",
         "join pairs, sorted runs", "one run, clean and N reads", "W=256",
         "W=257"]
PAD_FREE = [c for c in CASES if c not in (
    "internal PAD", "one run, clean and N reads", "W=256", "W=257")]
# the pairs of a case that the numpy model of the kernel runs (it is a
# Python loop): the first 60, or the whole list
MODEL_PAIRS = {"join pairs, sorted runs": None,
               "one run, clean and N reads": None}


def _runs(ia):
    """(start, stop) of each run of equal ia."""
    starts = np.r_[0, np.flatnonzero(np.diff(ia)) + 1]
    return starts, np.r_[starts[1:], len(ia)]


def _join_window(span=160):
    """Reads of 100-150 bases from a genome of 300 random bases and 500 of
    two letters, the port's k = 4 join on them (pairs sorted by (ia, ib)),
    and the first window of `span` pairs from a run start that holds a run
    longer than a chunk, a run of one and a run across a chunk boundary."""
    r = random.Random(2)
    genome = ("".join(r.choice("ACGT") for _ in range(300))
              + "".join(r.choice("AC") for _ in range(500)))
    reads = []
    for _ in range(1200):
        start, n = r.randrange(len(genome) - 100), r.randint(100, 150)
        reads.append(genome[start:start + n])
    unique, _ = port_build.dedup_reads(reads)
    ia, ib = port_build.candidate_pairs_arrays(unique, 4, device="cpu")
    codes, lens = encode_batch(unique, align="left")
    chunk = op.PAIRS_A_WARP
    for lo in _runs(ia)[0]:
        starts, stops = _runs(ia[lo:lo + span])
        whole = stops < min(span, len(ia) - lo)
        size = (stops - starts)[whole]
        across = (starts // chunk != (stops - 1) // chunk)[whole]
        if (size > chunk).any() and (size == 1).any() and across.any():
            return codes, lens, ia[lo:lo + span], ib[lo:lo + span]
    raise AssertionError("no window with the runs the case needs")


def _port(codes, lens, ia, ib, ms=10, mm=-1):
    s, e = op.overlap_scores_pairs(torch.from_numpy(codes),
                                   torch.from_numpy(lens),
                                   torch.from_numpy(ia),
                                   torch.from_numpy(ib), ms, mm)
    return s.numpy(), e.numpy()


def _jax(codes, lens, ia, ib, ms=10, mm=-1):
    right = np.asarray(jax_right_align(jnp.asarray(codes), jnp.asarray(lens)))
    s, e = jax_overlap_scores(
        jnp.asarray(right[ia]), jnp.asarray(lens[ia]),
        jnp.asarray(codes[ib]), jnp.asarray(lens[ib]),
        match_score=ms, mismatch=mm)
    return np.asarray(s), np.asarray(e)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_overlap_scores(case):
    codes, lens, ia, ib, ms, mm = _case(case)
    got = _port(codes, lens, ia, ib, ms, mm)
    want = _jax(codes, lens, ia, ib, ms, mm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32


@pytest.mark.parametrize("case", PAD_FREE)
def test_plain_matches_cpp_on_pad_free_reads(case):
    codes, lens, ia, ib, ms, mm = _case(case)
    got = _port(codes, lens, ia, ib, ms, mm)
    want = jax_graphcore.overlap_nogap_pairs(codes, lens, ia, ib, ms, mm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_internal_n_gets_a_fourth_answer():
    """ROADMAP §C 3: a PAD cell scores 0 in overlap_scores (and here), the
    mismatch in the C++ scorer and in the one-hot all-pairs version."""
    codes, lens = encode_batch(["ACGTACGTAC", "CGTACNTTTT"])
    ia, ib = np.array([0], np.int32), np.array([1], np.int32)
    assert tuple(map(int, np.concatenate(_port(codes, lens, ia, ib)))) == (
        58, 9)
    assert int(_jax(codes, lens, ia, ib)[0][0]) == 58
    assert int(jax_graphcore.overlap_nogap_pairs(codes, lens, ia,
                                                 ib)[0][0]) == 57
    s_xla, _ = jax_block_xla(jnp.asarray(codes[:1]), jnp.asarray(lens[:1]),
                             jnp.asarray(codes[1:]), jnp.asarray(lens[1:]))
    assert int(np.asarray(s_xla)[0, 0]) == 57


def _funnel_rc(lo, hi, sh):
    """__funnelshift_rc: (hi:lo) >> min(sh, 32), the low 32 bits."""
    return (((hi << np.uint64(32)) | lo) >> np.minimum(sh, 32).astype(
        np.uint64)) & np.uint64(0xFFFFFFFF)


def _popc(x):
    return np.bitwise_count(x).astype(np.int64)


CLEAN_BIT = 1 << 16


def pack_model(codes, lens):
    """overlap_pairs_kernel_pack: (U, 3, plane_stride) uint64 planes (bit 0
    of the code, bit 1, a base inside the length; word w of a plane at
    1 + w, zero words before, after and in the padding) and the length
    words (length | CLEAN_BIT when every position below it is a base)."""
    u, w_pad = codes.shape
    nw = (w_pad + 31) // 32
    ps = op.plane_stride(w_pad)
    assert ps % 4 == 0 and ps >= nw + 2
    assert op.scratch_words(u, w_pad) == u * (3 * ps + 1)
    c = np.full((u, 32 * nw), 4, np.int64)
    c[:, :w_pad] = codes
    inside = np.arange(32 * nw)[None, :] < np.asarray(lens)[:, None]
    base = inside & (c >= 0) & (c < 4)
    bits = np.stack([base & (c & 1 == 1), base & (c & 2 == 2), base], 1)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (bits.reshape(u, 3, nw, 32).astype(np.uint64) * weights).sum(
        -1, dtype=np.uint64)
    planes = np.zeros((u, 3, ps), np.uint64)
    planes[:, :, 1:1 + nw] = words
    clean = ~(inside & ~base).any(1)
    return planes, np.asarray(lens, np.int64) | np.where(clean, CLEAN_BIT, 0)


def _score_model(a, b, la, lb, clean, nw, ms, mm):
    """One pair, the 32 lanes as a vector: lane t takes the ends
    j = la - 32 k - t; step k faces a's word w with b's words w - k - 1 and
    w - k (at plane index w - k and w - k + 1). The register instances
    (nw <= REG_MAX_W / 32) shift b's words into the lane's place once a
    pair and run every step to a's word nw - 1 (a's words past its length
    are zero); the generic instance shifts in each step and stops at a's
    last word."""
    t = np.arange(32)
    sh = 32 - t
    low = (np.uint64(0xFFFFFFFF) << t.astype(np.uint64)) & np.uint64(
        0xFFFFFFFF)
    regs = nw <= op.REG_MAX_W // 32
    if regs:                                # bs[q][i]: b's words i - 1, i
        bs = [[_funnel_rc(b[q, i], b[q, i + 1], sh) for i in range(nw + 1)]
              for q in range(3)]
    w_last = (la - 1) >> 5
    k_lo = -((lb - la + 31) >> 5)
    thr = np.ones(32, np.int64)             # j = 0 scores 0
    best_j = np.zeros(32, np.int64)
    for k in range(k_lo, w_last + 1):
        assert -nw <= k < max(nw, 1)        # the register template's range
        matches = np.zeros(32, np.int64)
        valid = np.zeros(32, np.int64)
        for w in range(max(k, 0), nw if regs else w_last + 1):
            i = w - k                       # b's word w - k - 1 at [i]
            if regs:
                if i > nw:                  # faces only b's zero words
                    continue
                blo, bhi, bv = bs[0][i], bs[1][i], bs[2][i]
            else:
                assert 0 <= i and i + 1 <= nw + 1 and 1 + w <= nw
                blo, bhi, bv = (_funnel_rc(b[q, i], b[q, i + 1], sh)
                                for q in range(3))
            av = a[2, 1 + w]
            mask = av & low if w == k else np.full(32, av)
            differ = (a[0, 1 + w] ^ blo) | (a[1, 1 + w] ^ bhi)
            if clean:
                matches += _popc(mask & ~differ)
            else:
                both = mask & bv
                matches += _popc(both & ~differ)
                valid += _popc(both)
        jm1 = la - 1 - t - 32 * k           # ends met in decreasing order
        if clean:
            valid = np.minimum(la, jm1 + 1)
        s = mm * valid + (ms - mm) * matches
        take = ((jm1 >= 0) & (jm1 < lb)) & (s >= thr)
        thr = np.where(take, s, thr)
        best_j = np.where(take, jm1 + 1, best_j)
    best_s = np.where(best_j > 0, thr, 0)
    s = best_s.max()                        # the warp's fold
    return s, best_j[best_s == s].min()


def kernel_model(codes, lens, ia, ib, ms=10, mm=-1, force_clean=False):
    """The arithmetic of csrc/overlap_pairs.cu: the reads packed once, then
    a warp a chunk of PAIRS_A_WARP pairs in list order, reloading a's
    planes only when ia changes. Returns (scores, ends, a's loads).
    force_clean takes the one-popcount path for every pair (a negative
    control: wrong where a read has an N)."""
    planes, meta = pack_model(codes, lens)
    nw = (codes.shape[1] + 31) // 32
    scores = np.zeros(len(ia), np.int32)
    ends = np.zeros(len(ia), np.int32)
    loads = 0
    for p0 in range(0, len(ia), op.PAIRS_A_WARP):
        cur_a = -1
        for p in range(p0, min(p0 + op.PAIRS_A_WARP, len(ia))):
            if ia[p] != cur_a:
                cur_a = ia[p]
                a, ma = planes[cur_a].copy(), int(meta[cur_a])
                loads += 1
            b, mb = planes[ib[p]], int(meta[ib[p]])
            clean = force_clean or bool(ma & mb & CLEAN_BIT)
            scores[p], ends[p] = _score_model(
                a, b, ma & 0xFFFF, mb & 0xFFFF, clean, nw, ms, mm)
    return scores, ends, loads


def _segments(ia):
    """Runs of equal ia cut at chunk boundaries: a's loads in the kernel."""
    p = np.arange(len(ia))
    return int(((p % op.PAIRS_A_WARP == 0)
                | (np.r_[-1, ia[:-1]] != ia)).sum())


@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_matches_plain(case):
    codes, lens, ia, ib, ms, mm = _case(case)
    keep = slice(0, MODEL_PAIRS.get(case, 60))
    ia, ib = ia[keep], ib[keep]
    *got, loads = kernel_model(codes, lens, ia, ib, ms, mm)
    want = _port(codes, lens, ia, ib, ms, mm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert loads == _segments(ia)


def test_join_case_holds_the_runs_it_names():
    """The join case's pairs: sorted, a run longer than a chunk, a run of
    one and a run across a chunk boundary; a's planes are loaded once a
    run and chunk, so far fewer times than there are pairs."""
    _, _, ia, ib, _, _ = _case("join pairs, sorted runs")
    assert (np.diff(ia) >= 0).all()
    starts, stops = _runs(ia)
    size = stops - starts
    chunk = op.PAIRS_A_WARP
    assert (size > chunk).any() and (size[:-1] == 1).any()
    assert (starts // chunk != (stops - 1) // chunk).any()
    assert _segments(ia) * 4 < len(ia)


def test_fast_path_on_reads_with_n_differs_from_plain():
    """Negative control: the one-popcount path taken where a read has an
    N inside its length must give other scores than the plain version."""
    codes, lens, ia, ib, ms, mm = _case("internal PAD")
    ia, ib = ia[:60], ib[:60]
    want = _port(codes, lens, ia, ib, ms, mm)
    forced = kernel_model(codes, lens, ia, ib, ms, mm, force_clean=True)
    assert not np.array_equal(forced[0], want[0])
    clean = kernel_model(codes, lens, ia, ib, ms, mm)
    np.testing.assert_array_equal(clean[0], want[0])


def _reads(seed, n=90, l=14, genome_len=260):
    r = random.Random(seed)
    genome = "".join(r.choice("ACGT") for _ in range(genome_len))
    reads = [genome[r.randrange(genome_len):][:l] for _ in range(n)]
    return reads + reads[::9]


@pytest.mark.parametrize("k", [3, 6])
def test_sparse_route_of_score_pairs_matches_jax(k, monkeypatch):
    """On CPU tensors the sparse route runs the plain version; the JAX
    package scores the same pairs with its C++ route (no N in the reads)."""
    reads = _reads(11 + k)
    unique, _ = jax_dedup_reads(reads)
    calls = []
    real = op.overlap_scores_pairs

    def spy(*args, **kwargs):
        calls.append(args[2].numel())
        return real(*args, **kwargs)

    monkeypatch.setattr(dispatch, "use_host_pair_scoring",
                        lambda device, *rule: False)
    monkeypatch.setattr(port_build, "DENSE_MAX_U", 4)
    monkeypatch.setattr(op, "overlap_scores_pairs", spy)
    ia, ib = port_build.candidate_pairs_arrays(unique, k, device="cpu")
    assert len(ia) * 20 < len(unique) ** 2
    got = port_build.score_pairs(unique, (ia, ib), device="cpu")
    want = jax_score_pairs(unique, (ia, ib))
    assert calls == [len(ia)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    g = port_build.build_overlap_graph(reads, k=k, device="cpu")
    g0 = jax_build_overlap_graph(reads, k=k)
    for a, b in zip((g.src, g.dst, g.weight, g.end_pos),
                    (g0.src, g0.dst, g0.weight, g0.end_pos)):
        np.testing.assert_array_equal(a, b)


def _tensors(codes, lens, ia, ib):
    return [torch.from_numpy(np.asarray(x)) for x in (codes, lens, ia, ib)]


@pytest.mark.parametrize("bad, match", [
    ("length -1", "lengths"), ("length W+1", "lengths"),
    ("ia -1", "ia"), ("ib U", "ib"), ("W > MAX_W", "padded width"),
    ("int64 pairs", "int32"),
])
def test_rejects_inputs_the_kernel_does_not_take(bad, match):
    rs = np.random.RandomState(3)
    codes, lens = _batch(rs, 6, 20)
    ia, ib = np.arange(6, dtype=np.int32), np.arange(6, dtype=np.int32)[::-1]
    ib = ib.copy()
    if bad == "length -1":
        lens[2] = -1
    elif bad == "length W+1":
        lens[2] = 21
    elif bad == "ia -1":
        ia[0] = -1
    elif bad == "ib U":
        ib[0] = 6
    elif bad == "W > MAX_W":
        codes = np.full((2, op.MAX_W + 1), 4, np.int8)
        lens, ia, ib = lens[:2], ia[:2] % 2, ib[:2] % 2
    elif bad == "int64 pairs":
        ia = ia.astype(np.int64)
    with pytest.raises(ValueError, match=match):
        op.overlap_scores_pairs(*_tensors(codes, lens, ia, ib))


def test_empty_pair_list_and_empty_reads():
    codes = np.full((3, 0), 4, np.int8)
    lens = np.zeros(3, np.int32)
    s, e = op.overlap_scores_pairs(*_tensors(
        codes, lens, np.array([0, 1], np.int32), np.array([2, 2], np.int32)))
    assert s.tolist() == [0, 0] and e.tolist() == [0, 0]
    codes, lens = _batch(np.random.RandomState(0), 3, 9)
    s, e = op.overlap_scores_pairs(*_tensors(
        codes, lens, np.zeros(0, np.int32), np.zeros(0, np.int32)))
    assert s.shape == e.shape == (0,)
