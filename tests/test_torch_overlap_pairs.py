"""The pair-list overlap scorer of the sparse route against the JAX package.

- the plain ``overlap_scores_pairs`` equals JAX ``ops/overlap.py::
  overlap_scores`` on the right-aligned gathered operands (ragged lengths
  0, 1, W - 1 and W; W = 150 and 1,023; internal PAD; penalties 5/-4;
  ia == ib and repeated pairs), and the C++ ``gc_overlap_nogap_pairs`` on
  reads without an N;
- an N inside a read: ``overlap_scores`` (and the port's pair scorer) give
  58 where the C++ scorer gives 57 (ROADMAP §C 3);
- a numpy model of the CUDA kernel's arithmetic (bit planes, funnel
  shifts, popcounts, the lanes' first maxima and the warp's fold) equals
  the plain version: the kernel itself runs only on a card
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
    else:
        raise KeyError(name)
    u = len(codes)
    return (codes, lens, rs.randint(0, u, p).astype(np.int32),
            rs.randint(0, u, p).astype(np.int32), 10, -1)


CASES = ["ragged W=150", "lengths 0, 1, W-1, W", "wide W=1023",
         "internal PAD", "penalties 5/-4", "ia == ib and repeated pairs"]
PAD_FREE = [c for c in CASES if c != "internal PAD"]


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


def _funnel_r(lo: int, hi: int, sh: int) -> int:
    return ((hi << 32 | lo) >> sh) & 0xFFFFFFFF


def _planes(row, n, nw):
    """Three bit planes (bit 0, bit 1, is a base) of nw + 2 words, zero
    words first and last, as the kernel's pack_read builds them."""
    out = [[0] * (nw + 2) for _ in range(3)]
    for pos in range(min(n, len(row))):
        c = int(row[pos])
        if 0 <= c < 4:
            w, t = divmod(pos, 32)
            out[0][1 + w] |= (c & 1) << t
            out[1][1 + w] |= ((c >> 1) & 1) << t
            out[2][1 + w] |= 1 << t
    return out


def kernel_model(codes, lens, ia, ib, ms=10, mm=-1):
    """The arithmetic of csrc/overlap_pairs.cu, pair by pair, lane by lane."""
    w_pad = codes.shape[1]
    nw = (w_pad + 31) // 32
    scores, ends = [], []
    for ua, ub in zip(ia, ib):
        la, lb = int(lens[ua]), int(lens[ub])
        a = _planes(codes[ua], la, nw)
        b = _planes(codes[ub], lb, nw)
        w_last = (la - 1) >> 5
        lanes = []
        for lane in range(32):
            best_s, best_j = 0, 0
            for j in range(lane + 1, lb + 1, 32):
                o = j - la
                w0 = (-o) >> 5 if o < 0 else 0
                base = 32 * w0 + o
                assert base >= -31
                wi, sh = base >> 5, base & 31
                prev = [b[q][1 + wi] for q in range(3)]
                matches = valid = 0
                for w in range(w0, w_last + 1):
                    assert wi + 1 <= nw
                    nxt = [b[q][2 + wi] for q in range(3)]
                    blo, bhi, bv = (_funnel_r(prev[q], nxt[q], sh)
                                    for q in range(3))
                    both = a[2][1 + w] & bv
                    differ = (a[0][1 + w] ^ blo) | (a[1][1 + w] ^ bhi)
                    matches += bin(both & ~differ & 0xFFFFFFFF).count("1")
                    valid += bin(both).count("1")
                    prev = nxt
                    wi += 1
                s = mm * valid + (ms - mm) * matches
                if s > best_s:
                    best_s, best_j = s, j
            lanes.append((best_s, best_j))
        for off in (16, 8, 4, 2, 1):
            # __shfl_down_sync: lanes past 31 - off read their own value
            lanes = [min(lanes[t], lanes[t + off] if t + off < 32 else lanes[t],
                         key=lambda sj: (-sj[0], sj[1]))
                     for t in range(32)]
        scores.append(lanes[0][0])
        ends.append(lanes[0][1])
    return np.array(scores, np.int32), np.array(ends, np.int32)


@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_matches_plain(case):
    codes, lens, ia, ib, ms, mm = _case(case)
    keep = slice(0, 60)                     # the model is a Python loop
    ia, ib = ia[keep], ib[keep]
    got = kernel_model(codes, lens, ia, ib, ms, mm)
    want = _port(codes, lens, ia, ib, ms, mm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


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
                        lambda device: False)
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
