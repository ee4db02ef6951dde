"""The port's Smith-Waterman module against the JAX package's, on the CPU.

- the plain ``local_align_batch_ops`` and ``local_align_batch_banded``
  against the JAX functions on the same numpy-seeded inputs, exactly;
- the wrappers on CPU tensors (the plain versions) against the C++ engine;
- the four seed helpers against the JAX package's;
- a numpy emulation of the two CUDA kernels' traversal (a warp of 32 rows
  sweeping anti-diagonals, row buffers between strips, 2-bit codes, the
  strip's best-cell reduction and the walk) against the plain versions:
  the kernels themselves run only on a card
  (tests/test_torch_kernel_gpu.py, chip_smoke.py).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.ops import smith_waterman as jsw
from genome_assembly_tpu_torch.native import graphcore
from genome_assembly_tpu_torch.ops import smith_waterman as sw

PAD = 4


def _codes(rs, n_rows, width, lengths, alphabet=4):
    lengths = np.asarray(lengths, np.int32)
    mat = rs.randint(0, alphabet, size=(n_rows, width)).astype(np.int8)
    mat[np.arange(width)[None, :] >= lengths[:, None]] = PAD
    return mat, lengths


def _full_case(name):
    """(queries, q_len, genome, w_len, penalties) for the full-width pass."""
    rs = np.random.RandomState(7)
    genome = rs.randint(0, 4, size=300).astype(np.int8)
    pen = (10, -1, -1)
    if name == "ragged":
        q, ql = _codes(rs, 12, 70, rs.randint(1, 71, size=12))
        wl = rs.randint(1, 301, size=12)
    elif name == "ties":
        # repeated substrings and a two-letter genome: many equal maxima
        genome = np.tile(np.array([0, 1, 0, 1, 1], np.int8), 40)
        q, ql = _codes(rs, 8, 40, rs.randint(5, 41, size=8), alphabet=2)
        wl = np.full(8, 200)
    elif name == "internal N":
        q, ql = _codes(rs, 8, 50, np.full(8, 50))
        q[:, 10] = PAD
        genome[[5, 50, 120]] = PAD
        q[0, :30] = genome[40:70]
        wl = np.full(8, 300)
    elif name == "empty query and window":
        q, ql = _codes(rs, 6, 30, [0, 30, 12, 0, 30, 1])
        wl = np.array([300, 0, 5, 0, 300, 1])
    elif name == "query longer than window":
        q, ql = _codes(rs, 6, 90, np.full(6, 90))
        q[1, 10:40] = genome[-30:]
        wl = np.array([20, 30, 5, 89, 40, 1])
    elif name == "tail windows":
        q, ql = _codes(rs, 8, 60, rs.randint(20, 61, size=8))
        for r in range(8):
            q[r, :ql[r]] = genome[300 - ql[r]:]
            q[r, ql[r] // 2] = (q[r, ql[r] // 2] + 1) % 4
        wl = ql.copy()
    elif name == "penalties 5/-3/-2":
        q, ql = _codes(rs, 10, 64, rs.randint(1, 65, size=10))
        q[2, :64] = genome[100:164]
        q[2, 20] = PAD
        wl = rs.randint(1, 301, size=10)
        pen = (5, -3, -2)
    elif name == "two strips":
        # > 32 rows: the row buffer between strips and the cross-strip max
        q, ql = _codes(rs, 5, 100, [100, 33, 64, 65, 97])
        q[0, :100] = genome[150:250]
        q[0, [10, 50, 90]] = PAD
        wl = np.full(5, 300)
    else:
        raise KeyError(name)
    return q, ql, genome, np.asarray(wl, np.int32), pen


FULL_CASES = ["ragged", "ties", "internal N", "empty query and window",
              "query longer than window", "tail windows",
              "penalties 5/-3/-2", "two strips"]


def _band_case(name):
    """(queries, q_len, genome, d0, band, penalties) for the banded pass."""
    rs = np.random.RandomState(11)
    genome = rs.randint(0, 4, size=400).astype(np.int8)
    q, ql = _codes(rs, 8, 80, rs.randint(0, 81, size=8))
    for r in range(0, 8, 2):
        start = rs.randint(0, 400 - ql[r] + 1)
        q[r, :ql[r]] = genome[start:start + ql[r]]
    q[1, 5] = PAD
    d0 = np.array([-50, -3, 0, 5, 150, 330, 390, 1000], np.int32)
    pen = (10, -1, -1)
    band = {"band 0": 0, "band 1": 1, "band 6": 6, "band 40": 40,
            "penalties 5/-3/-2": 6, "band past the genome": 3,
            "two strips": 8}[name]
    if name == "penalties 5/-3/-2":
        pen = (5, -3, -2)
    if name == "band past the genome":
        d0 = np.array([-500, -90, 401, 480, 2000, -200, 0, 399], np.int32)
    if name == "two strips":
        q, ql = _codes(rs, 4, 90, [90, 40, 70, 33])
        q[0, :90] = genome[200:290]
        q[0, [20, 60]] = (q[0, [20, 60]] + 1) % 4
        d0 = np.array([200, 7, -10, 300], np.int32)
    return q, ql, genome, d0, band, pen


BAND_CASES = ["band 0", "band 1", "band 6", "band 40", "penalties 5/-3/-2",
              "band past the genome", "two strips"]


def _windows(genome, w_len, width):
    m = len(genome)
    refs = np.full((len(w_len), width), PAD, np.int8)
    for b, w in enumerate(w_len):
        refs[b, :w] = genome[m - w:]
    return refs


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", FULL_CASES)
def test_plain_full_width_matches_jax(case):
    q, ql, genome, wl, pen = _full_case(case)
    refs = _windows(genome, wl, len(genome))
    ref = jsw.local_align_batch_ops(jnp.asarray(q), jnp.asarray(ql),
                                    jnp.asarray(refs), jnp.asarray(wl), *pen)
    got = sw.local_align_batch_ops(*_t(q, ql, refs, wl), *pen)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("case", BAND_CASES)
def test_plain_banded_matches_jax(case):
    q, ql, genome, d0, band, pen = _band_case(case)
    m = len(genome)
    ref = jsw.local_align_batch_banded(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(genome[None]),
        jnp.full((len(q),), m, jnp.int32), jnp.asarray(d0), band, *pen)
    got = sw.local_align_batch_banded(
        *_t(q, ql, genome[None], np.full(len(q), m, np.int32), d0), band,
        *pen)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def _trim(ops_row):
    stop = np.nonzero(ops_row == 0)[0]
    return ops_row[:stop[0]] if len(stop) else ops_row


@pytest.mark.parametrize("case", FULL_CASES)
def test_full_width_wrapper_on_cpu_equals_cpp_engine(case):
    q, ql, genome, wl, pen = _full_case(case)
    best, bi, bj, ops, start = sw.sw_full_width(*_t(q, ql, genome, wl), *pen)
    assert ops.shape == (len(q), q.shape[1] + len(genome))
    queries = ["".join("ACGTN"[c] for c in row[:n]) for row, n in zip(q, ql)]
    score, ci, cj, steps, cops = graphcore.local_align_batch_suffix_windows(
        queries, genome, wl, *pen)
    np.testing.assert_array_equal(best.numpy(), score)
    np.testing.assert_array_equal(bi.numpy(), ci)
    np.testing.assert_array_equal(bj.numpy(), cj)
    for b in range(len(q)):
        np.testing.assert_array_equal(_trim(ops[b].numpy()),
                                      cops[b, :steps[b]])
        rmove = np.isin(cops[b, :steps[b]], (1, 3)).sum()
        assert int(start[b]) == int(cj[b]) - rmove


@pytest.mark.parametrize("case", BAND_CASES)
def test_banded_wrapper_on_cpu_equals_cpp_engine(case):
    q, ql, genome, d0, band, pen = _band_case(case)
    best, bi, bj, ops, start = sw.sw_banded(*_t(q, ql, genome, d0), band,
                                            *pen)
    assert ops.shape == (len(q), 2 * q.shape[1] + 2 * band + 1)
    queries = ["".join("ACGTN"[c] for c in row[:n]) for row, n in zip(q, ql)]
    score, ci, cj, steps, cops = graphcore.local_align_banded_batch(
        queries, genome, d0, band, *pen)
    np.testing.assert_array_equal(best.numpy(), score)
    np.testing.assert_array_equal(bi.numpy(), ci)
    np.testing.assert_array_equal(bj.numpy(), cj)
    for b in range(len(q)):
        np.testing.assert_array_equal(_trim(ops[b].numpy()),
                                      cops[b, :steps[b]])


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, ql, genome, wl, _ = _full_case("ragged")
    tq, tql, tg, twl = _t(q, ql, genome, wl)
    with pytest.raises(ValueError, match="indel"):
        sw.sw_full_width(tq, tql, tg, twl, 10, -1, 1)
    with pytest.raises(ValueError, match="window lengths"):
        sw.sw_full_width(tq, tql, tg, twl + 1000)
    with pytest.raises(ValueError, match="query lengths"):
        sw.sw_full_width(tq, tql.clone().fill_(71), tg, twl)
    with pytest.raises(ValueError, match="int8"):
        sw.sw_full_width(tq.to(torch.int32), tql, tg, twl)
    with pytest.raises(ValueError, match="overflow"):
        sw.sw_full_width(tq, tql, tg, twl, 2**22, -1, -1)
    with pytest.raises(ValueError, match="band"):
        sw.sw_banded(tq, tql, tg, twl, -1)
    meta = torch.zeros((2, 4), dtype=torch.int8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sw.sw_full_width(meta, lens, torch.zeros(4, dtype=torch.int8,
                                                 device="meta"), lens)
    with pytest.raises(ValueError, match="unsupported device"):
        sw.sw_banded(meta, lens, torch.zeros(4, dtype=torch.int8,
                                             device="meta"), lens, 3)


def test_seed_helpers_match_jax():
    r = random.Random(3)
    genome = "".join(r.choice("ACGT") for _ in range(2000))
    genome = genome[:700] + "NN" + genome[702:]
    contigs = [genome[100:400], genome[1500:1700] + genome[300:380],
               "ACGTACGTAC", genome[650:760], "", genome[1990:],
               "".join(r.choice("ACGT") for _ in range(200))]
    for k in (9, 15):
        got = sw.seed_diagonals_batch(contigs, genome, k=k)
        ref = jsw.seed_diagonals_batch(contigs, genome, k=k)
        for g, e in zip(got, ref):
            np.testing.assert_array_equal(g, e)
        for g, e in zip(sw.genome_hash_index(genome, k),
                        jsw.genome_hash_index(genome, k)):
            np.testing.assert_array_equal(g, e)
        index = sw.genome_kmer_index(genome, k)
        assert index == jsw.genome_kmer_index(genome, k)
        for c in contigs:
            assert (sw.seed_diagonal(c, index, len(genome), k)
                    == jsw.seed_diagonal(c, index, len(genome), k))


def test_local_align_one_and_traceback_host_match_jax():
    r = random.Random(5)
    ref = "".join(r.choice("ACGT") for _ in range(120))
    for query in (ref[30:80], ref[10:40] + "T" + ref[41:70], "GATTACA", ""):
        assert (sw.local_align_one(query, ref, device="cpu")
                == jsw.local_align_one(query, ref))
    query = ref[20:60]
    q, ql = _t(*_codes(np.random.RandomState(0), 1, 40, [40]))
    q[0] = torch.from_numpy(np.frombuffer(
        query.translate(str.maketrans("ACGT", "\0\1\2\3")).encode(),
        np.int8).copy())
    g = torch.from_numpy(np.frombuffer(
        ref.translate(str.maketrans("ACGT", "\0\1\2\3")).encode(),
        np.int8).copy())
    best, bi, bj, codes = sw.local_align_batch(q, ql, g[None],
                                               torch.tensor([120]))
    assert (sw.traceback_host(codes[:, 0].numpy(), int(bi[0]), int(bj[0]),
                              query, ref)
            == jsw.traceback_host(codes[:, 0].numpy(), int(bi[0]),
                                  int(bj[0]), query, ref))


# ---------------------------------------------------------------------------
# numpy emulation of csrc/smith_waterman.cu
# ---------------------------------------------------------------------------

LANES = np.arange(32)


def _warp_sweep(steps, lane_state, qc, row_above, match, mismatch, indel):
    """One strip of the kernels' wavefront, as the warp runs it: at each
    step lane 0 takes its up value from the row above (``row_above``, the
    previous strip's last row by column or band slot), every other lane
    from lane - 1's last value (a shuffle); diag is the up value of the
    step before. ``lane_state(step)`` gives per lane whether the cell
    counts, its column or slot, the genome code it faces and whether its
    value is kept (0 otherwise), and lane 31's slot for the row buffer (or
    None). Returns the packed 2-bit codes, the lanes' first strict maxima
    (score, column or slot) and lane 31's values by slot."""
    h = np.zeros(32, np.int64)
    hd = np.zeros(32, np.int64)
    hd[0] = row_above.get(0, 0)
    words = np.zeros(((steps + 15) // 16, 32), np.uint64)
    lane_best = np.zeros(32, np.int64)
    lane_at = np.zeros(32, np.int64)
    last_row = {}
    for step in range(steps):
        u = np.r_[row_above.get(step + 1, 0), h[:-1]]
        counts, at, rc, keep, out_slot = lane_state(step)
        diag = hd + np.where(rc == qc, match, mismatch)
        up = u + indel
        hn = np.maximum(np.maximum(diag, up), np.maximum(h + indel, 0))
        code = np.where(hn > 0, np.where(hn == diag, 1,
                                         np.where(hn == up, 2, 3)), 0)
        words[step >> 4] |= code.astype(np.uint64) << np.uint64(
            2 * (step & 15))
        upd = counts & (hn > lane_best)
        lane_best = np.where(upd, hn, lane_best)
        lane_at = np.where(upd, at, lane_at)
        hd = u
        h = np.where(keep, hn, 0)
        if out_slot is not None:
            last_row[out_slot] = int(h[31])
    return words, lane_best, lane_at, last_row


def _reduce(best, bi, b_at, lane_best, lane_at, s):
    """The strip's best cell: highest score, then the lowest row."""
    smax = int(lane_best.max())
    if smax > best:
        src = int(np.argmax(lane_best == smax))
        return smax, 32 * s + 1 + src, int(lane_at[src])
    return best, bi, b_at


def _read_code(codes, i, step):
    s, k = (i - 1) >> 5, (i - 1) & 31
    return int((codes[s][step >> 4, k] >> np.uint64(2 * (step & 15))) & 3)


def emulate_full_kernel(q, n, genome, w, match, mismatch, indel, stride):
    """One item of sw_full_kernel: (best, bi, bj, ops, start_j)."""
    m = len(genome)
    ops = np.zeros(stride, np.uint8)
    if n == 0 or w == 0:
        return 0, 0, 0, ops, 0
    rp = genome[m - w:]
    best = bi = bj = 0
    row_above: dict = {}               # by column; column 0 reads 0
    codes = []
    for s in range((n + 31) // 32):
        row_ok = 32 * s + 1 + LANES <= n
        qc = np.where(row_ok, q[np.minimum(32 * s + LANES, n - 1)], -1)

        def lane_state(step):
            j = step - LANES + 1
            col_ok = (j >= 1) & (j <= w)
            jo = step - 30
            return (col_ok & row_ok, j, rp[np.clip(j - 1, 0, w - 1)],
                    col_ok, jo if 1 <= jo <= w else None)

        words, lane_best, lane_j, row_above = _warp_sweep(
            w + 31, lane_state, qc, row_above, match, mismatch, indel)
        codes.append(words)
        best, bi, bj = _reduce(best, bi, bj, lane_best, lane_j, s)
    i, j, k = bi, bj, 0
    while i > 0 and j > 0 and k < stride:
        c = _read_code(codes, i, j - 1 + ((i - 1) & 31))
        if c == 0:
            break
        ops[k] = c
        k += 1
        i -= c != 3
        j -= c != 2
    return best, bi, bj, ops, j


def emulate_banded_kernel(q, n, genome, d0, band, match, mismatch, indel,
                          stride):
    """One item of sw_banded_kernel: (best, bi, bj, ops, start_j)."""
    m = len(genome)
    ops = np.zeros(stride, np.uint8)
    if n == 0 or m == 0:
        return 0, 0, 0, ops, 0
    wb = 2 * band + 1
    best = bi = bt = 0
    row_above: dict = {}               # by band slot
    codes = []
    for s in range((n + 31) // 32):
        row_ok = 32 * s + 1 + LANES <= n
        qc = np.where(row_ok, q[np.minimum(32 * s + LANES, n - 1)], -1)
        jlo = d0 - band + 32 * s + 1 + LANES

        def lane_state(step):
            t = step - 2 * LANES
            j = jlo + t
            ok = (t >= 0) & (t < wb) & (j >= 1) & (j <= m) & row_ok
            to = step - 62
            return (ok, t, genome[np.clip(j - 1, 0, m - 1)], ok,
                    to if 0 <= to < wb else None)

        words, lane_best, lane_t, row_above = _warp_sweep(
            wb + 62, lane_state, qc, row_above, match, mismatch, indel)
        codes.append(words)
        best, bi, bt = _reduce(best, bi, bt, lane_best, lane_t, s)
    if best == 0:
        return 0, 0, 0, ops, 0
    i, t, k = bi, bt, 0
    while i > 0 and d0 - band + i + t > 0 and 0 <= t < wb and k < stride:
        c = _read_code(codes, i, t + 2 * ((i - 1) & 31))
        if c == 0:
            break
        ops[k] = c
        k += 1
        i -= c != 3
        t += (c == 2) - (c == 3)
    return best, bi, d0 - band + bi + bt, ops, d0 - band + i + t


@pytest.mark.parametrize("case", FULL_CASES)
def test_full_kernel_traversal_matches_plain(case):
    q, ql, genome, wl, pen = _full_case(case)
    best, bi, bj, ops, start = sw.sw_full_width_plain(
        *_t(q, ql, genome, wl), *pen)
    stride = q.shape[1] + len(genome)
    for b in range(len(q)):
        e = emulate_full_kernel(q[b], int(ql[b]), genome, int(wl[b]), *pen,
                                stride)
        assert e[:3] == (int(best[b]), int(bi[b]), int(bj[b])), b
        np.testing.assert_array_equal(e[3], ops[b].numpy())
        assert e[4] == int(start[b])


@pytest.mark.parametrize("case", BAND_CASES)
def test_banded_kernel_traversal_matches_plain(case):
    q, ql, genome, d0, band, pen = _band_case(case)
    best, bi, bj, ops, start = sw.sw_banded_plain(
        *_t(q, ql, genome, d0), band, *pen)
    stride = 2 * q.shape[1] + 2 * band + 1
    for b in range(len(q)):
        e = emulate_banded_kernel(q[b], int(ql[b]), genome, int(d0[b]), band,
                                  *pen, stride)
        assert e[:3] == (int(best[b]), int(bi[b]), int(bj[b])), b
        np.testing.assert_array_equal(e[3], ops[b].numpy())
        assert e[4] == int(start[b])
