"""The port's Smith-Waterman module against the JAX package's, on the CPU.

- the plain ``local_align_batch_ops`` and ``local_align_batch_banded``
  against the JAX functions on the same numpy-seeded inputs, exactly;
- the wrappers on CPU tensors (the plain versions) against the C++ engine;
- the four seed helpers against the JAX package's;
- a numpy emulation of the two CUDA kernels' traversal (a warp of 32 rows
  sweeping anti-diagonals, row buffers between strips, 2-bit codes, the
  strip's best-cell reduction and the walk) against the plain versions,
  with an item's strips spread over a block of 1, 2, 4 or 8 warps as the
  kernels run them: each strip waits on the progress of the strip above,
  the two row buffers are shared, and the warps interleave in every order
  the wait allows; a wait one block short must corrupt a result. The
  kernels themselves run only on a card (tests/test_torch_kernel_gpu.py,
  chip_smoke.py).
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
    elif name == "ties across warps":
        q, ql, genome = _tie_across_warps(rs)
        wl = np.full(len(q), len(genome))
    else:
        raise KeyError(name)
    return q, ql, genome, np.asarray(wl, np.int32), pen


FULL_CASES = ["ragged", "ties", "internal N", "empty query and window",
              "query longer than window", "tail windows",
              "penalties 5/-3/-2", "two strips", "ties across warps"]


def _tie_across_warps(rs):
    """Queries whose best score ties between strips 7 and 8: at W = 2, 4
    and 8 they belong to warps W - 1 and 0, so a block that folded its
    warps' maxima by warp index would report the later row.

    The genome's only 0/1 stretch is y = genome[100:132]; row 0 is 224 N
    (which never match the genome), y, y: exactly 320 at rows 256 and 288
    and nowhere above it. Row 1 ties between strips 1 and 9, which one
    warp runs at every W."""
    genome = rs.randint(2, 4, size=200).astype(np.int8)
    y = rs.randint(0, 2, size=32).astype(np.int8)
    genome[100:132] = y
    q = np.full((2, 320), PAD, np.int8)
    q[0, 224:256] = q[0, 256:288] = y
    q[1, 29:61] = q[1, 284:316] = y
    return q, np.array([288, 320], np.int32), genome


def _band_tie_across_warps(rs):
    """The banded form of `_tie_across_warps`: y twice in the genome
    (columns 101-132 and 150-181) and twice in the query (rows 208-239 and
    257-288), both on diagonal -107, with 17 rows between them at
    penalties -20, so the second alignment starts anew: 320 at rows 239
    (strip 7) and 288 (strip 8)."""
    genome = rs.randint(2, 4, size=200).astype(np.int8)
    y = rs.randint(0, 2, size=32).astype(np.int8)
    genome[100:132] = genome[149:181] = y
    q = np.full((1, 288), PAD, np.int8)
    q[0, 207:239] = q[0, 256:288] = y
    return q, np.array([288], np.int32), genome


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
            "two strips": 8, "ties across warps": 5}[name]
    if name == "penalties 5/-3/-2":
        pen = (5, -3, -2)
    if name == "band past the genome":
        d0 = np.array([-500, -90, 401, 480, 2000, -200, 0, 399], np.int32)
    if name == "two strips":
        q, ql = _codes(rs, 4, 90, [90, 40, 70, 33])
        q[0, :90] = genome[200:290]
        q[0, [20, 60]] = (q[0, [20, 60]] + 1) % 4
        d0 = np.array([200, 7, -10, 300], np.int32)
    if name == "ties across warps":
        q, ql, genome = _band_tie_across_warps(rs)
        d0 = np.array([-107], np.int32)
        pen = (10, -20, -20)
    return q, ql, genome, d0, band, pen


BAND_CASES = ["band 0", "band 1", "band 6", "band 40", "penalties 5/-3/-2",
              "band past the genome", "two strips", "ties across warps"]


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
KPAD = 15             # csrc kPad: index x of a row buffer lives at x + kPad
BLOCK = 16            # csrc kBlock: steps per block, one load and one flag
WARPS = [1, 2, 4, 8]  # the instantiations of sw_kernel's kW
POLICIES = ["in order", "readers first", "random 0", "random 1"]


def _strip_sweep(s, steps, width, banded, lane_state, qc, bufs, pen,
                 slack=0):
    """One strip of the kernels' wavefront as its warp runs it, as a
    generator that stops where the block's other warps may run: it yields
    ("wait", done) before lane 0 loads row-buffer values (strip s - 1 must
    have done `done` steps first) and ("done", steps) after each block of
    16 steps, when lane 31 publishes its progress; it returns the packed
    2-bit codes and the lanes' first strict maxima (score, column or slot).

    Lane 0 takes its up value from the row buffer ``bufs[s & 1]``, loaded
    a block before use, the other lanes from lane - 1 (a shuffle); diag is
    the up value of the step before; lane 31 stores into
    ``bufs[(s + 1) & 1]`` by index x + 1 (full width) or slot x (banded).
    ``lane_state(step)`` gives per lane whether the cell counts (else its
    value is 0), its column or slot and the genome code it faces. `slack`
    steps taken off each wait make the wait rule wrong (a negative
    control)."""
    match, mismatch, indel = pen
    hin, hout = bufs[s & 1], bufs[(s + 1) & 1]
    last_shift, store_off = (62, 0) if banded else (31, 1)
    lag = last_shift - store_off          # index c is stored at step c + lag

    def need(tb):                         # strip s-1 stored tb+1 .. tb+16
        return min(steps, tb + BLOCK + lag + 1) - slack

    def load(tb):
        if s == 0:
            return np.zeros(BLOCK, np.int64)
        return hin[tb + 1 + KPAD:tb + 1 + BLOCK + KPAD].copy()

    if s > 0:
        yield "wait", need(0)
    h = np.zeros(32, np.int64)
    hd = np.zeros(32, np.int64)
    if banded and s > 0:
        hd[0] = hin[KPAD]
    next_above = load(0)
    n16 = (steps + BLOCK - 1) // BLOCK
    words = np.zeros((n16, 32), np.uint64)
    lane_best = np.zeros(32, np.int64)
    lane_at = np.zeros(32, np.int64)
    for tb in range(0, steps, BLOCK):
        above = next_above
        if tb + BLOCK < steps:
            if s > 0:
                yield "wait", need(tb + BLOCK)
            next_above = load(tb + BLOCK)
        for step in range(tb, tb + BLOCK):
            lane0 = above[step - tb] if not banded or step + 1 < width else 0
            u = np.r_[lane0, h[:-1]]
            ok, at, rc = lane_state(step)
            diag = hd + np.where(rc == qc, match, mismatch)
            up = u + indel
            hn = np.maximum(np.maximum(diag, up), np.maximum(h + indel, 0))
            code = np.where(hn > 0, np.where(hn == diag, 1,
                                             np.where(hn == up, 2, 3)), 0)
            words[step >> 4] |= code.astype(np.uint64) << np.uint64(
                2 * (step & 15))
            upd = ok & (hn > lane_best)
            lane_best = np.where(upd, hn, lane_best)
            lane_at = np.where(upd, at, lane_at)
            hd = u
            h = np.where(ok, hn, 0)
            x31 = step - last_shift
            if x31 >= -store_off:
                hout[x31 + store_off + KPAD] = h[31]
        yield "done", min(tb + BLOCK, steps)
    return words, lane_best, lane_at


def _reduce(best, bi, b_at, lane_best, lane_at, s):
    """The strip's best cell: highest score, then the lowest row."""
    smax = int(lane_best.max())
    if smax > best:
        src = int(np.argmax(lane_best == smax))
        return smax, 32 * s + 1 + src, int(lane_at[src])
    return best, bi, b_at


def _fold_warps(per_warp):
    """The block's best cell from its warps' (best, bi, at): highest
    score, then the lowest row."""
    best, bi, at = per_warp[0]
    for wb, wi, wa in per_warp[1:]:
        if wb > best or (wb == best and wi < bi):
            best, bi, at = wb, wi, wa
    return best, bi, at


def _run_block(strips, steps, sweep, warps, policy, slack=0):
    """Run an item's strips on a block of `warps` warps: warp v runs strips
    v, v + W, ... in order, one `_strip_sweep` each; at every point where
    warps may interleave the policy picks one among those the wait rule
    lets go on:
    - "in order": the lowest strip (each producer as far ahead as allowed,
      each reader as late as allowed);
    - "readers first": the highest strip (each reader loads the moment its
      wait allows, each producer only as far ahead as needed);
    - "random <seed>": a choice drawn from np.random.RandomState(seed).
    The two row buffers start as garbage. Returns each strip's codes and
    each warp's best cell, folded over its strips in order."""
    rs = (np.random.RandomState(int(policy.split()[1]))
          if policy.startswith("random") else None)
    buf_rs = np.random.RandomState(strips * 131 + steps)
    hstride = (steps + 48 + 31) // 32 * 32
    bufs = [buf_rs.randint(0, 1000, size=hstride).astype(np.int64)
            for _ in range(2)]
    progress = [0] * warps
    todo = [list(range(v, strips, warps)) for v in range(warps)]
    running = {}                       # warp -> [strip, generator, wait]
    codes = [None] * strips
    best = [(0, 0, 0)] * warps

    def start(v):
        if todo[v]:
            st = todo[v].pop(0)
            running[v] = [st, sweep(st, bufs, slack), None]
        else:
            running.pop(v, None)

    def ready(v):
        st, _, wait = running[v]
        return wait is None or (progress[(v - 1) % warps]
                                >= (st - 1) * steps + wait)

    for v in range(warps):
        start(v)
    while running:
        cands = [v for v in running if ready(v)]
        assert cands, "the block deadlocked"
        if policy == "in order":
            v = min(cands, key=lambda c: running[c][0])
        elif policy == "readers first":
            v = max(cands, key=lambda c: running[c][0])
        else:
            v = cands[rs.randint(len(cands))]
        st, gen, _ = running[v]
        running[v][2] = None
        try:
            kind, value = next(gen)
        except StopIteration as stop:
            words, lane_best, lane_at = stop.value
            codes[st] = words
            best[v] = _reduce(*best[v], lane_best, lane_at, st)
            start(v)
            continue
        if kind == "wait":
            running[v][2] = value
        else:
            progress[v] = st * steps + value
    return codes, best


def _read_code(codes, i, step):
    s, k = (i - 1) >> 5, (i - 1) & 31
    return int((codes[s][step >> 4, k] >> np.uint64(2 * (step & 15))) & 3)


def _strip_inputs(q, n, s):
    row_ok = 32 * s + 1 + LANES <= n
    return row_ok, np.where(row_ok, q[np.minimum(32 * s + LANES, n - 1)], -1)


def emulate_full_kernel(q, n, genome, w, match, mismatch, indel, stride,
                        warps=1, policy="in order", slack=0, per_warp=None):
    """One item of sw_kernel<false, warps>: (best, bi, bj, ops, start_j).
    `per_warp`, a list, receives each warp's best cell."""
    m = len(genome)
    ops = np.zeros(stride, np.uint8)
    if n == 0 or w == 0:
        return 0, 0, 0, ops, 0
    rp = genome[m - w:]
    steps = w + 31

    def sweep(s, bufs, slack):
        row_ok, qc = _strip_inputs(q, n, s)

        def lane_state(step):
            j = step - LANES + 1
            ok = (j >= 1) & (j <= w) & row_ok
            return ok, j - 1, rp[np.clip(j - 1, 0, w - 1)]

        return _strip_sweep(s, steps, w, False, lane_state, qc, bufs,
                            (match, mismatch, indel), slack)

    codes, warp_best = _run_block((n + 31) // 32, steps, sweep, warps,
                                  policy, slack)
    if per_warp is not None:
        per_warp.extend(warp_best)
    best, bi, at = _fold_warps(warp_best)
    i, j, k = bi, at + 1 if best > 0 else 0, 0
    bj = j
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
                          stride, warps=1, policy="in order", slack=0,
                          per_warp=None):
    """One item of sw_kernel<true, warps>: (best, bi, bj, ops, start_j)."""
    m = len(genome)
    ops = np.zeros(stride, np.uint8)
    if n == 0 or m == 0:
        return 0, 0, 0, ops, 0
    wb = 2 * band + 1
    steps = wb + 62

    def sweep(s, bufs, slack):
        row_ok, qc = _strip_inputs(q, n, s)
        jlo = d0 - band + 32 * s + 1 + LANES

        def lane_state(step):
            t = step - 2 * LANES
            j = jlo + t
            ok = (t >= 0) & (t < wb) & (j >= 1) & (j <= m) & row_ok
            return ok, t, genome[np.clip(j - 1, 0, m - 1)]

        return _strip_sweep(s, steps, wb, True, lane_state, qc, bufs,
                            (match, mismatch, indel), slack)

    codes, warp_best = _run_block((n + 31) // 32, steps, sweep, warps,
                                  policy, slack)
    if per_warp is not None:
        per_warp.extend(warp_best)
    best, bi, bt = _fold_warps(warp_best)
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


def _emulated_equals_plain(kind, case, warps, policy, slack=0):
    """Whether the emulated block schedule gives the plain version's
    outputs on every item of a case."""
    if kind == "full":
        q, ql, genome, wl, pen = _full_case(case)
        want = sw.sw_full_width_plain(*_t(q, ql, genome, wl), *pen)
        stride = q.shape[1] + len(genome)
        got = [emulate_full_kernel(q[b], int(ql[b]), genome, int(wl[b]),
                                   *pen, stride, warps, policy, slack)
               for b in range(len(q))]
    else:
        q, ql, genome, d0, band, pen = _band_case(case)
        want = sw.sw_banded_plain(*_t(q, ql, genome, d0), band, *pen)
        stride = 2 * q.shape[1] + 2 * band + 1
        got = [emulate_banded_kernel(q[b], int(ql[b]), genome, int(d0[b]),
                                     band, *pen, stride, warps, policy,
                                     slack)
               for b in range(len(q))]
    best, bi, bj, ops, start = want
    return all(e[:3] == (int(best[b]), int(bi[b]), int(bj[b]))
               and np.array_equal(e[3], ops[b].numpy())
               and e[4] == int(start[b]) for b, e in enumerate(got))


@pytest.mark.parametrize("case", FULL_CASES)
@pytest.mark.parametrize("warps", WARPS)
def test_full_kernel_block_schedule_matches_plain(warps, case):
    # strips spread over a block's warps, under every interleaving policy
    # the wait rule allows (one warp has one order)
    for policy in POLICIES if warps > 1 else POLICIES[:1]:
        assert _emulated_equals_plain("full", case, warps, policy), policy


@pytest.mark.parametrize("case", BAND_CASES)
@pytest.mark.parametrize("warps", WARPS)
def test_banded_kernel_block_schedule_matches_plain(warps, case):
    for policy in POLICIES if warps > 1 else POLICIES[:1]:
        assert _emulated_equals_plain("banded", case, warps, policy), policy


@pytest.mark.parametrize("kind", ["full", "banded"])
@pytest.mark.parametrize("warps", WARPS[1:])
def test_ties_across_warps_fold_by_row_not_by_warp(kind, warps):
    # the case's best score ties between warps whose order by index is not
    # the order of their rows: a fold by warp index gets it wrong
    if kind == "full":
        q, ql, genome, wl, pen = _full_case("ties across warps")
        per_warp: list = []
        e = emulate_full_kernel(q[0], int(ql[0]), genome, int(wl[0]), *pen,
                                q.shape[1] + len(genome), warps,
                                per_warp=per_warp)
        want = sw.sw_full_width_plain(*_t(q, ql, genome, wl), *pen)
    else:
        q, ql, genome, d0, band, pen = _band_case("ties across warps")
        per_warp = []
        e = emulate_banded_kernel(q[0], int(ql[0]), genome, int(d0[0]), band,
                                  *pen, 2 * q.shape[1] + 2 * band + 1,
                                  warps, per_warp=per_warp)
        want = sw.sw_banded_plain(*_t(q, ql, genome, d0), band, *pen)
    top = max(b for b, _, _ in per_warp)
    tied = [(v, bi) for v, (b, bi, _) in enumerate(per_warp) if b == top]
    assert top == 320 and len(tied) == 2
    assert tied[0][1] > tied[1][1]      # the lower warp holds the later row
    assert (e[0], e[1]) == (int(want[0][0]), int(want[1][0])) == (
        top, tied[1][1])


def test_a_wait_one_block_short_corrupts_a_result():
    # negative control: with each wait one block (16 steps) short, a reader
    # loads row-buffer values before they are stored, and the emulation
    # must catch it on some case
    for warps in WARPS[1:]:
        broken = [case for kind, cases in (("full", FULL_CASES),
                                           ("banded", BAND_CASES))
                  for case in cases
                  if not _emulated_equals_plain(kind, case, warps,
                                                "readers first", slack=16)]
        assert broken, warps


def test_warps_per_item_rule():
    # the PhiX main path's 2,642 contigs by strips (a long tail up to 20):
    # the tail sets the warps; the long path's banded launches: 10,730
    # items of at most 7 strips fill the card one warp each, 581 fill it
    # at 4 warps, a few items take 8
    hist = {1: 22, 2: 16, 3: 26, 4: 28, 5: 1167, 6: 697, 7: 332, 8: 174,
            9: 84, 10: 49, 11: 19, 12: 10, 13: 8, 14: 3, 16: 4, 18: 1, 20: 2}
    phix = np.repeat(list(hist), list(hist.values()))
    assert (len(phix), phix.sum()) == (2642, 15820)
    assert sw._warps_per_item(phix, 132) == 4
    rs = np.random.RandomState(0)
    for items, want in ((10730, 1), (581, 4), (166, 8), (49, 8), (4, 8)):
        strips = rs.choice([4, 5, 5, 5, 6, 6, 7], items)
        assert sw._warps_per_item(strips, 132) == want, items
    assert sw._warps_per_item(np.zeros(5, np.int64), 132) == 1
    for strips in (phix, np.array([0, 1, 40]), np.full(10**5, 3)):
        assert sw._warps_per_item(strips, 132) in sw.WARPS_PER_ITEM
