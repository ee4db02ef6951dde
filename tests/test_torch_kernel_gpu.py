"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card: the all-pairs and the pair-list overlap kernels, the two
Smith-Waterman kernels and the sequence-parallel SW's kernel (its steps
in worlds simulated in order, at the geometries where its segments or its
path change, and both variants on a one-rank world; the cases and harness
of tests/test_torch_seqpar_kernel.py); and, on the
card, the routes of reads with an N
below the pair threshold, the string-graph and unitig pipelines, the gapped
overlap DP and the device samplers.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from genome_assembly_tpu_torch.ops import overlap as op
from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
from genome_assembly_tpu_torch.ops import seqpar as sq
from genome_assembly_tpu_torch.ops import smith_waterman as sw


def _batch(rs, n, l, lengths=None):
    if lengths is None:
        lengths = rs.randint(1, l + 1, size=n)
    lengths = np.asarray(lengths, np.int32)
    codes = rs.randint(0, 4, size=(n, l)).astype(np.int8)
    codes[np.arange(l)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def _case(name):
    rs = np.random.RandomState(99)
    if name == "square L=150":
        a, al = _batch(rs, 256, 150)
        return a, al, a, al, 10, -1
    if name == "rectangular off-tile":
        a, al = _batch(rs, 37, 150)
        b, bl = _batch(rs, 333, 150)
        return a, al, b, bl, 10, -1
    if name == "penalties L=60":
        a, al = _batch(rs, 40, 60)
        b, bl = _batch(rs, 50, 60)
        return a, al, b, bl, 3, -2
    if name == "penalties 40/-1":
        # match - mismatch = 41: the kernel cannot fold it into its bytes
        a, al = _batch(rs, 40, 60)
        b, bl = _batch(rs, 50, 60)
        return a, al, b, bl, 40, -1
    if name == "L=127":
        a, al = _batch(rs, 64, 127, rs.randint(121, 128, size=64))
        return a, al, a, al, 10, -1
    if name == "lengths 0 and 1":
        a, al = _batch(rs, 45, 150, rs.choice([0, 1, 2, 3, 150], size=45))
        return a, al, a, al, 10, -1
    if name == "two-letter alphabet":
        a, al = _batch(rs, 64, 33)
        a[a < 4] %= 2                       # long runs of matches and ties
        return a, al, a, al, 10, -1
    if name == "internal N":
        # N (code 4) inside every other read; on the diagonal N faces N
        a, al = _batch(rs, 96, 150)
        for r in range(0, 96, 2):
            a[r, rs.randint(0, al[r], size=4)] = 4
        return a, al, a, al, 10, -1
    if name == "129x257 ragged":
        a, al = _batch(rs, 129, 150)
        b, bl = _batch(rs, 257, 150)
        return a, al, b, bl, 10, -1
    if name == "1x1":
        a, al = _batch(rs, 1, 150)
        return a, al, a, al, 10, -1
    if name == "lengths <= 8":
        a, al = _batch(rs, 100, 150, rs.randint(0, 9, size=100))
        return a, al, a, al, 10, -1
    if name == "40x40 L=MAX_L":
        # match=4 is the largest the reference's packing takes at L=1023
        a, al = _batch(rs, 40, oa.MAX_L)
        return a, al, a, al, 4, -1
    if name == "one base changed":
        # each read against itself with one base changed: ties in the max
        a, al = _batch(rs, 130, 150, np.full(130, 150))
        b = a.copy()
        rows, pos = np.arange(130), rs.randint(0, 150, size=130)
        b[rows, pos] = (b[rows, pos] + 1) % 4
        return a, al, b, al, 10, -1
    raise KeyError(name)


CASES = ["square L=150", "rectangular off-tile", "penalties L=60",
         "penalties 40/-1", "L=127",
         "lengths 0 and 1", "two-letter alphabet", "internal N",
         "129x257 ragged", "1x1", "lengths <= 8", "40x40 L=MAX_L",
         "one base changed"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _to(dev, *arrays):
    return [torch.from_numpy(x).to(dev) for x in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain_version(case, cuda_device):
    a, al, b, bl, ms, mm = _case(case)
    ta, tal, tb, tbl = _to(cuda_device, a, al, b, bl)
    before = oa.launches
    s, e = oa.overlap_scores_block(ta, tal, tb, tbl, ms, mm)
    torch.cuda.synchronize()
    assert oa.launches == before + 1
    s0, e0 = oa.overlap_scores_block_plain(ta, tal, tb, tbl, ms, mm)
    assert torch.equal(s, s0)
    assert torch.equal(e, e0)
    # and the plain version on the card equals the plain version on the CPU
    s1, e1 = oa.overlap_scores_block_plain(*_to("cpu", a, al, b, bl),
                                           ms, mm)
    assert torch.equal(s.cpu(), s1) and torch.equal(e.cpu(), e1)


@pytest.mark.gpu
def test_kernel_on_rows_at_an_odd_address(cuda_device):
    # contiguous inputs whose data starts one byte into an allocation: the
    # kernel cannot use 16-byte loads on them
    a, al = _batch(np.random.RandomState(5), 150, 150)
    flat = torch.empty(a.size + 1, dtype=torch.int8, device=cuda_device)
    ta = flat[1:].view(a.shape)
    ta.copy_(torch.from_numpy(a))
    tal = torch.from_numpy(al).to(cuda_device)
    assert ta.is_contiguous() and ta.data_ptr() % 16 != 0
    s, e = oa.overlap_scores_block(ta, tal, ta, tal)
    s0, e0 = oa.overlap_scores_block_plain(ta, tal, ta, tal)
    assert torch.equal(s, s0) and torch.equal(e, e0)


@pytest.mark.gpu
def test_empty_blocks_launch_nothing(cuda_device):
    a, al = _batch(np.random.RandomState(1), 5, 20)
    ta, tal = _to(cuda_device, a, al)
    before = oa.launches
    s, e = oa.overlap_scores_block(ta[:0], tal[:0], ta, tal)
    assert s.shape == e.shape == (0, 5)
    assert oa.launches == before


@pytest.mark.gpu
def test_rejects_non_contiguous_input(cuda_device):
    a, al = _batch(np.random.RandomState(2), 6, 20)
    ta, tal = _to(cuda_device, a, al)
    with pytest.raises(ValueError, match="contiguous"):
        oa.overlap_scores_block(ta[::2], tal[::2], ta, tal)


@pytest.mark.gpu
def test_rejects_key_overflow(cuda_device):
    # passes the reference kernel's limits, but the kernel's int32 key
    # (score * 1024 + 1023 - j) cannot hold (1999 + 2000) * 1023 * 1024
    a, al = _batch(np.random.RandomState(3), 4, 1023)
    ta, tal = _to(cuda_device, a, al)
    with pytest.raises(ValueError, match="key overflows"):
        oa.overlap_scores_block(ta, tal, ta, tal, 1, 2000)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [-1, "L+1"])
def test_rejects_lengths_outside_the_padded_width(bad, cuda_device):
    a, al = _batch(np.random.RandomState(4), 6, 20)
    al[2] = 21 if bad == "L+1" else bad
    ta, tal = _to(cuda_device, a, al)
    with pytest.raises(ValueError, match="a_len"):
        oa.overlap_scores_block(ta, tal, ta, tal)


def _pair_case(name):
    """(codes, lengths, ia, ib, match, mismatch) for the pair-list kernel."""
    rs = np.random.RandomState(17)

    def pairs(u, n):
        return (rs.randint(0, u, n).astype(np.int32),
                rs.randint(0, u, n).astype(np.int32))

    if name == "lengths 0/1/L-1/L, W=150":
        c, cl = _batch(rs, 300, 150, rs.choice(
            np.r_[[0, 1, 149, 150] * 10, np.arange(151)], size=300))
        return c, cl, *pairs(300, 20_000), 10, -1
    if name == "W=1023":
        c, cl = _batch(rs, 48, 1023, rs.choice([0, 1, 1022, 1023, 600], 48))
        return c, cl, *pairs(48, 2000), 10, -1
    if name == "internal PAD":
        c, cl = _batch(rs, 200, 150)
        for r in range(0, 200, 2):
            c[r, rs.randint(0, cl[r], size=4)] = 4
        return c, cl, *pairs(200, 10_000), 10, -1
    if name == "penalties 5/-4":
        c, cl = _batch(rs, 120, 60)
        return c, cl, *pairs(120, 10_000), 5, -4
    if name == "ia == ib and repeated pairs":
        c, cl = _batch(rs, 64, 150)
        ia = np.r_[np.arange(64), [5] * 300].astype(np.int32)
        ib = np.r_[np.arange(64), [5, 6, 7] * 100].astype(np.int32)
        return c, cl, ia, ib, 10, -1
    if name == "W=33, one pair a block and a ragged last block":
        c, cl = _batch(rs, 30, 33)
        return c, cl, *pairs(30, 9), 10, -1
    if name == "sorted runs across chunk boundaries":
        # runs of equal ia of 1 to 118 pairs, as the join emits them
        c, cl = _batch(rs, 500, 150, rs.choice([150] * 8 + [1, 33, 149], 500))
        ia = np.repeat(np.arange(500), rs.choice(
            [1, 2, 31, 32, 33, 64, 76, 118], 500)).astype(np.int32)
        return c, cl, ia, rs.randint(0, 500, len(ia)).astype(np.int32), 10, -1
    if name == "one run, clean and N reads":
        c, cl = _batch(rs, 200, 150, rs.randint(120, 151, 200))
        for r in range(0, 200, 2):
            c[r, rs.randint(0, cl[r], size=2)] = 4
        ia = np.repeat([1, 0, 3, 2], 90).astype(np.int32)
        return c, cl, ia, rs.randint(0, 200, len(ia)).astype(np.int32), 10, -1
    if name in ("W=256", "W=257"):
        w = int(name[2:])
        c, cl = _batch(rs, 120, w, rs.choice([0, 1, w - 33, w - 1, w], 120))
        for r in range(0, 40, 2):
            c[r, rs.randint(0, max(cl[r], 1), size=2)] = 4
        ia = np.sort(rs.randint(0, 120, 4000)).astype(np.int32)
        return c, cl, ia, rs.randint(0, 120, 4000).astype(np.int32), 10, -1
    raise KeyError(name)


PAIR_CASES = ["lengths 0/1/L-1/L, W=150", "W=1023", "internal PAD",
              "penalties 5/-4", "ia == ib and repeated pairs",
              "W=33, one pair a block and a ragged last block",
              "sorted runs across chunk boundaries",
              "one run, clean and N reads", "W=256", "W=257"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAIR_CASES)
def test_pair_kernel_equals_plain_version(case, cuda_device):
    c, cl, ia, ib, ms, mm = _pair_case(case)
    args = _to(cuda_device, c, cl, ia, ib)
    before = op.launches
    s, e = op.overlap_scores_pairs(*args, ms, mm)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    s0, e0 = op.overlap_scores_pairs_plain(*args, ms, mm)
    assert torch.equal(s, s0) and torch.equal(e, e0)
    s1, e1 = op.overlap_scores_pairs_plain(*_to("cpu", c, cl, ia, ib),
                                           ms, mm)
    assert torch.equal(s.cpu(), s1) and torch.equal(e.cpu(), e1)


@pytest.mark.gpu
def test_pair_kernel_on_codes_at_an_odd_address(cuda_device):
    c, cl, ia, ib, ms, mm = _pair_case("internal PAD")
    flat = torch.empty(c.size + 1, dtype=torch.int8, device=cuda_device)
    tc = flat[1:].view(c.shape)
    tc.copy_(torch.from_numpy(c))
    tl, tia, tib = _to(cuda_device, cl, ia, ib)
    s, e = op.overlap_scores_pairs(tc, tl, tia, tib)
    s0, e0 = op.overlap_scores_pairs_plain(tc, tl, tia, tib)
    assert torch.equal(s, s0) and torch.equal(e, e0)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["length -1", "length W+1", "index U"])
def test_pair_kernel_rejects_bad_inputs(bad, cuda_device):
    c, cl = _batch(np.random.RandomState(6), 6, 20)
    ia = np.arange(6, dtype=np.int32)
    if bad == "length -1":
        cl[1] = -1
    elif bad == "length W+1":
        cl[1] = 21
    else:
        ia[3] = 6
    before = op.launches
    with pytest.raises(ValueError, match="lengths" if "length" in bad
                       else "ia"):
        op.overlap_scores_pairs(*_to(cuda_device, c, cl, ia, ia[::-1].copy()))
    assert op.launches == before


def _queries(rs, genome, lengths, subst=0.03):
    """Queries cut from the genome, with substitutions and N."""
    width = max(1, int(max(lengths)))
    q = np.full((len(lengths), width), 4, np.int8)
    for r, n in enumerate(lengths):
        if n:
            start = rs.randint(0, max(1, len(genome) - n))
            row = genome[start:start + n].copy()
            flip = rs.rand(len(row)) < subst
            row[flip] = rs.randint(0, 5, flip.sum())
            q[r, :len(row)] = row
    return q, np.asarray(lengths, np.int32)


def _sw_full_case(name):
    rs = np.random.RandomState(21)
    genome = rs.randint(0, 4, size=3000).astype(np.int8)
    pen = (10, -1, -1)
    if name == "ragged":
        q, ql = _queries(rs, genome, rs.randint(1, 300, size=50))
        wl = np.where(rs.rand(50) < 0.3, ql, 3000)
    elif name == "ties":
        genome = np.tile(np.array([0, 1, 1, 0, 1], np.int8), 300)
        q, ql = _queries(rs, genome, rs.randint(5, 150, size=32), subst=0)
        wl = np.full(32, len(genome))
    elif name == "N in query and window":
        genome[rs.randint(0, 3000, 30)] = 4
        q, ql = _queries(rs, genome, rs.randint(40, 200, size=32), 0.1)
        wl = np.full(32, 3000)
    elif name == "empty query and window":
        q, ql = _queries(rs, genome, [0, 0, 0, 50, 80, 1])
        wl = np.array([3000, 0, 10, 0, 3000, 1])
    elif name == "query longer than window":
        q, ql = _queries(rs, genome, np.full(24, 200))
        wl = rs.randint(1, 200, 24)
    elif name == "tail windows":
        lens = rs.randint(20, 150, size=24)
        q = np.full((24, 150), 4, np.int8)
        for r, n in enumerate(lens):
            q[r, :n] = genome[3000 - n:]
            q[r, n // 2] = (q[r, n // 2] + 1) % 4
        ql, wl = lens.astype(np.int32), lens
    elif name == "penalties 5/-3/-2":
        q, ql = _queries(rs, genome, rs.randint(1, 300, size=40), 0.1)
        wl = np.full(40, 3000)
        pen = (5, -3, -2)
    else:
        raise KeyError(name)
    return q, ql, genome, np.asarray(wl, np.int32), pen


SW_FULL_CASES = ["ragged", "ties", "N in query and window",
                 "empty query and window", "query longer than window",
                 "tail windows", "penalties 5/-3/-2"]


def _force_warps(monkeypatch, warps):
    """Make the wrappers launch every item with `warps` warps a block."""
    monkeypatch.setattr(sw, "_warps_per_item", lambda strips, sms: warps)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", sw.WARPS_PER_ITEM)
@pytest.mark.parametrize("case", SW_FULL_CASES)
def test_sw_full_width_kernel_equals_plain_version(case, warps, cuda_device,
                                                   monkeypatch):
    _force_warps(monkeypatch, warps)
    q, ql, genome, wl, pen = _sw_full_case(case)
    args = _to(cuda_device, q, ql, genome, wl)
    before = sw.full_width_launches
    got = sw.sw_full_width(*args, *pen)
    torch.cuda.synchronize()
    assert sw.full_width_launches == before + 1
    want = sw.sw_full_width_plain(*args, *pen)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", sw.WARPS_PER_ITEM)
@pytest.mark.parametrize("band", [0, 1, 64, 2048])
@pytest.mark.parametrize("pen", [(10, -1, -1), (5, -3, -2)])
def test_sw_banded_kernel_equals_plain_version(band, pen, warps, cuda_device,
                                               monkeypatch):
    _force_warps(monkeypatch, warps)
    rs = np.random.RandomState(band + 7)
    genome = rs.randint(0, 4, size=20000).astype(np.int8)
    q, ql = _queries(rs, genome, rs.randint(0, 400, size=40))
    d0 = rs.randint(-100, 20100, size=40).astype(np.int32)
    # negative, 0, near m, and bands wholly outside the genome
    d0[:6] = [-50, 0, 19990, -band - 500, 20000 + band + 5, 10**6]
    args = _to(cuda_device, q, ql, genome, d0)
    before = sw.banded_launches
    got = sw.sw_banded(*args, band, *pen)
    torch.cuda.synchronize()
    assert sw.banded_launches == before + 1
    want = sw.sw_banded_plain(*args, band, *pen)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", [1, 8])
def test_sw_kernels_on_a_query_of_40_strips(warps, cuda_device, monkeypatch):
    # 1,280 bases against a 6 kb genome: at W = 8 each warp runs five
    # strips, so its progress counter carries over from strip to strip
    _force_warps(monkeypatch, warps)
    rs = np.random.RandomState(40)
    genome = rs.randint(0, 4, size=6000).astype(np.int8)
    q, ql = _queries(rs, genome, [1280, 1280, 1279, 700, 33, 0])
    q[1, :1280] = genome[2000:3280]
    q[1, [100, 640, 1000]] = 4
    full = _to(cuda_device, q, ql, genome, np.full(6, 6000, np.int32))
    want = sw.sw_full_width_plain(*full)
    got = sw.sw_full_width(*full)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    d0 = _to(cuda_device, np.array([2000, 1990, 0, 5000, -40, 7],
                                   np.int32))[0]
    for band in (16, 300):
        want = sw.sw_banded_plain(*full[:3], d0, band)
        got = sw.sw_banded(*full[:3], d0, band)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", [0, 3, 16])
def test_sw_launch_refuses_other_warp_counts(warps, cuda_device,
                                             monkeypatch):
    lib = sw.load_kernel()
    for fn, extra in ((lib.sw_full_launch, ()), (lib.sw_banded_launch, (8,))):
        # refused before anything is read: null pointers, no items
        assert fn(None, 0, None, None, 0, None, *extra, None, None, 0, None,
                  10, -1, -1, 1, None, None, None, None, None, None, 0,
                  warps) != 0
    _force_warps(monkeypatch, warps)
    q, ql, genome, wl, pen = _sw_full_case("ragged")
    args = _to(cuda_device, q, ql, genome, wl)
    with pytest.raises(RuntimeError, match="launch failed"):
        sw.sw_full_width(*args, *pen)
    with pytest.raises(RuntimeError, match="launch failed"):
        sw.sw_banded(*args, 8, *pen)


@pytest.mark.gpu
def test_sw_kernels_chunk_over_the_scratch_budget(cuda_device, monkeypatch):
    q, ql, genome, wl, pen = _sw_full_case("ragged")
    args = _to(cuda_device, q, ql, genome, wl)
    whole = sw.sw_full_width(*args)
    monkeypatch.setattr(sw, "SCRATCH_BUDGET_BYTES", 1 << 20)
    before = sw.full_width_launches
    chunked = sw.sw_full_width(*args)
    assert sw.full_width_launches > before + 1
    for g, w in zip(chunked, whole):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("banded", [False, True])
def test_metrics_pass_on_the_card_stays_within_its_budgets(
        banded, cuda_device, monkeypatch):
    # 600 contigs against a 6 kb genome: one call's full-width op streams
    # would take 600 x (300 + 6000) B = 3.8 MB; with the op-stream and
    # scratch budgets cut to 256 KiB and 512 KiB, the pass runs in several
    # calls and launches, its peak stays under 2 MiB, and its details
    # equal the C++ engine's
    from genome_assembly_tpu_torch.metrics import align_to_ref as atr

    rs = np.random.RandomState(5)
    genome = "".join("ACGT"[c] for c in rs.randint(0, 4, size=6000))
    contigs = [genome[s:s + n] for s, n in zip(rs.randint(0, 5700, 600),
                                               rs.randint(100, 300, 600))]
    contigs = [c[:5] + "T" + c[6:] for c in contigs]
    want = atr.align_contigs_to_reference(contigs, genome, 100, band=16,
                                          banded=banded, executor="native",
                                          device="cpu")
    monkeypatch.setattr(atr, "CARD_OPS_BUDGET_BYTES", 256 << 10)
    monkeypatch.setattr(sw, "SCRATCH_BUDGET_BYTES", 512 << 10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    before = sw.full_width_launches + sw.banded_launches
    got = atr.align_contigs_to_reference(contigs, genome, 100, band=16,
                                         banded=banded, device=cuda_device)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert got == want
    assert sw.full_width_launches + sw.banded_launches - before > 8
    assert peak < 2 << 20


def _sweep_config(num_iterations=2):
    import random

    r = random.Random(8)
    genome = "".join(r.choice("ACGT") for _ in range(3000))
    return {"num_reads": 400, "read_length": 60, "error_prob": 0.01,
            "k": 5, "reference_genome": genome,
            "expected_coverage": 400 * 60 / len(genome),
            "experiment_name": "gpu", "num_iterations": num_iterations,
            "contigs": None}


@pytest.mark.gpu
def test_run_for_params_on_the_card_equals_the_host_and_keeps_memory_flat(
        cuda_device, monkeypatch, tmp_path):
    # the card's aggregate equals the host's for the same seeds, and device
    # memory after iteration 2 equals that after iteration 1
    import random

    from genome_assembly_tpu_torch.experiments import runner

    def seeds():
        return {"rng": random.Random(3), "np_rng": np.random.RandomState(3)}

    want = runner.run_for_params(_sweep_config(), path=str(tmp_path),
                                 device="cpu", **seeds())
    after = []
    inner = runner.run_simulations

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(cuda_device))
        return out

    monkeypatch.setattr(runner, "run_simulations", recorded)
    before = oa.launches, sw.full_width_launches
    got = runner.run_for_params(_sweep_config(), path=str(tmp_path),
                                device=cuda_device, **seeds())
    assert got == want
    assert (oa.launches - before[0], sw.full_width_launches - before[1]) == (
        2, 2)
    assert len(after) == 2 and after[1] == after[0]


@pytest.mark.gpu
def test_spawn_pool_on_the_card_equals_sequential_runs(cuda_device,
                                                       tmp_path):
    import copy
    import random

    from genome_assembly_tpu_torch.experiments import runner

    configs = [_sweep_config(1), {**_sweep_config(1), "k": 7},
               {**_sweep_config(1), "num_reads": 300}]
    kw = {"rng": random.Random(4), "np_rng": np.random.RandomState(4),
          "device": "cuda"}
    pooled = runner.run_simulations_parallel(configs, path=str(tmp_path),
                                             n_jobs=2, **kw)
    alone = [runner.run_for_params(p, path=str(tmp_path),
                                   **copy.deepcopy(kw)) for p in configs]
    assert pooled == alone


def _n_reads(rs, count, with_n):
    # distinct reads of 30..60 bases from a 2,000 bp genome; with_n puts an
    # N at every 50th base, so overlapping reads put N against N
    chars = np.array(list("ACGT"))[rs.randint(0, 4, size=2000)]
    if with_n:
        chars[::50] = "N"
    genome = "".join(chars)
    reads = {}
    while len(reads) < count:
        s = rs.randint(0, 1940)
        reads.setdefault(genome[s:s + rs.randint(30, 61)])
    return list(reads)


@pytest.mark.gpu
@pytest.mark.parametrize("with_n", [True, False])
def test_score_pairs_gives_reads_with_an_n_the_engine_below_the_threshold(
        with_n, cuda_device):
    # below 200,000 pairs, reads with an N get the C++ scorer's answer (the
    # JAX package's there) and launch nothing; reads without one take the
    # all-pairs kernel, diagonal included, with the same answer
    from genome_assembly_tpu_torch.core.encoding import encode_batch
    from genome_assembly_tpu_torch.graph.build import score_pairs
    from genome_assembly_tpu_torch.native import graphcore

    unique = _n_reads(np.random.RandomState(12), 300, with_n)
    ia, ib = (x.ravel().astype(np.int32) for x in np.meshgrid(
        np.arange(300), np.arange(300), indexing="ij"))
    before = oa.launches, op.launches
    s, e = score_pairs(unique, (ia, ib), device=cuda_device)
    left, lens = encode_batch(unique, align="left")
    want_s, want_e = graphcore.overlap_nogap_pairs(left, lens, ia, ib)
    assert np.array_equal(s, want_s) and np.array_equal(e, want_e)
    launched = (oa.launches - before[0], op.launches - before[1])
    assert launched == ((0, 0) if with_n else (1, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", ["string graph", "unitig"])
def test_alt_pipelines_on_the_card_equal_the_host_runs(pipeline,
                                                       cuda_device):
    import random

    from genome_assembly_tpu_torch.models import string_graph, unitig

    r = random.Random(21)
    genome = "".join(r.choice("ACGT") for _ in range(1500))
    reads = [genome[s:s + 50] for s in (r.randint(0, 1450)
                                        for _ in range(150))]
    reads += reads[:10]                     # duplicates: self-pairs
    run = (string_graph.assemble_contigs_string if pipeline == "string graph"
           else unitig.assemble_contigs)
    before = oa.launches
    got = run(reads, device=cuda_device)
    assert oa.launches == before + 1
    assert got == run(reads, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("indel", [-2, -1, -(2**25)])
def test_overlap_align_full_on_the_card_equals_the_host_run(indel,
                                                            cuda_device):
    rs = np.random.RandomState(31)
    a, al = _batch(rs, 64, 40)
    b, bl = _batch(rs, 64, 40)
    b[:32] = a[32:]                          # related pairs: gaps pay off
    bl[:32] = al[32:]
    got = op.overlap_align_full(*_to(cuda_device, a, al, b, bl), indel=indel)
    want = op.overlap_align_full(*_to("cpu", a, al, b, bl), indel=indel)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_device_samplers_keep_their_contract_on_the_card(cuda_device):
    import importlib.util
    import os

    from genome_assembly_tpu_torch.simulate import (
        inject_errors_device,
        sample_reads_device,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    genome = torch.randint(0, 4, (3000,), dtype=torch.int8,
                           generator=torch.Generator().manual_seed(2))
    assert smoke.sampler_contract(sample_reads_device, inject_errors_device,
                                  genome.to(cuda_device), 80, 500, 0.1,
                                  7) == []


def _parallel_cases(rs):
    """The parallel layer's calls of the kernels on the card (4 ranks)."""
    reads, lens = _batch(rs, 256, 150)
    right = np.full_like(reads, 4)
    for i, n in enumerate(lens):
        right[i, 150 - n:] = reads[i, :n]
    ia = rs.randint(0, 256, 1000).astype(np.int32)
    ib = rs.randint(0, 256, 1000).astype(np.int32)
    genome = rs.randint(0, 4, 400).astype(np.int8)
    q, ql = _batch(rs, 12, 60)
    return {
        "reads": (reads, lens), "indexed": (right, reads, lens, ia, ib),
        "seqpar": (q, ql, genome, 400),
    }


@pytest.mark.gpu
def test_parallel_layer_on_the_card_equals_plain_versions(cuda_device,
                                                          tmp_path):
    """A 4-rank gloo world sharing the card, and a 1-rank NCCL world: the
    all-pairs row blocks, the indexed pair scoring and the pipelined seqpar
    against the plain versions on the card."""
    import torch_parallel_workers as workers

    from genome_assembly_tpu_torch.ops.smith_waterman import (
        local_align_batch,
    )
    from genome_assembly_tpu_torch.parallel.spawn import spawn

    inputs = _parallel_cases(np.random.RandomState(41))
    cases = [
        ("allpairs", ("1d", 4, "data"), "all_pairs_block_scores",
         inputs["reads"], {}),
        ("indexed", ("1d", 4, "data"), "sharded_overlap_scores_indexed",
         inputs["indexed"], {}),
        ("seqpar", ("1d", 4, "data"), "local_align_batch_seqpar_pipelined",
         inputs["seqpar"], {"rows_per_exchange": 8, "gather_codes": True}),
    ]
    one = [(name, ("1d", 1, "data"), fn, args, kw)
           for name, _, fn, args, kw in cases]
    gloo = spawn(workers.run_cases, 4, args=(cases, "cuda"), device="cuda",
                 timeout_s=300, workdir=str(tmp_path))
    nccl = spawn(workers.run_cases, 1, args=(one, "cuda"), device="cuda",
                 backend="nccl", timeout_s=300, workdir=str(tmp_path))
    reads, lens = _to(cuda_device, *inputs["reads"])
    s, e = oa.overlap_scores_block_plain(reads, lens, reads, lens)
    s.fill_diagonal_(-(2**31) + 1)
    right, left, ilens, ia, ib = _to(cuda_device, *inputs["indexed"])
    ps, pe = op.overlap_scores_pairs_plain(left, ilens, ia, ib)
    q, ql, genome, g_len = inputs["seqpar"]
    refs = np.tile(genome[None], (len(ql), 1))
    sw_out = local_align_batch(*_to(cuda_device, q, ql, refs,
                                    np.full(len(ql), g_len, np.int32)))
    want = {"allpairs": (s, e), "indexed": (ps, pe),
            "seqpar": (*sw_out[:3], sw_out[3][:, :, 1:])}
    for results in (gloo, nccl):
        for out in results:
            for name, ref in want.items():
                got = out[name]
                if name == "seqpar":
                    got = [*got[:3], got[3][:q.shape[1]]]
                for g, w in zip(got, ref):
                    np.testing.assert_array_equal(g, w.cpu().numpy(),
                                                  err_msg=name)


# ---------------------------------------------------------------------------
# the seqpar kernel (csrc/seqpar.cu): its model's cases and harness, from
# tests/test_torch_seqpar_kernel.py (which imports JAX only inside the
# functions that need it)
# ---------------------------------------------------------------------------

class _SeqparKernel:
    """The wrappers (on the card: the kernel) under the plain versions'
    names."""

    seqpar_step = staticmethod(sq.seqpar_step)
    seqpar_row_pre = staticmethod(sq.seqpar_row_pre)
    seqpar_row_post = staticmethod(sq.seqpar_row_post)


def _seqpar_cases():
    import test_torch_seqpar_kernel as model

    return model, {**model.MODEL_CASES, "two tiles": model._two_tiles()}


SEQPAR_CASES = ["ties", "pad inside", "past g_len", "two tiles"]


@pytest.mark.gpu
@pytest.mark.parametrize("indel", [1, -1, -3])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("case", SEQPAR_CASES)
def test_seqpar_step_kernel_equals_plain_step(case, rows, indel,
                                              cuda_device):
    """Every active step of every rank of a simulated world: the kernel's
    outputs and updated state equal the plain step's on the card."""
    model, cases = _seqpar_cases()
    pair = model.Paired(model.PLAIN, _SeqparKernel)
    sq.step_launches = 0
    model.run_pipelined(pair.step, model.DEVICES.get(case, 2), cases[case],
                        rows, (10, -1, indel), device=cuda_device)
    torch.cuda.synchronize()
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    assert sq.step_launches == pair.steps


@pytest.mark.gpu
@pytest.mark.parametrize("indel", [1, -1, -3])
@pytest.mark.parametrize("case", SEQPAR_CASES)
def test_seqpar_row_kernels_equal_plain_halves(case, indel, cuda_device):
    model, cases = _seqpar_cases()
    pair = model.Paired(model.PLAIN, _SeqparKernel)
    sq.row_launches = 0
    model.run_per_row(pair.pre, pair.post, model.DEVICES.get(case, 2),
                      cases[case], (10, -1, indel), device=cuda_device)
    torch.cuda.synchronize()
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    assert sq.row_launches == pair.steps


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
def test_seqpar_variants_on_a_one_rank_world_launch_the_kernel(variant,
                                                               cuda_device):
    """Both variants in this process (a one-rank world) on the card, at a
    block of 50,000 columns (11 tiles): equal to the plain row scan, with
    2 n_pad launches per call per-row and n_blocks pipelined."""
    from genome_assembly_tpu_torch import parallel
    model, _ = _seqpar_cases()
    q, ql, g_pad, g_len = model._setup(4242, n_q=16, g_len=50_000, q_max=45,
                                       pad_to=1)
    mesh = parallel.make_mesh(1, device=cuda_device)
    sq.step_launches = sq.row_launches = 0
    n_pad = q.shape[1]
    if variant == "per-row":
        got = parallel.local_align_batch_seqpar(mesh, q, ql, g_pad, g_len)
        assert (sq.row_launches, sq.step_launches) == (2 * n_pad, 0)
    else:
        got = parallel.local_align_batch_seqpar_pipelined(
            mesh, q, ql, g_pad, g_len, rows_per_exchange=8)
        assert (sq.row_launches, sq.step_launches) == (0, -(-n_pad // 8))
    qd, qld, gd = _to(cuda_device, q, ql, g_pad[:g_len])
    best, bi, bj, codes = sw.local_align_batch(
        qd, qld, gd[None].expand(len(ql), -1).contiguous(),
        torch.full((len(ql),), g_len, dtype=torch.int32, device=cuda_device))
    for g, w in zip(got[:3], (best, bi, bj)):
        assert torch.equal(g, w)
    assert torch.equal(got[3][:n_pad], codes[:, :, 1:])


def _seqpar_geometry_case(name):
    """(inputs, ranks, rows a step) of the card-only geometries: 64 items
    against the 50 kb genome's width on 1, 4 and 8 ranks (phase 8f's blocks
    of 50,000, 12,500 and 6,250 columns, six segments each); a step's
    segment past the shared memory a block holds (2 items of 140,000
    columns: 8 segments of 17,500, tiled); one item (8 segments); 150
    items, past the 132 SMs (steps of 4 segments of 12,500 columns, rows of
    2 segments walking 7 tiles); and 40 rows a step, past the ring of
    carries."""
    model, _ = _seqpar_cases()
    if name.startswith("8f mesh "):
        return (model._setup(9101, n_q=64, g_len=50_000, q_max=20,
                             pad_to=8), int(name.split()[-1]), 8)
    if name == "past shared memory":
        return model._setup(9102, n_q=2, g_len=140_000, q_max=20), 1, 8
    if name == "B = 1":
        return model._setup(9103, n_q=1, g_len=50_000, q_max=20), 1, 8
    if name == "B = 150":
        return model._setup(9104, n_q=150, g_len=50_000, q_max=12), 1, 8
    if name == "R = 40":
        return model._setup(9105, n_q=16, g_len=50_000, q_max=45), 1, 40
    raise KeyError(name)


SEQPAR_GEOMETRIES = ["8f mesh 1", "8f mesh 4", "8f mesh 8",
                     "past shared memory", "B = 1", "B = 150", "R = 40"]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["per-row", "pipelined"])
@pytest.mark.parametrize("name", SEQPAR_GEOMETRIES)
def test_seqpar_kernel_at_its_geometries_equals_plain(name, variant,
                                                     cuda_device):
    """Every step and row of every rank against the plain steps on the
    card, max abs err 0, where S, the resident and tiled paths and the
    ring change."""
    model, _ = _seqpar_cases()
    inputs, n_dev, rows = _seqpar_geometry_case(name)
    b, gb = inputs[0].shape[0], len(inputs[2]) // n_dev
    geo = sq.plan(b, gb, variant == "pipelined")
    assert geo.segments > 1
    pair = model.Paired(model.PLAIN, _SeqparKernel)
    sq.step_launches = sq.row_launches = 0
    if variant == "per-row":
        model.run_per_row(pair.pre, pair.post, n_dev, inputs, (10, -1, -1),
                          device=cuda_device)
    else:
        model.run_pipelined(pair.step, n_dev, inputs, rows, (10, -1, -1),
                            device=cuda_device)
    torch.cuda.synchronize()
    assert pair.steps > 0 and pair.diffs == 0, (pair.diffs, pair.steps)
    assert sq.step_launches + sq.row_launches == pair.steps


@pytest.mark.gpu
def test_seqpar_constants_equal_the_sources(cuda_device):
    """ops/seqpar.py's copy of the kernel's constants and shared-memory
    sizes (csrc seqpar_constants) equals the built source's; every 8f
    geometry fits on the card."""
    import ctypes

    got = (ctypes.c_int * 7)()
    sq.load_kernel().seqpar_constants(got)
    assert list(got) == [sq.THREADS, sq.TILE_CHUNK, sq.MAX_CHUNK,
                         sq.MAX_CLUSTER, sq.RING, sq.smem_bytes(False, 1),
                         sq.smem_bytes(True, sq.MAX_RESIDENT)]
    for width in (50_000, 12_500, 6_250):
        for kind in ("step", "pre", "post"):
            geo = sq.plan(64, width, kind == "step")
            assert sq.max_active_clusters(kind, geo) > 0


@pytest.mark.gpu
def test_seqpar_refuses_scores_outside_the_kernels_range(cuda_device):
    from genome_assembly_tpu_torch import parallel

    model, _ = _seqpar_cases()
    q, ql, g_pad, g_len = model.A
    mesh = parallel.make_mesh(1, device=cuda_device)
    for fn in (parallel.local_align_batch_seqpar,
               parallel.local_align_batch_seqpar_pipelined):
        with pytest.raises(ValueError, match="exact range"):
            fn(mesh, q, ql, g_pad, g_len, indel=-(2**20))
