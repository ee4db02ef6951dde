"""The port's all-pairs overlap scorer against the JAX package's.

The plain PyTorch version (what the port's wrapper runs on a CPU tensor) must
equal, exactly, each Pallas kernel variant of
``genome_assembly_tpu.ops.overlap_allpairs.overlap_scores_block`` in
interpret mode (``shift`` = chainrev, chain, matmul) and the XLA version
``overlap_scores_block_xla``, on the same numpy inputs. The CUDA kernel is
held against the plain version on the card in test_torch_kernel_gpu.py.
"""

import numpy as np
import pytest
import torch

from genome_assembly_tpu.core.encoding import encode_batch
from genome_assembly_tpu.ops.overlap import right_align as jax_right_align
from genome_assembly_tpu.ops.overlap_allpairs import (
    overlap_scores_block as jax_block,
    overlap_scores_block_xla as jax_block_xla,
)
from genome_assembly_tpu_torch.convert import from_jax_arrays
from genome_assembly_tpu_torch.ops import overlap_allpairs as port
from genome_assembly_tpu_torch.ops.overlap import right_align


def _random_reads(rng, n, l, min_len=1):
    return ["".join(rng.choice(list("ACGT"), rng.integers(min_len, l + 1)))
            for _ in range(n)]


def _case(name):
    """(a_codes, a_len, b_codes, b_len, match, mismatch) numpy inputs."""
    rng = np.random.default_rng(7)
    if name == "square":
        ca, la = encode_batch(_random_reads(rng, 24, 12), width=12)
        return ca, la, ca, la, 10, -1
    if name == "rectangular":
        ca, la = encode_batch(_random_reads(rng, 10, 12), width=12)
        cb, lb = encode_batch(_random_reads(rng, 18, 12), width=12)
        return ca, la, cb, lb, 10, -1
    if name == "penalties":
        ca, la = encode_batch(_random_reads(rng, 16, 12), width=12)
        cb, lb = encode_batch(_random_reads(rng, 12, 12), width=12)
        return ca, la, cb, lb, 3, -2
    if name == "penalties 40/-1":
        # match - mismatch = 41: too large for the kernel to fold into its
        # one-hot bytes, so its epilogue multiplies
        ca, la = encode_batch(_random_reads(rng, 14, 12), width=12)
        cb, lb = encode_batch(_random_reads(rng, 11, 12), width=12)
        return ca, la, cb, lb, 40, -1
    if name == "l127":
        # tests/test_overlap_allpairs.py's (8 reads, L=127) case: chainrev
        # pads j past the lane count there and falls back to the matmul shift
        ca, la = encode_batch(_random_reads(rng, 8, 127, min_len=121),
                              width=127)
        return ca, la, ca, la, 10, -1
    if name == "lengths 0-3":
        reads = [("".join(rng.choice(list("ACGT"), n)))
                 for n in rng.choice([0, 1, 2, 3, 12], size=20)]
        ca, la = encode_batch(reads, width=12)
        return ca, la, ca, la, 10, -1
    if name == "internal N":
        # several N (PAD inside a read's length), some facing each other
        reads = _random_reads(rng, 16, 24, min_len=10)
        for r in range(0, 16, 2):
            s = list(reads[r])
            for p in rng.choice(len(s), size=3, replace=False):
                s[p] = "N"
            reads[r] = "".join(s)
        ca, la = encode_batch(reads, width=24)
        return ca, la, ca, la, 10, -1
    raise KeyError(name)


CASES = ["square", "rectangular", "penalties", "penalties 40/-1", "l127"]
EMULATED_CASES = CASES + ["lengths 0-3", "internal N"]


def _plain(ca, la, cb, lb, ms, mm):
    ta, tla = from_jax_arrays(ca, la, "cpu")
    tb, tlb = from_jax_arrays(cb, lb, "cpu")
    s, e = port.overlap_scores_block_plain(ta, tla, tb, tlb, ms, mm)
    return s.numpy(), e.numpy()


@pytest.mark.parametrize("variant", ["chainrev", "chain", "matmul", "xla"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernels(case, variant):
    ca, la, cb, lb, ms, mm = _case(case)
    if variant == "xla":
        s0, e0 = jax_block_xla(ca, la, cb, lb, match_score=ms, mismatch=mm)
    else:
        s0, e0 = jax_block(ca, la, cb, lb, match_score=ms, mismatch=mm,
                           tm=8, tn=128, interpret=True, shift=variant)
    s, e = _plain(ca, la, cb, lb, ms, mm)
    np.testing.assert_array_equal(s, np.asarray(s0))
    np.testing.assert_array_equal(e, np.asarray(e0))


@pytest.mark.parametrize("case", CASES)
def test_wrapper_on_cpu_runs_plain_version(case):
    ca, la, cb, lb, ms, mm = _case(case)
    port.launches = 0
    ta, tla = from_jax_arrays(ca, la, "cpu")
    tb, tlb = from_jax_arrays(cb, lb, "cpu")
    s, e = port.overlap_scores_block(ta, tla, tb, tlb, ms, mm)
    s0, e0 = jax_block_xla(ca, la, cb, lb, match_score=ms, mismatch=mm)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e0))
    assert s.dtype == e.dtype == torch.int32
    assert port.launches == 0


def test_right_align_matches_jax():
    rng = np.random.default_rng(3)
    reads = _random_reads(rng, 40, 20) + [""]
    codes, lens = encode_batch(reads, width=20)
    ref = np.asarray(jax_right_align(codes, lens))
    got = right_align(torch.from_numpy(codes), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ms,mm,l,msg", [
    (1, 0, 1024, "exceeds"),
    (4000, -1, 2, "not exact"),
    (10, -1, 410, "not exact"),
])
def test_rejects_what_the_jax_kernel_rejects(ms, mm, l, msg):
    codes = torch.full((2, l), 4, dtype=torch.int8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        port.overlap_scores_block(codes, lens, codes, lens, ms, mm)


def test_rejects_bad_shapes_and_types():
    codes = torch.zeros((3, 8), dtype=torch.int8)
    lens = torch.full((3,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="padded width"):
        port.overlap_scores_block(codes, lens, codes[:, :4], lens)
    with pytest.raises(ValueError, match="int32"):
        port.overlap_scores_block(codes, lens.long(), codes, lens)
    with pytest.raises(ValueError, match="int8"):
        port.overlap_scores_block(codes.long(), lens, codes, lens)
    with pytest.raises(ValueError, match="vectors"):
        port.overlap_scores_block(codes, lens[:2], codes, lens)


def test_plain_matches_xla_on_internal_n():
    """The port follows the JAX package's one-hot XLA version, where an N
    inside a read matches nothing (its Pallas kernels' simplex code gives
    such a position a score of its own)."""
    ca, la, cb, lb, ms, mm = _case("internal N")
    assert ((ca == 4) & (np.arange(ca.shape[1]) < la[:, None])).sum() >= 24
    s0, e0 = jax_block_xla(ca, la, cb, lb, match_score=ms, mismatch=mm)
    s, e = _plain(ca, la, cb, lb, ms, mm)
    np.testing.assert_array_equal(s, np.asarray(s0))
    np.testing.assert_array_equal(e, np.asarray(e0))


@pytest.mark.parametrize("variant", ["chainrev", "chain", "matmul"])
def test_pallas_kernels_differ_on_internal_n(variant):
    """A quirk of the reference, pinned so that its log stays true: the
    Pallas bodies' +-1 simplex code gives an N inside a read a zero vector,
    which their match count (S + d) / 4 does not score as a mismatch, so on
    these reads they disagree with overlap_scores_block_xla (and with the
    port)."""
    ca, la, cb, lb, ms, mm = _case("internal N")
    s0, e0 = map(np.asarray, jax_block_xla(ca, la, cb, lb, match_score=ms,
                                           mismatch=mm))
    s, e = map(np.asarray, jax_block(ca, la, cb, lb, match_score=ms,
                                     mismatch=mm, tm=8, tn=128,
                                     interpret=True, shift=variant))
    assert s0.size == 256
    assert int((s != s0).sum()) == 177
    assert int((e != e0).sum()) == 27


def _kernel_emulation(a, al, b, bl, match, mismatch, bn=128):
    """numpy emulation of csrc/overlap_allpairs.cu's arithmetic: one-hot
    words (4 channel bytes per position), the right-aligned a window with
    zero positions after it, ceil(j/8) k-steps of 8 positions as 4-channel
    byte products, and the packed int32 key max with its decode. Tiles of
    ``bn`` b-rows run j up to their longest b, unmasked; a column's output is
    its key at j = len(b), or score 0 at j = 0 for an empty b."""
    na, l = a.shape
    nb = b.shape[0]
    al = np.clip(al.astype(np.int64), 0, l)
    bl = np.clip(bl.astype(np.int64), 0, l)
    kp = (l + 7) // 8 * 8
    sab = l + 7                              # bytes the window can reach

    # the kernel folds (match - mismatch) * 1024 into its one-hot bytes
    # (8 diff in a's, 128 in b's) when the diff is 1..31
    diff = match - mismatch
    va, vb = (8 * diff, 128) if 1 <= diff <= 31 else (1, 1)
    assert max(va, vb) <= 255

    def one_hot(codes):                      # (..., 4) channel bytes
        return vb * (codes[..., None] == np.arange(4)).astype(np.int64)

    # A: shift bytes 8*code of right-aligned positions, 32 elsewhere, and
    # the kernel's word va << shift (0 for a shift of 32)
    shift = np.full((na, sab), 32, np.int64)
    for i in range(na):
        n = al[i]
        row = a[i, :n].astype(np.int64)
        shift[i, l - n:l] = np.where((row >= 0) & (row < 4), 8 * row, 32)
    words = np.where(shift < 32, np.left_shift(va, np.minimum(shift, 31)), 0)
    a_bytes = (words[..., None] >> (8 * np.arange(4))) & 0xFF  # (na, sab, 4)
    # B: one-hot prefix, zero past len b and up to kp positions
    b_pad = np.full((nb, kp), 4, np.int8)
    b_pad[:, :l] = b
    b_pad[np.arange(kp)[None, :] >= bl[:, None]] = 4
    b_bytes = one_hot(b_pad)                                   # (nb, kp, 4)

    d_key = diff * 1024 // (va * vb)             # 1 when folded

    def counts(j, rows, cols):               # M_j: ceil(j/8) k-steps
        m = 0
        for s in range((j + 7) // 8):
            win = a_bytes[rows, l - j + 8 * s:l - j + 8 * s + 8]    # (r,8,4)
            m = m + np.einsum("ipc,tpc->it", win,
                              b_bytes[cols, 8 * s:8 * s + 8])
        return m

    key_out = np.full((na, nb), 1023, np.int64)
    for t0 in range(0, nb, bn):
        cols = np.arange(t0, min(t0 + bn, nb))
        key = np.full((na, len(cols)), 1023, np.int64)
        for j in range(1, bl[cols].max() + 1):
            c = mismatch * np.minimum(al, j) * 1024 + 1023 - j
            val = counts(j, slice(None), cols) * d_key + c[:, None]
            assert np.abs(val).max() < 2**31
            key = np.maximum(key, val)
            ended = bl[cols] == j             # write columns ending at j
            key_out[:, cols[ended]] = key[:, ended]
    return ((key_out >> 10).astype(np.int32),
            (1023 - (key_out & 1023)).astype(np.int32))


@pytest.mark.parametrize("case", EMULATED_CASES)
def test_kernel_arithmetic_matches_plain(case):
    ca, la, cb, lb, ms, mm = _case(case)
    s, e = _kernel_emulation(ca, la, cb, lb, ms, mm, bn=8)
    s0, e0 = _plain(ca, la, cb, lb, ms, mm)
    np.testing.assert_array_equal(s, s0)
    np.testing.assert_array_equal(e, e0)
