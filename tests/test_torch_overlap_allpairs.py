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
    if name == "l127":
        # tests/test_overlap_allpairs.py's (8 reads, L=127) case: chainrev
        # pads j past the lane count there and falls back to the matmul shift
        ca, la = encode_batch(_random_reads(rng, 8, 127, min_len=121),
                              width=127)
        return ca, la, ca, la, 10, -1
    raise KeyError(name)


CASES = ["square", "rectangular", "penalties", "l127"]


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
