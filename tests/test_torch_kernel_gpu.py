"""The hand-written CUDA kernel against its plain PyTorch version, on a card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from genome_assembly_tpu_torch.ops import overlap_allpairs as oa


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
    raise KeyError(name)


CASES = ["square L=150", "rectangular off-tile", "penalties L=60", "L=127",
         "lengths 0 and 1", "two-letter alphabet"]


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
