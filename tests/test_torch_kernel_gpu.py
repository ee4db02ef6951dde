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
