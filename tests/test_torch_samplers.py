"""The device samplers (``simulate/reads.py::sample_reads_device``,
``simulate/errors.py::inject_errors_device``) by contract, on CPU tensors.

``jax.random`` and ``torch.Generator`` streams differ, so the samplers cannot
match the JAX package's read for read. The contract they keep instead:
lengths are min(l, G - start) with the starts redrawn from the same seed,
each read is its genome window with PAD past its length, PAD never mutates,
every mutation is the alternative that the JAX package's host alphabet map
(``simulate/errors.py::_ALPHABET``: A->CGT, C->AGT, G->ACT, T->ACG) gives
for the base and the redrawn index, and one seed gives one output.
``reads_to_device`` equals the JAX package's encoding.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from genome_assembly_tpu.simulate.errors import _ALPHABET as JAX_ALPHABET
from genome_assembly_tpu.simulate.reads import (
    reads_to_device as jax_reads_to_device,
)
from genome_assembly_tpu_torch.simulate import (
    inject_errors_device,
    reads_to_device,
    sample_reads_device,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _genome(g=500, seed=0):
    return torch.randint(0, 4, (g,), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(seed))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# (base code, index drawn from 0..2) -> the alternative base's code, from
# the JAX package's host alphabet map, not from the injector's formula
ALT_TABLE = torch.tensor([["ACGT".index(c) for c in JAX_ALPHABET[b]]
                          for b in "ACGT"], dtype=torch.int8)


def _alternative(reads, idx):
    return ALT_TABLE[reads.long().clamp(max=3), idx.long()]


@pytest.mark.parametrize("g, l", [(500, 40), (60, 50), (30, 30)])
def test_sampled_reads_are_truncated_genome_windows(g, l):
    genome = _genome(g)
    reads, lengths = sample_reads_device(_gen(3), genome, l, 400)
    starts = torch.randint(0, g, (400,), generator=_gen(3))
    assert reads.dtype == torch.int8 and lengths.dtype == torch.int32
    assert reads.shape == (400, l)
    assert torch.equal(lengths.long(), torch.clamp(g - starts, max=l))
    assert int(lengths.min()) >= 1
    for i in range(400):
        n = int(lengths[i])
        s = int(starts[i])
        assert torch.equal(reads[i, :n], genome[s:s + n])
        assert bool((reads[i, n:] == 4).all())


def test_errors_keep_pad_and_the_alternative_base_order():
    genome = _genome()
    reads, lengths = sample_reads_device(_gen(1), genome, 60, 300)
    out = inject_errors_device(_gen(2), reads, lengths, 0.2)
    gen = _gen(2)
    u = torch.rand(reads.shape, generator=gen)
    idx = torch.randint(0, 3, reads.shape, generator=gen, dtype=torch.int8)
    inside = torch.arange(60)[None, :] < lengths[:, None].long()
    assert torch.equal(out, torch.where((u <= 0.2) & inside,
                                        _alternative(reads, idx), reads))
    assert bool((out[~inside] == 4).all())
    assert torch.equal(out != reads, (u <= 0.2) & inside)


def test_every_base_mutates_to_each_alternative_at_p_1():
    genome = _genome(2000)
    reads, lengths = sample_reads_device(_gen(4), genome, 50, 400)
    out = inject_errors_device(_gen(5), reads, lengths, 1.0)
    gen = _gen(5)
    torch.rand(reads.shape, generator=gen)
    idx = torch.randint(0, 3, reads.shape, generator=gen, dtype=torch.int8)
    inside = torch.arange(50)[None, :] < lengths[:, None].long()
    assert bool((out[inside] != reads[inside]).all())
    assert bool((out[~inside] == 4).all())
    for base in range(4):
        got = set(out[inside & (reads == base)].tolist())
        assert got == set(range(4)) - {base}
        # each drawn index names the alternative of the JAX host map
        for i in range(3):
            at = inside & (reads == base) & (idx == i)
            assert bool(at.any())
            assert set(out[at].tolist()) == {
                "ACGT".index(JAX_ALPHABET["ACGT"[base]][i])}


def test_one_seed_gives_one_output():
    genome = _genome()
    a = sample_reads_device(_gen(7), genome, 30, 100)
    b = sample_reads_device(_gen(7), genome, 30, 100)
    c = sample_reads_device(_gen(8), genome, 30, 100)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    e1 = inject_errors_device(_gen(9), *a, 0.3)
    e2 = inject_errors_device(_gen(9), *b, 0.3)
    e3 = inject_errors_device(_gen(10), *a, 0.3)
    assert torch.equal(e1, e2) and not torch.equal(e1, e3)


def test_reads_to_device_equals_jax_encoding():
    reads = ["ACGT", "", "ACNNTG", "acgtA"]
    for width in (None, 9):
        codes, lens = reads_to_device(reads, width, device="cpu")
        want_codes, want_lens = jax_reads_to_device(reads, width)
        np.testing.assert_array_equal(codes.numpy(), want_codes)
        np.testing.assert_array_equal(lens.numpy(), want_lens)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            reads_to_device(reads)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_smokes_contract_check_passes_and_catches_a_broken_injector():
    smoke = _smoke()
    genome = _genome(800)
    assert smoke.sampler_contract(sample_reads_device, inject_errors_device,
                                  genome, 60, 300, 0.1, 0) == []

    def mutates_pad(gen, reads, lengths, p):
        out = inject_errors_device(gen, reads, lengths, p)
        return torch.where(reads == 4, torch.zeros_like(out), out)

    failed = smoke.sampler_contract(sample_reads_device, mutates_pad,
                                    genome, 60, 300, 0.1, 0)
    assert "PAD never mutates" in failed

    def swaps_two_alternatives(gen, reads, lengths, p):
        # A -> GCT instead of CGT: the right set in the wrong order
        out = inject_errors_device(gen, reads, lengths, p)
        a = (reads == 0) & (out != reads)
        swapped = torch.where(out == 1, torch.full_like(out, 2),
                              torch.where(out == 2, torch.ones_like(out),
                                          out))
        return torch.where(a, swapped, out)

    failed = smoke.sampler_contract(sample_reads_device,
                                    swaps_two_alternatives, genome, 60, 300,
                                    0.1, 0)
    assert failed == ["alternative-base order"]
    assert smoke.ALTERNATIVES == JAX_ALPHABET
