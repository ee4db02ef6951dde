"""The port's metrics alignment against the JAX package's, on the CPU.

``align_contigs_to_reference`` and ``calculate_measures`` on the same
seeded genome and contigs, for every executor (``auto``: the C++ engine on
a CPU device; ``native``; ``xla``: the plain PyTorch versions) and both
routes (full width, and banded on a genome small enough that the plain
route stays quick), must return the JAX package's details exactly.
"""

import random

import numpy as np
import pytest
import torch

from genome_assembly_tpu.metrics.align_to_ref import (
    align_contigs_to_reference as jax_align,
    align_read_or_contig_to_reference as jax_align_one,
)
from genome_assembly_tpu.metrics.measures import (
    calculate_measures as jax_measures,
)
from genome_assembly_tpu_torch.metrics import align_to_ref as atr
from genome_assembly_tpu_torch.metrics.align_to_ref import (
    align_contigs_to_reference,
    align_read_or_contig_to_reference,
)
from genome_assembly_tpu_torch.metrics.measures import calculate_measures

READ_LENGTH = 100
BAND = 16


def _genome_and_contigs(seed=0, genome_len=1500):
    r = random.Random(seed)
    genome = "".join(r.choice("ACGT") for _ in range(genome_len))

    def mutate(s, n):
        s = list(s)
        for _ in range(n):
            s[r.randrange(len(s))] = r.choice("ACGT")
        return "".join(s)

    contigs = [
        genome[100:400],
        mutate(genome[300:520], 4),
        genome[600:700] + "TTG" + genome[700:800],      # an insertion
        genome[900:1000] + genome[1010:1150],           # a deletion
        genome[1200:1350] + genome[200:300],            # chimeric
        "".join(r.choice("ACGT") for _ in range(160)),  # no seed hit
        genome[-60:],                                   # tail window
        mutate(genome[-80:], 2),
        "ACGTAC",
        "",
        genome[100:400],                                # duplicate
        genome[450:700].replace("A", "N", 2),
    ]
    return genome, contigs


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("executor", ["auto", "native", "xla"])
def test_align_contigs_matches_jax(executor, banded):
    genome, contigs = _genome_and_contigs()
    got = align_contigs_to_reference(contigs, genome, READ_LENGTH,
                                     banded=banded, band=BAND,
                                     executor=executor, max_batch=4,
                                     device="cpu")
    ref = jax_align(contigs, genome, READ_LENGTH, banded=banded, band=BAND,
                    executor=executor, max_batch=4)
    assert list(got) == list(ref)
    assert got == ref


@pytest.mark.parametrize("banded", [False, True])
def test_calculate_measures_matches_jax(banded, tmp_path):
    genome, contigs = _genome_and_contigs(seed=1)
    args = (contigs, [], 200, READ_LENGTH, 0.01, 5, genome, "t", 1,
            str(tmp_path))
    got = calculate_measures(*args, banded=banded, band=BAND, device="cpu")
    ref = jax_measures(*args, banded=banded, band=BAND)
    assert got == ref


def test_align_one_matches_jax():
    genome, contigs = _genome_and_contigs(seed=2)
    for c in (contigs[1], contigs[6], ""):
        assert (align_read_or_contig_to_reference(c, genome, READ_LENGTH,
                                                  device="cpu")
                == jax_align_one(c, genome, READ_LENGTH))


def test_long_genomes_take_the_banded_route():
    # 16,384 bp and more: banded="auto" bands, and the port no longer
    # raises there (the native executor keeps it quick on the CPU)
    genome, contigs = _genome_and_contigs(seed=3, genome_len=16384)
    got = align_contigs_to_reference(contigs, genome, READ_LENGTH,
                                     device="cpu")
    assert got == jax_align(contigs, genome, READ_LENGTH)


def test_card_calls_are_cut_by_the_op_stream_budget(monkeypatch):
    # the card's call plan needs no card: longest items first, every item
    # in exactly one call, each call's op streams within the budget (an
    # item larger than the budget alone)
    monkeypatch.setattr(atr, "CARD_OPS_BUDGET_BYTES", 40_000)
    rs = np.random.RandomState(0)
    lengths = np.r_[rs.randint(1, 700, size=500), 50_000]

    def stride(n):
        return n + 5386

    calls = atr._batches(None, torch.device("cuda"), 128, lengths, stride)
    assert sorted(i for c in calls for i in c) == list(range(501))
    assert calls[0] == [500]
    for call in calls[1:]:
        assert lengths[call[0]] == lengths[call].max()
        assert len(call) * stride(lengths[call[0]]) <= 40_000
    assert len(calls) < 501
    # at the default budget the PhiX main path's full-width items (2,642,
    # the longest 639 bases) stay one call
    monkeypatch.undo()
    assert len(atr._batches(None, torch.device("cuda"), 128,
                            np.full(2642, 639), stride)) == 1
