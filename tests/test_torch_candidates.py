"""The k-mer sort-join as torch ops against the JAX package.

On CPU tensors the port's ``candidate_pairs_device`` runs the same torch ops
it runs on a card; it must equal the JAX package's ``candidate_pairs_device``
(JAX on the CPU, k <= 15) and its ``candidate_pairs_numpy`` (k <= 31)
element for element, for k = 1, 5, 15, 16 and 31, reads shorter than k,
many equal keys, and U = 0 and 1.
"""

import random

import numpy as np
import pytest

from genome_assembly_tpu.graph.build import (
    candidate_pairs_arrays as jax_candidate_pairs_arrays,
)
from genome_assembly_tpu.graph.candidates import (
    MAX_DEVICE_K as JAX_MAX_DEVICE_K,
    candidate_pairs_device as jax_candidate_pairs_device,
    candidate_pairs_numpy as jax_candidate_pairs_numpy,
)
from genome_assembly_tpu_torch.graph import build as port_build
from genome_assembly_tpu_torch.graph import candidates as port_cand


def _unique_reads(seed, n=300, genome_len=400, max_len=24):
    """Distinct reads of length 0 .. max_len from a short genome: many
    share a k-mer, some are shorter than k."""
    r = random.Random(seed)
    genome = "".join(r.choice("ACGT") for _ in range(genome_len))
    reads = [genome[r.randrange(genome_len):][:r.randint(0, max_len)]
             for _ in range(n)]
    return list(dict.fromkeys(reads))


def _repeat_reads(seed, n=200):
    """Distinct reads over a two-letter repeat: a few keys shared by many."""
    r = random.Random(seed)
    unit = "ACACACACAGT" * 8
    reads = [unit[r.randrange(20):][:r.randint(0, 40)] + r.choice("ACGT") * 2
             for _ in range(n)]
    return list(dict.fromkeys(reads))


def _assert_same(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32


@pytest.mark.parametrize("reads", ["random", "repeat"])
@pytest.mark.parametrize("k", [1, 5, 15, 16, 31])
def test_device_join_matches_jax_and_numpy(k, reads):
    # reads reach past k (and some share k-mers) at k = 16 and 31 too
    max_len = 24 if k <= 15 else k + 12
    unique = (_unique_reads(k, max_len=max_len) if reads == "random"
              else _repeat_reads(k))
    assert any(len(u) < k for u in unique) or k == 1
    got = port_cand.candidate_pairs_device(unique, k, device="cpu")
    if k <= JAX_MAX_DEVICE_K:
        _assert_same(got, jax_candidate_pairs_device(unique, k))
    _assert_same(got, jax_candidate_pairs_numpy(unique, k))
    assert len(got[0]) > 0


@pytest.mark.parametrize("unique", [[], ["ACGTA"], ["AC", ""]])
def test_device_join_on_tiny_inputs(unique):
    for k in (1, 5):
        got = port_cand.candidate_pairs_device(unique, k, device="cpu")
        _assert_same(got, jax_candidate_pairs_numpy(unique, k))
        if unique:
            _assert_same(got, jax_candidate_pairs_device(unique, k))


def test_device_join_refuses_k_above_its_cap():
    with pytest.raises(ValueError, match="1..31"):
        port_cand.candidate_pairs_device(["ACGT"], 32, device="cpu")
    with pytest.raises(ValueError, match="1..31"):
        port_cand.candidate_pairs_device(["ACGT"], 0, device="cpu")


@pytest.mark.parametrize("k", [5, 15, 20, 32])
def test_candidate_pairs_arrays_takes_the_device_join_where_the_rule_says(
        k, monkeypatch):
    """The route is chosen by k alone: the torch join for 1 <= k <= 31 on
    whichever device is passed (CPU tensors here), the dict join above;
    the JAX package's pairs either way."""
    unique = _unique_reads(40 + k)
    calls = []
    real = port_cand.candidate_pairs_device

    def spy(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_cand, "candidate_pairs_device", spy)
    got = port_build.candidate_pairs_arrays(unique, k, device="cpu")
    assert calls == ([k] if k <= port_cand.MAX_JOIN_K else [])
    _assert_same(got, jax_candidate_pairs_arrays(unique, k, device=False))
