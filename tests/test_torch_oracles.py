"""The port's host oracles, the gapped overlap DP, the all-pairs entry-point
names, the C++ engine's two oracle functions, the metric variants and the
config bounds, against the JAX package's on the same seeded inputs; exact.

The gapped DP (``ops/overlap.py::overlap_align_full``) runs as torch ops on
CPU tensors here, against the JAX package's XLA program on the CPU, on
random ragged batches at several gap penalties, the -2**24 clamp, and a
two-letter alphabet whose long runs make ties.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.core import consts as jax_consts
from genome_assembly_tpu.core.encoding import encode_batch
from genome_assembly_tpu.experiments.runner import (
    test_assembly as run_jax_assembly,
)
from genome_assembly_tpu.metrics import measures as jm
from genome_assembly_tpu.native import graphcore as jax_graphcore
from genome_assembly_tpu.ops import gotoh as jg
from genome_assembly_tpu.ops import oracle as jo
from genome_assembly_tpu.ops.overlap import (
    overlap_align_full as jax_align_full,
)
from genome_assembly_tpu.ops.overlap import (
    overlap_scores_host as jax_scores_host,
)
from genome_assembly_tpu.ops.overlap_allpairs import (
    overlap_scores_all_pairs_host as jax_all_pairs_host,
)
from genome_assembly_tpu.ops.overlap_allpairs import (
    overlap_scores_all_pairs_xla as jax_all_pairs_xla,
)
from genome_assembly_tpu_torch.core.config import (
    METRIC_LABELS,
    METRIC_NAMES,
    ParamBounds,
)
from genome_assembly_tpu_torch.metrics import measures as pm
from genome_assembly_tpu_torch.native import graphcore
from genome_assembly_tpu_torch.ops import gotoh, oracle
from genome_assembly_tpu_torch.ops import overlap as op
from genome_assembly_tpu_torch.ops import overlap_allpairs as oa


def _dna(r, n, alphabet="ACGT"):
    return "".join(r.choice(alphabet) for _ in range(n))


def _pairs(seed, n=40, alphabet="ACGT"):
    """Random pairs: related (a's suffix is b's prefix, with an edit),
    unrelated, and of length 0 and 1."""
    r = random.Random(seed)
    out = [("", "ACG"), ("A", ""), ("A", "A"), ("AC", "CA")]
    for _ in range(n):
        core = list(_dna(r, r.randint(2, 15), alphabet))
        if r.random() < 0.5:
            i = r.randrange(len(core))
            if r.random() < 0.5:
                del core[i]
            else:
                core.insert(i, r.choice(alphabet))
        a = _dna(r, r.randint(0, 10), alphabet) + "".join(core)
        b = "".join(core) + _dna(r, r.randint(0, 10), alphabet)
        out.append((a, b) if r.random() < 0.6
                   else (_dna(r, r.randint(1, 25), alphabet), b))
    return out


@pytest.mark.parametrize("indel", [-(2**31), -2, -1, 0])
def test_overlap_and_global_oracles_match_jax(indel):
    for a, b in _pairs(1):
        assert (oracle.overlap_align_oracle(a, b, indel=indel)
                == jo.overlap_align_oracle(a, b, indel=indel))
        assert (oracle.global_align_oracle(a, b, indel=indel)
                == jo.global_align_oracle(a, b, indel=indel))
    for v in (0, 2**31 - 1, 2**31, -(2**31) - 1, 3 * 2**32 + 5):
        assert oracle._wrap_i32(v) == jo._wrap_i32(v)


@pytest.mark.parametrize("pen", [(10, -1, -1), (5, -3, -2), (2, -1, -3)])
def test_local_oracles_match_jax_and_the_engine(pen):
    ms, mm, indel = pen
    for q, ref in _pairs(2):
        want = jo.local_align_oracle(q, ref, ms, mm, indel)
        assert oracle.local_align_oracle(q, ref, ms, mm, indel) == want
        got = graphcore.local_align(q, ref, ms, mm, indel)
        assert got == jax_graphcore.local_align(q, ref, ms, mm, indel)
        if q and ref:
            assert got == want


@pytest.mark.parametrize("gaps", [(-1, -1), (-5, -1), (-2, -2), (0, 0)])
def test_affine_gap_aligner_matches_jax(gaps):
    for t, q in _pairs(3):
        assert (gotoh.local_align_affine(t, q, 3, -2, *gaps)
                == jg.local_align_affine(t, q, 3, -2, *gaps))
    a, b = gotoh.PairwiseAlignerCompat(), jg.PairwiseAlignerCompat()
    for aligner in (a, b):
        aligner.match_score, aligner.mismatch_score = 2, -1
        aligner.open_gap_score, aligner.extend_gap_score = gaps
    assert ([a.score(t, q) for t, q in _pairs(4)]
            == [b.score(t, q) for t, q in _pairs(4)])


def _batch(seed, n, alphabet="ACGT"):
    pairs = _pairs(seed, n, alphabet)
    w = max(max(len(a), len(b)) for a, b in pairs)
    a, al = encode_batch([a for a, _ in pairs], width=w, align="left")
    b, bl = encode_batch([b for _, b in pairs], width=w, align="left")
    return a, al, b, bl


def test_nogap_host_scorers_match_jax_and_the_engine():
    a, al, b, bl = _batch(5, 60)
    for ms, mm in ((10, -1), (3, -2)):
        got = op.overlap_scores_host(a, b, al, bl, ms, mm)
        want = jax_scores_host(a, b, al, bl, ms, mm)
        base = graphcore.overlap_baseline_batch(a, al, b, bl, ms, mm)
        for g, w, x in zip(got, want, base):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, x)
    codes, lens = a[:25], al[:25]
    got = oa.overlap_scores_all_pairs_host(codes, lens)
    want = jax_all_pairs_host(codes, lens)
    plain = oa.overlap_scores_all_pairs(torch.from_numpy(codes),
                                        torch.from_numpy(lens))
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p.numpy())


@pytest.mark.parametrize("name", ["xla", "auto"])
def test_all_pairs_entry_names_run_the_port_route(name):
    """``_xla`` is the plain version, as the JAX name is its plain
    reference; ``_auto`` takes numpy arrays to the device it is given."""
    a, al, _, _ = _batch(6, 30)
    if name == "auto":
        got = oa.overlap_scores_all_pairs_auto(a, al, match_score=3,
                                               mismatch=-2, device="cpu")
    else:
        got = oa.overlap_scores_all_pairs_xla(
            torch.from_numpy(a), torch.from_numpy(al), match_score=3,
            mismatch=-2)
    want = jax_all_pairs_xla(jnp.asarray(a), jnp.asarray(al),
                             match_score=3, mismatch=-2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_all_pairs_auto_defaults_to_the_card(monkeypatch):
    """Without a device argument ``_auto`` asks for the card, and raises
    where there is none instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, al, _, _ = _batch(3, 10)
    with pytest.raises(RuntimeError, match="cuda"):
        oa.overlap_scores_all_pairs_auto(a, al)


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("indel", [-2, -1, -5, 0, -(2**24), -(2**25),
                                   -(2**31)])
def test_gapped_overlap_dp_matches_jax(indel, alphabet):
    a, al, b, bl = _batch(7, 50, alphabet)
    got = op.overlap_align_full(*(torch.from_numpy(x)
                                  for x in (a, al, b, bl)), indel=indel)
    want = jax_align_full(*(jnp.asarray(x) for x in (a, al, b, bl)),
                          indel=indel)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if indel > -(2**24):
        # and the reference recurrence itself, pair by pair
        pairs = _pairs(7, 50, alphabet)
        for i, (x, y) in enumerate(pairs):
            _, _, s, e = oracle.overlap_align_oracle(x, y, indel=indel)
            assert (int(got[0][i]), int(got[1][i])) == (s, e), (x, y)


def test_gapped_overlap_dp_refuses_unequal_widths():
    a = torch.zeros((2, 5), dtype=torch.int8)
    lens = torch.full((2,), 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="one shape"):
        op.overlap_align_full(a, lens, torch.zeros((2, 6), dtype=torch.int8),
                              lens)


def test_metric_variants_match_jax(tmp_path):
    r = random.Random(3)
    genome = _dna(r, 700)
    contigs, _, details, _ = run_jax_assembly(
        genome, 50, 60, 0.02, 5, "m", 1, path=str(tmp_path),
        rng=random.Random(3), np_rng=np.random.RandomState(3))
    cov, mism = pm._coverage_and_mismatch_python(details, len(genome))
    want_cov, want_mism = jm._coverage_and_mismatch_python(details,
                                                           len(genome))
    np.testing.assert_array_equal(cov, want_cov)
    np.testing.assert_array_equal(mism, want_mism)
    vec = pm.coverage_and_mismatch_vectors(details, len(genome),
                                           device="cpu")
    np.testing.assert_array_equal(vec[0], cov)
    np.testing.assert_array_equal(vec[1], mism)
    assert (pm.calculate_mismatch_rate_aligned_regions(details, genome)
            == jm.calculate_mismatch_rate_aligned_regions(details, genome))
    assert (pm.calculate_mismatch_rate_full_genome(details, genome, cov)
            == jm.calculate_mismatch_rate_full_genome(details, genome, cov))


def test_config_layer_matches_jax():
    """The port's bounds and metric names equal the JAX package's getters
    (tests/test_torch_consts.py holds the port's copy of the getters)."""
    b = ParamBounds()
    for field in ("l", "n", "p"):
        assert getattr(b, f"lower_{field}") == getattr(
            jax_consts, f"get_lower_bound_{field}")()
        assert getattr(b, f"upper_{field}") == getattr(
            jax_consts, f"get_upper_bound_{field}")()
    assert b.big_n == jax_consts.get_big_n()
    assert METRIC_NAMES == jax_consts.get_metrics()
    assert METRIC_LABELS == jax_consts.get_metric_labels()
