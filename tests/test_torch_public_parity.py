"""The names and knobs the port took over from the JAX package, against
the JAX package on the CPU (seeded inputs, exact equality):

- ``ops.overlap_scores`` (right-aligned a, left-aligned b, one pair a row)
  against JAX ``ops.overlap_scores``: ragged lengths 0..L, internal N,
  penalties (10, -1) and (5, -4);
- ``ops.overlap_scores_block_xla`` (the plain version's other name)
  against JAX ``overlap_scores_block_xla``;
- ``graph.candidates.candidate_pairs_numpy`` against the JAX numpy join at
  k = 1, 5, 15, 16 and 31, pair order included;
- ``native.graphcore.remove_cycles(legacy=True)`` against the JAX legacy
  remover and the port's incremental one on random graphs;
- GA_TPU_DENSE_MAX_U, GA_TPU_BANDED_AUTO_MIN and GA_TPU_CYCLES_LEGACY set
  through monkeypatch: the port takes the JAX package's route.
"""

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.core import dispatch as jax_dispatch
from genome_assembly_tpu.graph import build as jax_build
from genome_assembly_tpu.graph.candidates import (
    candidate_pairs_numpy as jax_candidate_pairs_numpy,
)
from genome_assembly_tpu.metrics import align_to_ref as jax_align
from genome_assembly_tpu.native import graphcore as jax_graphcore
from genome_assembly_tpu.ops import overlap_allpairs as jax_allpairs
from genome_assembly_tpu.ops.overlap import (
    overlap_scores as jax_overlap_scores,
)
from genome_assembly_tpu_torch import ops as port_ops
from genome_assembly_tpu_torch.core import dispatch
from genome_assembly_tpu_torch.graph import build as port_build
from genome_assembly_tpu_torch.graph import candidates as port_cand
from genome_assembly_tpu_torch.metrics import align_to_ref as port_align
from genome_assembly_tpu_torch.native import graphcore
from genome_assembly_tpu_torch.utils.tracing import global_tracer

PAD = 4


def _ragged(rs, n, l, with_n=True):
    """(n, l) left-aligned codes with lengths 0..l (both ends drawn) and,
    with_n, an N (PAD) inside every third read."""
    lens = rs.randint(0, l + 1, size=n).astype(np.int32)
    lens[:2] = (0, l)
    codes = rs.randint(0, 4, size=(n, l)).astype(np.int8)
    codes[np.arange(l)[None, :] >= lens[:, None]] = PAD
    if with_n:
        for r in range(0, n, 3):
            if lens[r]:
                codes[r, rs.randint(0, lens[r], size=2)] = PAD
    return codes, lens


def _right_aligned(codes, lens):
    n, l = codes.shape
    out = np.full_like(codes, PAD)
    for i in range(n):
        out[i, l - lens[i]:] = codes[i, :lens[i]]
    return out


@pytest.mark.parametrize("penalties", [(10, -1), (5, -4)])
def test_overlap_scores_matches_jax(penalties):
    rs = np.random.RandomState(sum(penalties) + 40)
    b_n, l = 97, 37
    a, al = _ragged(rs, b_n, l)
    b, bl = _ragged(rs, b_n, l)
    a[5] = b[5]                     # a few pairs that overlap in full
    al[5] = bl[5]
    a_right = _right_aligned(a, al)
    ms, mm = penalties
    want = jax_overlap_scores(jnp.asarray(a_right), jnp.asarray(al),
                              jnp.asarray(b), jnp.asarray(bl),
                              match_score=ms, mismatch=mm)
    got = port_ops.overlap_scores(torch.from_numpy(a_right),
                                  torch.from_numpy(al), torch.from_numpy(b),
                                  torch.from_numpy(bl), match_score=ms,
                                  mismatch=mm)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_overlap_scores_refuses_what_the_jax_function_asserts():
    t = torch.zeros((2, 8), dtype=torch.int8)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16-exact"):
        port_ops.overlap_scores(t, n, t, n, match_score=300, mismatch=-1)


def test_overlap_scores_block_xla_is_the_plain_version_and_matches_jax():
    from genome_assembly_tpu_torch.ops import overlap_allpairs

    assert (port_ops.overlap_scores_block_xla
            is overlap_allpairs.overlap_scores_block_plain)
    rs = np.random.RandomState(7)
    a, al = _ragged(rs, 23, 30)
    b, bl = _ragged(rs, 31, 30)
    for ms, mm in ((10, -1), (3, -2)):
        want = jax_allpairs.overlap_scores_block_xla(
            jnp.asarray(a), jnp.asarray(al), jnp.asarray(b), jnp.asarray(bl),
            match_score=ms, mismatch=mm)
        got = port_ops.overlap_scores_block_xla(
            torch.from_numpy(a), torch.from_numpy(al), torch.from_numpy(b),
            torch.from_numpy(bl), match_score=ms, mismatch=mm)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 5, 15, 16, 31])
def test_candidate_pairs_numpy_matches_jax(k):
    r = random.Random(k)
    genome = "".join(r.choice("ACGT") for _ in range(300))
    reads = [genome[r.randrange(300):][:r.randint(0, 40)] for _ in range(260)]
    reads += [("ACGT" * 9)[:m] for m in range(0, 34, 3)]
    unique = list(dict.fromkeys(reads))
    ia, ib = port_cand.candidate_pairs_numpy(unique, k)
    ja, jb = jax_candidate_pairs_numpy(unique, k)
    assert ia.dtype == ib.dtype == np.int32
    assert len(ia) > 0
    np.testing.assert_array_equal(ia, ja)
    np.testing.assert_array_equal(ib, jb)


def test_join_caps_are_the_port_join_cap():
    assert port_cand.MAX_DEVICE_K == port_cand.MAX_HOST_K == 31
    with pytest.raises(ValueError, match="1..31"):
        port_cand.candidate_pairs_numpy(["ACGT"], 32)


def _random_graph(seed, n_nodes=60, n_edges=400):
    rs = np.random.RandomState(seed)
    src = rs.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rs.randint(0, n_nodes, n_edges).astype(np.int32)
    weight = rs.randint(-5, 40, n_edges).astype(np.int32)   # ties on purpose
    return SimpleNamespace(num_nodes=n_nodes, src=src, dst=dst,
                           weight=weight, alive=np.ones(n_edges, bool))


def _copy(g):
    return SimpleNamespace(num_nodes=g.num_nodes, src=g.src, dst=g.dst,
                           weight=g.weight, alive=g.alive.copy())


@pytest.mark.parametrize("seed", range(6))
def test_legacy_cycle_removal_matches_jax_and_the_incremental_remover(seed):
    g = _random_graph(seed, n_nodes=20 + 15 * seed, n_edges=60 + 90 * seed)
    legacy, v2, jax_legacy = _copy(g), _copy(g), _copy(g)
    removed = graphcore.remove_cycles(legacy, legacy=True)
    assert removed > 0
    assert graphcore.remove_cycles(v2, legacy=False) == removed
    assert jax_graphcore.remove_cycles(jax_legacy, legacy=True) == removed
    np.testing.assert_array_equal(legacy.alive, v2.alive)
    np.testing.assert_array_equal(legacy.alive, jax_legacy.alive)


def test_graphcore_available():
    assert graphcore.available() is True


class _LibSpy:
    """Stands for a loaded engine and records the entry points used."""

    def __init__(self, lib):
        self.lib, self.used = lib, []

    def __getattr__(self, name):
        self.used.append(name)
        return getattr(self.lib, name)


@pytest.mark.parametrize("env", [None, "1", "0"])
def test_cycles_legacy_knob_selects_the_jax_remover(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("GA_TPU_CYCLES_LEGACY", raising=False)
    else:
        monkeypatch.setenv("GA_TPU_CYCLES_LEGACY", env)
    port_spy = _LibSpy(graphcore.load())
    jax_spy = _LibSpy(jax_graphcore._load())
    monkeypatch.setattr(graphcore, "_LIB", port_spy)
    monkeypatch.setattr(jax_graphcore, "_load", lambda: jax_spy)
    g = _random_graph(11)
    a, b = _copy(g), _copy(g)
    assert graphcore.remove_cycles(a) == jax_graphcore.remove_cycles(b)
    np.testing.assert_array_equal(a.alive, b.alive)
    want = "gc_remove_cycles" if env == "1" else "gc_remove_cycles_v2"
    assert [u for u in port_spy.used if u.startswith("gc_remove")] == [want]
    assert [u for u in jax_spy.used if u.startswith("gc_remove")] == [want]


def _reads(seed, n=90, l=14, genome_len=260):
    r = random.Random(seed)
    genome = "".join(r.choice("ACGT") for _ in range(genome_len))
    reads = [genome[r.randrange(genome_len):][:l] for _ in range(n)]
    return list(dict.fromkeys(reads))


@pytest.mark.parametrize("dense_max_u", ["4", "100000"])
def test_dense_max_u_knob_takes_the_jax_route(dense_max_u, monkeypatch):
    """With the card's rules (no host scorer, an accelerator attached) in
    both packages, GA_TPU_DENSE_MAX_U picks the all-pairs or the pair-list
    route alike, and the scores agree."""
    monkeypatch.setenv("GA_TPU_DENSE_MAX_U", dense_max_u)
    monkeypatch.setattr(dispatch, "use_host_pair_scoring",
                        lambda device, *rule: False)
    monkeypatch.setattr(jax_dispatch, "use_host_pair_scoring",
                        lambda n_pairs: False)
    monkeypatch.setattr(jax_dispatch, "accelerator_attached", lambda: True)
    jax_dense = []
    real = jax_allpairs.overlap_scores_all_pairs_auto

    def spy(*args, **kwargs):
        jax_dense.append(True)
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_allpairs, "overlap_scores_all_pairs_auto", spy)
    unique = _reads(3)
    ia, ib = port_build.candidate_pairs_arrays(unique, 6, device="cpu")
    assert 0 < len(ia) * 20 < len(unique) ** 2
    tracer = global_tracer()
    tracer.reset()
    got = port_build.score_pairs(unique, (ia, ib), device="cpu")
    want = jax_build.score_pairs(unique, (ia, ib))
    port_dense = "score.pairs.allpairs" in tracer.times
    assert port_dense != ("score.pairs.pairlist" in tracer.times)
    assert port_dense == bool(jax_dense) == (int(dense_max_u) >= len(unique))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("env", [None, "1000", "100000", "not a number"])
def test_banded_auto_min_knob_follows_the_jax_rule(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("GA_TPU_BANDED_AUTO_MIN", raising=False)
    else:
        monkeypatch.setenv("GA_TPU_BANDED_AUTO_MIN", env)
    assert port_align.banded_auto_min() == jax_align._banded_auto_min()


def test_banded_auto_min_knob_bands_the_alignment_alike(monkeypatch):
    """At GA_TPU_BANDED_AUTO_MIN=1000 a 2,000 bp genome takes the banded
    route under banded="auto" in the port, with the JAX package's
    details."""
    monkeypatch.setenv("GA_TPU_BANDED_AUTO_MIN", "1000")
    r = random.Random(5)
    genome = "".join(r.choice("ACGT") for _ in range(2000))
    contigs = []
    for _ in range(12):
        s = r.randrange(1800)
        c = list(genome[s:s + r.randint(60, 190)])
        c[len(c) // 2] = "A" if c[len(c) // 2] != "A" else "C"
        contigs.append("".join(c))
    planned = []
    real = port_align._banded_plan

    def spy(*args, **kwargs):
        planned.append(len(args[0]))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_align, "_banded_plan", spy)
    got = port_align.align_contigs_to_reference(contigs, genome, 50,
                                                device="cpu")
    want = jax_align.align_contigs_to_reference(contigs, genome, 50)
    assert planned and planned[0] > 0
    assert got == want
