"""Module parity of the port's graph and metrics layers with the JAX package.

Same seeded inputs into both packages; candidate pairs, overlap-graph edges,
cycle removal and the measures/details must be bit-identical.
"""

import random

import numpy as np
import pytest

from genome_assembly_tpu.graph.build import (
    build_overlap_graph as jax_build_overlap_graph,
    candidate_pairs_arrays as jax_candidate_pairs_arrays,
    dedup_reads as jax_dedup_reads,
)
from genome_assembly_tpu.graph.cycles import remove_cycles as jax_remove_cycles
from genome_assembly_tpu.graph.layout import walk_contigs as jax_walk_contigs
from genome_assembly_tpu.graph.topo import topological_order as jax_topo
from genome_assembly_tpu.metrics.measures import (
    calculate_measures as jax_calculate_measures,
    coverage_and_mismatch_vectors as jax_coverage_vectors,
)
from genome_assembly_tpu_torch.convert import graph_from_numpy
from genome_assembly_tpu_torch.core import dispatch
from genome_assembly_tpu_torch.graph import build as port_build
from genome_assembly_tpu_torch.graph.cycles import remove_cycles
from genome_assembly_tpu_torch.graph.layout import walk_contigs
from genome_assembly_tpu_torch.graph.topo import topological_order
from genome_assembly_tpu_torch.metrics.measures import (
    calculate_measures,
    coverage_and_mismatch_vectors,
)
from genome_assembly_tpu_torch.ops import overlap_allpairs


def random_dna(r, length):
    return "".join(r.choice("ACGT") for _ in range(length))


def _reads(seed, n=120, l=12, genome_len=300, dup_every=7):
    r = random.Random(seed)
    genome = random_dna(r, genome_len)
    reads = [genome[r.randrange(len(genome)):][:l] for _ in range(n)]
    reads += reads[::dup_every]         # duplicate reads: several copies
    return genome, reads


@pytest.mark.parametrize("k", [0, 1, 5, 15])
def test_candidate_pairs_arrays_match_jax(k):
    _, reads = _reads(1)
    unique, _ = jax_dedup_reads(reads)
    ia0, ib0 = jax_candidate_pairs_arrays(unique, k, device=False)
    ia, ib = port_build.candidate_pairs_arrays(unique, k, device="cpu")
    np.testing.assert_array_equal(ia, ia0)
    np.testing.assert_array_equal(ib, ib0)
    assert ia.dtype == ib.dtype == np.int32


def _edges(g):
    return (g.src, g.dst, g.weight, g.end_pos)


@pytest.mark.parametrize("route", ["dense", "host"])
@pytest.mark.parametrize("k", [0, 3])
def test_build_overlap_graph_edges_match_jax(k, route, monkeypatch):
    _, reads = _reads(2, n=90)
    g0 = jax_build_overlap_graph(reads, k=k)
    if route == "dense":
        # the route a CUDA device takes, on the CPU: the all-pairs scorer
        # (its plain version) over U x U, then the gather
        monkeypatch.setattr(dispatch, "use_host_pair_scoring",
                            lambda device, *rule: False)
    g = port_build.build_overlap_graph(reads, k=k, device="cpu")
    assert g.unique_reads == g0.unique_reads
    np.testing.assert_array_equal(g.counts, g0.counts)
    np.testing.assert_array_equal(g.offsets, g0.offsets)
    for got, ref in zip(_edges(g), _edges(g0)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype


def test_sparse_route_beyond_dense_limit_is_not_ported(monkeypatch):
    """The sparse route, which raised naming ROADMAP A5 until it was
    ported, gives the JAX package's edges: past DENSE_MAX_U with sparse
    candidates the pair-list scorer (its plain version on CPU tensors)
    scores the candidates alone, and the all-pairs scorer is not called."""
    _, reads = _reads(3, n=60)
    monkeypatch.setattr(dispatch, "use_host_pair_scoring",
                        lambda device, *rule: False)
    monkeypatch.setattr(port_build, "DENSE_MAX_U", 4)

    def no_dense(*args, **kwargs):
        raise AssertionError("the dense route was taken")

    monkeypatch.setattr(overlap_allpairs, "overlap_scores_all_pairs",
                        no_dense)
    g = port_build.build_overlap_graph(reads, k=8, device="cpu")
    g0 = jax_build_overlap_graph(reads, k=8)
    assert len(g.src) > 0
    for got, ref in zip(_edges(g), _edges(g0)):
        np.testing.assert_array_equal(got, ref)


def test_dense_route_scores_unpadded_u_by_u(monkeypatch):
    _, reads = _reads(4, n=50)
    unique, _ = jax_dedup_reads(reads)
    shapes = []
    real = overlap_allpairs.overlap_scores_all_pairs

    def spy(codes, lengths, **kw):
        shapes.append(tuple(codes.shape))
        return real(codes, lengths, **kw)

    monkeypatch.setattr(dispatch, "use_host_pair_scoring",
                        lambda device, *rule: False)
    monkeypatch.setattr(overlap_allpairs, "overlap_scores_all_pairs", spy)
    port_build.build_overlap_graph(reads, k=0, device="cpu")
    assert shapes == [(len(unique), max(len(r) for r in unique))]


@pytest.mark.parametrize("seed,k", [(5, 0), (6, 3)])
def test_cycle_removal_topo_and_walk_match_jax(seed, k):
    _, reads = _reads(seed, n=80, l=10)
    g0 = jax_build_overlap_graph(reads, k=k)
    g = graph_from_numpy(g0.unique_reads, g0.src, g0.dst, g0.weight,
                         g0.end_pos, g0.counts, g0.offsets)
    removed0 = jax_remove_cycles(g0)
    removed = remove_cycles(g)
    assert removed == removed0 > 0
    np.testing.assert_array_equal(g.alive, g0.alive)
    topo0 = jax_topo(g0)
    assert topological_order(g) == topo0
    assert walk_contigs(g, topo0) == jax_walk_contigs(g0, topo0)


@pytest.mark.parametrize("seed", [7, 8])
def test_calculate_measures_and_details_match_jax(seed):
    r = random.Random(seed)
    genome = random_dna(r, 600)
    contigs = []
    for _ in range(25):
        s = r.randrange(len(genome))
        c = list(genome[s:s + r.randint(3, 60)])
        for _ in range(r.randint(0, 3)):        # substitutions
            if c:
                c[r.randrange(len(c))] = r.choice("ACGT")
        contigs.append("".join(c))
    contigs += ["", contigs[0]]                 # empty + duplicate contig
    m0, d0 = jax_calculate_measures(contigs, contigs, len(contigs), 20, 0.01,
                                    5, genome, "t", 1)
    m, d = calculate_measures(contigs, contigs, len(contigs), 20, 0.01, 5,
                              genome, "t", 1, device="cpu")
    assert m == m0
    assert d == d0
    cov0, mis0 = jax_coverage_vectors(d0, len(genome))
    cov, mis = coverage_and_mismatch_vectors(d, len(genome), device="cpu")
    np.testing.assert_array_equal(cov, cov0)
    np.testing.assert_array_equal(mis, mis0)
    assert cov.dtype == cov0.dtype and mis.dtype == mis0.dtype
