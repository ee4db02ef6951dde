"""The fast greedy layout, the consensus polish and the read placements
against the JAX package, on small seeded genomes (the host routes).

- ``assemble_contigs_greedy(device="cpu")`` equals the JAX one for
  k = 0, 5 and 15, with the default guards and unguarded;
- the C++ ``greedy_chain`` equals ``greedy_chain_python``, and a failed
  engine raises where the JAX package falls back (ROADMAP §C);
- ``polish_contigs``, ``walk_contigs(with_placements=True)``, the
  exact-parity layout with ``consensus=True`` and
  ``test_assembly(exact_parity=False)`` equal the JAX package's.
"""

import random

import numpy as np
import pytest

from genome_assembly_tpu.experiments.runner import (
    test_assembly as jax_test_assembly,
)
from genome_assembly_tpu.graph.build import (
    build_overlap_graph as jax_build_overlap_graph,
)
from genome_assembly_tpu.graph.consensus import (
    polish_contigs as jax_polish_contigs,
)
from genome_assembly_tpu.graph.cycles import remove_cycles as jax_remove_cycles
from genome_assembly_tpu.graph.greedy import (
    assemble_contigs_greedy as jax_assemble_contigs_greedy,
)
from genome_assembly_tpu.graph.layout import walk_contigs as jax_walk_contigs
from genome_assembly_tpu.graph.topo import topological_order as jax_topo
from genome_assembly_tpu.models.overlap_graph import (
    assemble_contigs_using_overlap_graphs as jax_assemble,
)
from genome_assembly_tpu.simulate.errors import (
    generate_error_prone_reads as jax_error_prone,
)
from genome_assembly_tpu.simulate.reads import (
    generate_error_free_reads as jax_error_free,
)
from genome_assembly_tpu_torch.convert import graph_from_numpy
from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly as port_test_assembly,
)
from genome_assembly_tpu_torch.graph import greedy
from genome_assembly_tpu_torch.graph.consensus import polish_contigs
from genome_assembly_tpu_torch.graph.cycles import remove_cycles
from genome_assembly_tpu_torch.graph.layout import walk_contigs
from genome_assembly_tpu_torch.graph.topo import topological_order
from genome_assembly_tpu_torch.models.overlap_graph import (
    assemble_contigs_using_overlap_graphs,
)
from genome_assembly_tpu_torch.native import graphcore


def _genome(seed, n):
    r = random.Random(seed)
    return "".join(r.choice("ACGT") for _ in range(n))


def _reads(seed, genome_len=700, l=40, n=150, p=0.01):
    genome = _genome(seed, genome_len)
    reads = jax_error_prone(
        jax_error_free(genome, l, n, rng=random.Random(seed + 1)), p,
        rs=np.random.RandomState(seed + 2))
    return genome, reads


UNGUARDED = dict(min_overlap=0, min_frac=0.0, drop_redundant=False,
                 consensus=False)


@pytest.mark.parametrize("guards", ["default", "unguarded"])
@pytest.mark.parametrize("k", [0, 5, 15])
def test_greedy_layout_matches_jax(k, guards):
    _, reads = _reads(3 + k, n=90 if k == 0 else 150)
    kw = {} if guards == "default" else UNGUARDED
    want = jax_assemble_contigs_greedy(reads, k=k, **kw)
    got = greedy.assemble_contigs_greedy(reads, k=k, device="cpu", **kw)
    assert got == want
    assert got


def _chain_inputs(seed, n_nodes=200, n_edges=900):
    rs = np.random.RandomState(seed)
    src = rs.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rs.randint(0, n_nodes, n_edges).astype(np.int32)
    order = np.argsort(-rs.randint(0, 30, n_edges), kind="stable")
    return n_nodes, src, dst, order


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_greedy_chain_matches_python(seed):
    args = _chain_inputs(seed)
    got = greedy.greedy_chain(*args, use_native=True)
    want = greedy.greedy_chain_python(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] >= 0).sum() > 10
    empty = greedy.greedy_chain(0, np.zeros(0, np.int32),
                                np.zeros(0, np.int32), np.zeros(0, np.int64))
    assert [len(x) for x in empty] == [0, 0]


def test_greedy_chain_raises_when_the_engine_fails(monkeypatch):
    def broken():
        raise RuntimeError("building libgraphcore.so failed")

    monkeypatch.setattr(graphcore, "load", broken)
    with pytest.raises(RuntimeError, match="graphcore"):
        greedy.greedy_chain(*_chain_inputs(0))
    # use_native=False is the Python loop, and needs no engine
    assert greedy.greedy_chain(*_chain_inputs(0), use_native=False)


def _walk_inputs(seed):
    _, reads = _reads(seed, n=120)
    g0 = jax_build_overlap_graph(reads, k=5)
    g = graph_from_numpy(g0.unique_reads, g0.src, g0.dst, g0.weight,
                         g0.end_pos, g0.counts, g0.offsets)
    jax_remove_cycles(g0)
    remove_cycles(g)
    return g0, jax_topo(g0), g, topological_order(g)


@pytest.mark.parametrize("seed", [20, 21])
def test_walk_with_placements_and_polish_match_jax(seed):
    g0, topo0, g, topo = _walk_inputs(seed)
    want, pl0 = jax_walk_contigs(g0, topo0, with_placements=True)
    got, pl = walk_contigs(g, topo, with_placements=True)
    assert got == want == walk_contigs(g, topo)
    for a, b in zip(pl, pl0):
        np.testing.assert_array_equal(a, b)
    weight = g.counts[pl[0]].astype(np.int64)
    polished = polish_contigs(got, g.unique_reads, *pl, place_weight=weight)
    assert polished == jax_polish_contigs(want, g0.unique_reads, *pl0,
                                          place_weight=weight)
    assert [len(c) for c in polished] == [len(c) for c in got]


def test_polish_contigs_on_crafted_pileups():
    unique = ["ACGTTA", "GTTACC", "GTAACC", "TTACCG"]
    contigs = ["ACGTTACCG", "GTAACC"]
    read = np.array([0, 1, 2, 3, 2, 1])
    off = np.array([0, 2, 2, 3, -1, 0])
    contig = np.array([0, 0, 0, 0, 1, 1])
    for weight in (None, np.array([1, 3, 1, 2, 1, 1])):
        got = polish_contigs(contigs, unique, read, off, contig, weight)
        assert got == jax_polish_contigs(contigs, unique, read, off, contig,
                                         weight)
    assert polish_contigs([], unique, read, off, contig) == []
    assert polish_contigs(contigs, unique, read[:0], off[:0],
                          contig[:0]) == contigs


@pytest.mark.parametrize("seed", [30, 31])
def test_exact_layout_with_consensus_matches_jax(seed):
    _, reads = _reads(seed, n=140)
    want = jax_assemble(reads, k=5, exact_parity=True, consensus=True)
    got = assemble_contigs_using_overlap_graphs(
        reads, k=5, device="cpu", exact_parity=True, consensus=True)
    assert got == want
    assert got != assemble_contigs_using_overlap_graphs(reads, k=5,
                                                        device="cpu")


@pytest.mark.parametrize("k", [5, 15])
def test_test_assembly_fast_layout_matches_jax(k, tmp_path):
    genome = _genome(40 + k, 900)
    args = (genome, 50, 160, 0.01, k, "fast", 1)
    want = jax_test_assembly(*args, path=str(tmp_path),
                             rng=random.Random(k),
                             np_rng=np.random.RandomState(k),
                             exact_parity=False)
    got = port_test_assembly(*args, path=str(tmp_path),
                             rng=random.Random(k),
                             np_rng=np.random.RandomState(k),
                             exact_parity=False, device="cpu")
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert got[3] == want[3]
