"""The string-graph and unitig pipelines of the port against the JAX
package's, on the same seeded inputs; every result exact (same edges in the
same order, same alive mask, contigs, unitigs and measures).

- ``build_string_graph``, ``transitive_reduction`` and
  ``assemble_contigs_string`` on the toy reads of tests/test_alt_pipelines.py
  and on PhiX reads with duplicate reads, on the host route and on the dense
  route a card takes (its plain version on the CPU);
- the Myers reduction as tensor ops against the JAX package's loop on
  random graphs with equal-weight ties, copies and dead edges;
- ``construct_string_graph``, ``transitive_reduction2`` and
  ``find_unitigs`` with duplicate reads (self-pairs, both directions), on
  random graphs carried over with ``convert.digraph_from_dicts``, and the
  2-cycle guard;
- ``test_assembly_new_pipeline`` at a small N.
"""

import random

import numpy as np
import pytest

from genome_assembly_tpu.experiments.runner import (
    test_assembly_new_pipeline as jax_new_pipeline,
)
from genome_assembly_tpu.graph.build import OverlapGraph as JaxGraph
from genome_assembly_tpu.models import string_graph as jsg
from genome_assembly_tpu.models import unitig as jun
from genome_assembly_tpu.simulate import read_genome_from_fasta
from genome_assembly_tpu.simulate.errors import generate_error_prone_reads
from genome_assembly_tpu.simulate.reads import generate_error_free_reads
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.core import dispatch
from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly_new_pipeline as port_new_pipeline,
)
from genome_assembly_tpu_torch.models import string_graph as psg
from genome_assembly_tpu_torch.models import unitig as pun

TOY_GENOME = "ATGCGTACGTTAGCACGTGTTCGATAGC"
TOY_READS = ["TGTTC", "TGCGT", "ACGTG", "CACGT", "AGCAC",
             "GATAG", "CGATA", "GTACG", "CGTAC", "ATGCG"]
PHIX = "data/phix174.fasta"


def _phix_reads(seed, n, l=60, dup=0):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    genome = read_genome_from_fasta(os.path.join(root, PHIX))
    reads = generate_error_prone_reads(
        generate_error_free_reads(genome, l, n, rng=random.Random(seed)),
        0.01, rs=np.random.RandomState(seed))
    return reads + reads[:dup]


READ_SETS = {
    "toy": lambda: TOY_READS,
    "toy with duplicates": lambda: TOY_READS + TOY_READS[:4],
    "PhiX N=60": lambda: _phix_reads(1, 60),
    "PhiX N=100 + 20 copies": lambda: _phix_reads(2, 100, dup=20),
    "PhiX N=150, l=40": lambda: _phix_reads(3, 150, l=40),
    "PhiX N=120, l=100 + 10 copies": lambda: _phix_reads(4, 120, l=100,
                                                         dup=10),
}


def _edges(g):
    return (g.src, g.dst, g.weight, g.end_pos)


@pytest.mark.parametrize("route", ["host", "dense"])
@pytest.mark.parametrize("reads", list(READ_SETS))
def test_string_graph_matches_jax(reads, route, monkeypatch):
    reads = READ_SETS[reads]()
    if route == "dense":
        # the route of a CUDA device, on the CPU: the all-pairs scorer's
        # plain version over U x U, then the gather
        monkeypatch.setattr(dispatch, "use_host_pair_scoring",
                            lambda device, *rule: False)
    g0 = jsg.build_string_graph(reads)
    g = psg.build_string_graph(reads, device="cpu")
    assert g.unique_reads == g0.unique_reads
    for got, want in zip(_edges(g), _edges(g0)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    jsg.transitive_reduction(g0)
    psg.transitive_reduction(g, device="cpu")
    np.testing.assert_array_equal(g.alive, g0.alive)
    assert (psg.assemble_contigs_string(reads, device="cpu")
            == jsg.assemble_contigs_string(reads))


def _random_graph(seed):
    """Random graph fields: U bases with 1-3 copies, random base pairs
    without self-loops fanned out to copies, weights per edge from a small
    range (ties), and some edges dead."""
    rs = np.random.RandomState(seed)
    u = rs.randint(5, 40)
    counts = rs.randint(1, 4, size=u).astype(np.int32)
    offsets = np.zeros(u + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    src, dst = [], []
    density = rs.uniform(0.1, 0.9)
    for a in range(u):
        for b in rs.permutation(u):
            if a != b and rs.rand() < density:
                for ca in range(counts[a]):
                    for cb in range(counts[b]):
                        src.append(offsets[a] + ca)
                        dst.append(offsets[b] + cb)
    n_edges = len(src)
    fields = dict(
        unique_reads=[f"r{i}" for i in range(u)], counts=counts,
        offsets=offsets, src=np.array(src, np.int32),
        dst=np.array(dst, np.int32),
        weight=rs.randint(-2, 5, size=n_edges).astype(np.int32),
        end_pos=rs.randint(0, 9, size=n_edges).astype(np.int32))
    alive = rs.rand(n_edges) > rs.choice([0.0, 0.2])
    return fields, alive


@pytest.mark.parametrize("block", [0, 3])
@pytest.mark.parametrize("seeds", [range(0, 20), range(20, 40)])
def test_myers_reduction_matches_jax_on_random_graphs(seeds, block,
                                                      monkeypatch):
    if block:
        monkeypatch.setattr(psg, "REDUCTION_BLOCK_ELEMENTS", block)
    for seed in seeds:
        fields, alive = _random_graph(seed)
        g0 = JaxGraph(**fields)
        g0.alive[:] = alive
        g = convert.graph_from_numpy(**fields)
        g.alive[:] = alive
        jsg.transitive_reduction(g0)
        psg.transitive_reduction(g, device="cpu")
        np.testing.assert_array_equal(g.alive, g0.alive, err_msg=str(seed))


def test_explicit_shortcut_is_eliminated_as_in_jax():
    reads = ["AAAATTTT", "TTTTGGGG", "GGGGCCCC"]
    g = jsg.build_string_graph(reads)
    fields = dict(
        unique_reads=g.unique_reads, counts=g.counts, offsets=g.offsets,
        src=np.concatenate([g.src, [0]]).astype(np.int32),
        dst=np.concatenate([g.dst, [2]]).astype(np.int32),
        weight=np.concatenate([g.weight, [1]]).astype(np.int32),
        end_pos=np.concatenate([g.end_pos, [8]]).astype(np.int32))
    g0 = JaxGraph(**fields)
    g1 = convert.graph_from_numpy(**fields)
    jsg.transitive_reduction(g0)
    psg.transitive_reduction(g1, device="cpu")
    np.testing.assert_array_equal(g1.alive, g0.alive)
    assert not g1.alive[-1]


def _dicts(g):
    return ([(u, list(n.items())) for u, n in g.succ.items()],
            [(v, list(n.items())) for v, n in g.pred.items()])


@pytest.mark.parametrize("route", ["host", "dense"])
@pytest.mark.parametrize("reads", list(READ_SETS))
def test_unitig_pipeline_matches_jax(reads, route, monkeypatch):
    reads = READ_SETS[reads]()
    if route == "dense":
        monkeypatch.setattr(dispatch, "use_host_pair_scoring",
                            lambda device, *rule: False)
    g0 = jun.construct_string_graph(reads)
    g = pun.construct_string_graph(reads, device="cpu")
    assert _dicts(g) == _dicts(g0)
    r0 = jun.transitive_reduction2(g0)
    r = pun.transitive_reduction2(g, device="cpu")
    assert _dicts(r) == _dicts(r0)
    assert _dicts(g) == _dicts(g0)          # the input is left unchanged
    assert pun.find_unitigs(r) == jun.find_unitigs(r0)
    assert (pun.assemble_contigs(reads, device="cpu")
            == jun.assemble_contigs(reads))


def test_duplicate_reads_give_self_pairs_and_both_directions():
    reads = ["ACGTACGT", "CGTACGTA", "ACGTACGT", "CGTACGTA"]
    g0 = jun.construct_string_graph(reads)
    g = pun.construct_string_graph(reads, device="cpu")
    assert _dicts(g) == _dicts(g0)
    assert g.has_edge("ACGTACGT", "ACGTACGT")
    assert g.has_edge("ACGTACGT", "CGTACGTA")
    assert g.has_edge("CGTACGTA", "ACGTACGT")


def _random_digraph(seed):
    """A JAX-package _DiGraph over 4-30 nodes, edges in a random order,
    self-loops and both directions included."""
    rs = np.random.RandomState(seed)
    n = rs.randint(4, 30)
    names = [f"n{i}" for i in rs.permutation(n)]
    g = jun._DiGraph()
    for name in names:
        g.add_node(name)
    density = rs.uniform(0.05, 0.5)
    pairs = [(a, b) for a in names for b in names]
    for k in rs.permutation(len(pairs)):
        if rs.rand() < density:
            a, b = pairs[k]
            g.add_edge(a, b, weight=int(rs.randint(1, 50)),
                       end_position=int(rs.randint(0, 5)))
    return g


@pytest.mark.parametrize("block", [0, 2])
@pytest.mark.parametrize("seeds", [range(0, 25), range(25, 50)])
def test_path_reduction_matches_jax_on_random_graphs(seeds, block,
                                                     monkeypatch):
    if block:
        monkeypatch.setattr(pun, "REDUCTION_BLOCK_ELEMENTS", block)
    for seed in seeds:
        g0 = _random_digraph(seed)
        g = convert.digraph_from_dicts(g0.succ, g0.pred)
        assert _dicts(g) == _dicts(g0)
        r0 = jun.transitive_reduction2(g0)
        r = pun.transitive_reduction2(g, device="cpu")
        assert _dicts(r) == _dicts(r0), seed
        assert pun.find_unitigs(r) == jun.find_unitigs(r0), seed


def test_two_cycle_guard_matches_jax():
    graphs = []
    for mod in (jun, pun):
        g = mod._DiGraph()
        g.add_edge("AAAATTTT", "TTTTAAAA", weight=40, end_position=4)
        g.add_edge("TTTTAAAA", "AAAATTTT", weight=40, end_position=4)
        graphs.append(mod.find_unitigs(g))
    assert graphs[0] == graphs[1] and len(graphs[1]) >= 1


def test_new_pipeline_run_matches_jax(tmp_path):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    genome = read_genome_from_fasta(os.path.join(root, PHIX))
    runs = [run(genome, 60, 90, "alt", 1, str(tmp_path), 0.01, 5,
                rng=random.Random(5), np_rng=np.random.RandomState(5),
                **kw)
            for run, kw in ((jax_new_pipeline, {}),
                            (port_new_pipeline, {"device": "cpu"}))]
    want, got = runs
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2] and got[3] == want[3]


def test_new_pipeline_run_on_the_toy_genome(tmp_path):
    kw = dict(rng=random.Random(0), np_rng=np.random.RandomState(0))
    got = port_new_pipeline(TOY_GENOME * 4, 8, 20, "alt", 1, str(tmp_path),
                            0.0, fuzz=5, device="cpu", **kw)
    kw = dict(rng=random.Random(0), np_rng=np.random.RandomState(0))
    want = jax_new_pipeline(TOY_GENOME * 4, 8, 20, "alt", 1, str(tmp_path),
                            0.0, fuzz=5, device=False, **kw)
    assert got[:2] == want[:2] and got[2] == want[2]
