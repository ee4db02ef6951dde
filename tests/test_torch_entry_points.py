"""The port's entry points take the JAX package's keywords (ROADMAP §C 1),
and the overlap wrapper refuses lengths outside [0, L] (ROADMAP §C 2).

- every reference keyword is accepted, and the values ported since the
  first slice (the fast layout, the consensus polish, the read placements,
  the Python cycle removal behind ``use_native=False``) give the JAX
  package's results;
- reads with an N below the pair threshold get the C++ scorer's answer on
  a CUDA device too (ROADMAP §C 3);
- ``device=True`` / ``False`` mean the card / the host, as in the JAX
  package: False gives the result of ``device="cpu"``, True raises here
  without a card.
"""

import random

import numpy as np
import pytest
import torch

from genome_assembly_tpu.experiments.runner import (
    test_assembly as jax_run_assembly,
)
from genome_assembly_tpu.graph.build import (
    build_overlap_graph as jax_build_overlap_graph,
)
from genome_assembly_tpu.graph.build import score_pairs as jax_score_pairs
from genome_assembly_tpu.graph.cycles import remove_cycles as jax_remove_cycles
from genome_assembly_tpu.graph.layout import walk_contigs as jax_walk_contigs
from genome_assembly_tpu.models.overlap_graph import (
    assemble_contigs_using_overlap_graphs as jax_assemble_contigs,
)
from genome_assembly_tpu.graph.topo import topological_order as jax_topo
from genome_assembly_tpu_torch.core.dispatch import (
    MIN_DEVICE_PAIRS,
    use_host_metrics,
    use_host_pair_scoring,
)
from genome_assembly_tpu_torch.graph import build as port_build
from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly as run_assembly,
)
from genome_assembly_tpu_torch.graph.build import (
    build_overlap_graph,
    candidate_pairs_arrays,
    dedup_reads,
    score_pairs,
)
from genome_assembly_tpu_torch.graph.cycles import remove_cycles
from genome_assembly_tpu_torch.graph.layout import walk_contigs
from genome_assembly_tpu_torch.graph.topo import topological_order
from genome_assembly_tpu_torch.metrics.align_to_ref import (
    align_contigs_to_reference,
)
from genome_assembly_tpu_torch.metrics.measures import calculate_measures
from genome_assembly_tpu_torch.models.overlap_graph import (
    assemble_contigs_using_overlap_graphs,
)
from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
from genome_assembly_tpu_torch.utils.tracing import global_tracer


def _genome(n=600, seed=0):
    r = random.Random(seed)
    return "".join(r.choice("ACGT") for _ in range(n))


def _run(run=run_assembly, **kwargs):
    return run(_genome(), 40, 60, 0.01, 5, "kw", 1,
               rng=random.Random(1), np_rng=np.random.RandomState(1),
               **kwargs)


def _graph():
    genome = _genome()
    reads = [genome[i:i + 40] for i in range(0, 560, 13)]
    return reads, build_overlap_graph(reads, k=5, device="cpu")


def test_reference_keywords_are_accepted(tmp_path):
    genome = _genome()
    contigs, measures, details, reads = _run(
        device="cpu", use_native=True, banded=False, path=str(tmp_path))
    assert contigs and len(measures) == 5
    assert assemble_contigs_using_overlap_graphs(
        reads, k=5, device="cpu", use_native=True) == contigs
    _, g = _graph()
    assert remove_cycles(g, use_native=True) >= 0
    assert walk_contigs(g, topological_order(g), with_placements=False)
    unique, _ = dedup_reads(reads)
    s1 = score_pairs(unique, [(0, 1), (1, 2)], chunk=2, device="cpu")
    s2 = score_pairs(unique, [(0, 1), (1, 2)], device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(s1, s2))
    c1 = candidate_pairs_arrays(unique, 5, device=False)
    c2 = candidate_pairs_arrays(unique, 5, device="cpu")
    assert len(c1[0]) and all(np.array_equal(a, b) for a, b in zip(c1, c2))
    m1, d1 = calculate_measures(contigs, reads, 60, 40, 0.01, 5, genome,
                                "kw", 1, str(tmp_path), banded=True, band=16,
                                device="cpu")
    assert m1 == measures and d1 == details
    d2 = align_contigs_to_reference(contigs, genome, 40, max_batch=3,
                                    banded=True, band=16, seed_k=11,
                                    executor="xla", device="cpu")
    assert d2 == details


def test_device_false_is_the_host_route():
    a = _run(device=False)
    b = _run(device="cpu")
    assert a[:2] == b[:2] and a[2] == b[2]


def test_device_true_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _run(device=True)


def _cycles_three_ways():
    """alive after the port's Python cycle removal, the JAX package's and
    the port's C++ engine's, on one graph."""
    reads, _ = _graph()
    out = []
    for build, remove, kw in (
            (build_overlap_graph, remove_cycles, {"use_native": False}),
            (jax_build_overlap_graph, jax_remove_cycles,
             {"use_native": False}),
            (build_overlap_graph, remove_cycles, {"use_native": True})):
        g = build(reads, k=5, **({} if build is jax_build_overlap_graph
                                 else {"device": "cpu"}))
        removed = remove(g, **kw)
        out.append((removed, g.alive.tolist()))
    return out


@pytest.mark.parametrize("call, item", [
    (lambda: [_run(device="cpu", use_native=False),
              _run(run=jax_run_assembly, use_native=False),
              _run(device="cpu", use_native=True)], "A9"),
    (lambda: [assemble_contigs_using_overlap_graphs(
        _graph()[0], device="cpu", use_native=False),
        jax_assemble_contigs(_graph()[0], use_native=False),
        assemble_contigs_using_overlap_graphs(
            _graph()[0], device="cpu", use_native=True)], "A9"),
    (_cycles_three_ways, "A9"),
])
def test_unported_values_name_their_roadmap_item(call, item):
    """The three values that raised naming ROADMAP A9 (`item`) before the
    Python cycle removal was ported give the JAX package's Python-loop
    results and the C++ engine's."""
    port_python, jax_python, port_native = call()
    if isinstance(port_python, tuple) and len(port_python) == 4:
        # test_assembly: contigs, measures, details, reads
        assert port_python[0] and port_python[1]
        for got in (jax_python, port_native):
            assert port_python[0] == got[0] and port_python[1] == got[1]
            assert port_python[2] == got[2] and port_python[3] == got[3]
        return
    assert port_python
    assert port_python == jax_python == port_native


def test_reads_with_an_n_below_the_pair_threshold_get_the_engine_on_a_card():
    """ROADMAP §C 3: on a CUDA device (a torch.device object; no card is
    needed to ask the rule), fewer than 200,000 pairs of reads with PAD
    inside their lengths go to the C++ scorer, the JAX package's answer on
    every backend there; everything else on a card takes the kernels."""
    cuda = torch.device("cuda")
    rule = use_host_pair_scoring
    assert MIN_DEVICE_PAIRS == 200_000
    assert rule(cuda, 0, True) and rule(cuda, MIN_DEVICE_PAIRS - 1, True)
    assert not rule(cuda, MIN_DEVICE_PAIRS, True)
    assert not rule(cuda, 10, False) and not rule(cuda, 10**7, False)
    cpu = torch.device("cpu")
    assert all(rule(cpu, n, pad) for n in (0, 10**7) for pad in (0, 1))
    # score_pairs on a CUDA device object: reads with an internal N take the
    # host route without touching a card, and answer as the JAX package
    unique = ["ACGTACGTAC", "CGTACNTTTT", "ACNNACGTAC", "NNACGTAC"]
    ia = np.repeat(np.arange(4, dtype=np.int32), 4)
    ib = np.tile(np.arange(4, dtype=np.int32), 4)
    tracer = global_tracer()
    tracer.reset()
    got = port_build._score_pairs_impl(unique, ia, ib, cuda)
    assert list(tracer.times) == ["score.pairs.host"]
    want = jax_score_pairs(unique, (ia, ib))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if torch.cuda.is_available():
        return
    # reads padded past their lengths carry no N: they go for the card,
    # which is absent here
    tracer.reset()
    with pytest.raises((AssertionError, RuntimeError)):
        port_build._score_pairs_impl(["ACGTAC", "AC"], ia[:2], ib[:2] % 2,
                                     cuda)
    assert "score.pairs.host" not in tracer.times


def _walk_with_placements(build, remove, topo, walk):
    reads, _ = _graph()
    g = build(reads, k=5, **({} if build is jax_build_overlap_graph
                             else {"device": "cpu"}))
    remove(g)
    contigs, placements = walk(g, topo(g), with_placements=True)
    return contigs, [p.tolist() for p in placements]


@pytest.mark.parametrize("call", ["placements", "fast layout", "consensus"])
def test_formerly_unported_values_match_jax(call):
    """The three values that raised naming ROADMAP A6 before they were
    ported give the JAX package's results."""
    if call == "placements":
        got = _walk_with_placements(build_overlap_graph, remove_cycles,
                                    topological_order, walk_contigs)
        want = _walk_with_placements(jax_build_overlap_graph,
                                     jax_remove_cycles, jax_topo,
                                     jax_walk_contigs)
        assert got == want and got[1][0]
        return
    kw = ({"exact_parity": False} if call == "fast layout"
          else {"consensus": True})
    got = _run(device="cpu", **kw)
    want = _run(run=jax_run_assembly, **kw)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]


def test_unknown_metrics_executor_is_refused():
    with pytest.raises(ValueError, match="executor"):
        use_host_metrics(torch.device("cpu"), "tpu")
    assert use_host_metrics(torch.device("cpu"), "auto")
    assert not use_host_metrics(torch.device("cpu"), "xla")
    assert use_host_metrics(torch.device("cuda"), "native")
    assert not use_host_metrics(torch.device("cuda"), "auto")


@pytest.mark.parametrize("which", ["a_len", "b_len"])
@pytest.mark.parametrize("bad", [-1, 13])
def test_overlap_rejects_lengths_outside_the_padded_width(which, bad):
    rs = np.random.RandomState(0)
    codes = torch.from_numpy(rs.randint(0, 4, size=(3, 12)).astype(np.int8))
    ok = torch.tensor([12, 5, 0], dtype=torch.int32)
    wrong = ok.clone()
    wrong[1] = bad
    a_len, b_len = (wrong, ok) if which == "a_len" else (ok, wrong)
    with pytest.raises(ValueError, match=which):
        oa.overlap_scores_block(codes, a_len, codes, b_len)
