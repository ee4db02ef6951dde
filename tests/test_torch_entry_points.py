"""The port's entry points take the JAX package's keywords (ROADMAP §C 1),
and the overlap wrapper refuses lengths outside [0, L] (ROADMAP §C 2).

- every reference keyword is accepted; values whose path is not ported
  raise NotImplementedError naming their ROADMAP item, and the values
  ported since (the fast layout, the consensus polish, the read
  placements) give the JAX package's results;
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
from genome_assembly_tpu.graph.cycles import remove_cycles as jax_remove_cycles
from genome_assembly_tpu.graph.layout import walk_contigs as jax_walk_contigs
from genome_assembly_tpu.graph.topo import topological_order as jax_topo
from genome_assembly_tpu_torch.core.dispatch import use_host_metrics
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


@pytest.mark.parametrize("call, item", [
    (lambda: _run(device="cpu", use_native=False), "A9"),
    (lambda: assemble_contigs_using_overlap_graphs(
        _graph()[0], device="cpu", use_native=False), "A9"),
    (lambda: remove_cycles(_graph()[1], use_native=False), "A9"),
])
def test_unported_values_name_their_roadmap_item(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call()


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
