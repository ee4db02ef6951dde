"""Single-config pipeline driver.

`test_assembly` is the end-to-end unit (reference testAssembly.py:7-39):
read generation -> error injection -> assembly -> metrics. It is the port's
main path; the sweep drivers around it (``run_simulations``,
``run_for_params``, the experiment harness) are not ported yet.
"""

from __future__ import annotations

import random

import numpy as np

from ..core.dispatch import resolve_device
from ..metrics.measures import calculate_measures
from ..models.overlap_graph import assemble_contigs_using_overlap_graphs
from ..simulate.errors import generate_error_prone_reads
from ..simulate.reads import generate_error_free_reads
from ..utils.tracing import stage


def test_assembly(genome: str, l: int, N: int, error_prob: float, k: int,
                  experiment_name: str, num_iteration: int, path: str = "plots",
                  rng: random.Random | None = None,
                  np_rng: np.random.RandomState | None = None,
                  plot_hooks=None, device="cuda", use_native: bool = True,
                  verbose: bool = False, banded: bool | str = "auto",
                  exact_parity: bool = True, consensus: bool = False):
    """Run one assembly simulation; returns
    (contigs, measures, contigs_alignment_details, error_prone_reads).

    `device` is the torch device of the device stages ("cuda" by default;
    True and False as in the JAX package: the card or the host; raises
    without a card, pass "cpu" to run on the host). `path` is only handed
    to `plot_hooks`. `banded` chooses the metrics pass's alignment route
    (`calculate_measures`): "auto" bands genomes of 16384 bp or more with
    seeded, stability-verified bands, True forces banding, False full
    width. `exact_parity=False` switches the layout to the fast greedy
    chaining (graph/greedy.py, with its consensus polish; documented
    non-parity semantics); `consensus=True` polishes the exact-parity
    contigs by pileup majority vote (graph/consensus.py).
    `use_native=False` with the exact layout (the Python cycle removal) is
    not ported yet and raises NotImplementedError."""
    dev = resolve_device(device)
    with stage("simulate.reads", items=N):
        error_free = generate_error_free_reads(genome, l, N, rng=rng)
        error_prone = generate_error_prone_reads(error_free, error_prob,
                                                 rs=np_rng)

    params = {"N": N, "l": l, "k": k, "error_prob": error_prob,
              "experiment_name": experiment_name, "num_iteration": num_iteration}
    contigs = assemble_contigs_using_overlap_graphs(
        error_prone, k=k, params=params, device=dev, use_native=use_native,
        verbose=verbose, exact_parity=exact_parity, consensus=consensus)

    with stage("metrics.calculate", items=len(contigs)):
        measures, details = calculate_measures(
            contigs, error_prone, len(error_prone), l, error_prob, k, genome,
            experiment_name, num_iteration, path, plot_hooks=plot_hooks,
            verbose=verbose, banded=banded, device=dev)
    return contigs, measures, details, error_prone
