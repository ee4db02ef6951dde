"""Per-iteration plots (reference plots.py:19-168, C20)."""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np

from .helpers import save_figure


def plot_genome_coverage(coverage, genome_length: int, experiment_name: str,
                         num_iteration: int, path: str) -> None:
    """Binary covered/uncovered track over genome positions
    (plots.py:19-54)."""
    positions = np.arange(genome_length)
    fig = plt.figure(figsize=(10, 5))
    plt.plot(positions, np.asarray(coverage) > 0, marker="o", linestyle="-",
             color="b")
    plt.xlabel("Genome Base Position")
    plt.ylabel("Coverage Count")
    plt.title(f"Genome Coverage by Assembled Contigs - {experiment_name} "
              f"iteration: {num_iteration}")
    plt.axhline(y=1, color="g", linestyle="--",
                label="Fully Covered Threshold")
    plt.legend()
    save_figure(fig,
                f"{path}/genome_coverage_iteration_{num_iteration}.png",
                dpi=None, tight=False)


def plot_genome_depth(coverage, expected_coverage: float, genome_length: int,
                      experiment_name: str, num_iteration: int,
                      path: str) -> None:
    """Per-base depth track with the expected-coverage line
    (plots.py:57-94)."""
    positions = np.arange(genome_length)
    fig = plt.figure(figsize=(10, 5))
    plt.plot(positions, coverage, marker="o", linestyle="-")
    plt.xlabel("Genome Base Position")
    plt.ylabel("Read Coverage Depth")
    plt.title(f"Genome Coverage Depth - experiment {experiment_name} "
              f"iteration: {num_iteration}")
    if len(coverage) > 0:
        plt.axhline(y=expected_coverage, color="g", linestyle="--",
                    label="Expected Coverage")
        plt.legend()
    else:
        print("Warning: No coverage values available. "
              "Check the alignment process.")
    save_figure(fig, f"{path}/genome_depth_iteration_{num_iteration}.png",
                dpi=None, tight=False)


def plot_reconstructed_coverage(contigs: list[str], reads: list[str],
                                num_reads: int, read_length: int,
                                reference_genome: str, experiment_name: str,
                                num_iteration: int, path: str,
                                rng=None, device="cuda") -> None:
    """Read-depth per contig base: each read is assigned to its best-scoring
    contig (random tie-break) and its aligned span incremented
    (plots.py:97-168). Ships but is not on the live metrics path — the
    reference comments out the call (performanceMeasures.py:234-236).

    Kept as the JAX package has it: the call below unpacks four values
    from ``align_read_or_contig_to_reference``, which returns six, so it
    raises ValueError at its first alignment. `device` is the
    alignment's torch device.
    """
    from ..metrics.align_to_ref import align_read_or_contig_to_reference

    if rng is None:
        rng = np.random
    coverages = {c: np.zeros(len(c)) for c in contigs}
    for read in reads:
        best_score = -float("inf")
        best: list[tuple[str, int, int]] = []
        for contig in contigs:
            _, score, start, end = align_read_or_contig_to_reference(
                read, contig, read_length, device=device)
            if start == -1 or end == -1:
                continue
            if score > best_score:
                best_score = score
                best = [(contig, start, end)]
            elif score == best_score:
                best.append((contig, start, end))
        if best:
            contig, start, end = best[rng.choice(len(best))] \
                if hasattr(rng, "choice") else best[0]
            coverages[contig][start:end] += 1

    expected = num_reads * read_length / len(reference_genome)
    for idx, contig in enumerate(contigs):
        cov = coverages[contig]
        fig = plt.figure(figsize=(10, 5))
        plt.plot(np.arange(len(contig)), cov, marker="o", linestyle="-")
        plt.xlabel("Contig Base Position")
        plt.ylabel("Read Coverage Depth")
        plt.title(f"Read Coverage Depth for Contig {idx + 1} - experiment "
                  f"{experiment_name} iteration: {num_iteration}")
        if len(cov) > 0:
            plt.axhline(y=expected, color="g", linestyle="--",
                        label="Expected Depth")
            plt.axhline(y=float(np.mean(cov)), color="r", linestyle="--",
                        label="Empirical Average Depth")
            plt.legend()
        save_figure(
            fig,
            f"{path}/contig_coverage_{idx + 1}_iteration_{num_iteration}.png",
            dpi=None, tight=False)
