"""Assembly quality metrics.

Reference semantics (performanceMeasures.py):
- per aligned contig, coverage[start:end] += 1 (performanceMeasures.py:34);
- mismatch columns: for i in range(end-start), a column is a mismatch when
  the query char is '-' or differs from the ref char; counted into
  mismatches[start+i] (performanceMeasures.py:37-50) — note this scans the
  first (end-start) characters of the aligned strings, including '-'
  columns, exactly as the reference does;
- coverage_rate = nonzero(coverage)/G;
  mismatch_rate_aligned = nonzero(mismatch)/covered (0.0 if none covered);
  mismatch_rate_genome = (nonzero(mismatch)+uncovered)/G
  (performanceMeasures.py:61-69);
- N50 = classic mass-median over descending contig lengths
  (performanceMeasures.py:124-143);
- the measures dict uses the exact metric names of consts.py:8.

The coverage and mismatch counts run on the given torch device: a +1/-1
difference array with ``index_add_`` and ``cumsum``, and an ``index_add_`` of
the mismatch columns (the JAX package's ``_scatter_device_fn``). The
reference's loop (``_coverage_and_mismatch_python``, the parity oracle) and
its two dead-code metric variants are host copies of the JAX package's.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..core.config import METRIC_NAMES
from ..core.dispatch import resolve_device
from ..utils.tracing import stage
from .align_to_ref import align_contigs_to_reference

_DASH = np.uint8(ord("-"))


def _coverage_and_mismatch_python(details: dict, genome_length: int):
    """The reference's per-column interpreter loop
    (performanceMeasures.py:25-50); kept as the parity oracle for the
    vectorized path below."""
    coverage = np.zeros(genome_length)
    mismatches = np.zeros(genome_length)
    for contig, d in details.items():
        start, end = d["Start Position"], d["End Position"]
        if start == -1 or end == -1:
            continue
        coverage[start:end] += 1
        ar = d["Alignment_reference"]
        aq = d["Alignment_query"]
        for i in range(end - start):
            if aq[i] == "-" or aq[i] != ar[i]:
                mismatches[start + i] += 1
    return coverage, mismatches


def coverage_and_mismatch_vectors(details: dict, genome_length: int,
                                  device="cuda"):
    """(coverage, mismatches) float64 numpy count vectors of length G,
    bit-equal to the reference loop. Per contig the aligned-column compare
    is one numpy bytes comparison; the accumulation runs on `device`."""
    dev = resolve_device(device)
    pos_parts, mm_parts, starts_l, ends_l = [], [], [], []
    for d in details.values():
        start, end = d["Start Position"], d["End Position"]
        if start == -1 or end == -1:
            continue
        starts_l.append(start)
        ends_l.append(end)
        span = end - start
        if span <= 0:
            continue
        ar = np.frombuffer(
            d["Alignment_reference"][:span].encode("ascii"), np.uint8)
        aq = np.frombuffer(
            d["Alignment_query"][:span].encode("ascii"), np.uint8)
        mm_parts.append((aq == _DASH) | (aq != ar))
        pos_parts.append(np.arange(start, end, dtype=np.int64))
    if not starts_l:
        return np.zeros(genome_length), np.zeros(genome_length)
    g = genome_length
    starts = torch.tensor(starts_l, dtype=torch.int64, device=dev)
    ends = torch.tensor(ends_l, dtype=torch.int64, device=dev)
    delta = torch.zeros(g + 1, dtype=torch.int64, device=dev)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, ends, -torch.ones_like(ends))
    coverage = torch.cumsum(delta, 0)[:g]
    mism = torch.zeros(g, dtype=torch.int64, device=dev)
    if pos_parts:
        pos = np.concatenate(pos_parts)
        mm = np.concatenate(mm_parts)
        mm_pos = torch.from_numpy(pos[mm]).to(dev)
        mism.index_add_(0, mm_pos, torch.ones_like(mm_pos))
    both = torch.stack([coverage, mism]).cpu().numpy().astype(float)
    return both[0], both[1]


def calculate_n50(contigs: list[str]) -> int:
    lengths = sorted((len(c) for c in contigs), reverse=True)
    total = sum(lengths)
    cum = 0
    for length in lengths:
        cum += length
        if cum >= total / 2:
            return length
    return 0


def contig_summary(contigs: list[str]) -> dict:
    """Count, N50, total length and the sha256 of the newline-joined
    contigs: what the port's drivers hold against the JAX package's
    recorded runs."""
    return {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
    }


def calculate_genome_coverage_and_mismatch_rate(
        contigs_alignment_details: dict, reference_genome: str,
        expected_coverage: float, experiment_name: str, num_iteration: int,
        path: str = "plots", plot_hooks=None, device="cuda"):
    """Returns (coverage_rate, mismatch_rate_aligned, mismatch_rate_genome)."""
    genome_length = len(reference_genome)
    coverage, mismatches = coverage_and_mismatch_vectors(
        contigs_alignment_details, genome_length, device=device)

    if plot_hooks is not None:
        # reference gating (performanceMeasures.py:53-58): skip flat coverage
        # on iterations beyond the first
        if not (num_iteration != 1 and np.all(coverage == coverage[0])):
            plot_hooks["coverage"](coverage, genome_length, experiment_name,
                                   num_iteration, path)
            plot_hooks["depth"](coverage, expected_coverage, genome_length,
                                experiment_name, num_iteration, path)

    covered = int(np.count_nonzero(coverage))
    uncovered = genome_length - covered
    coverage_rate = covered / genome_length
    n_mismatch = int(np.count_nonzero(mismatches))
    mismatch_rate_aligned = n_mismatch / covered if covered > 0 else 0.0
    mismatch_rate_genome = (n_mismatch + uncovered) / genome_length
    return coverage_rate, mismatch_rate_aligned, mismatch_rate_genome


def calculate_mismatch_rate_aligned_regions(contigs_alignment_details: dict,
                                            reference_genome: str) -> float:
    """Dead-code metric variant kept for capability parity
    (performanceMeasures.py:76-121, never called in the live path)."""
    genome_length = len(reference_genome)
    total_mm = 0
    total_aligned = 0
    for contig, d in contigs_alignment_details.items():
        start, end = d["Start Position"], d["End Position"]
        if start == -1 or end == -1:
            continue
        total_aligned += end - start
        c_seq = contig[max(0, -start): min(len(contig), len(contig) + (genome_length - end))]
        r_seq = reference_genome[max(0, start): min(genome_length, end)]
        m = min(len(c_seq), len(r_seq))
        if m > 0:
            total_mm += sum(a != b for a, b in zip(c_seq[:m], r_seq[:m]))
    if total_aligned == 0:
        return 0.0
    rate = (total_mm / total_aligned) * (total_aligned / genome_length)
    return min(1.0, max(0.0, rate))


def calculate_mismatch_rate_full_genome(contigs_alignment_details: dict,
                                        reference_genome: str,
                                        coverage: np.ndarray) -> float:
    """Dead-code metric variant (performanceMeasures.py:146-187)."""
    genome_length = len(reference_genome)
    total_mm = 0
    for contig, d in contigs_alignment_details.items():
        start, end = d["Start Position"], d["End Position"]
        if start == -1 or end == -1:
            continue
        c_seq = contig[max(0, -start): min(len(contig), len(contig) + (genome_length - end))]
        r_seq = reference_genome[max(0, start): min(genome_length, end)]
        m = min(len(c_seq), len(r_seq))
        if m > 0:
            total_mm += sum(a != b for a, b in zip(c_seq[:m], r_seq[:m]))
    total_mm += int(np.count_nonzero(coverage == 0))
    return min(1.0, total_mm / genome_length)


def calculate_measures(contigs: list[str], reads: list[str], num_reads: int,
                       reads_length: int, error_prob: float, k: int,
                       ref_genome: str, experiment_name: str,
                       num_iteration: int, path: str = "plots",
                       plot_hooks=None, verbose: bool = False,
                       banded: bool | str = "auto", band: int = 64,
                       device="cuda"):
    """Returns (measures, contigs_alignment_details) — reference
    performanceMeasures.py:190-252 signature and output parity.

    `banded` and `band` choose the alignment route of the contigs
    (``align_contigs_to_reference``): "auto" bands genomes of
    ``banded_auto_min()`` bp or more with seeded, stability-verified
    bands; True forces banding; False forces full width. The alignment
    feeds the tracer's "metrics.align" stage."""
    if verbose:
        print(f"Calculating performance measures for {experiment_name} "
              f"(Iteration {num_iteration})")
    dev = resolve_device(device)
    expected_coverage = num_reads * reads_length / len(ref_genome)
    with stage("metrics.align", items=len(contigs)):
        details = align_contigs_to_reference(contigs, ref_genome,
                                             reads_length, banded=banded,
                                             band=band, device=dev)

    coverage_rate, mm_aligned, mm_genome = (
        calculate_genome_coverage_and_mismatch_rate(
            details, ref_genome, expected_coverage, experiment_name,
            num_iteration, path, plot_hooks=plot_hooks, device=dev))

    measures = {
        METRIC_NAMES[0]: len(contigs),
        METRIC_NAMES[1]: coverage_rate,
        METRIC_NAMES[2]: calculate_n50(contigs),
        METRIC_NAMES[3]: mm_aligned,
        METRIC_NAMES[4]: mm_genome,
    }
    return measures, details
