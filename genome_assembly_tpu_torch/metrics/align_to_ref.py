"""Contig -> reference-genome alignment for the metrics pass.

Reference semantics (aligners.py:170-202): a contig is locally aligned to the
genome; a contig *shorter than the read length* is aligned only against the
LAST len(contig) characters of the genome (short reads only arise from
truncation at the genome's end), with start/end offset back by
genome_len - len(contig). This tail-window quirk materially skews the metrics
for short contigs and is replicated exactly.

Contigs are deduplicated (first-occurrence order — the reference keys its
details dict by contig string, performanceMeasures.py:223). Every window is
a suffix of the genome, so one batched call of the C++ engine
(native/graphcore.cpp ``gc_local_align_batch``) aligns them all; its results
are bit-identical to the JAX package's device row scan by that package's
own differential tests. In this slice the C++ engine is the executor on
every device; the device row scan, which the JAX package uses above 2e9 DP
cells on an accelerator, is ROADMAP B2.

The JAX package bands the alignment of genomes of 16384 bp or more
(``banded="auto"``); that route is not ported yet, so such genomes raise
NotImplementedError. Every reference experiment runs on the 5386 bp PhiX.
"""

from __future__ import annotations

import numpy as np

from ..core.dispatch import resolve_device
from ..core.encoding import encode
from ..ops.smith_waterman import replay_ops_host

# genome length from which the JAX package's default bands the alignment
# (GA_TPU_BANDED_AUTO_MIN default)
BANDED_AUTO_MIN = 16384


def _details_entry(ar: str, aq: str, score: int, start: int, end: int) -> dict:
    return {
        "Print": (f"\nTarget:   {ar}\n          {'|' * len(ar)}"
                  f"\nQuery:    {aq}"),
        "Alignment_reference": ar,
        "Alignment_query": aq,
        "Alignment Score": score,
        "Start Position": start,
        "End Position": end,
    }


def _align_full_width_native(items: list[tuple[str, str, int]],
                             details: dict, reference_genome: str,
                             match_score: int, mismatch: int,
                             indel: int) -> None:
    """One batched C++ call over (contig, window, offset) items; fills
    `details` in place."""
    from ..native import graphcore

    genome_codes = encode(reference_genome)
    queries = [c for c, _, _ in items]
    w_len = np.array([len(w) for _, w, _ in items], np.int32)
    score, bi, bj, steps, ops = graphcore.local_align_batch_suffix_windows(
        queries, genome_codes, w_len, match_score=match_score,
        mismatch=mismatch, indel=indel)
    for idx, (c, w, offset) in enumerate(items):
        ar, aq, start = replay_ops_host(ops[idx, :steps[idx]], bi[idx],
                                        bj[idx], c, w)
        details[c] = _details_entry(ar, aq, int(score[idx]), start + offset,
                                    int(bj[idx]) + offset)


def align_contigs_to_reference(contigs: list[str], reference_genome: str,
                               read_length: int, match_score: int = 10,
                               mismatch: int = -1, indel: int = -1,
                               device="cuda") -> dict:
    """Align contigs to the genome; returns {contig: details} in
    first-occurrence order (duplicates collapse, dict-key semantics of
    performanceMeasures.py:219-230)."""
    resolve_device(device)
    genome_len = len(reference_genome)
    if genome_len >= BANDED_AUTO_MIN:
        raise NotImplementedError(
            f"genomes of {BANDED_AUTO_MIN} bp or more take the banded "
            "alignment route (ROADMAP B3), not ported yet")
    seen: dict[str, None] = {}
    for c in contigs:
        seen.setdefault(c)
    items: list[tuple[str, str, int]] = []   # (contig, window, offset)
    for c in seen:
        n = len(c)
        if n == 0:
            continue
        if n < read_length:
            items.append((c, reference_genome[-n:], genome_len - n))
        else:
            items.append((c, reference_genome, 0))

    details: dict[str, dict] = {}
    if items:
        _align_full_width_native(items, details, reference_genome,
                                 match_score, mismatch, indel)
    for c in seen:
        if len(c) == 0:
            details[c] = _details_entry("", "", 0, genome_len, genome_len)
    return {c: details[c] for c in seen}
