"""Synthetic read sampling (host).

Semantics (reference generateErrorFreeReads.py:22-52): each read starts at a
uniform position in [0, G-1] (inclusive), spans `read_length` bases, and is
*truncated* (not wrapped) at the genome end — the genome is linear, so reads
near the end are shorter, with length in [1, read_length].

A copy of ``genome_assembly_tpu.simulate.reads.generate_error_free_reads``:
under the same seeded ``random.Random`` it gives bit-identical reads. The
device sampler (``sample_reads_device``, ROADMAP A10) is not ported yet.
"""

from __future__ import annotations

import random as _random


def generate_error_free_reads(genome: str, read_length: int, num_reads: int,
                              rng: _random.Random | None = None) -> list[str]:
    """Host sampler; same draw sequence as the reference when `rng` is seeded
    the same way (reference uses the global `random` module)."""
    r = rng if rng is not None else _random
    g = len(genome)
    reads = []
    for _ in range(num_reads):
        start = r.randint(0, g - 1)
        reads.append(genome[start:start + read_length])
    return reads


def calculate_coverage(genome_len: int, num_reads: int, read_length: int) -> float:
    """Expected coverage C = N*l/G (generateErrorFreeReads.py:55-56)."""
    return num_reads * read_length / genome_len
