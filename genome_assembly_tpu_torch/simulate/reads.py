"""Synthetic read sampling.

Semantics (reference generateErrorFreeReads.py:22-52): each read starts at a
uniform position in [0, G-1] (inclusive), spans `read_length` bases, and is
*truncated* (not wrapped) at the genome end — the genome is linear, so reads
near the end are shorter, with length in [1, read_length].

Two backends, as in the JAX package:
- `generate_error_free_reads` — host path, a copy of the JAX package's:
  under the same seeded ``random.Random`` it gives bit-identical reads;
- `sample_reads_device` — torch ops on the genome tensor's device, drawing
  from an explicit ``torch.Generator``, returning padded int8 reads and
  lengths. Its stream is torch's, so it matches the JAX package's
  ``jax.random`` sampler in its contract, not read for read.
"""

from __future__ import annotations

import random as _random

import torch

from ..core.dispatch import resolve_device
from ..core.encoding import PAD


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


def sample_reads_device(generator: torch.Generator,
                        genome_codes: torch.Tensor, read_length: int,
                        num_reads: int):
    """Vectorized device sampler.

    Args:
        generator: torch.Generator on the genome's device; the starts are
            its first draw.
        genome_codes: (G,) int8 genome.
        read_length: nominal read length l.
        num_reads: N.

    Returns:
        reads: (N, l) int8, PAD beyond each read's true length.
        lengths: (N,) int32 true lengths (= min(l, G - start)).
    """
    dev = genome_codes.device
    g = genome_codes.shape[0]
    starts = torch.randint(0, g, (num_reads,), generator=generator,
                           device=dev)
    return reads_at_starts(genome_codes, starts, read_length)


def reads_at_starts(genome_codes: torch.Tensor, starts: torch.Tensor,
                    read_length: int):
    """The reads of `sample_reads_device` for given starts: (N, l) int8
    windows of the genome from each start, PAD past each true length
    min(l, G - start), and the (N,) int32 lengths."""
    dev = genome_codes.device
    g = genome_codes.shape[0]
    lengths = torch.clamp(g - starts, max=read_length)
    # genome padded by l PADs so every window is in bounds
    padded = torch.cat([genome_codes.to(torch.int8),
                        torch.full((read_length,), int(PAD),
                                   dtype=torch.int8, device=dev)])
    pos = torch.arange(read_length, device=dev)[None, :]
    reads = padded[starts[:, None] + pos]
    reads = torch.where(pos < lengths[:, None], reads,
                        torch.full((), int(PAD), dtype=torch.int8,
                                   device=dev))
    return reads, lengths.to(torch.int32)


def reads_to_device(reads: list[str], read_length: int | None = None,
                    device="cuda"):
    """Encode host reads into padded (N, l) int8 codes + (N,) int32 lengths
    on `device` ("cuda" by default; raises without a card)."""
    from ..core.encoding import encode_batch

    dev = resolve_device(device)
    codes, lengths = encode_batch(reads, width=read_length, align="left")
    return (torch.from_numpy(codes).to(dev),
            torch.from_numpy(lengths).to(dev))
