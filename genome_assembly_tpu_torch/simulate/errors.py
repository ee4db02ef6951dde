"""Sequencing-error injection (substitutions only, no indels).

Semantics (reference generateErrorProneReads.py:4-45): each base mutates with
probability p (draw `u <= p`, inclusive); a mutated base is replaced by one of
its 3 alternatives chosen uniformly, in the fixed order
A->CGT, C->AGT, G->ACT, T->ACG. In int8 codes that order is
`alt = idx + (idx >= base)` for idx in {0,1,2}.

Two backends, as in the JAX package: the host path, a copy of
``genome_assembly_tpu.simulate.errors.generate_error_prone_reads`` (under the
same seeded ``np.random.RandomState`` it gives bit-identical reads), and
`inject_errors_device`, torch ops over padded read tensors drawing from an
explicit ``torch.Generator`` (its stream is torch's, not ``jax.random``'s).
"""

from __future__ import annotations

import numpy as np
import torch

_ALPHABET = {"A": "CGT", "C": "AGT", "G": "ACT", "T": "ACG"}


def _introduce_errors_host(read: str, error_prob: float, rs: np.random.RandomState) -> str:
    """Single-read substitution injection (generateErrorProneReads.py:4-28)."""
    errs = np.nonzero(rs.random_sample(len(read)) <= error_prob)[0]
    picks = rs.randint(0, 3, size=len(errs))
    out = list(read)
    for pos, idx in zip(errs, picks):
        out[pos] = _ALPHABET[out[pos]][idx]
    return "".join(out)


def generate_error_prone_reads(reads: list[str], error_prob: float,
                               rs: np.random.RandomState | None = None) -> list[str]:
    """Host error injector over a list of reads."""
    if rs is None:
        rs = np.random.RandomState()
    return [_introduce_errors_host(r, error_prob, rs) for r in reads]


def inject_errors_device(generator: torch.Generator, reads: torch.Tensor,
                         lengths: torch.Tensor,
                         error_prob: float) -> torch.Tensor:
    """Vectorized substitution injection over padded (N, l) int8 reads on
    their device, drawing the mutation mask then the alternative index from
    `generator` (on the reads' device).

    Positions past each read's length (PAD) never mutate. The
    alternative-base order matches the reference's alphabet map exactly.
    """
    dev = reads.device
    u = torch.rand(reads.shape, generator=generator, device=dev)
    mutate = u <= error_prob
    idx = torch.randint(0, 3, reads.shape, generator=generator, device=dev,
                        dtype=torch.int8)
    alt = idx + (idx >= reads).to(torch.int8)
    valid = (torch.arange(reads.shape[1], device=dev)[None, :]
             < lengths.to(torch.int64)[:, None])
    return torch.where(mutate & valid, alt, reads)
