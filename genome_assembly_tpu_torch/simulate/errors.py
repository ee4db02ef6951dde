"""Sequencing-error injection (substitutions only, no indels), host.

Semantics (reference generateErrorProneReads.py:4-45): each base mutates with
probability p (draw `u <= p`, inclusive); a mutated base is replaced by one of
its 3 alternatives chosen uniformly, in the fixed order
A->CGT, C->AGT, G->ACT, T->ACG.

A copy of ``genome_assembly_tpu.simulate.errors.generate_error_prone_reads``:
under the same seeded ``np.random.RandomState`` it gives bit-identical reads.
The device injector (``inject_errors_device``, ROADMAP A10) is not ported yet.
"""

from __future__ import annotations

import numpy as np

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
