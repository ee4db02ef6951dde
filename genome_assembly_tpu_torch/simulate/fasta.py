"""FASTA input (reference: generateErrorFreeReads.py:4-19)."""

from __future__ import annotations


def read_genome_from_fasta(file_path: str) -> str:
    """Concatenate all non-header lines of a FASTA file into one string."""
    parts: list[str] = []
    with open(file_path, "r") as fh:
        for line in fh:
            if line.startswith(">"):
                continue
            parts.append(line.strip())
    return "".join(parts)
