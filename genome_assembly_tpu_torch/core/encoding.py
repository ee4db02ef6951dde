"""int8 nucleotide encoding.

Sequences live on device as int8 tensors: A=0, C=1, G=2, T=3, PAD=4.
Ragged reads are padded to a common width with PAD; a separate lengths
vector carries the true lengths (reads truncated at the genome end are
shorter than the nominal read length — reference semantics of
``generateErrorFreeReads.py:45-48``).
"""

from __future__ import annotations

import numpy as np

PAD = np.int8(4)

_BASES = "ACGT"

# ASCII -> code lookup (256 wide); unknown chars map to PAD.
_ASCII_TO_CODE = np.full(256, PAD, dtype=np.int8)
for _i, _b in enumerate(_BASES):
    _ASCII_TO_CODE[ord(_b)] = _i
    _ASCII_TO_CODE[ord(_b.lower())] = _i

_CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()


def encode(seq: str) -> np.ndarray:
    """Encode a DNA string to an int8 code vector."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ASCII_TO_CODE[raw]


def decode(codes: np.ndarray, length: int | None = None) -> str:
    """Decode an int8 code vector back to a string (optionally truncated)."""
    codes = np.asarray(codes)
    if length is not None:
        codes = codes[:length]
    else:
        # strip trailing pads (pads are only trailing in well-formed
        # tensors; keep everything up to the last valid code)
        valid = codes != PAD
        if not valid.all():
            n = int(np.max(np.nonzero(valid)[0]) + 1) if valid.any() else 0
            codes = codes[:n]
    return _CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def encode_batch(seqs: list[str], width: int | None = None, align: str = "left"):
    """Encode a list of strings into a padded (N, width) int8 matrix + lengths.

    align='left'  pads on the right (standard layout for target reads).
    align='right' pads on the left (used for the overlap kernel's source
    reads, whose *suffix* participates in the alignment — right-aligning
    makes the diagonal geometry shift-invariant across ragged lengths).
    """
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    if width is None:
        width = int(lengths.max()) if len(seqs) else 0
    out = np.full((len(seqs), width), PAD, dtype=np.int8)
    for i, s in enumerate(seqs):
        codes = encode(s)
        if align == "left":
            out[i, : len(codes)] = codes
        elif align == "right":
            out[i, width - len(codes):] = codes
        else:
            raise ValueError(f"unknown align: {align}")
    return out, lengths


def decode_batch(mat: np.ndarray, lengths: np.ndarray) -> list[str]:
    return [decode(row, int(n)) for row, n in zip(np.asarray(mat), np.asarray(lengths))]
