"""Host k-mer candidate-pair generation (numpy sort-join).

A copy of the JAX package's host join (``candidate_pairs_numpy``) and dense
enumeration (``candidate_pairs_dense``): bit-identical pair order to the
reference's dict probe (``overlapGraphs.py:30-49``):

- the reference iterates source reads ua in unique order and, per ua,
  walks `prefix_index[suffix]` — a list appended in unique order, i.e.
  increasing ub. So the pair list is sorted by (ua, ub).
- here: a STABLE argsort of prefix keys keeps ub increasing within each
  equal-key group, so `order[lo[ua]:hi[ua]]` replays the reference's
  per-ua candidate order, and emitting groups in ua order replays the
  outer loop. Self-pairs (ua == ub; reference's `read_a != read_b`
  check at `overlapGraphs.py:52`) are masked out afterwards.

Reads shorter than k use the whole read as both prefix and suffix
(`overlapGraphs.py:33-47`), so keys append a TERMINATOR digit:
key = Σ_{i<m} code_i·4^i + 4^m for m = min(len, k), injective across
lengths; int64 keys hold k up to 31.

The device join (ROADMAP A7) is not ported yet: the JAX package runs it
only from 50,000 unique reads up, and this slice's main path has 9,510.
"""

from __future__ import annotations

import numpy as np

from ..core.encoding import encode_batch

MAX_HOST_K = 31    # numpy join uses int64 keys: 31-mer + terminator = 63 bits


def candidate_pairs_numpy(unique_reads: list[str], k: int):
    """Stable-argsort + searchsorted k-mer join in numpy — bit-identical
    pair order to `build.candidate_pairs`.

    Unlike the reference's dict probe (overlapGraphs.py:30-49) it is
    vectorized end to end. int64 keys hold k up to 31.
    """
    if not 0 < k <= MAX_HOST_K:
        raise ValueError(f"numpy join supports 1..{MAX_HOST_K}, got k={k}")
    u_count = len(unique_reads)
    if u_count == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    left, lens = encode_batch(unique_reads, align="left")
    codes = left.astype(np.int64)
    lens64 = lens.astype(np.int64)
    w = codes.shape[1]
    m = np.minimum(lens64, k)                          # effective k-mer len
    pos = np.arange(w, dtype=np.int64)
    pow4 = np.left_shift(np.int64(1), 2 * np.minimum(pos, MAX_HOST_K))
    pref_mask = pos[None, :] < m[:, None]
    pref = np.where(pref_mask, codes * pow4[None, :], 0).sum(axis=1)
    rel = pos[None, :] - (lens64 - m)[:, None]
    suf_mask = (rel >= 0) & (rel < m[:, None])
    sw = np.left_shift(np.int64(1), 2 * np.clip(rel, 0, MAX_HOST_K))
    suf = np.where(suf_mask, codes * sw, 0).sum(axis=1)
    term = np.left_shift(np.int64(1), 2 * m)           # 4^m terminator
    pref += term
    suf += term

    order = np.argsort(pref, kind="stable")
    skeys = pref[order]
    lo = np.searchsorted(skeys, suf, side="left")
    cnt = np.searchsorted(skeys, suf, side="right") - lo
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if total >= 2**31:
        raise ValueError("candidate count exceeds int32 indexing")
    cum = np.zeros(u_count + 1, dtype=np.int64)
    np.cumsum(cnt, out=cum[1:])
    ua = np.repeat(np.arange(u_count, dtype=np.int64), cnt)
    within = np.arange(total, dtype=np.int64) - cum[ua]
    ub = order[lo[ua] + within]
    keep = ua != ub  # reference skips identical reads (overlapGraphs.py:52)
    return ua[keep].astype(np.int32), ub[keep].astype(np.int32)


def candidate_pairs_dense(u_count: int):
    """k=0: all ordered pairs of distinct unique reads, row-major
    (`overlapGraphs.py:49`), as vectorized index arrays."""
    ia, ib = np.meshgrid(np.arange(u_count, dtype=np.int32),
                         np.arange(u_count, dtype=np.int32), indexing="ij")
    keep = ia != ib
    return ia[keep], ib[keep]
