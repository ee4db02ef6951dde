"""k-mer candidate-pair generation: one sort-join as torch ops on the
caller's device, and the dense enumeration for k = 0.

The JAX package has two joins, an XLA program for k <= 15
(``candidate_pairs_device``) and a numpy copy for k <= 31
(``candidate_pairs_numpy``); both compute the same pairs. Here one join,
``candidate_pairs_device``, runs as torch ops on a card or on the host;
``candidate_pairs_numpy`` is that join on the host under the JAX name,
and ``candidate_pairs_dense`` is a copy. Both give the reference dict
probe's pair order bit for bit (``overlapGraphs.py:30-49``):

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
lengths; int64 keys hold k up to 31 (the JAX package's int32 lanes cap
its device join at 15).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encoding import encode_batch

MAX_JOIN_K = 31  # int64 keys: 31-mer + terminator = 63 bits
# The JAX package's caps on its two joins. Its device join packs keys into
# int32 lanes (JAX runs without x64), hence its MAX_DEVICE_K of 15; the
# torch join keeps int64 keys on every device, so both caps are MAX_JOIN_K.
MAX_DEVICE_K = MAX_JOIN_K
MAX_HOST_K = MAX_JOIN_K


def kmer_join_keys(left: torch.Tensor, lens: torch.Tensor, k: int):
    """(prefix_key, suffix_key) int64 per read; equal keys <=> equal
    strings.

    left: (U, W) int8 LEFT-aligned codes; lens: (U,) true lengths.
    key = sum_{i<m} code_i * 4^i + 4^m (terminator digit), m = min(len, k).
    """
    w = left.shape[1]
    dev = left.device
    lens64 = lens.to(torch.int64)
    m = torch.clamp(lens64, max=k)                     # effective k-mer len
    pos = torch.arange(w, dtype=torch.int64, device=dev)
    codes = left.to(torch.int64)
    # weights 4^i for i < m; the shift is capped so masked-out lanes of
    # long reads stay in range
    pow4 = torch.ones((), dtype=torch.int64, device=dev) << (
        2 * torch.clamp(pos, max=MAX_JOIN_K))
    pref_mask = pos[None, :] < m[:, None]
    pref = torch.where(pref_mask, codes * pow4[None, :], 0).sum(dim=1)
    rel = pos[None, :] - (lens64 - m)[:, None]
    suf_mask = (rel >= 0) & (rel < m[:, None])
    sw = torch.ones((), dtype=torch.int64, device=dev) << (
        2 * torch.clamp(rel, 0, MAX_JOIN_K))
    suf = torch.where(suf_mask, codes * sw, 0).sum(dim=1)
    term = torch.ones((), dtype=torch.int64, device=dev) << (2 * m)
    return pref + term, suf + term


def _join_index(pref: torch.Tensor, suf: torch.Tensor):
    """Sorted-join bookkeeping: (order, lo, hi) with order a stable argsort
    of prefix keys and [lo[u], hi[u]) the match range for read u's suffix."""
    order = torch.argsort(pref, stable=True)
    skeys = pref[order]
    lo = torch.searchsorted(skeys, suf, side="left")
    hi = torch.searchsorted(skeys, suf, side="right")
    return order, lo, hi


def _emit_pairs(cum: torch.Tensor, lo: torch.Tensor, order: torch.Tensor,
                p: torch.Tensor):
    """Flatten the ragged per-ua match groups into (ua, ub).

    Pair p lives in group ua = searchsorted(cum, p, 'right') - 1 at
    within-group offset p - cum[ua]; its target is order[lo[ua] + r].
    """
    ua = torch.searchsorted(cum, p, side="right") - 1
    ub = order[lo[ua] + (p - cum[ua])]
    return ua, ub


def candidate_pairs_device(unique_reads: list[str], k: int, device="cuda"):
    """The sort-join as torch ops on ``device`` (a card or the host);
    reference enumeration order.

    Returns (ia, ib) int32 numpy arrays, equal element for element to the
    JAX package's joins: a stable argsort keeps ub ascending within each
    key. Requires 0 < k <= MAX_JOIN_K. The codes go to the device once; the
    pair count (one sync) and the pairs come back.
    """
    if not 0 < k <= MAX_JOIN_K:
        raise ValueError(f"k-mer join supports 1..{MAX_JOIN_K}, got k={k}")
    u_count = len(unique_reads)
    if u_count == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    dev = torch.device(device)
    left, lens = encode_batch(unique_reads, align="left")
    pref, suf = kmer_join_keys(torch.from_numpy(left).to(dev),
                               torch.from_numpy(lens).to(dev), k)
    order, lo, hi = _join_index(pref, suf)
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(hi - lo, dim=0)])
    total = int(cum[-1])
    if total == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if total >= 2**31:
        raise ValueError("candidate count exceeds int32 indexing")
    ua, ub = _emit_pairs(cum, lo, order,
                         torch.arange(total, dtype=torch.int64, device=dev))
    keep = ua != ub  # reference skips identical reads (overlapGraphs.py:52)
    pairs = torch.stack([ua[keep], ub[keep]]).to(torch.int32).cpu().numpy()
    return pairs[0], pairs[1]


def candidate_pairs_numpy(unique_reads: list[str], k: int):
    """The join on the host: `candidate_pairs_device` on the CPU, the
    JAX package's ``candidate_pairs_numpy`` (int32 numpy (ia, ib) in the
    reference's pair order). Requires 0 < k <= MAX_HOST_K."""
    return candidate_pairs_device(unique_reads, k, device="cpu")


def candidate_pairs_dense(u_count: int):
    """k=0: all ordered pairs of distinct unique reads, row-major
    (`overlapGraphs.py:49`), as vectorized index arrays."""
    ia, ib = np.meshgrid(np.arange(u_count, dtype=np.int32),
                         np.arange(u_count, dtype=np.int32), indexing="ij")
    keep = ia != ib
    return ia[keep], ib[keep]
