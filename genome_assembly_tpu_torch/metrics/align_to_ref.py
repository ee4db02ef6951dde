"""Contig -> reference-genome alignment for the metrics pass.

Reference semantics (aligners.py:170-202): a contig is locally aligned to the
genome; a contig *shorter than the read length* is aligned only against the
LAST len(contig) characters of the genome (short reads only arise from
truncation at the genome's end), with start/end offset back by
genome_len - len(contig). This tail-window quirk materially skews the metrics
for short contigs and is replicated exactly.

Contigs are deduplicated (first-occurrence order — the reference keys its
details dict by contig string, performanceMeasures.py:223). Every window is
a suffix of the genome, so one genome serves every item.

Executors (``core/dispatch.py::use_host_metrics``), bit-identical to each
other and to the JAX package's:
- the torch route: on a card the Smith-Waterman kernels
  (``ops/smith_waterman.py``: ``sw_full_width``, ``sw_banded``), in calls
  whose op streams fit ``CARD_OPS_BUDGET_BYTES``; on the host their plain
  versions, in the JAX package's shape classes of at most ``max_batch``
  items;
- the C++ engine (``native/graphcore.cpp``), the default on a CPU device.

Banded option (banded=True, or banded="auto" on genomes of
``banded_auto_min()`` bp or more: GA_TPU_BANDED_AUTO_MIN, default 16,384):
seeded full-genome contigs go through the diagonal-banded alignment with
a per-contig band sized from the batched k-mer seed: the
band covers [d_lo, d_hi], the diagonal range of the contig's exact k-mer
hits, plus a slack of `band`. Every banded result is then band-stability
verified: the alignment is recomputed at twice the band and accepted only
when score, endpoints and the full traceback agree between the two widths
(and the wider path keeps clear of its band edges); disagreeing contigs
escalate geometrically until stable, band-capped, or handed to the
full-width pass. banded=False forces full width everywhere.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.dispatch import resolve_device, use_host_metrics
from ..core.encoding import encode, encode_batch
from ..ops.smith_waterman import replay_ops_host

# genome length from which banded="auto" bands the alignment (the JAX
# package's GA_TPU_BANDED_AUTO_MIN default; every reference experiment runs
# on the 5386 bp PhiX and stays below it, i.e. exact full width)
BANDED_AUTO_MIN = 16384


def banded_auto_min() -> int:
    """GA_TPU_BANDED_AUTO_MIN, or BANDED_AUTO_MIN when it is unset or not
    an integer (the JAX package's rule)."""
    try:
        return int(os.environ.get("GA_TPU_BANDED_AUTO_MIN", BANDED_AUTO_MIN))
    except ValueError:
        return BANDED_AUTO_MIN


# On a card, one call's op streams (B x stride uint8) are cut at this many
# bytes, so that peak device memory and the copy to the host stay bounded
# however many contigs and however long the genome.
CARD_OPS_BUDGET_BYTES = 256 << 20

_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


def _batches(keys: list, dev: torch.device, max_batch: int,
             lengths=None, stride=None):
    """Index lists of the calls of the torch route.

    On a card: items longest first, cut where a call's op streams (B rows
    of `stride(longest length)` bytes, zero-filled on the card and copied
    whole to the host) would pass CARD_OPS_BUDGET_BYTES; the kernels bound
    their own scratch. On the host: groups of equal key (the JAX package's
    shape classes) of at most `max_batch`."""
    if dev.type == "cuda":
        lengths = np.asarray(lengths, np.int64)
        order = np.argsort(-lengths, kind="stable")
        calls, lo = [], 0
        while lo < len(order):
            row_bytes = max(1, stride(int(lengths[order[lo]])))
            rows = max(1, CARD_OPS_BUDGET_BYTES // row_bytes)
            calls.append(order[lo:lo + rows].tolist())
            lo += rows
        return calls
    groups: dict = {}
    for idx, key in enumerate(keys):
        groups.setdefault(key, []).append(idx)
    return [g[lo:lo + max_batch] for g in groups.values()
            for lo in range(0, len(g), max_batch)]


def align_read_or_contig_to_reference(read_or_contig: str, reference_genome: str,
                                      read_length: int, match_score: int = 10,
                                      mismatch: int = -1, indel: int = -1,
                                      device="cuda"):
    """Single-contig API (reference aligners.py:170-202 signature parity).

    Returns (to_print, aligned_ref, aligned_query, score, start, end).
    """
    details = align_contigs_to_reference([read_or_contig], reference_genome,
                                         read_length, match_score=match_score,
                                         mismatch=mismatch, indel=indel,
                                         device=device)
    d = details[read_or_contig]
    return (d["Print"], d["Alignment_reference"], d["Alignment_query"],
            d["Alignment Score"], d["Start Position"], d["End Position"])


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


def _fill_details(details: dict, items: list[tuple[str, str, int]], score,
                  bi, bj, op_rows) -> None:
    """Replay each (contig, window, offset) item's op stream against its
    window and enter its details (coordinates offset back to the genome)."""
    for idx, (c, w, offset) in enumerate(items):
        ar, aq, start = replay_ops_host(op_rows[idx], bi[idx], bj[idx], c, w)
        details[c] = _details_entry(ar, aq, int(score[idx]), start + offset,
                                    int(bj[idx]) + offset)


def _align_full_width_native(items: list[tuple[str, str, int]],
                             details: dict, reference_genome: str,
                             match_score: int, mismatch: int,
                             indel: int) -> None:
    """One batched C++ call over (contig, window, offset) items; fills
    `details` in place."""
    from ..native import graphcore

    w_len = np.array([len(w) for _, w, _ in items], np.int32)
    score, bi, bj, steps, ops = graphcore.local_align_batch_suffix_windows(
        [c for c, _, _ in items], encode(reference_genome), w_len,
        match_score=match_score, mismatch=mismatch, indel=indel)
    _fill_details(details, items, score, bi, bj,
                  [ops[i, :steps[i]] for i in range(len(items))])


def _align_full_width(items: list[tuple[str, str, int]], details: dict,
                      reference_genome: str, match_score: int, mismatch: int,
                      indel: int, max_batch: int, dev: torch.device) -> None:
    """The torch route of the full-width pass over (contig, window, offset)
    items (`sw_full_width`: the kernel on a card, its plain version on the
    host); fills `details` in place. Only the op streams and four ints per
    item come back to the host."""
    from ..ops.smith_waterman import sw_full_width

    genome = torch.from_numpy(encode(reference_genome).copy()).to(dev)
    m = genome.shape[0]
    keys = [(_bucket(len(c)), offset == 0) for c, _, offset in items]
    for sel in _batches(keys, dev, max_batch, [len(c) for c, _, _ in items],
                        lambda n: n + m):
        batch = [items[i] for i in sel]
        q_mat, q_len = encode_batch([c for c, _, _ in batch])
        w_len = np.array([len(w) for _, w, _ in batch], np.int32)
        best, bi, bj, ops, _ = sw_full_width(
            torch.from_numpy(q_mat).to(dev), torch.from_numpy(q_len).to(dev),
            genome, torch.from_numpy(w_len).to(dev),
            match_score=match_score, mismatch=mismatch, indel=indel)
        _fill_details(details, batch,
                      *(t.cpu().numpy() for t in (best, bi, bj, ops)))


def _trim_ops(ops_1d: np.ndarray) -> np.ndarray:
    """Cut a traceback op stream at its terminator (eases comparison)."""
    stop = np.nonzero(ops_1d == 0)[0]
    return ops_1d[:int(stop[0])] if len(stop) else ops_1d


def _banded_exec_native(items, reference_genome, match_score, mismatch,
                        indel):
    """Run the C++ banded executor over (contig, d0, band) items; returns
    a per-item list of (best, bi, bj, ops) with ops trimmed."""
    from ..native import graphcore

    genome_codes = encode(reference_genome)
    out = [None] * len(items)
    groups: dict[int, list[int]] = {}
    for i, (_, _, bb) in enumerate(items):
        groups.setdefault(bb, []).append(i)
    for bb, idxs in groups.items():
        qs = [items[i][0] for i in idxs]
        d0_arr = np.array([items[i][1] for i in idxs], np.int32)
        best, bi, bj, steps, ops = graphcore.local_align_banded_batch(
            qs, genome_codes, d0_arr, bb, match_score=match_score,
            mismatch=mismatch, indel=indel)
        for row, i in enumerate(idxs):
            out[i] = (int(best[row]), int(bi[row]), int(bj[row]),
                      ops[row, :int(steps[row])].copy())
    return out


def _banded_exec_device(items, reference_genome, match_score, mismatch,
                        indel, max_batch, dev):
    """The torch route of `_banded_exec_native` (`sw_banded`: the kernel on
    a card, in calls of one band; its plain version on the host, in groups
    of (band, length bucket) of at most `max_batch`)."""
    from ..ops.smith_waterman import sw_banded

    genome = torch.from_numpy(encode(reference_genome).copy()).to(dev)
    out = [None] * len(items)
    by_band: dict[int, list[int]] = {}
    for i, (_, _, bb) in enumerate(items):
        by_band.setdefault(bb, []).append(i)
    for bb, idxs in by_band.items():
        lengths = [len(items[i][0]) for i in idxs]
        for sel in _batches([(bb, _bucket(n)) for n in lengths], dev,
                            max_batch, lengths,
                            lambda n, bb=bb: 2 * n + 2 * bb + 1):
            rows = [idxs[s] for s in sel]
            q_mat, q_len = encode_batch([items[i][0] for i in rows])
            d0_arr = np.array([items[i][1] for i in rows], np.int32)
            best, bi, bj, ops, _ = sw_banded(
                torch.from_numpy(q_mat).to(dev),
                torch.from_numpy(q_len).to(dev), genome,
                torch.from_numpy(d0_arr).to(dev), bb,
                match_score=match_score, mismatch=mismatch, indel=indel)
            best, bi, bj, ops = (t.cpu().numpy() for t in (best, bi, bj, ops))
            for row, i in enumerate(rows):
                out[i] = (int(best[row]), int(bi[row]), int(bj[row]),
                          _trim_ops(ops[row]).copy())
    return out


def _band_edge_contact(ops_col: np.ndarray, best_i: int, best_j: int,
                       d0: int, band: int, margin: int = 2) -> bool:
    """True when the replayed path ever comes within `margin` cells of a
    band edge — the signal that the unrestricted optimum may leave the
    band."""
    stop = np.nonzero(ops_col == 0)[0]
    n = int(stop[0]) if len(stop) else len(ops_col)
    c = ops_col[:n]
    di = np.cumsum((c == 1) | (c == 2)).astype(np.int64)
    dj = np.cumsum((c == 1) | (c == 3)).astype(np.int64)
    # diagonal drift along the path, including the start cell (bi, bj)
    drift = np.r_[np.int64(best_j - best_i),
                  (best_j - dj) - (best_i - di)] - d0
    return bool((np.abs(drift) >= band - margin).any())


def split_contigs(contigs: list[str], reference_genome: str,
                  read_length: int):
    """Deduplicate the contigs and split the non-empty ones by window.

    Returns (seen, full_window, tail_items): every contig once in
    first-occurrence order (a dict), the contigs aligned against the whole
    genome, and (contig, window, offset) items of the contigs shorter than
    `read_length`, aligned against the genome's last len(contig) bases."""
    genome_len = len(reference_genome)
    seen: dict[str, None] = dict.fromkeys(contigs)
    full_window: list[str] = []
    tail_items: list[tuple[str, str, int]] = []
    for c in seen:
        n = len(c)
        if 0 < n < read_length:
            tail_items.append((c, reference_genome[-n:], genome_len - n))
        elif n:
            full_window.append(c)
    return seen, full_window, tail_items


def _banded_plan(full_window, reference_genome, band, seed_k, full_items):
    """Seed the full-genome contigs and size each one's band; returns the
    (contig, center diagonal, band, band cap) items, appending the contigs
    that cannot be banded to `full_items`."""
    from ..ops.smith_waterman import seed_diagonals_batch

    genome_len = len(reference_genome)
    d0s, d_lo, d_hi, has = seed_diagonals_batch(
        full_window, reference_genome, k=seed_k)
    banded_items: list[tuple[str, int, int, int]] = []
    for i, c in enumerate(full_window):
        if not has[i]:
            full_items.append((c, reference_genome, 0))
            continue
        spread_half = (int(d_hi[i]) - int(d_lo[i]) + 1) // 2
        # geometric band ladder: grow the band until it covers the seed's
        # diagonal spread, capped at a small multiple of the contig length
        # (drift beyond O(n) costs more gap steps than the contig can
        # repay). A contig whose hit clusters span more than the cap gets
        # the capped band centred on its vote-max diagonal; stability
        # verification escalates it to full width if that is not stable.
        bb = band
        cap = max(8 * band, 8 * len(c))
        while (bb < spread_half + band // 2
               and genome_len >= 2 * (4 * bb + 1) and bb < cap):
            bb *= 2
        if genome_len < 2 * (4 * bb + 1):
            # the 2x verification band would cover most of the genome
            full_items.append((c, reference_genome, 0))
            continue
        if spread_half + band // 2 <= bb:
            center = (int(d_lo[i]) + int(d_hi[i])) // 2
        else:
            center = int(d0s[i])
        banded_items.append((c, center, bb, cap))
    return banded_items


def align_contigs_to_reference(contigs: list[str], reference_genome: str,
                               read_length: int, match_score: int = 10,
                               mismatch: int = -1, indel: int = -1,
                               max_batch: int = 128,
                               banded: bool | str = "auto",
                               band: int = 64, seed_k: int = 15,
                               executor: str = "auto",
                               device="cuda") -> dict:
    """Align contigs to the genome; returns {contig: details} in
    first-occurrence order (duplicates collapse, dict-key semantics of
    performanceMeasures.py:219-230).

    banded:
      "auto" (default) — full width below banded_auto_min() bp, verified
        banding from it on (the long-genome regime);
      False — full width for everything (exact);
      True — banded alignment for seeded full-genome contigs, every result
        verified at twice its band (module docstring); unseeded contigs,
        zero scores, capped escalation and near-genome-width bands take
        the full-width pass.
    executor: "auto" (the C++ engine on a CPU device, the kernels on a
      card), "native" (the C++ engine) or "xla" (the torch route: the
      kernels on a card, their plain versions on the host). Bit-identical
      either way.
    max_batch: items per call of the plain versions; a card's calls are cut
      by the bytes of their op streams (CARD_OPS_BUDGET_BYTES) instead, and
      the kernels bound their scratch themselves.
    device: the torch device of the torch route ("cuda" by default; raises
      without a card).
    """
    dev = resolve_device(device)
    use_native = use_host_metrics(dev, executor)
    genome_len = len(reference_genome)
    seen, full_window, full_items = split_contigs(contigs, reference_genome,
                                                  read_length)

    use_banded = banded is True or (banded == "auto"
                                    and genome_len >= banded_auto_min())
    banded_items: list[tuple[str, int, int, int]] = []
    if use_banded and full_window:
        banded_items = _banded_plan(full_window, reference_genome, band,
                                    seed_k, full_items)
    else:
        full_items.extend((c, reference_genome, 0) for c in full_window)

    details: dict[str, dict] = {}
    suspects: list[tuple[str, str, int]] = []

    def run(batch):
        if use_native:
            return _banded_exec_native(batch, reference_genome, match_score,
                                       mismatch, indel)
        return _banded_exec_device(batch, reference_genome, match_score,
                                   mismatch, indel, max_batch, dev)

    # band-stability escalation: every banded alignment is recomputed at 2x
    # the band and accepted only when score, endpoints and the full
    # traceback agree AND the wider path stays clear of its band edges;
    # otherwise the band doubles until stable, the cap is exceeded, or the
    # band stops fitting the genome (both -> full width)
    pending = banded_items
    results = run([(c, d0, bb) for c, d0, bb, _ in pending]) if pending \
        else []
    while pending:
        grown: list[tuple[str, int, int, int]] = []
        grown_prev: list[tuple] = []
        verify: list[tuple[str, int, int, int]] = []
        verify_prev: list[tuple] = []
        for (c, d0, bb, cap), res in zip(pending, results):
            nb = 2 * bb
            if res[0] == 0 or nb > cap or genome_len < 2 * (2 * nb + 1):
                suspects.append((c, reference_genome, 0))
                continue
            verify.append((c, d0, nb, cap))
            verify_prev.append(res)
        if not verify:
            break
        wide = run([(c, d0, nb) for c, d0, nb, _ in verify])
        for (c, d0, nb, cap), prev, res in zip(verify, verify_prev, wide):
            stable = (res[0] == prev[0] and res[1] == prev[1]
                      and res[2] == prev[2]
                      and np.array_equal(res[3], prev[3]))
            if stable and not _band_edge_contact(res[3], res[1], res[2], d0,
                                                 nb):
                ar, aq, start = replay_ops_host(res[3], res[1], res[2], c,
                                                reference_genome)
                details[c] = _details_entry(ar, aq, res[0], start, res[2])
            else:
                grown.append((c, d0, nb, cap))
                grown_prev.append(res)
        pending = grown
        results = grown_prev

    fw_items = full_items + suspects
    if fw_items and use_native:
        _align_full_width_native(fw_items, details, reference_genome,
                                 match_score, mismatch, indel)
    elif fw_items:
        _align_full_width(fw_items, details, reference_genome, match_score,
                          mismatch, indel, max_batch, dev)

    for c in seen:
        if len(c) == 0:
            details[c] = _details_entry("", "", 0, genome_len, genome_len)
    # restore first-occurrence order
    return {c: details[c] for c in seen}
