"""Host helpers of the Smith-Waterman metrics pass.

Only ``replay_ops_host`` is ported in this slice: the C++ batch aligner
(native/graphcore.cpp) emits the op streams it replays. The device row scan
with traceback (``local_align_batch_ops``, ROADMAP B2) and the banded scan
(ROADMAP B3) wait for the next slice.
"""

from __future__ import annotations

import numpy as np


def replay_ops_host(ops_col: np.ndarray, best_i: int, best_j: int,
                    query: str, reference: str):
    """Rebuild the aligned strings from a traceback op stream.

    Reference aligners.py:139-161 semantics: ops are emitted backwards from
    the best cell (1 = diagonal, 2 = up, 3 = left, 0 = stop). Returns
    (aligned_ref, aligned_query, start_j).
    """
    ops = np.asarray(ops_col)
    stop = np.nonzero(ops == 0)[0]
    n = int(stop[0]) if len(stop) else len(ops)
    if n == 0:
        return "", "", int(best_j)
    c = ops[:n]
    qmove = (c == 1) | (c == 2)              # consumes a query char
    rmove = (c == 1) | (c == 3)              # consumes a reference char
    # positions consumed at each (backwards) step: exclusive prefix counts
    qpos = int(best_i) - 1 - (np.cumsum(qmove) - qmove)
    rpos = int(best_j) - 1 - (np.cumsum(rmove) - rmove)
    qb = np.frombuffer(query.encode("ascii"), np.uint8)
    rb = np.frombuffer(reference.encode("ascii"), np.uint8)
    dash = np.uint8(ord("-"))
    aq = np.where(qmove, qb[np.clip(qpos, 0, max(len(qb) - 1, 0))], dash)
    ar = np.where(rmove, rb[np.clip(rpos, 0, max(len(rb) - 1, 0))], dash)
    start_j = int(best_j) - int(rmove.sum())
    return (ar[::-1].tobytes().decode("ascii"),
            aq[::-1].tobytes().decode("ascii"), start_j)
