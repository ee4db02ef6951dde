"""Affine-gap local alignment (Gotoh three-state DP), host oracle.

The reference's external kernel oracle is Biopython's C PairwiseAligner
(aligners.py:205-274): local mode with a match/mismatch substitution scheme
and affine gap costs (open_gap_score / extend_gap_score). That package is
not a dependency of this project, so this module is a clean-room equivalent of the scoring
semantics the reference configures — used both as the executable stand-in
for the Biopython differential (tests/test_oracle_external.py runs the
reference's 10 case families against it, aligners.py:277-434) and as the
framework's affine-gap capability (the reference API exposes gap_open !=
gap_extend through local_alignment_biopython; our linear-gap kernels cover
only gap_open == gap_extend).

Deliberately a different recurrence family from every other aligner in the
repo (ops/smith_waterman.py row-scan cascade, ops/oracle.py reference
replica, native/graphcore.cpp C++ DP): three explicitly separate Gotoh
state matrices

    M[i][j]  — best local alignment ending in a substitution at (i, j)
    X[i][j]  — best ending in a gap in the target (consuming query chars)
    Y[i][j]  — best ending in a gap in the query (consuming target chars)

with the local-mode 0 floor applied to alignment *starts*, so agreement
with the linear-gap kernels (when open == extend) is a genuine
cross-implementation check, not shared code re-run.

A copy of the JAX package's host module (it imports nothing of JAX).
"""

from __future__ import annotations

NEG_INF = -(1 << 40)


def local_align_affine(target: str, query: str, match: int = 10,
                       mismatch: int = -1, gap_open: int = -1,
                       gap_extend: int = -1):
    """Best local alignment of target vs query with affine gaps.

    A gap of length L costs gap_open + (L - 1) * gap_extend (Biopython
    semantics: open_gap_score scores the first gap column,
    extend_gap_score each further one — both usually negative).

    Returns (score, t_start, t_end, q_start, q_end): the half-open
    aligned spans in target and query (all 0 when no positive-scoring
    alignment exists). Ties resolve to the FIRST best cell in row-major
    (i, j) order with an M > X > Y predecessor preference — a fixed,
    documented convention; callers comparing against other aligners
    should compare scores, and positions only up to co-optimality.
    """
    n, m = len(target), len(query)
    if n == 0 or m == 0:
        return 0, 0, 0, 0, 0

    M = [[0] * (m + 1) for _ in range(n + 1)]
    X = [[NEG_INF] * (m + 1) for _ in range(n + 1)]
    Y = [[NEG_INF] * (m + 1) for _ in range(n + 1)]
    for j in range(m + 1):
        M[0][j] = NEG_INF
    for i in range(n + 1):
        M[i][0] = NEG_INF
    best = 0
    best_i = best_j = 0
    for i in range(1, n + 1):
        ti = target[i - 1]
        mi, xi, yi = M[i], X[i], Y[i]
        mp, xp, yp = M[i - 1], X[i - 1], Y[i - 1]
        for j in range(1, m + 1):
            sub = match if ti == query[j - 1] else mismatch
            # a fresh local start (the 0 term) is allowed before a
            # substitution; gaps never start or end an optimal local
            # alignment but the states still track them exactly
            mi[j] = max(mp[j - 1], xp[j - 1], yp[j - 1], 0) + sub
            xi[j] = max(max(mi[j - 1], yi[j - 1]) + gap_open,
                        xi[j - 1] + gap_extend)
            yi[j] = max(max(mp[j], xp[j]) + gap_open,
                        yp[j] + gap_extend)
            h = mi[j]          # local alignments end on substitutions
            if h > best:
                best, best_i, best_j = h, i, j

    if best <= 0:
        return 0, 0, 0, 0, 0

    # traceback from the best cell down to the 0-floor start
    i, j, state = best_i, best_j, "M"
    while True:
        if state == "M":
            prev = max(M[i - 1][j - 1], X[i - 1][j - 1], Y[i - 1][j - 1], 0)
            i -= 1
            j -= 1
            if prev == 0:
                break
            state = ("M" if M[i][j] == prev
                     else "X" if X[i][j] == prev else "Y")
        elif state == "X":
            viaopen = max(M[i][j - 1], Y[i][j - 1]) + gap_open
            if X[i][j] == X[i][j - 1] + gap_extend and X[i][j] != viaopen:
                j -= 1
            else:
                j -= 1
                state = "M" if M[i][j] >= Y[i][j] else "Y"
        else:  # "Y"
            viaopen = max(M[i - 1][j], X[i - 1][j]) + gap_open
            if Y[i][j] == Y[i - 1][j] + gap_extend and Y[i][j] != viaopen:
                i -= 1
            else:
                i -= 1
                state = "M" if M[i][j] >= X[i][j] else "X"
    return int(best), i, best_i, j, best_j


class PairwiseAlignerCompat:
    """Minimal Bio.Align.PairwiseAligner-shaped facade over
    `local_align_affine` — only the surface the reference's oracle wrapper
    configures (aligners.py:225-231): mode, match_score, mismatch_score,
    open_gap_score, extend_gap_score, and .score()."""

    def __init__(self):
        self.mode = "local"
        self.match_score = 1
        self.mismatch_score = 0
        self.open_gap_score = 0
        self.extend_gap_score = 0

    def score(self, target: str, query: str) -> int:
        assert self.mode == "local", "only local mode is vendored"
        s, *_ = local_align_affine(
            target, query, match=self.match_score,
            mismatch=self.mismatch_score, gap_open=self.open_gap_score,
            gap_extend=self.extend_gap_score)
        return s
