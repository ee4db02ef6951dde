"""Exact-semantics host oracles for the alignment kernels.

These are deliberately slow, loop-level reimplementations of the reference's
Numba kernels with *bit-identical* numeric behavior, used only in tests to
validate the device kernels. Key semantics they pin down:

- `overlap_align` (reference aligners.py:6-82): NW variant, dp int32
  zero-initialized (free overhanging ends), tie-break cascade diag>=up>=left,
  best = first-max over the LAST ROW ONLY (strict >, scanning j=0..m).
  Under Numba, `int32 dp + int64 indel` promotes to int64, so with the default
  indel=-2**31 gap moves are never selected (verified in SURVEY.md §2.2-C1);
  we reproduce the promotion by computing candidate scores in Python ints and
  storing with int32 wraparound.

- `local_align` (reference aligners.py:85-167): Smith-Waterman clamped at 0,
  cascade diag>=up>=left each additionally >=0, global best tracked with
  strict > in row-major order, traceback until score 0 / edge / code 0.

A copy of the JAX package's host module (it imports nothing of JAX).
"""

from __future__ import annotations

INT32_MIN = -(2**31)


def _wrap_i32(v: int) -> int:
    """C-style int32 wraparound (what a Numba int32 array store does)."""
    return ((v + 2**31) % 2**32) - 2**31


def overlap_align_oracle(s: str, t: str, match_score: int = 10, mismatch: int = -1,
                         indel: int = INT32_MIN):
    """Returns (align_s, align_t, score, end_position) — reference aligners.py:6-82."""
    n, m = len(s), len(t)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    tb = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            diag = dp[i - 1][j - 1] + (match_score if s[i - 1] == t[j - 1] else mismatch)
            up = dp[i - 1][j] + indel
            left = dp[i][j - 1] + indel
            if diag >= up and diag >= left:
                dp[i][j], tb[i][j] = _wrap_i32(diag), 0
            elif up >= left:
                dp[i][j], tb[i][j] = _wrap_i32(up), 1
            else:
                dp[i][j], tb[i][j] = _wrap_i32(left), 2

    best = float("-inf")
    overlap_len = 0
    for j in range(m + 1):
        if dp[n][j] > best:
            best = dp[n][j]
            overlap_len = j

    align_s, align_t = "", ""
    i, j = n, overlap_len
    while i > 0 and j > 0:
        code = tb[i][j]
        if code == 0:
            align_s = s[i - 1] + align_s
            align_t = t[j - 1] + align_t
            i -= 1
            j -= 1
        elif code == 1:
            align_s = s[i - 1] + align_s
            align_t = "-" + align_t
            i -= 1
        else:
            align_s = "-" + align_s
            align_t = t[j - 1] + align_t
            j -= 1

    return align_s, align_t, int(best), overlap_len


def global_align_oracle(s: str, t: str, match_score: int = 0,
                        mismatch: int = -1, indel: int = -1) -> int:
    """Global Needleman-Wunsch score with the same recurrence + tie-break
    cascade as `overlap_align_oracle`, but penalized ends (dp[0][j] = j*indel,
    dp[i][0] = i*indel) and the score taken at dp[n][m].

    Exists for the third-party differential (VERDICT round 2, next-step #6):
    with match=0, mismatch=-1, indel=-1 this equals minus the Levenshtein
    edit distance, so the C `Levenshtein` library provides an external,
    independently-authored oracle for the recurrence family all our DP
    implementations (Python oracles, C++ graphcore, device kernels) share.
    Reference recurrence: aligners.py:33-48."""
    n, m = len(s), len(t)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for j in range(1, m + 1):
        dp[0][j] = j * indel
    for i in range(1, n + 1):
        dp[i][0] = i * indel
        for j in range(1, m + 1):
            diag = dp[i - 1][j - 1] + (
                match_score if s[i - 1] == t[j - 1] else mismatch)
            up = dp[i - 1][j] + indel
            left = dp[i][j - 1] + indel
            if diag >= up and diag >= left:
                dp[i][j] = diag
            elif up >= left:
                dp[i][j] = up
            else:
                dp[i][j] = left
    return dp[n][m]


def local_align_oracle(query: str, reference: str, match_score: int = 10,
                       mismatch: int = -1, indel: int = -1):
    """Returns (aligned_ref, aligned_query, score, start, end) — reference
    aligners.py:85-167. `start`/`end` are reference coordinates."""
    n, m = len(query), len(reference)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    tb = [[0] * (m + 1) for _ in range(n + 1)]
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            diag = dp[i - 1][j - 1] + (match_score if query[i - 1] == reference[j - 1] else mismatch)
            up = dp[i - 1][j] + indel
            left = dp[i][j - 1] + indel
            if diag >= up and diag >= left and diag >= 0:
                dp[i][j], tb[i][j] = diag, 1
            elif up >= left and up >= 0:
                dp[i][j], tb[i][j] = up, 2
            elif left >= 0:
                dp[i][j], tb[i][j] = left, 3
            # else stays 0/0
            if dp[i][j] > best:
                best, bi, bj = dp[i][j], i, j

    aligned_q, aligned_r = "", ""
    i, j = bi, bj
    while i > 0 and j > 0 and dp[i][j] > 0:
        code = tb[i][j]
        if code == 1:
            aligned_q = query[i - 1] + aligned_q
            aligned_r = reference[j - 1] + aligned_r
            i -= 1
            j -= 1
        elif code == 2:
            aligned_q = query[i - 1] + aligned_q
            aligned_r = "-" + aligned_r
            i -= 1
        elif code == 3:
            aligned_q = "-" + aligned_q
            aligned_r = reference[j - 1] + aligned_r
            j -= 1
        else:
            break

    return aligned_r, aligned_q, int(best), j, bj
