"""Read-layout ops shared by the overlap scorers.

Only ``right_align`` is ported in this slice; the sparse pair scorer
``overlap_scores`` (ROADMAP A5) and the gapped ``overlap_align_full``
(ROADMAP A9) wait for theirs.
"""

from __future__ import annotations

import torch

from ..core.encoding import PAD


def right_align(reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Shift each left-aligned padded read to the right edge of its slot.

    (N, L) int8 + (N,) lengths -> (N, L) int8 with PAD on the left:
    out[i, p] = reads[i, p - (L - len_i)] for p >= L - len_i.
    """
    n, l = reads.shape
    shift = (l - lengths.to(torch.int64))[:, None]               # (N, 1)
    src = torch.arange(l, device=reads.device)[None, :] - shift  # (N, L)
    gathered = torch.gather(reads, 1, src.clamp(0, max(l - 1, 0)))
    return torch.where(src >= 0, gathered,
                       torch.tensor(int(PAD), dtype=reads.dtype,
                                    device=reads.device))
