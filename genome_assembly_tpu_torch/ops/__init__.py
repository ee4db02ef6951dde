from .gotoh import local_align_affine
from .overlap import (
    overlap_align_full,
    overlap_scores,
    overlap_scores_pairs,
    overlap_scores_pairs_plain,
    right_align,
)
from .overlap_allpairs import (
    overlap_scores_all_pairs,
    overlap_scores_block,
    overlap_scores_block_plain,
    overlap_scores_block_xla,
)
from .smith_waterman import (
    local_align_batch,
    local_align_batch_banded,
    local_align_batch_ops,
    local_align_one,
    seed_diagonals_batch,
)

__all__ = [
    "local_align_affine",
    "local_align_batch",
    "local_align_batch_banded",
    "local_align_batch_ops",
    "local_align_one",
    "overlap_align_full",
    "overlap_scores",
    "overlap_scores_all_pairs",
    "overlap_scores_block",
    "overlap_scores_block_plain",
    "overlap_scores_block_xla",
    "overlap_scores_pairs",
    "overlap_scores_pairs_plain",
    "right_align",
    "seed_diagonals_batch",
]
