from .gotoh import local_align_affine
from .overlap import (
    overlap_align_full,
    overlap_scores_pairs,
    overlap_scores_pairs_plain,
    right_align,
)
from .overlap_allpairs import (
    overlap_scores_all_pairs,
    overlap_scores_block,
    overlap_scores_block_plain,
)

__all__ = [
    "local_align_affine",
    "overlap_align_full",
    "overlap_scores_all_pairs",
    "overlap_scores_block",
    "overlap_scores_block_plain",
    "overlap_scores_pairs",
    "overlap_scores_pairs_plain",
    "right_align",
]
