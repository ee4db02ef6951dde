"""The parallel layer on ``torch.distributed``: meshes of ranks, sharded
pair scoring and the pipeline step, sequence-parallel Smith-Waterman and
the two-stage build pipeline (the JAX package's ``parallel``; ``mesh.py``
states the execution model and the backend rule). ``spawn.py`` starts a
world of ranks on one machine."""

from .mesh import (
    init_distributed,
    make_mesh,
    make_mesh_2d,
    make_mesh_hosts_chips,
)
from .pipeline import (
    candidates_score_unpipelined,
    pipelined_candidates_score,
)
from .seqpar import (
    local_align_batch_seqpar,
    local_align_batch_seqpar_pipelined,
    traceback_host_seqpar,
)
from .sharded import (
    all_pairs_block_scores,
    all_pairs_block_scores_2d,
    distributed_assemble_contigs,
    distributed_build_overlap_graph,
    distributed_score_pairs,
    sharded_overlap_scores,
    sharded_overlap_scores_indexed,
    sharded_pipeline_step,
    sharded_pipeline_step_reads,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_hosts_chips",
    "candidates_score_unpipelined",
    "pipelined_candidates_score",
    "local_align_batch_seqpar",
    "local_align_batch_seqpar_pipelined",
    "traceback_host_seqpar",
    "all_pairs_block_scores",
    "all_pairs_block_scores_2d",
    "distributed_assemble_contigs",
    "distributed_build_overlap_graph",
    "distributed_score_pairs",
    "sharded_overlap_scores",
    "sharded_overlap_scores_indexed",
    "sharded_pipeline_step",
    "sharded_pipeline_step_reads",
]
