"""Sharded pair scoring and the distributed pipeline step.

The JAX package's ``parallel/sharded.py`` on ``torch.distributed`` (see
``mesh.py`` for the execution model). Every member rank of the mesh calls
a function with the same global inputs, scores its shard on its own device
and returns the global result; a rank outside the mesh returns None.

- Pair batches (`sharded_overlap_scores`, `..._indexed`,
  `distributed_score_pairs` and what is built on it) are cut into equal
  blocks along the mesh axis; each rank scores its block with the
  pair-list scorer (``ops/overlap.py::overlap_scores_pairs``: the kernel on
  a card, its plain version on the CPU) and the blocks are all-gathered in
  axis order, so the output order, the edge list and the contigs do not
  depend on the mesh size.
- Dense all-pairs scoring (`all_pairs_block_scores`, the pipeline steps)
  gives each rank an (N/D) x N row block, or an (N/r) x (N/c) tile on a
  2-D mesh, through the all-pairs scorer
  (``ops/overlap_allpairs.py::overlap_scores_block``); the JAX package
  picks its Pallas kernel on a TPU and the one-hot XLA contraction
  elsewhere, which the kernel follows (an N matches nothing).
- Coverage: each rank's +1/-1 difference array, cumulated and summed over
  the mesh.

Like the JAX package's parallel layer, these call the device scorers
whatever the pair count: reads with an internal N get the pair-list
scorer's answer here, never the C++ scorer's that ``graph/build.py``'s
``score_pairs`` gives below 200,000 pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encoding import encode_batch
from ..ops.overlap import overlap_scores, overlap_scores_pairs
from ..ops.overlap_allpairs import overlap_scores_block
from ..simulate.errors import inject_errors_device
from ..simulate.reads import reads_at_starts
from ..utils.tracing import stage
from . import _comm
from .mesh import Mesh

# the masked diagonal of the dense score matrices
DIAGONAL_SCORE = -(2**31) + 1


def _on(mesh: Mesh, x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=mesh.device, dtype=dtype)


def _block(mesh: Mesh, axis: str, n: int) -> slice:
    """This rank's block of n items cut evenly along `axis`."""
    size = n // mesh.shape[axis]
    i = mesh.axis_index(axis)
    return slice(i * size, (i + 1) * size)


def _check_divides(n: int, n_dev: int, message: str) -> None:
    if n % n_dev:
        raise ValueError(message)


def _mask_diagonal(scores: torch.Tensor) -> torch.Tensor:
    return scores.fill_diagonal_(DIAGONAL_SCORE)


def sharded_overlap_scores(mesh: Mesh, a_right, a_len, b, b_len,
                           axis: str = "data"):
    """Shard a flat pair batch over the mesh; each rank scores its slice.

    a_right: (P, L) int8 source reads RIGHT-aligned; a_len (P,) int32;
    b: (P, L) int8 target reads LEFT-aligned; b_len (P,) int32 (the
    contract of the JAX package's ``overlap_scores``). The pair count must
    be divisible by the mesh size (pad upstream).

    Returns (scores, ends): (P,) int32 on the mesh device; None outside
    the mesh. Each rank scores its block with ``ops/overlap.py``'s
    ``overlap_scores``.
    """
    n_dev = mesh.shape[axis]
    _check_divides(
        a_right.shape[0], n_dev,
        f"pair count {a_right.shape[0]} not divisible by mesh axis "
        f"'{axis}' size {n_dev}; pad the pair batch upstream")
    if not mesh.member:
        return None
    blk = _block(mesh, axis, a_right.shape[0])
    s, e = overlap_scores(_on(mesh, a_right[blk], torch.int8),
                          _on(mesh, a_len[blk], torch.int32),
                          _on(mesh, b[blk], torch.int8),
                          _on(mesh, b_len[blk], torch.int32))
    line = mesh.axis_line(axis)
    return _comm.all_gather(s, line), _comm.all_gather(e, line)


def sharded_overlap_scores_indexed(mesh: Mesh, right, left, lens, ia, ib,
                                   axis: str = "data"):
    """Score pairs given by index arrays into one replicated read set.

    right / left: (U, L) int8 reads right- and left-aligned; lens (U,)
    int32; ia, ib (P,) source and target indices, P divisible by the mesh
    size (pad upstream). Only the indices are sharded; each rank scores its
    block of pairs with the pair-list scorer on `left` (which needs no
    right-aligned copy: `right` is accepted for the JAX signature).

    Returns (scores, ends): (P,) int32 on the mesh device; None outside
    the mesh.
    """
    n_dev = mesh.shape[axis]
    _check_divides(
        ia.shape[0], n_dev,
        f"pair count {ia.shape[0]} not divisible by mesh axis "
        f"'{axis}' size {n_dev}; pad the index arrays upstream")
    if not mesh.member:
        return None
    blk = _block(mesh, axis, ia.shape[0])
    s, e = overlap_scores_pairs(_on(mesh, left, torch.int8),
                                _on(mesh, lens, torch.int32),
                                _on(mesh, ia[blk], torch.int32),
                                _on(mesh, ib[blk], torch.int32))
    line = mesh.axis_line(axis)
    return _comm.all_gather(s, line), _comm.all_gather(e, line)


def all_pairs_block_scores(mesh: Mesh, reads, lengths, axis: str = "data"):
    """Dense all-pairs scoring (k=0 regime): each rank scores the row block
    of (N/D) source reads against all N reads.

    reads: (N, L) int8 LEFT-aligned; lengths (N,) int32; N divisible by
    the mesh size.

    Returns (scores, ends), both (N, N) int32 on the mesh device, with the
    diagonal of scores masked to -2**31 + 1; None outside the mesh.
    """
    n = reads.shape[0]
    n_dev = mesh.shape[axis]
    _check_divides(n, n_dev,
                   f"N={n} not divisible by mesh axis '{axis}' size "
                   f"{n_dev}; pad the read set to a mesh-size multiple")
    if not mesh.member:
        return None
    r = _on(mesh, reads, torch.int8)
    ln = _on(mesh, lengths, torch.int32)
    blk = _block(mesh, axis, n)
    s, e = overlap_scores_block(r[blk].contiguous(), ln[blk].contiguous(),
                                r, ln)
    line = mesh.axis_line(axis)
    return (_mask_diagonal(_comm.all_gather(s, line)),
            _comm.all_gather(e, line))


def all_pairs_block_scores_2d(mesh: Mesh, reads, lengths,
                              axes=("pair_i", "pair_j")):
    """Dense all-pairs scoring on a 2-D mesh: each rank scores its
    (row block x column block) tile; the tiles are gathered along the
    column axis, then the row blocks along the row axis.

    N must be divisible by both mesh dimensions (pad the read set).
    Returns (scores, ends) (N, N) int32 with the diagonal masked; None
    outside the mesh.
    """
    n = reads.shape[0]
    ai, aj = axes
    if n % mesh.shape[ai] or n % mesh.shape[aj]:
        raise ValueError(
            f"N={n} must be divisible by both mesh axes "
            f"({ai}={mesh.shape[ai]}, {aj}={mesh.shape[aj]}); pad the "
            f"read set")
    if not mesh.member:
        return None
    r = _on(mesh, reads, torch.int8)
    ln = _on(mesh, lengths, torch.int32)
    rows, cols = _block(mesh, ai, n), _block(mesh, aj, n)
    s, e = overlap_scores_block(r[rows].contiguous(), ln[rows].contiguous(),
                                r[cols].contiguous(), ln[cols].contiguous())
    row_line, col_line = mesh.axis_line(aj), mesh.axis_line(ai)

    def gather(tile):
        # (c * N/r, N/c) stacked tiles -> the (N/r, N) row block -> (N, N)
        c = mesh.shape[aj]
        stacked = _comm.all_gather(tile, row_line)
        blk = stacked.reshape(c, tile.shape[0], tile.shape[1])
        blk = blk.permute(1, 0, 2).reshape(tile.shape[0], n)
        return _comm.all_gather(blk.contiguous(), col_line)

    return _mask_diagonal(gather(s)), gather(e)


def distributed_score_pairs(mesh: Mesh, unique_reads: list[str], pairs,
                            axis: str = "data"):
    """Score an ordered sparse candidate-pair list across the mesh.

    `pairs` is a list of (ua, ub) or an (ia, ib) index-array tuple. The
    pair batch is padded with pair (0, 0) to a mesh-size multiple and
    sharded over `axis`. Output order equals input order, so the edge list
    and the contigs do not depend on the mesh size.

    Returns (scores, ends) int32 numpy arrays aligned with `pairs`; None
    outside the mesh.
    """
    from ..graph.build import _pairs_to_arrays

    ia, ib = _pairs_to_arrays(pairs)
    if not mesh.member:
        return None
    if len(ia) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    width = max(len(r) for r in unique_reads)
    right, lens = encode_batch(unique_reads, width=width, align="right")
    left, _ = encode_batch(unique_reads, width=width, align="left")
    n = len(ia)
    n_pad = (-n) % mesh.devices.size
    if n_pad:
        ia = np.concatenate([ia, np.zeros(n_pad, np.int32)])
        ib = np.concatenate([ib, np.zeros(n_pad, np.int32)])
    s, e = sharded_overlap_scores_indexed(mesh, right, left, lens, ia, ib,
                                          axis=axis)
    both = torch.stack([s, e]).cpu().numpy()
    return both[0, :n], both[1, :n]


def distributed_build_overlap_graph(mesh: Mesh, reads: list[str], k: int = 5,
                                    axis: str = "data"):
    """Mesh-sharded overlap-graph build with the reference's edge order:
    candidate enumeration (the k-mer join on the mesh device) -> sharded
    scoring -> host edge fan-out. Its edge list equals
    ``graph.build.build_overlap_graph``'s on any mesh size. None outside
    the mesh."""
    from ..graph.build import (
        OverlapGraph,
        candidate_pairs_arrays,
        dedup_reads,
        fanout_edges,
    )

    if not mesh.member:
        return None
    unique, counts = dedup_reads(reads)
    offsets = np.zeros(len(unique) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    ia, ib = candidate_pairs_arrays(unique, k, device=mesh.device)
    scores, ends = distributed_score_pairs(mesh, unique, (ia, ib), axis=axis)
    src, dst, weight, end_pos = fanout_edges(ia, ib, scores, ends,
                                             counts, offsets)
    return OverlapGraph(unique_reads=unique, counts=counts, offsets=offsets,
                        src=src, dst=dst, weight=weight, end_pos=end_pos)


def distributed_assemble_contigs(mesh: Mesh, reads: list[str], k: int = 5,
                                 axis: str = "data",
                                 use_native: bool = True) -> list[str]:
    """Full distributed assembly: sharded pair scoring over the mesh, then
    the exact-parity layout (cycle removal -> topological order -> greedy
    walk) on every member's host. The contigs equal the single-device
    ``models.overlap_graph`` pipeline's. None outside the mesh. Its stages
    feed the global tracer under ``models.overlap_graph``'s names."""
    from ..graph.cycles import remove_cycles
    from ..graph.layout import walk_contigs
    from ..graph.topo import topological_order

    if not mesh.member:
        return None
    with stage("graph.build"):
        g = distributed_build_overlap_graph(mesh, reads, k=k, axis=axis)
    with stage("graph.remove_cycles", items=len(g.src)):
        remove_cycles(g, use_native=use_native)
    with stage("graph.topo_sort"):
        topo = topological_order(g)
    with stage("graph.walk_contigs"):
        return walk_contigs(g, topo)


def _pipeline_step(mesh: Mesh, reads: torch.Tensor, lens: torch.Tensor,
                   starts: torch.Tensor, genome_len: int, axis: str):
    """A member's step on its shard of reads: all-gather the read set,
    score the shard's row block against it, and sum the coverage."""
    line = mesh.axis_line(axis)
    all_reads = _comm.all_gather(reads, line)
    all_lens = _comm.all_gather(lens, line)
    s, e = overlap_scores_block(reads, lens, all_reads, all_lens)
    delta = torch.zeros(genome_len + 1, dtype=torch.int32, device=mesh.device)
    one = torch.ones_like(lens)
    delta.index_add_(0, starts.to(torch.int64), one)
    delta.index_add_(0, (starts + lens).to(torch.int64), -one)
    cov = torch.cumsum(delta, 0, dtype=torch.int32)[:genome_len]
    return (_comm.all_gather(s, line), _comm.all_gather(e, line),
            _comm.psum(cov, line))


def sharded_pipeline_step_reads(mesh: Mesh, reads, lengths, starts,
                                genome_len: int, axis: str = "data"):
    """The distributed pipeline step on FIXED input reads: shard the given
    read set over the mesh, all-gather the global set, score each rank's
    row block, sum the start/length coverage histogram. With the same
    inputs, scores, ends and coverage are bit-identical on every mesh size.

    Args:
        reads:   (N, L) int8 padded reads (error-injected upstream).
        lengths: (N,) int32.
        starts:  (N,) int32 genome start of each read (for coverage).

    Returns (scores, ends, coverage): (N, N) int32 (the diagonal NOT
    masked, as in the JAX package's step) and the (genome_len,) int32
    coverage, on the mesh device; None outside the mesh.
    """
    n = reads.shape[0]
    n_dev = mesh.devices.size
    _check_divides(n, n_dev, f"N={n} not divisible by mesh size {n_dev}; "
                             f"pad the read set")
    if not mesh.member:
        return None
    blk = _block(mesh, axis, n)
    return _pipeline_step(mesh, _on(mesh, reads[blk], torch.int8),
                          _on(mesh, lengths[blk], torch.int32),
                          _on(mesh, starts[blk], torch.int32),
                          genome_len, axis)


def split_generator(generator: torch.Generator, n: int,
                    device) -> list[torch.Generator]:
    """The n per-rank generators of `sharded_pipeline_step` (the JAX
    package splits one key into D keys): n seeds drawn from `generator` as
    ``torch.randint(0, 2**62, (n,))`` on its device, the i-th seeding a
    fresh ``torch.Generator`` on `device`. A caller rebuilds rank i's reads
    from a generator in the state it passed the step."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def sharded_pipeline_step(mesh: Mesh, generator: torch.Generator,
                          genome_codes, read_length: int, num_reads: int,
                          error_prob: float, axis: str = "data"):
    """One full distributed assembly-data step: per rank, sample a shard of
    reads -> inject errors -> all-gather the global read set -> score the
    shard's row block of the dense pair matrix -> sum a genome coverage
    histogram over the mesh.

    Sampling: every rank passes a generator in the same state; the mesh
    member at axis index i draws from ``split_generator(generator, D,
    mesh.device)[i]``: N/D starts ``torch.randint(0, G, (N/D,))``, its reads
    ``simulate.reads.reads_at_starts`` (``sample_reads_device``'s), then
    ``inject_errors_device`` with the same generator. As in the JAX
    package the reads depend on the mesh size.

    Returns (scores, ends, coverage): (N, N) int32 (diagonal not masked)
    and the (G,) int32 coverage on the mesh device; None outside the mesh
    (whose ranks still draw the seeds, so every caller's generator moves
    alike).
    """
    n_dev = mesh.devices.size
    _check_divides(num_reads, n_dev, f"num_reads={num_reads} not divisible "
                                     f"by mesh size {n_dev}")
    gens = split_generator(generator, n_dev, mesh.device)
    if not mesh.member:
        return None
    genome = _on(mesh, genome_codes, torch.int8)
    g = genome.shape[0]
    gen = gens[mesh.axis_index(axis)]
    starts = torch.randint(0, g, (num_reads // n_dev,), generator=gen,
                           device=mesh.device)
    reads, lens = reads_at_starts(genome, starts, read_length)
    noisy = inject_errors_device(gen, reads, lens, error_prob)
    return _pipeline_step(mesh, noisy, lens, starts.to(torch.int32), g, axis)
