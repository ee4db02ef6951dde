"""Carry the JAX package's arrays into the port.

The system has no weights; its state is the reads, their encoded code
matrices and the overlap graphs. These helpers take that state as numpy
arrays (``np.asarray`` of a JAX array) or, for the unitig pipeline's string
graph, as its succ/pred dicts, and build the port's counterparts, so that
both packages compute on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph.build import OverlapGraph
from .models.unitig import _DiGraph


def from_jax_arrays(codes, lengths, device):
    """(N, L) int8 codes and (N,) int32 lengths -> torch tensors on
    `device`, contiguous, with the dtypes the port's kernels take."""
    codes = np.ascontiguousarray(np.asarray(codes), dtype=np.int8)
    lengths = np.ascontiguousarray(np.asarray(lengths), dtype=np.int32)
    if codes.ndim != 2 or lengths.shape != (codes.shape[0],):
        raise ValueError(f"expected (N, L) codes and (N,) lengths, got "
                         f"{codes.shape} and {lengths.shape}")
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(lengths).to(device))


def graph_from_numpy(unique_reads: list[str], src, dst, weight, end_pos,
                     counts, offsets) -> OverlapGraph:
    """An OverlapGraph of the port from the fields of the JAX package's
    ``OverlapGraph`` (``src/dst/weight/end_pos/counts/offsets``)."""
    return OverlapGraph(
        unique_reads=list(unique_reads),
        counts=np.asarray(counts, dtype=np.int32),
        offsets=np.asarray(offsets, dtype=np.int64),
        src=np.asarray(src, dtype=np.int32),
        dst=np.asarray(dst, dtype=np.int32),
        weight=np.asarray(weight, dtype=np.int32),
        end_pos=np.asarray(end_pos, dtype=np.int32))


def digraph_from_dicts(succ: dict, pred: dict) -> _DiGraph:
    """The port's unitig-pipeline `_DiGraph` from the ``succ`` and ``pred``
    dicts of the JAX package's (node -> {neighbour: attrs}), with every
    node, edge and attribute dict in the same insertion order."""
    g = _DiGraph()
    for n in succ:
        g.add_node(n)
    for u, nbrs in succ.items():
        for v, attrs in nbrs.items():
            g.succ[u][v] = dict(attrs)
    for v, nbrs in pred.items():
        for u, attrs in nbrs.items():
            g.pred[v][u] = dict(attrs)
    return g
