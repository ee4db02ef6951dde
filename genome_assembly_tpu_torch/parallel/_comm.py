"""Collectives of the parallel layer along one mesh axis.

Each takes a mesh axis's line, ``(process group, global ranks in axis
order)`` from ``Mesh.axis_line``. Under NCCL a CUDA tensor goes to the
collective as it is; under gloo, which takes CPU tensors only, a CUDA
tensor is copied to pinned host memory first and the result copied back
to the card. All of it is exact integer work. Without a process group
(group None: a one-process world) each is the identity on one rank.

``collectives`` counts the calls, one a call whatever the tensor; set it
to 0 to start counting.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

collectives = 0


def _count() -> None:
    global collectives
    collectives += 1


def _staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """`x` as the backend takes it: a pinned host copy under gloo."""
    if staged:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.contiguous()


def _empty(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def all_gather(x: torch.Tensor, line) -> torch.Tensor:
    """Every rank's `x` along the line, concatenated along dim 0 in axis
    order (JAX ``all_gather(..., tiled=True)``; a 0-d `x` gives a vector).
    Every rank gives the same shape."""
    group, ranks = line
    if group is None:
        return x.reshape(-1) if x.dim() == 0 else x
    n = len(ranks)
    staged = _staged(group, x)
    wire = _wire(x, staged)
    out = _empty((n, *x.shape), x, staged)
    if dist.get_backend(group) == "gloo":
        dist.all_gather(list(out.unbind(0)), wire, group=group)
    else:
        dist.all_gather_into_tensor(out, wire, group=group)
    _count()
    # group ranks are ascending global ranks; put them in axis order
    by_rank = sorted(ranks)
    perm = [by_rank.index(r) for r in ranks]
    if perm != list(range(n)):
        out = out[perm]
    out = out.to(x.device)
    return out.reshape(n * x.shape[0], *x.shape[1:]) if x.dim() else out


def ppermute_right(x: torch.Tensor, line, index: int) -> torch.Tensor:
    """Each rank's `x` to its right neighbour along the line; the rank at
    index 0 receives zeros (JAX ``ppermute`` with perm (i, i + 1))."""
    group, ranks = line
    if group is None:
        return torch.zeros_like(x)
    staged = _staged(group, x)
    wire = _wire(x, staged)
    buf = _empty(x.shape, x, staged).zero_()
    ops = []
    if index + 1 < len(ranks):
        ops.append(dist.P2POp(dist.isend, wire, peer=ranks[index + 1],
                              group=group))
    if index > 0:
        ops.append(dist.P2POp(dist.irecv, buf, peer=ranks[index - 1],
                              group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count()
    return buf.to(x.device)


def psum(x: torch.Tensor, line) -> torch.Tensor:
    """Sum of `x` over the line, on every rank (JAX ``psum``)."""
    group, _ = line
    if group is None:
        return x
    wire = _wire(x, _staged(group, x))
    if wire is x:
        wire = x.clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    _count()
    return wire.to(x.device)


class _Pending:
    """An isend or irecv in flight; ``wait()`` returns its tensor on the
    caller's device."""

    def __init__(self, req, tensor: torch.Tensor, device: torch.device):
        self._req, self._tensor, self._device = req, tensor, device

    def wait(self) -> torch.Tensor:
        self._req.wait()
        return self._tensor.to(self._device)


def isend(x: torch.Tensor, line, dst_index: int) -> _Pending:
    """Send `x` to the rank at `dst_index` along the line."""
    group, ranks = line
    staged = _staged(group, x)
    wire = _wire(x, staged)
    _count()
    return _Pending(dist.isend(wire, dst=ranks[dst_index], group=group),
                    wire, x.device)


def irecv(shape, like: torch.Tensor, line, src_index: int) -> _Pending:
    """Receive a tensor of `shape` and `like`'s dtype from the rank at
    `src_index` along the line, onto `like`'s device."""
    group, ranks = line
    staged = _staged(group, like)
    buf = _empty(shape, like, staged)
    _count()
    return _Pending(dist.irecv(buf, src=ranks[src_index], group=group),
                    buf, like.device)
