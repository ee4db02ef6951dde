"""Meshes of ranks on ``torch.distributed``.

The JAX package runs one program over a mesh of devices under a single
controller (``shard_map``), and its callers see global arrays. Here every
rank of a process group calls the same function with the same global
inputs (SPMD): each computes its shard on its own device and takes part in
the collectives, and every member rank returns the global result, which is
what a JAX caller reads from a global array.

A ``Mesh`` is a grid of global ranks with named axes, a process group
along each line of each axis, and the rank's own ``torch.device``. ``make_mesh(n)`` takes the first n ranks, as JAX's takes
the first n devices; ``make_mesh_2d`` builds one group a row and one a
column. Every rank of the world must build every mesh, in the same order,
because a mesh creates process groups (``dist.new_group`` is collective
over the world). A rank outside a mesh computes nothing and waits for no
one: the parallel functions return None there at once.

The backend rule (``pick_backend``): the rank-to-card map decides it. A
rank's card is ``cuda:(local rank mod cards on its node)``. Ranks on the
CPU, or ranks that share a card (more ranks on a node than cards), use
gloo, whose collectives here stage CUDA tensors through pinned host
memory (``_comm.py``); ranks that each own a card use NCCL. A world of one
rank on a card therefore uses NCCL. Asking for NCCL where ranks share a
card raises (NCCL refuses two ranks on one GPU), and a failed NCCL
initialisation raises: nothing switches to gloo on its own.

Without an initialised process group the world is this process alone:
``make_mesh()`` is a one-rank mesh and the collectives are identities.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..core.dispatch import resolve_device

BACKENDS = ("gloo", "nccl")
# seconds a collective waits for its peers before it raises
DEFAULT_TIMEOUT_S = 600


def _local_rank(default: int | None = None) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if default is not None:
        return default
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device="cuda", local_rank: int | None = None) -> torch.device:
    """This rank's ``torch.device``: ``cuda:(local rank mod cards)`` for a
    bare ``"cuda"`` (the local rank from ``LOCAL_RANK``, else
    ``local_rank``, else the global rank), the device itself otherwise.
    Raises RuntimeError for a card when none is present."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda",
                        _local_rank(local_rank) % torch.cuda.device_count())


def pick_backend(device_type: str, local_world_size: int, n_cards: int,
                 requested: str | None = None) -> str:
    """The backend for ranks on `device_type`, `local_world_size` of them on
    a node with `n_cards` cards: NCCL when each rank owns a card, gloo when
    ranks share one or run on the CPU. `requested` forces a backend and
    raises ValueError where NCCL cannot run."""
    shared = device_type != "cuda" or local_world_size > n_cards
    if requested is None:
        return "gloo" if shared else "nccl"
    if requested not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{requested!r}")
    if requested == "nccl" and shared:
        raise ValueError(
            f"NCCL needs a card a rank: {local_world_size} rank(s) on "
            f"{n_cards} card(s) of type {device_type!r}; use gloo")
    return requested


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Multi-process bring-up: ``dist.init_process_group`` with the
    standard environment fallbacks (the JAX package's
    ``jax.distributed.initialize`` with ``JAX_COORDINATOR_ADDRESS``).

    `coordinator_address` is ``host:port``, or an init URL
    (``tcp://host:port``, ``file:///path`` for a FileStore); without it,
    ``MASTER_ADDR`` and ``MASTER_PORT``. `num_processes` and `process_id`
    default to ``WORLD_SIZE`` and ``RANK``. The backend follows
    `pick_backend` (``LOCAL_WORLD_SIZE`` ranks a node, else all of them),
    and the rank's card becomes the current device. A no-op for a single
    process with no coordinator, and when a process group exists. A failed
    bring-up raises.
    """
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    if coordinator_address is None and num_processes is None:
        return  # single-process run: nothing to initialise
    if dist.is_initialized():
        return
    if coordinator_address is None:
        raise ValueError("num_processes given without a coordinator address "
                         "(coordinator_address or MASTER_ADDR/MASTER_PORT)")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = rank_device(device, local_rank=process_id)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = pick_backend(dev.type, local_world, n_cards, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)


def _new_group(ranks: list[int]):
    """A process group over `ranks` (every rank of the world calls this);
    the world's own group when `ranks` is the whole world, None without a
    process group."""
    if not dist.is_initialized():
        return None
    if sorted(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks=sorted(ranks))


class Mesh:
    """A grid of global ranks with named axes (the JAX package's ``Mesh``
    of devices).

    Attributes:
        devices: np.ndarray of global ranks, one axis per name (JAX callers
            read ``mesh.devices.size`` and ``.shape``).
        axis_names: tuple of axis names.
        shape: dict axis name -> size (``mesh.shape[axis]``).
        device: this rank's ``torch.device``.
        rank: this rank's global rank; coords: its index in ``devices``,
            None when it is not a member.
    """

    def __init__(self, ranks, axis_names, device: torch.device):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d rank grid for axes {axis_names}")
        if len(set(ranks.ravel().tolist())) != ranks.size:
            raise ValueError(f"a rank appears twice in {ranks.tolist()}")
        self.devices = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.device = device
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        hit = np.argwhere(ranks == self.rank)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        # axis -> (group, ranks along the axis through this rank, in axis
        # order); every line of every axis is created on every rank
        self._lines = {}
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines.tolist():
                group = _new_group(line)
                if self.rank in line:
                    self._lines[name] = (group, line)

    @property
    def member(self) -> bool:
        return self.coords is not None

    def axis_index(self, axis: str) -> int:
        """This rank's index along `axis` (JAX ``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def axis_line(self, axis: str):
        """(process group, global ranks in axis order) of the ranks that
        share this rank's other coordinates."""
        return self._lines[axis]


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              devices=None, device="cuda") -> Mesh:
    """1-D mesh over the first n ranks (default: all). `devices`: the
    global ranks to take them from (default: the world's, in order)."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else 1)
    ranks = list(devices)
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return Mesh(np.asarray(ranks), (axis_name,), rank_device(device))


def make_mesh_2d(rows: int, cols: int, axis_names=("pair_i", "pair_j"),
                 devices=None, device="cuda") -> Mesh:
    """2-D mesh for block-sharding the candidate-pair score matrix: the
    first rows * cols ranks, row-major."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else 1)
    ranks = list(devices)
    if rows * cols > len(ranks):
        raise ValueError(f"a {rows} x {cols} mesh needs {rows * cols} "
                         f"ranks, there are {len(ranks)}")
    grid = np.asarray(ranks[: rows * cols]).reshape(rows, cols)
    return Mesh(grid, axis_names, rank_device(device))


def make_mesh_hosts_chips(axis_names=("hosts", "chips"), devices=None,
                          device="cuda") -> Mesh:
    """('hosts', 'chips') mesh: one row a node, its ranks by local rank
    (JAX sorts devices by (process_index, id)); collectives over 'chips'
    stay on a node. On one machine a 1 x D grid. Nodes are told apart by
    ``GROUP_RANK`` (set by torchrun), else by host name."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = (os.environ.get("GROUP_RANK") or socket.gethostname(),
          _local_rank())
    infos = [me]
    if dist.is_initialized():
        infos = [None] * world
        dist.all_gather_object(infos, me)
    ranks = list(range(world) if devices is None else devices)
    node_index = {}
    for r in ranks:
        node_index.setdefault(infos[r][0], len(node_index))
    ranks.sort(key=lambda r: (node_index[infos[r][0]], infos[r][1], r))
    n_local = max(1, sum(infos[r][0] == infos[ranks[0]][0] for r in ranks))
    if len(ranks) % n_local:
        raise ValueError(f"uneven local rank counts: {len(ranks)} ranks, "
                         f"{n_local} on node {infos[ranks[0]][0]}")
    grid = np.asarray(ranks).reshape(len(ranks) // n_local, n_local)
    return Mesh(grid, axis_names, rank_device(device))
