"""Start a world of ranks on this machine and collect their results.

``spawn(fn, world_size, args)`` starts `world_size` processes by the
``spawn`` method (a process forked after CUDA was touched cannot use the
card). Rank r sets ``RANK``, ``LOCAL_RANK`` = r, ``WORLD_SIZE`` and
``LOCAL_WORLD_SIZE``, joins the world through a FileStore in a fresh
temporary directory (``init_distributed``, so ``mesh.py``'s backend rule
holds: rank r on ``cuda:(r mod cards)``, gloo when ranks share a card),
calls ``fn(*args)`` and saves what it returns. ``spawn`` returns the
results in rank order.

On a card it first builds every kernel library and the C++ engine in this
process, so that the ranks load them instead of compiling at once.

A rank that raises fails the call: the others are killed and ``spawn``
raises RuntimeError with that rank's traceback. A world still running
after `timeout_s` is killed and ``spawn`` raises TimeoutError, so no call
waits forever. `fn` and `args` are pickled, so `fn` is a module-level
function; results are read back with ``torch.load`` from files the ranks
wrote, and should hold CPU tensors or numpy arrays.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..core.dispatch import resolve_device
from .mesh import DEFAULT_TIMEOUT_S, init_distributed


def build_kernels() -> None:
    """Build (or load) the four kernel libraries and the C++ engine."""
    from ..native import graphcore
    from ..ops import overlap, overlap_allpairs, seqpar, smith_waterman

    for load in (overlap_allpairs.load_kernel, overlap.load_kernel,
                 smith_waterman.load_kernel, seqpar.load_kernel,
                 graphcore.load):
        load()


def _rank_main(fn, args, rank: int, world_size: int, directory: str,
               device: str, backend: str | None, timeout_s: float) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    out = os.path.join(directory, f"rank{rank}")
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        init_distributed(f"file://{os.path.join(directory, 'store')}",
                         world_size, rank, device=device, backend=backend,
                         timeout_s=timeout_s)
        try:
            result = fn(*args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(result, out + ".tmp")
        os.replace(out + ".tmp", out + ".pt")
    except BaseException:
        with open(out + ".err", "w", encoding="utf-8") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world_size: int, args=(), device="cuda",
          backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S,
          workdir: str | None = None) -> list:
    """Run ``fn(*args)`` on every rank of a new world of `world_size`
    processes on `device` ("cuda": the card(s), "cpu": the host); return
    the ranks' results in rank order. `workdir`: where the world's
    temporary directory goes (its FileStore and results)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        build_kernels()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as directory:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world_size, directory,
                                   dev.type, backend, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"a world of {world_size} rank(s) did not end "
                        f"within {timeout_s} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in running], timeout=left)
                running = [p for p in procs if p.exitcode is None]
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errors = []
            for r in failed:
                path = os.path.join(directory, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path, encoding="utf-8") as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(
                f"rank(s) {failed} of {world_size} failed (exit codes "
                f"{[procs[r].exitcode for r in failed]})\n"
                + "\n".join(errors))
        return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
