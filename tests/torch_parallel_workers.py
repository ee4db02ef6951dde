"""Entry function of the spawned ranks in the parallel layer's tests.

The ranks are fresh processes started by
``genome_assembly_tpu_torch.parallel.spawn.spawn``; this module imports
torch, numpy and the port only, never JAX or the JAX package (the test
files that import it do, in the pytest process).
"""

import numpy as np
import torch

from genome_assembly_tpu_torch import parallel
from genome_assembly_tpu_torch.graph.build import OverlapGraph
from genome_assembly_tpu_torch.parallel import _comm, seqpar


def _mesh(spec, device):
    kind, *rest = spec
    if kind == "1d":
        n, axis = rest
        return parallel.make_mesh(n, axis_name=axis, device=device)
    if kind == "2d":
        rows, cols = rest
        return parallel.make_mesh_2d(rows, cols, device=device)
    return parallel.make_mesh_hosts_chips(device=device)


def _host(x):
    """Tensors to numpy, an OverlapGraph to a dict, tuples to lists."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, OverlapGraph):
        return {"unique_reads": x.unique_reads, "counts": x.counts,
                "offsets": x.offsets, "src": x.src, "dst": x.dst,
                "weight": x.weight, "end_pos": x.end_pos}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


def run_cases(cases, device="cpu"):
    """Run each case on this rank, in order, and return {name: result}.

    A case is (name, mesh spec, function name, args, kwargs): the mesh
    spec ("1d", n, axis name), ("2d", rows, cols) or ("hosts_chips",), or
    None for a function without a mesh; the function a name of
    ``genome_assembly_tpu_torch.parallel``, or "mesh" for the mesh's own
    attributes. kwargs may add ``generator_seed`` (a torch.Generator on the
    mesh device, seeded so, goes first among the args) and
    ``gather_codes`` (the global seqpar codes in place of the slice). A
    result is numpy arrays and lists, None outside the mesh, or ("raised",
    message) for a ValueError; each case also records the collectives the
    function made, under (name, "collectives")."""
    out = {}
    for name, spec, fn_name, args, kwargs in cases:
        kwargs = dict(kwargs)
        if spec is None:
            out[name] = _host(getattr(parallel, fn_name)(*args, **kwargs,
                                                         device=device))
            continue
        mesh = _mesh(spec, device)
        if fn_name == "mesh":
            out[name] = {"axis_names": mesh.axis_names,
                         "shape": mesh.devices.shape,
                         "sizes": dict(mesh.shape), "member": mesh.member}
            continue
        gather = kwargs.pop("gather_codes", False)
        if "generator_seed" in kwargs:
            gen = torch.Generator(device=mesh.device).manual_seed(
                kwargs.pop("generator_seed"))
            args = (gen, *args)
        _comm.collectives = 0
        try:
            res = getattr(parallel, fn_name)(mesh, *args, **kwargs)
        except ValueError as exc:
            out[name] = ("raised", str(exc))
            continue
        out[name, "collectives"] = _comm.collectives
        if gather and res is not None:
            res = (*res[:3], seqpar.gather_codes(mesh, res[3],
                                                 kwargs.get("axis", "data")))
        out[name] = _host(res)
    return out


def sample_shards(seed: int, n_dev: int, genome: np.ndarray,
                  read_length: int, num_reads: int, error_prob: float,
                  device="cpu"):
    """The reads, lengths and starts each of n_dev mesh members draws in
    ``sharded_pipeline_step`` from a generator seeded `seed`, by the rule
    its docstring states; concatenated in axis order."""
    from genome_assembly_tpu_torch.parallel.sharded import split_generator
    from genome_assembly_tpu_torch.simulate import inject_errors_device
    from genome_assembly_tpu_torch.simulate.reads import reads_at_starts

    dev = torch.device(device)
    gens = split_generator(torch.Generator(device=dev).manual_seed(seed),
                           n_dev, dev)
    g = torch.as_tensor(genome, device=dev)
    reads, lens, starts = [], [], []
    for gen in gens:
        s = torch.randint(0, g.shape[0], (num_reads // n_dev,),
                          generator=gen, device=dev)
        r, ln = reads_at_starts(g, s, read_length)
        reads.append(inject_errors_device(gen, r, ln, error_prob))
        lens.append(ln)
        starts.append(s.to(torch.int32))
    return torch.cat(reads), torch.cat(lens), torch.cat(starts)


def fail_on(rank: int):
    """Raise on `rank`; the other ranks wait for it in a barrier."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def sleep(seconds: float):
    import time

    time.sleep(seconds)
