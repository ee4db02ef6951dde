"""Scaling report of the PyTorch/CUDA port: sharded all-pairs scoring
against the mesh size.

The port's counterpart of ``bench_scaling.py``, with its modes, knobs and
rows, on ``torch.distributed`` (``genome_assembly_tpu_torch/parallel``):
one world of ranks is spawned on this machine (``parallel/spawn.py``),
every rank builds the meshes of 1, 2, 4 and 8 ranks up to the world size,
and the member ranks of each run ``all_pairs_block_scores`` (each rank
scores its (N/m) x N row block with the all-pairs kernel, then the blocks
are all-gathered) on PhiX reads (``bench.py``'s samplers, REP row-rotated
copies staged on each rank's card).

- SCALE_MODE=weak (default): SCALE_N_PER_DEV reads a rank (512), so N
  grows with the mesh; efficiency = pairs/s a rank against mesh 1;
- SCALE_MODE=strong: SCALE_N reads in all (1024), split over the mesh.

A mesh-1 "direct" control row times the kernel without the mesh wrapper
(``overlap_scores_all_pairs`` on rank 0) at the mesh-1 N. With a world of
two ranks or more, two sequence-parallel Smith-Waterman rows follow at the
largest mesh (``local_align_batch_seqpar`` and its pipelined variant at 25
rows an exchange; 16 queries of 100 bases against a SCALE_SEQPAR_G bp
random genome, SCALE_SEQPAR=0 skips them).

Timing: each member rank times ROUNDS passes over the REP copies on its
host clock, the checksums of the sweeps chained on its card and fetched
once at the end; a row takes the slowest member rank. The warm-up is two
fixed rounds (``bench_scaling.py`` warms until two rounds agree, a rule
that ranks deciding apart could break in the middle of a collective).

The world: one rank a card when the machine has two cards or more, else
8 ranks. Ranks that each own a card use NCCL; ranks that share a card
(more ranks than cards) use gloo and time-slice it, so their rows
measure the mesh program on one card, not scaling across cards: every
row carries ``ranks_per_card``, ``backend`` and the card's name.

    python3 bench_scaling_torch.py

Rows go to stdout, the report to SCALE_OUT (default
``results/scaling_torch.json``, which ``.gitignore`` lists; the
tracked ``SCALING*.json`` are the JAX package's). Env: SCALE_MODE,
SCALE_N, SCALE_N_PER_DEV, SCALE_L (100), SCALE_REP (8), SCALE_ROUNDS (10),
SCALE_SEQPAR, SCALE_SEQPAR_G (50000), SCALE_OUT. Runs on the
card only: without one it raises (``run(..., device="cpu")`` is for the
tests).
"""

from __future__ import annotations

import json
import math
import os
import random
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

MESH_SIZES = (1, 2, 4, 8)
WARM_ROUNDS = 2
SEQPAR_BATCH, SEQPAR_QUERY_LEN, SEQPAR_ROWS = 16, 100, 25
DEFAULT_OUT = os.path.join(ROOT, "results", "scaling_torch.json")
TIMEOUT_S = 1800


def config_from_env(env=os.environ) -> dict:
    """``bench_scaling.py``'s knobs and defaults."""
    mode = env.get("SCALE_MODE", "weak")
    if mode not in ("weak", "strong"):
        raise ValueError(f"SCALE_MODE must be weak or strong, got {mode!r}")
    return {
        "mode": mode,
        "n_total": int(env.get("SCALE_N", "1024")),
        "n_per_dev": int(env.get("SCALE_N_PER_DEV", "512")),
        "l": int(env.get("SCALE_L", "100")),
        "rep": int(env.get("SCALE_REP", "8")),
        "rounds": int(env.get("SCALE_ROUNDS", "10")),
        "seqpar": env.get("SCALE_SEQPAR", "1") == "1",
        "seqpar_g": int(env.get("SCALE_SEQPAR_G", "50000")),
    }


def mesh_sizes(cfg: dict, world: int) -> list[int]:
    sizes = [m for m in MESH_SIZES if m <= world]
    if cfg["mode"] == "strong":
        sizes = [m for m in sizes if cfg["n_total"] % m == 0]
    return sizes


def reads_at(cfg: dict, m: int) -> int:
    """N at mesh size m."""
    return cfg["n_per_dev"] * m if cfg["mode"] == "weak" else cfg["n_total"]


def _inputs(n: int, l: int, rep: int, dev):
    """``bench.py``'s reads (N, l), REP row-rotated copies on `dev`."""
    import torch

    from bench_torch import bench_reads

    codes, lengths = bench_reads(n, l)
    ld = torch.from_numpy(lengths).to(dev)
    return [torch.from_numpy(np.roll(codes, i + 1, axis=0)).to(dev)
            for i in range(rep)], ld


def _fold(out):
    """``bench_scaling.py``'s fold of the sharded outputs: the masked
    diagonal zeroed, both matrices summed (int64 on their device)."""
    import torch

    s, e = out
    return ((s * (s > -2**30)).sum(dtype=torch.int64)
            + e.sum(dtype=torch.int64))


def _timed(fn, variants, ld, rounds: int, sync) -> dict:
    """Fixed warm-up, then `rounds` chained passes over the copies and one
    fetch: host seconds a sweep, host threads busy, the first checksum."""
    first = int(fn(variants[0], ld))
    for _ in range(WARM_ROUNDS):
        acc = fn(variants[0], ld)
        for c in variants[1:]:
            acc = acc + fn(c, ld)
        int(acc)
    sync()
    t0 = time.perf_counter()
    c0 = time.process_time()
    acc = None
    for _ in range(rounds):
        for c in variants:
            acc = fn(c, ld) if acc is None else acc + fn(c, ld)
    int(acc)
    wall = time.perf_counter() - t0
    return {"sweep_s": wall / (len(variants) * rounds),
            "threads_busy": (time.process_time() - c0) / wall,
            "checksum": first}


def rank_rows(cfg: dict, sizes: list[int], device: str) -> dict:
    """Every rank of the world: the direct row on rank 0, then each mesh
    (built by every rank, timed by its members), then the seqpar rows.
    Returns this rank's measurements."""
    import torch
    import torch.distributed as dist

    from genome_assembly_tpu_torch import parallel
    from genome_assembly_tpu_torch.core.encoding import (
        PAD,
        encode,
        encode_batch,
    )
    from genome_assembly_tpu_torch.ops.overlap_allpairs import (
        overlap_scores_all_pairs,
    )
    from genome_assembly_tpu_torch.parallel.mesh import rank_device

    dev = rank_device(device)
    rank = dist.get_rank()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"rank": rank, "meshes": {}, "seqpar": {}}
    l, rep, rounds = cfg["l"], cfg["rep"], cfg["rounds"]
    if rank == 0:
        n1 = reads_at(cfg, 1)
        variants, ld = _inputs(n1, l, rep, dev)
        out["direct"] = _timed(
            lambda c, lens: (lambda s, e: s.sum(dtype=torch.int64)
                             + e.sum(dtype=torch.int64))(
                *overlap_scores_all_pairs(c, lens)),
            variants, ld, rounds, sync)
        del variants
    dist.barrier()
    meshes = {}
    for m in sizes:
        mesh = meshes[m] = parallel.make_mesh(m, device=device)
        if mesh.member:
            variants, ld = _inputs(reads_at(cfg, m), l, rep, dev)
            out["meshes"][m] = _timed(
                lambda c, lens: _fold(
                    parallel.all_pairs_block_scores(mesh, c, lens)),
                variants, ld, rounds, sync)
            del variants
        dist.barrier()
    if cfg["seqpar"] and len(sizes) > 1:
        m = sizes[-1]
        mesh = meshes[m]
        r = random.Random(0)
        g = cfg["seqpar_g"]
        genome = "".join(r.choice("ACGT") for _ in range(g))
        queries = []
        for _ in range(SEQPAR_BATCH):
            s0 = r.randrange(g - SEQPAR_QUERY_LEN - 1)
            queries.append(genome[s0:s0 + SEQPAR_QUERY_LEN])
        q, ql = encode_batch(queries, align="left")
        g_pad = np.full(((g + m - 1) // m) * m, PAD, np.int8)
        g_pad[:g] = encode(genome)
        q, ql, g_d = (torch.from_numpy(x).to(dev) for x in (q, ql, g_pad))
        variants = (
            ("seqpar_per_row", parallel.local_align_batch_seqpar, {}),
            (f"seqpar_pipelined_R{SEQPAR_ROWS}",
             parallel.local_align_batch_seqpar_pipelined,
             {"rows_per_exchange": SEQPAR_ROWS}))
        for name, fn, kw in variants:
            if mesh.member:
                res = fn(mesh, q, ql, g_d, g, **kw)
                sync()
                t0 = time.perf_counter()
                for _ in range(3):
                    res = fn(mesh, q, ql, g_d, g, **kw)
                    sync()
                out["seqpar"][name] = {
                    "wall_s": (time.perf_counter() - t0) / 3,
                    "best": res[0].cpu().numpy()}
            dist.barrier()
    return out


def default_world(n_cards: int) -> int:
    """One rank a card on a machine of two cards or more, else 8 ranks
    sharing the card (or the host)."""
    return n_cards if n_cards >= 2 else max(MESH_SIZES)


def run(cfg: dict, device="cuda", world_size: int | None = None,
        timeout_s: float = TIMEOUT_S, workdir: str | None = None) -> dict:
    """Spawn the world, run `rank_rows` on every rank and assemble the
    report: {"rows": [...], ...} with ``bench_scaling.py``'s row keys, plus
    ``card``, ``cards``, ``ranks_per_card``, ``backend``, ``world_size``
    and each sweep's ``checksum``."""
    import torch

    from genome_assembly_tpu_torch.core.dispatch import resolve_device
    from genome_assembly_tpu_torch.parallel.mesh import pick_backend
    from genome_assembly_tpu_torch.parallel.spawn import spawn

    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    world = world_size or default_world(n_cards)
    sizes = mesh_sizes(cfg, world)
    results = spawn(rank_rows, world, args=(cfg, sizes, dev.type),
                    device=dev.type, timeout_s=timeout_s, workdir=workdir)
    common = {
        "platform": dev.type,
        "card": torch.cuda.get_device_name(0) if n_cards else None,
        "cards": n_cards,
        "ranks_per_card": math.ceil(world / n_cards) if n_cards else None,
        "backend": pick_backend(dev.type, world, n_cards),
        "world_size": world,
    }
    l, cores = cfg["l"], os.cpu_count() or 1
    rows = []
    n1 = reads_at(cfg, 1)
    direct = results[0]["direct"]
    rows.append({"mesh_size": 1, "wrapper": "direct", **common,
                 "pairs_per_sec": n1 * n1 / direct["sweep_s"],
                 "pairs_per_sec_per_device": n1 * n1 / direct["sweep_s"],
                 "host_threads_busy": direct["threads_busy"],
                 "checksum": direct["checksum"], "n": n1, "l": l})
    base_ppd = None
    for m in sizes:
        members = [r["meshes"][m] for r in results if m in r["meshes"]]
        sweep = max(t["sweep_s"] for t in members)
        n = reads_at(cfg, m)
        pps = n * n / sweep
        if base_ppd is None:
            base_ppd = pps / m
        row = {"mesh_size": m, "mode": cfg["mode"], "wrapper": "sharded",
               **common, "pairs_per_sec": pps,
               "pairs_per_sec_per_device": pps / m,
               "scaling_efficiency": pps / m / base_ppd,
               "host_threads_busy": max(t["threads_busy"] for t in members),
               "checksum": members[0]["checksum"],
               "checksums_agree": len({t["checksum"] for t in members}) == 1,
               "n": n, "l": l}
        if dev.type == "cpu":
            row["host_core_cap"] = min(1.0, cores / m)
        rows.append(row)
    m = sizes[-1]
    seqpar_names = [name for name in results[0]["seqpar"]]
    for name in seqpar_names:
        members = [r["seqpar"][name] for r in results if name in r["seqpar"]]
        wall = max(t["wall_s"] for t in members)
        per_row = name == "seqpar_per_row"
        g = cfg["seqpar_g"]
        rows.append({
            "mesh_size": m, "wrapper": name, **common, "genome_len": g,
            "batch": SEQPAR_BATCH, "query_len": SEQPAR_QUERY_LEN,
            "collectives_total": (2 * SEQPAR_QUERY_LEN if per_row else
                                  -(-SEQPAR_QUERY_LEN // SEQPAR_ROWS) + m - 1),
            "cells_per_sec": SEQPAR_BATCH * SEQPAR_QUERY_LEN * g / wall,
            "wall_ms": wall * 1e3,
            "best_agree": len({t["best"].tobytes() for t in members}) == 1,
        })
    report = {"rows": rows, "mode": cfg["mode"], **common,
              "mesh_sizes": sizes, "host_cores": cores}
    if dev.type == "cuda" and common["ranks_per_card"] > 1:
        report["analysis"] = (
            f"{world} ranks share {n_cards} card(s) on gloo: the ranks "
            f"time-slice the card and every all-gather is staged through "
            f"host memory, so these rows measure the mesh program's "
            f"overhead on one card, not scaling across cards.")
    return report


def main() -> int:
    cfg = config_from_env()
    report = run(cfg, device="cuda")
    for row in report["rows"]:
        print(json.dumps(row), flush=True)
    out = os.environ.get("SCALE_OUT", DEFAULT_OUT)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
    bad = [r["mesh_size"] for r in report["rows"]
           if r.get("checksums_agree") is False
           or r.get("best_agree") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
