"""Time the sequence-parallel Smith-Waterman kernel of one or more trees of
this repository on one card, in turns, at phase 8f's shape on one rank.

    python3 scripts/seqpar_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one, or a ``git archive`` of an earlier commit unpacked into a directory
that .gitignore lists). The trees run one after another, each in a process
of its own that imports that tree's ``genome_assembly_tpu_torch`` and
builds its kernel there, in the order given: pass parent, change, change,
parent to compare two on one card.

Each run times both variants' calls on one rank at chip_smoke.py phase
8f's shape -- 64 items of 197-256 bases (one of 256) cut from
chip_smoke.py's 50 kb genome with 2% substitutions (seed 0), n_pad 256,
R = 8 rows a step --
through the ops-level steps (``ops/seqpar.py``) with a one-rank world's
exchanges (a rank's totals are the gathered totals; its left neighbour
sends zeros): the kernels alone in a profiler trace of one call (device
time summed over the seqpar kernels' launches), twice, and the call by
CUDA events. Prints a JSON line a run, then one summary line; writes them
to chiprun_out/seqpar_ab.json where that directory exists.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

ITEMS, MIN_LEN, MAX_LEN, SUBST, ROWS, SEED = 64, 197, 256, 0.02, 8, 0
GENOME_SEED, GENOME_LEN = 0, 50_000     # chip_smoke.py LONG's genome
KERNELS = ("seqpar_step_kernel", "seqpar_row_pre_kernel",
           "seqpar_row_post_kernel")


def _inputs():
    """(queries, lengths, genome codes) as numpy arrays."""
    from genome_assembly_tpu_torch.core.encoding import encode, encode_batch

    rng = random.Random(GENOME_SEED)
    genome = "".join(rng.choice("ACGT") for _ in range(GENOME_LEN))
    rng = random.Random(SEED)
    queries = []
    for k in range(ITEMS):
        n = MAX_LEN if k == 0 else rng.randint(MIN_LEN, MAX_LEN)
        start = rng.randint(0, GENOME_LEN - n)
        queries.append("".join(
            c if rng.random() > SUBST else rng.choice("ACGT")
            for c in genome[start:start + n]))
    q, ql = encode_batch(queries, align="left")
    return q, ql, encode(genome)


def _device_ms(fn):
    """(ms, launches) of the seqpar kernels in a profiler trace of fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    entries = [e for e in prof.key_averages()
               if any(k in e.key for k in KERNELS)]
    return (sum(e.device_time_total for e in entries) / 1e3,
            sum(e.count for e in entries))


def _events_ms(fn, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def child(tree: str) -> dict:
    """One tree's run, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from genome_assembly_tpu_torch.ops import seqpar as sq

    t = time.perf_counter()
    sq.load_kernel()
    build_s = time.perf_counter() - t
    q, ql, g = _inputs()
    dev = torch.device("cuda", 0)
    b, n_pad = q.shape
    gb = g.shape[0]
    n_blocks = -(-n_pad // ROWS)
    qp = np.full((b, n_blocks * ROWS), 4, np.int8)
    qp[:, :n_pad] = q
    queries = torch.as_tensor(q, device=dev)
    padded = torch.as_tensor(qp, device=dev)
    q_len = torch.as_tensor(ql, device=dev)
    genome = torch.as_tensor(g, device=dev)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    prev, run, halo = z(b, gb), z(b, gb), z(b)
    best, bi, bj = z(b), z(b), z(b)
    codes = torch.empty((n_blocks * ROWS, b, gb), dtype=torch.uint8,
                        device=dev)
    slab = z(2, ROWS, b)

    def per_row():
        prev.zero_()
        best.zero_()
        for i in range(1, n_pad + 1):
            total = sq.seqpar_row_pre(queries, i, genome, 0, gb, prev, halo,
                                      run)
            sq.seqpar_row_post(queries, q_len, i, genome, 0, gb, 0, prev,
                               halo, run, total[None], codes[i - 1], best,
                               bi, bj)

    def pipelined():
        prev.zero_()
        best.zero_()
        for step in range(n_blocks):
            sq.seqpar_step(padded, q_len, step * ROWS, genome, 0, gb, prev,
                           halo, slab, codes, best, bi, bj)

    out = {"tree": tree, "module": sq.__file__, "build_s": build_s,
           "items": b, "n_pad": n_pad, "gb": gb,
           "card": torch.cuda.get_device_name(0)}
    if hasattr(sq, "plan"):     # a tree whose kernel has a launch plan
        for kind, step in (("step", True), ("pre", False), ("post", False)):
            geo = sq.plan(b, gb, step)
            out[f"{kind}_geometry"] = {
                **geo._asdict(),
                "clusters_at_once": sq.max_active_clusters(kind, geo)}
    for name, fn in (("per_row", per_row), ("pipelined", pipelined)):
        fn()
        runs = [_device_ms(fn) for _ in range(2)]
        out[name] = {"kernels_ms": [ms for ms, _ in runs],
                     "launches": runs[0][1], "call_ms": _events_ms(fn)}
        out[name]["best_sum"] = int(best.sum())
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    here = os.path.abspath(__file__)
    runs = []
    for tree in argv:
        root = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, here, "--child", root], capture_output=True,
            text=True, timeout=900, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["power_line"] = card
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"card": card, "order": argv,
               "per_row_kernels_ms": [r["per_row"]["kernels_ms"]
                                      for r in runs],
               "pipelined_kernels_ms": [r["pipelined"]["kernels_ms"]
                                        for r in runs],
               "best_sums_agree": len({(r["per_row"]["best_sum"],
                                        r["pipelined"]["best_sum"])
                                       for r in runs}) == 1}
    print(json.dumps(summary), flush=True)
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "seqpar_ab.json"), "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0 if summary["best_sums_agree"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
