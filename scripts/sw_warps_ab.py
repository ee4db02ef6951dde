#!/usr/bin/env python3
"""Time the port's two Smith-Waterman kernels on both smoke paths' own
calls at every block size and with and without the spin's sleep, on one
CUDA card.

    python3 scripts/sw_warps_ab.py [--reps 2]

Runs the PhiX main path and the 50 kb long-genome path of chip_smoke.py
once on the card, recording their full-width and banded calls. Then, for
two builds of csrc/smith_waterman.cu -- the source as it is (a waiting
warp sleeps kSpinSleepNs between polls) and a copy with the sleep's call
removed (the lane polls without a pause) -- in the order source, copy,
copy, source (`--reps` rounds), it runs each kernel on every recorded
call at W = 1, 2, 4 and 8 warps an item and at the wrapper's own choice
(`_warps_per_item`), and prints each launch's
device time from a profiler trace, the warps it ran with, and whether
every output equals the source build's at the wrapper's choice. Writes
the table to chiprun_out/sw_warps_ab.json. Needs nvcc; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2)
    opts = parser.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("sw_warps_ab: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    os.chdir(ROOT)
    import chip_smoke as cs
    from genome_assembly_tpu_torch import _build
    from genome_assembly_tpu_torch.experiments.runner import test_assembly
    from genome_assembly_tpu_torch.ops import smith_waterman as sw
    from genome_assembly_tpu_torch.simulate import read_genome_from_fasta

    # the two builds: the source, and a copy whose waiting warps never sleep
    out_dir = tempfile.mkdtemp(prefix="sw_warps_ab_")
    source = open(sw.SOURCE).read()
    # (a sleep of 0 ns would still yield the warp: drop the call)
    no_sleep, n = re.subn(r"__nanosleep\(kSpinSleepNs\);", "{}", source)
    assert n == 1, "__nanosleep(kSpinSleepNs); not found in the source"
    copy = os.path.join(out_dir, "smith_waterman_no_sleep.cu")
    with open(copy, "w") as f:
        f.write(no_sleep)
    libs = {}
    for name, src in (("source", sw.SOURCE), ("no sleep", copy)):
        libs[name] = _build.build_shared_library(
            f"smith_waterman_ab_{len(libs)}", src,
            [sw._nvcc(), *sw.NVCC_FLAGS], timeout=sw.BUILD_TIMEOUT_S)

    def use(name):
        sw._LIB = None
        sw.build_shared_library = lambda *a, **k: libs[name]
        sw.load_kernel()

    use("source")
    genome = read_genome_from_fasta(cs.GENOME)
    with tempfile.TemporaryDirectory() as tmp, \
            cs.CallRecorder(sw, "sw_full_width") as full:
        test_assembly(genome, cs.READ_LENGTH, cs.NUM_READS, cs.ERROR_PROB,
                      cs.K, "ab", 1, path=tmp, rng=random.Random(cs.SEED),
                      np_rng=np.random.RandomState(cs.SEED), device="cuda")
    lg, long = cs.long_genome(), cs.LONG
    with tempfile.TemporaryDirectory() as tmp, \
            cs.CallRecorder(sw, "sw_banded") as banded:
        test_assembly(lg, long["read_length"], long["num_reads"],
                      long["error_prob"], long["k"], "ab", 1, path=tmp,
                      rng=random.Random(long["rng_seed"]),
                      np_rng=np.random.RandomState(long["np_seed"]),
                      device="cuda")
    paths = (("full", full.calls, sw.sw_full_width, "sw_kernel<false"),
             ("banded", banded.calls, sw.sw_banded, "sw_kernel<true"))
    reference = {kind: [fn(*a, **k) for a, k in calls]
                 for kind, calls, fn, _ in paths}
    rule = sw._warps_per_item
    table: dict = {}
    try:
        for name in ["source", "no sleep", "no sleep", "source"] * opts.reps:
            use(name)
            for kind, calls, fn, kernel in paths:
                for warps in (*sw.WARPS_PER_ITEM, "rule"):
                    sw._warps_per_item = (rule if warps == "rule" else
                                          lambda s, m, w=warps: w)
                    same = all(cs.sw_equal(fn(*a, **k), r)[0]  # + warm-up
                               for (a, k), r in zip(calls, reference[kind]))
                    with cs.CallRecorder(sw, "_warps_per_item",
                                         keep_results=True) as picked, \
                            profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
                        for a, k in calls:
                            fn(*a, **k)
                        torch.cuda.synchronize()
                    per_launch = [e.time_range.elapsed_us() / 1e3
                                  for e in p.events() if kernel in e.name]
                    row = {"ms_alone": sum(per_launch),
                           "per_launch_ms": per_launch,
                           "warps": picked.results, "equal": same}
                    table.setdefault(f"{kind} | {name} | W={warps}",
                                     []).append(row)
                    print(f"{kind:6} {name:8} W={warps!s:4} "
                          f"{row['ms_alone']:.4f} ms alone, per launch "
                          f"{[round(x, 4) for x in per_launch]}, warps "
                          f"{picked.results}, outputs "
                          f"{'==' if same else '!='} source's", flush=True)
                    if not same:
                        return 1
    finally:
        sw._warps_per_item = rule
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "sw_warps_ab.json"), "w") as f:
        json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
