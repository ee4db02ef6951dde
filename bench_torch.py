"""Headline benchmark of the PyTorch/CUDA port: overlap-pair scoring
throughput on one NVIDIA card.

The port's counterpart of ``bench.py``, with its workload, defaults and
knobs: the all-pairs overlap kernel (``csrc/overlap_allpairs.cu`` behind
``genome_assembly_tpu_torch/ops/overlap_allpairs.py``) on the dense N x N
pair space of PhiX reads (N = 1,000, l = 100, p = 0.01, seed 0; the reads
equal ``bench.py``'s bit for bit), against the C++ full-DP overlap
alignment (``native/graphcore.py::overlap_baseline_batch``) on the same
65,536 sampled pairs.

Method: REP row-rotated copies of the reads are staged on the card; one
sweep scores every ordered pair of one copy and folds both outputs into a
running checksum on the card, so the sweeps form one chain. Before any
timing the kernel's outputs on copy 0 must equal the plain version's
(``torch.equal``), else the script exits 1.

- sustained: the host clock around ROUNDS x REP chained sweeps and the
  one fetch of the checksum, divided by the sweeps (``value``,
  ``sweep_us``);
- kernel-resident: CUDA events around the same chain (the sweeps and
  their checksum folds, no fetch), divided by the sweeps
  (``kernel_pairs_per_sec``, ``kernel_sweep_us``);
- ``dispatch_fetch_overhead_ms``: ``bench.py``'s difference of a chain of
  one round and one of ROUNDS rounds on the host clock;
- ``kernel_alone_us``: the all-pairs kernel's own device time a sweep in
  a ``torch.profiler`` trace of one round (not ``bench.py``'s; the events
  above also hold the wrapper's checks and the checksum folds).

Shares of the card's dense int8 peak (GA_TPU_PEAK_TFLOPS, default 1979
TOP/s, an H100 SXM): ``mfu`` and ``mfu_kernel_resident`` count the
tensor-core operations the kernel issues (``tensor_core_ops``),
``mfu_useful`` and ``mfu_useful_kernel_resident`` the base comparisons the
function needs at 6 int8 ops each (``comparisons`` x
``OPS_PER_COMPARISON``, the work its bound counts). BENCH_IMPL=xla times
the plain version instead of the kernel, with the same work counts.

Prints ONE JSON line with ``bench.py``'s keys. Runs on the card only:
without one it raises (``run(device="cpu")`` is for the tests).

    python3 bench_torch.py

Env knobs: BENCH_N (reads, 1000), BENCH_L (read length, 100), BENCH_REP
(copies, 20), BENCH_ROUNDS (rounds of the chain, 50), BENCH_IMPL
(auto|xla; pallas is refused), BENCH_QUICK=1 (N 128, l 32, REP 4, ROUNDS
2), GA_TPU_PEAK_TFLOPS (peak for the shares, 1979).
"""

from __future__ import annotations

import json
import os
import random
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

IMPLS = ("auto", "xla")
DEFAULT_PEAK_TOPS = 1979.0
BASELINE_PAIRS = 65536
# an H100 SXM's HBM3 rate, for the sweep's bound
PEAK_BYTES_PER_S = 3.35e12


def config_from_env(env=os.environ) -> dict:
    """``bench.py``'s knobs and defaults."""
    quick = env.get("BENCH_QUICK") == "1"
    impl = env.get("BENCH_IMPL", "auto")
    if impl not in IMPLS:
        raise ValueError(
            f"BENCH_IMPL={impl!r}: the port has no Pallas kernel; use "
            f"'auto' (the CUDA kernel) or 'xla' (its plain version)")
    return {
        "n": int(env.get("BENCH_N", "128" if quick else "1000")),
        "l": int(env.get("BENCH_L", "32" if quick else "100")),
        "rep": int(env.get("BENCH_REP", "4" if quick else "20")),
        "rounds": int(env.get("BENCH_ROUNDS", "2" if quick else "50")),
        "impl": impl,
        "peak_tops": float(env.get("GA_TPU_PEAK_TFLOPS", DEFAULT_PEAK_TOPS)),
    }


def bench_reads(n: int, l: int, seed: int = 0):
    """``bench.py``'s reads: PhiX, the host samplers with Random(seed) and
    RandomState(seed) at p = 0.01, left-aligned codes of width l."""
    from genome_assembly_tpu_torch.core.encoding import encode_batch
    from genome_assembly_tpu_torch.simulate import (
        generate_error_free_reads,
        generate_error_prone_reads,
        read_genome_from_fasta,
    )

    genome = read_genome_from_fasta(os.path.join(ROOT, "data",
                                                 "phix174.fasta"))
    reads = generate_error_free_reads(genome, l, n, rng=random.Random(seed))
    reads = generate_error_prone_reads(reads, 0.01,
                                       rs=np.random.RandomState(seed))
    return encode_batch(reads, width=l, align="left")


def checksum(scores, ends):
    """The fold of one sweep's outputs (``bench.py``'s: the sum of both
    matrices), as an int64 scalar on their device."""
    import torch

    return scores.sum(dtype=torch.int64) + ends.sum(dtype=torch.int64)


def baseline_pairs_per_sec(codes, lengths, seed: int = 0) -> float:
    """The C++ full DP on ``bench.py``'s 65,536 sampled pairs (pairs/s)."""
    from genome_assembly_tpu_torch.native import graphcore

    n = len(codes)
    b0 = min(BASELINE_PAIRS, n * n)
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, n, b0)
    ib = rng.integers(0, n, b0)
    a, al, b, bl = codes[ia], lengths[ia], codes[ib], lengths[ib]
    graphcore.overlap_baseline_batch(a[:64], al[:64], b[:64], bl[:64])
    t0 = time.perf_counter()
    graphcore.overlap_baseline_batch(a, al, b, bl)
    return b0 / (time.perf_counter() - t0)


def kernel_alone_us(one_round) -> float | None:
    """Mean device time (us) of one all-pairs kernel launch in a profiler
    trace of `one_round`; None when the trace shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages()
            if "overlap_allpairs_kernel" in e.key]
    launches = sum(e.count for e in mine)
    us = sum(getattr(e, "device_time_total", 0) for e in mine)
    return us / launches if launches and us else None


def run(n: int = 1000, l: int = 100, rep: int = 20, rounds: int = 50,
        impl: str = "auto", peak_tops: float = DEFAULT_PEAK_TOPS,
        device="cuda", seed: int = 0, baseline: bool = True) -> dict:
    """Measure one configuration; returns the result dict, whose ``equal``
    says whether the scorer's outputs on copy 0 equal the plain version's
    (when they do not, nothing is timed and ``equal`` is False).

    On a card the kernel is built first, so a failed build raises before
    any tensor reaches the card. On the CPU (the tests) the wrapper runs
    the plain version and only the counts and the checksum mean anything.
    """
    import torch

    from genome_assembly_tpu_torch.core.dispatch import resolve_device
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa

    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        oa.load_kernel()
    score_fn = {"auto": oa.overlap_scores_all_pairs,
                "xla": oa.overlap_scores_all_pairs_xla}[impl]
    codes, lengths = bench_reads(n, l, seed)
    ld = torch.from_numpy(lengths).to(dev)
    variants = [torch.from_numpy(np.roll(codes, i + 1, axis=0)).to(dev)
                for i in range(rep)]

    s_k, e_k = score_fn(variants[0], ld)
    s_p, e_p = oa.overlap_scores_all_pairs_xla(variants[0], ld)
    result = {"equal": bool(torch.equal(s_k, s_p) and torch.equal(e_k, e_p)),
              "first_checksum": int(checksum(s_k, e_k))}
    del s_k, e_k, s_p, e_p
    if not result["equal"]:
        return result

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def chain(n_rounds: int, events: bool = False):
        """Host seconds of n_rounds x rep chained sweeps and one fetch, and
        the device ms between CUDA events around the sweeps."""
        sync()
        if events:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if events:
            start.record()
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n_rounds):
            for c in variants:
                acc = acc + checksum(*score_fn(c, ld))
        if events:
            stop.record()
        total = int(acc)
        host_s = time.perf_counter() - t0
        device_ms = start.elapsed_time(stop) if events else None
        return host_s, device_ms, total

    # warm until two consecutive single rounds agree within 10%
    prev = float("inf")
    for _ in range(6):
        warm_s, _, _ = chain(1)
        if warm_s > 0.9 * prev:
            break
        prev = warm_s
    one, _, _ = chain(1)
    full, device_ms, total = chain(rounds, events=dev.type == "cuda")
    sweeps = rep * rounds
    dt = full / sweeps
    dt_kernel = device_ms * 1e-3 / sweeps if device_ms is not None else dt
    fetch_ms = (max(0.0, (one * rounds - full) / (rounds - 1) / 1e-3)
                if rounds > 1 else None)
    alone_us = kernel_alone_us(lambda: chain(1)) if (
        dev.type == "cuda" and impl == "auto") else None
    executed = oa.tensor_core_ops(lengths, lengths)
    useful = oa.OPS_PER_COMPARISON * oa.comparisons(lengths, lengths, l)
    peak = peak_tops * 1e12
    # the least time a sweep could take: the useful ops over the peak, or
    # the codes and lengths read once and both (N, N) outputs written once
    # over the memory rate
    ops_us = useful / peak * 1e6
    bytes_us = (n * l + 4 * n + 2 * 4 * n * n) / PEAK_BYTES_PER_S * 1e6
    pps = n * n / dt
    base_pps = (baseline_pairs_per_sec(codes, lengths, seed) if baseline
                else float("nan"))
    result.update({
        "metric": f"overlap_pairs_per_sec_per_chip(N={n},l={l},{dev.type})",
        "value": pps,
        "unit": "pairs/s",
        "vs_baseline": pps / base_pps if base_pps == base_pps else None,
        "tflops": executed / dt / 1e12,
        "mfu": executed / dt / peak,
        "mfu_useful": useful / dt / peak,
        "mfu_useful_kernel_resident": useful / dt_kernel / peak,
        "sweep_us": dt * 1e6,
        "kernel_sweep_us": dt_kernel * 1e6,
        "kernel_pairs_per_sec": n * n / dt_kernel,
        "mfu_kernel_resident": executed / dt_kernel / peak,
        "dispatch_fetch_overhead_ms": fetch_ms,
        "sweeps_per_fetch": sweeps,
        "chain_checksum": total,
        "kernel_alone_us": alone_us,
        "bound_us": max(ops_us, bytes_us),
        "bound_by": "operations" if ops_us >= bytes_us else "bytes",
        "baseline_pairs_per_sec": base_pps if base_pps == base_pps else None,
        "impl": impl,
    })
    if dev.type == "cuda":
        result["card"] = torch.cuda.get_device_name(dev)
    return result


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "tflops", "mfu",
              "mfu_useful", "mfu_useful_kernel_resident", "sweep_us",
              "kernel_sweep_us", "kernel_pairs_per_sec",
              "mfu_kernel_resident", "dispatch_fetch_overhead_ms",
              "sweeps_per_fetch")


def main() -> int:
    cfg = config_from_env()
    result = run(device="cuda", **cfg)
    if not result["equal"]:
        print("bench_torch: the kernel's outputs differ from the plain "
              "version's on copy 0; nothing timed", file=sys.stderr)
        return 1
    line = {k: result[k] for k in BENCH_KEYS}
    line.update({k: result[k] for k in ("card", "impl", "chain_checksum",
                                        "baseline_pairs_per_sec",
                                        "kernel_alone_us", "bound_us",
                                        "bound_by")})
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
