#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with the elapsed seconds as it ends:

1. device: a CUDA card must be present (exit 1 otherwise); prints the
   card's name and power limit as nvidia-smi gives them;
2. build: compiles the all-pairs overlap kernel (nvcc, sm_90a) and the C++
   graph engine (g++) from the sources in this checkout, in parallel;
3. kernel against its plain PyTorch version on the card, exact equality of
   score and end on every case (ragged, rectangular, non-default
   penalties, L=127, reads of length 0 and 1, a 256-row slice of the
   main path's own reads against all of them, and the cases the
   tensor-core design can get wrong: N inside reads, tiles cut ragged,
   1x1, lengths <= 8, L=1023, reads against themselves with one base
   changed, for ties, rows at an odd address, and penalties whose factor
   the kernel cannot fold into its one-hot bytes);
4. main path: ``test_assembly`` on PhiX at N=10000, l=150, p=0.01, k=5,
   seed 0, on the card; its contigs and measures must equal the JAX
   package's (the constants below, guarded by tests/test_torch_smoke.py),
   and the kernel must have been launched;
5. kernel time at the main path's shape with CUDA events, beside its bound,
   the tensor-core ops the kernel performs and the plain version's time.

Prints one JSON line of kernel measurements, then, as the last line,
``{"ok": true, "device": {...}}`` — only when every phase passed. Any
failure exits non-zero. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.dont_write_bytecode = True

# The smoke's configuration: PhiX, N = the reference's big_n, l = its upper
# read length, p = 0.01, k = 5, seed 0.
GENOME = os.path.join("data", "phix174.fasta")
READ_LENGTH = 150
NUM_READS = 10000
ERROR_PROB = 0.01
K = 5
SEED = 0

# What the JAX package's test_assembly returns at that configuration
# (recorded on the CPU; tests/test_torch_smoke.py re-runs the JAX package
# and asserts these values).
EXPECTED = {
    "contigs": 2698,
    "n50": 172,
    "total_length": 474708,
    "sha256": "ace0bbd07632457323b3901a00950118c01f36f3a79aeac82ebadf2c4e1b2407",
    "measures": {
        "Number of Contigs": 2698,
        "Genome Coverage": 1.0,
        "N50": 172,
        "Mismatch Rate Aligned Regions": 0.9834756776828816,
        "Mismatch Rate Genome Level": 0.9834756776828816,
    },
}

# Published peaks of one H100 SXM (dense): int8 tensor-core rate and HBM3.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# A base comparison is exact integer matching on int8 codes: as the JAX
# kernel's 3-channel +-1 product (exact in int8, int32 accumulation) it is
# a multiply-add per channel, 6 ops, priced at the card's int8 peak.
OPS_PER_COMPARISON = 6

KERNEL_SOURCE = "genome_assembly_tpu_torch/csrc/overlap_allpairs.cu"
KERNEL_REPLACES = "genome_assembly_tpu/ops/overlap_allpairs.py:312"


def contig_summary(contigs: list[str]) -> dict:
    from genome_assembly_tpu_torch.metrics.measures import calculate_n50

    return {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
    }


def comparisons(a_len, b_len, L: int) -> int:
    """sum over pairs of sum_{j=1}^{len_b} min(len_a, j): the base
    comparisons the function needs for these lengths."""
    import numpy as np

    n = np.arange(L + 1, dtype=np.int64)[:, None]
    m = np.arange(L + 1, dtype=np.int64)[None, :]
    f = np.where(m <= n, m * (m + 1) // 2, n * (n + 1) // 2 + n * (m - n))
    ca = np.bincount(np.asarray(a_len), minlength=L + 1).astype(np.int64)
    cb = np.bincount(np.asarray(b_len), minlength=L + 1).astype(np.int64)
    return int(ca @ f @ cb)


def random_batch(rs, n: int, L: int, lengths=None):
    import numpy as np

    if lengths is None:
        lengths = rs.randint(1, L + 1, size=n)
    lengths = np.asarray(lengths, np.int32)
    codes = rs.randint(0, 4, size=(n, L)).astype(np.int8)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def with_n(rs, codes, lengths, per_read: int = 4) -> None:
    """Put N (code 4) at ``per_read`` random places inside every other read's
    length, in place."""
    for r in range(0, len(codes), 2):
        if lengths[r] > 0:
            codes[r, rs.randint(0, lengths[r], size=per_read)] = 4


def at_odd_address(codes, dev):
    """A contiguous device copy of ``codes`` whose data starts one byte
    past an allocation's start (the kernel's 16-byte loads cannot be used)."""
    import torch

    flat = torch.empty(codes.size + 1, dtype=torch.int8, device=dev)
    view = flat[1:].view(codes.shape)
    view.copy_(torch.from_numpy(codes))
    return view


def tensor_core_ops(a_len, b_len) -> int:
    """int8 ops the kernel performs on the tensor cores: per pair, j runs
    ceil(j/8) k-steps of 8 positions x 4 channels, a multiply-add each."""
    import numpy as np

    n = np.asarray(b_len, np.int64)
    k = (n + 7) // 8                       # sum_{j<=n} 8 ceil(j/8)
    per_b = 8 * (8 * (k - 1) * k // 2 + k * (n - 8 * (k - 1)))
    return 2 * 4 * len(a_len) * int(per_b.sum())


def main() -> int:
    t0 = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[{time.perf_counter() - t0:7.2f}s] {msg}", flush=True)

    # ---- phase 1: device -------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} card(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    print(card_line, flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np

    from genome_assembly_tpu_torch import _build
    from genome_assembly_tpu_torch.core.encoding import encode_batch
    from genome_assembly_tpu_torch.experiments.runner import test_assembly
    from genome_assembly_tpu_torch.graph.build import dedup_reads
    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.simulate import (
        generate_error_free_reads,
        generate_error_prone_reads,
        read_genome_from_fasta,
    )
    from genome_assembly_tpu_torch.utils.tracing import global_tracer

    dev = torch.device("cuda", 0)

    # ---- phase 2: build --------------------------------------------------
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(oa.load_kernel), pool.submit(graphcore.load)]
        for f in futures:
            f.result()
    log(f"phase 2 build: nvcc overlap_allpairs "
        f"{_build.BUILD_SECONDS['overlap_allpairs']}s, g++ graphcore "
        f"{_build.BUILD_SECONDS['graphcore']}s (None: already built)")

    # ---- phase 3: kernel == plain version on the card --------------------
    genome = read_genome_from_fasta(GENOME)
    reads = generate_error_prone_reads(
        generate_error_free_reads(genome, READ_LENGTH, NUM_READS,
                                  rng=random.Random(SEED)),
        ERROR_PROB, rs=np.random.RandomState(SEED))
    unique, _ = dedup_reads(reads)
    main_codes, main_lens = encode_batch(unique, align="left")

    rs = np.random.RandomState(1234)
    cases = []
    a, al = random_batch(rs, 256, 150)
    cases.append(("256x256 ragged, L=150", a, al, a, al, 10, -1))
    a, al = random_batch(rs, 200, 150)
    b, bl = random_batch(rs, 333, 150)
    cases.append(("200x333 ragged, L=150", a, al, b, bl, 10, -1))
    a, al = random_batch(rs, 128, 60)
    b, bl = random_batch(rs, 96, 60)
    cases.append(("128x96, L=60, match=3 mismatch=-2", a, al, b, bl, 3, -2))
    a, al = random_batch(rs, 64, 127)
    cases.append(("64x64, L=127", a, al, a, al, 10, -1))
    a, al = random_batch(rs, 100, 60)
    cases.append(("100x100, L=60, match=40 mismatch=-1 (factor not folded)",
                  a, al, a, al, 40, -1))
    edge_lens = rs.choice([0, 1, 1, 2, 3, 150], size=70)
    a, al = random_batch(rs, 70, 150, edge_lens)
    cases.append(("70x70, lengths 0/1/2/3/150", a, al, a, al, 10, -1))
    cases.append(("main path reads, 256 x %d, L=%d" % main_codes.shape,
                  main_codes[:256], main_lens[:256], main_codes, main_lens,
                  10, -1))
    # cases the tensor-core design can get wrong
    a, al = random_batch(rs, 96, 150)
    with_n(rs, a, al)
    cases.append(("96x96 with internal N (N facing N on the diagonal)",
                  a, al, a, al, 10, -1))
    a, al = random_batch(rs, 129, 150)
    b, bl = random_batch(rs, 257, 150)
    cases.append(("129x257 ragged, L=150", a, al, b, bl, 10, -1))
    a, al = random_batch(rs, 1, 150)
    cases.append(("1x1, L=150", a, al, a, al, 10, -1))
    a, al = random_batch(rs, 100, 150, rs.randint(0, 9, size=100))
    cases.append(("100x100, lengths <= 8", a, al, a, al, 10, -1))
    a, al = random_batch(rs, 40, oa.MAX_L)
    cases.append(("40x40, L=%d, match=4 mismatch=-1" % oa.MAX_L,
                  a, al, a, al, 4, -1))
    b = main_codes[:256].copy()
    rows = np.arange(256)
    pos = rs.randint(0, main_lens[:256])
    b[rows, pos] = (b[rows, pos] + 1) % 4
    cases.append(("main path reads, 256 x 256 against one base changed",
                  main_codes[:256], main_lens[:256], b, main_lens[:256],
                  10, -1))
    a, al = random_batch(rs, 150, 150)
    b, bl = random_batch(rs, 140, 150)
    cases.append(("150x140, L=150, rows at an odd address",
                  at_odd_address(a, dev), al, at_odd_address(b, dev), bl,
                  10, -1))
    max_abs_err = 0
    for name, a, al, b, bl, ms, mm in cases:
        ta, tal = torch.as_tensor(a, device=dev), torch.as_tensor(al, device=dev)
        tb, tbl = torch.as_tensor(b, device=dev), torch.as_tensor(bl, device=dev)
        s_k, e_k = oa.overlap_scores_block(ta, tal, tb, tbl, ms, mm)
        s_p, e_p = oa.overlap_scores_block_plain(ta, tal, tb, tbl, ms, mm)
        torch.cuda.synchronize()
        err = max(int((s_k - s_p).abs().max()), int((e_k - e_p).abs().max()))
        max_abs_err = max(max_abs_err, err)
        if not (torch.equal(s_k, s_p) and torch.equal(e_k, e_p)):
            log(f"phase 3 FAILED: kernel != plain on {name} "
                f"(max abs err {err})")
            return 1
        log(f"phase 3 kernel == plain: {name}")

    # ---- phase 4: the main path ------------------------------------------
    tracer = global_tracer()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    oa.launches = 0
    t_main = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        contigs, measures, _, _ = test_assembly(
            genome, READ_LENGTH, NUM_READS, ERROR_PROB, K, "smoke", 1,
            path=tmp, rng=random.Random(SEED),
            np_rng=np.random.RandomState(SEED), device="cuda")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = oa.launches
    main_peak = torch.cuda.max_memory_allocated(dev)
    stages = tracer.as_dict()
    got = {**contig_summary(contigs), "measures": measures}
    log(f"phase 4 main path: {main_s:.2f}s, U={len(unique)}, "
        f"pairs={stages['score.pairs']['items']}, "
        f"edges={stages['graph.remove_cycles']['items']}, "
        f"contigs={got['contigs']}, N50={got['n50']}, "
        f"total length={got['total_length']}, kernel launches={launches}, "
        f"peak device memory={main_peak} B")
    log(f"phase 4 measures: {json.dumps(measures)}")
    for line in tracer.report().splitlines():
        log(f"phase 4 stage {line}")
    if launches < 1:
        log("phase 4 FAILED: the main path never launched the kernel")
        return 1
    if got != EXPECTED:
        log(f"phase 4 FAILED: result differs from the JAX package's:\n"
            f"  got      {json.dumps(got)}\n"
            f"  expected {json.dumps(EXPECTED)}")
        return 1
    log("phase 4 result == JAX package's")

    # ---- phase 5: kernel time at the main path's shape --------------------
    codes = torch.from_numpy(main_codes).to(dev)
    lens = torch.from_numpy(main_lens).to(dev)
    na, L = main_codes.shape
    torch.cuda.reset_peak_memory_stats(dev)
    oa.overlap_scores_all_pairs(codes, lens)            # warm-up
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        oa.overlap_scores_all_pairs(codes, lens)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    kernel_peak = torch.cuda.max_memory_allocated(dev)
    start.record()
    oa.overlap_scores_block_plain(codes, lens, codes, lens)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)

    n_cmp = comparisons(main_lens, main_lens, L)
    ops_ms = OPS_PER_COMPARISON * n_cmp / PEAK_INT8_OPS * 1e3
    n_bytes = 2 * na * L + 2 * 4 * na + 2 * 4 * na * na
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    tc_ops = tensor_core_ops(main_lens, main_lens)
    log(f"phase 5 kernel time at {na}x{na}, L={L}: {kernel_ms:.3f} ms "
        f"(mean of {reps}); plain version {plain_ms:.1f} ms; bound "
        f"{bound_ms:.3f} ms by {bound_by} ({n_cmp} comparisons = "
        f"{OPS_PER_COMPARISON * n_cmp} int8 ops -> {ops_ms:.3f} ms; "
        f"{n_bytes} B -> {bytes_ms:.3f} ms); kernel at "
        f"{bound_ms / kernel_ms:.3f} of its bound; tensor-core ops performed "
        f"{tc_ops} -> {tc_ops / PEAK_INT8_OPS * 1e3:.3f} ms at the int8 "
        f"peak, {tc_ops / (kernel_ms * 1e-3) / 1e12:.1f} TOP/s achieved; "
        f"peak device memory {kernel_peak} B; card {card_line}")

    print(json.dumps({"kernels": [{
        "name": "overlap_allpairs",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    log(f"all phases passed; wall {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
