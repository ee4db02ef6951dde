#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with the elapsed seconds as it ends:

1. device: a CUDA card must be present (exit 1 otherwise); prints the
   card's name and power limit as nvidia-smi gives them;
2. build: compiles the all-pairs and the pair-list overlap kernels and the
   two Smith-Waterman kernels (nvcc, sm_90a, one call per source) and the
   C++ graph engine (g++) from the sources in this checkout, all in
   parallel;
3. each kernel against its plain PyTorch version on the card, exact
   equality on every case. The overlap kernel: score and end (ragged,
   rectangular, non-default penalties, L=127, reads of length 0 and 1, a
   256-row slice of the main path's own reads against all of them, N
   inside reads, tiles cut ragged, 1x1, lengths <= 8, L=1023, reads
   against themselves with one base changed, rows at an odd address, and
   penalties whose factor the kernel cannot fold into its one-hot bytes).
   The pair-list overlap kernels: score and end (ragged lengths 0, 1, L-1
   and L, W = 150 and 1,023, internal PAD, penalties 5/-4, ia == ib and
   repeated pairs, inputs at an odd address, the main path's reads, sorted
   runs of ia across the warps' chunks, one run mixing clean reads and
   reads with an N, W = 256 and 257 on either side of the register
   instances).
   The Smith-Waterman kernels: score, best_i, best_j, start_j and the op
   stream (ragged batches, ties, N inside query and window, q_len 0 and
   window length 0, queries longer than their window, tail windows,
   penalties 5/-3/-2; banded at bands 1, 64 and 2048 with d0 negative, at
   0, near m and wholly outside the genome); after phases 4 and 4b, 64 of
   each path's own contigs, and every item of the long path's full-width
   calls;
4. main path: ``test_assembly`` on PhiX at N=10000, l=150, p=0.01, k=5,
   seed 0, on the card; its contigs and measures must equal the JAX
   package's (the constants below, guarded by tests/test_torch_smoke.py),
   and the overlap kernel and the full-width SW kernel must have been
   launched;
4b. long-genome path: ``test_assembly`` on a 50,000 bp random genome at
   N=15000, l=150, p=0.005, k=15 (scripts/long_genome_demo.py's exact
   k=15 row), on the card; both SW kernels must have been launched and the
   result must equal the JAX package's (LONG_EXPECTED);
4c. the long-genome path at its recorded size (LONG_GENOME.json: N=90000,
   nothing cut), two rows: "exact, k=15" and "fast, k=5" (the greedy
   layout with its consensus polish); both take the sparse route (the
   pair-list kernel) and the k-mer join on the card; the pair kernel, the
   join and the banded SW kernel must have run, and each row must equal
   the JAX package's (LONG90_EXPECTED);
5. each kernel's time at its path's own inputs with CUDA events, beside
   its bound and the plain version's time; for the SW kernels also DP
   cells, GCUPS, their code traffic and the C++ engine's time on the same
   items (a host figure, not a library call), and their outputs on every
   item of those calls held against the plain version's (exact); then,
   on the same calls, each SW kernel at every block size its launch
   entries take (1, 2, 4 and 8 warps an item; CUDA events and its time
   alone in a profiler trace), its outputs equal to those at the
   wrapper's choice. Phases 4 and 4b print the warps a block the wrapper
   gave each launch. The pair-list kernels on phase 4c's calls: every pair
   held against the plain version, their time (CUDA events around the
   wrapper and around the launch entry; the pack kernel and the pair kernel
   each alone in a profiler trace, with the launches the trace saw), bound,
   the plain version's and the C++ engine's time,
   and the device join's time; then on PhiX's candidate pairs beside the
   all-pairs kernel, whose gathered scores and ends it must equal;
6. the sweep path, on the card, its output in a temporary directory:
   6a ``run_for_params`` at phase 4's configuration, 3 iterations (the
   reference's default is 10), its aggregate equal to the JAX package's
   (SWEEP_EXPECTED), iteration 1 equal to EXPECTED, 3 launches of the
   all-pairs and of the full-width SW kernel, and device memory after
   iteration 3 within 2 MiB of that after iteration 1; 6b
   ``run_experiments`` on the CLI's ``--quick`` grids (12 configs), its 12
   CSV files byte-equal to the JAX package's (QUICK_EXPECTED); 6c
   ``run_simulations_parallel`` with 2 spawned workers on experiment 1's
   four configs, equal to sequential runs from copies of the same rngs;
   6d the CLI in subprocesses: ``assemble`` at phase 4's configuration
   with ``--profile``, its measures equal to EXPECTED and its trace naming
   the all-pairs and the full-width SW kernel (the device busy time and
   idle share over ``test_assembly`` are read from it), and
   ``experiments --quick --no-plots``, which must write the 12 CSVs.
   Prints which of pandas, matplotlib and joblib are installed here.

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

# The long-genome path: scripts/long_genome_demo.py's "exact, k=15" row at
# its default size (a 50,000 bp genome from random.Random(0), N=15000,
# l=150, p=0.005, read seeds random.Random(1) and RandomState(2)). Its
# metrics pass takes the banded route (genome >= 16,384 bp).
LONG = {"genome_len": 50_000, "genome_seed": 0, "read_length": 150,
        "num_reads": 15_000, "error_prob": 0.005, "k": 15, "rng_seed": 1,
        "np_seed": 2}
LONG_EXPECTED = {
    "contigs": 11901,
    "n50": 150,
    "total_length": 1814753,
    "sha256": "cf4f0c279017e061011d12c28c90355692a6a2c6cc3c5db12d5d9dd82a25568d",
    "measures": {
        "Number of Contigs": 11901,
        "Genome Coverage": 0.99986,
        "N50": 150,
        "Mismatch Rate Aligned Regions": 0.7057188006320885,
        "Mismatch Rate Genome Level": 0.70576,
    },
}

# The same path at the size LONG_GENOME.json records (N=90000): two of its
# rows. U = 76,033 unique reads; 96,906 candidate pairs at k=15 and
# 5,772,298 at k=5, both past the dense route's limits (the sparse route).
LONG90 = {**LONG, "num_reads": 90_000}
LONG90_ROWS = (("exact, k=15", {"k": 15, "exact_parity": True}),
               ("fast, k=5", {"k": 5, "exact_parity": False}))
LONG90_EXPECTED = {
    "exact, k=15": {
        "contigs": 37183,
        "n50": 150,
        "total_length": 6036252,
        "sha256": "6fc9fdc98b619c02706c0c9a3157d4823a1f4ce78b58939fdf18a5fed4761b04",
        "measures": {
            "Number of Contigs": 37183,
            "Genome Coverage": 1.0,
            "N50": 150,
            "Mismatch Rate Aligned Regions": 0.99854,
            "Mismatch Rate Genome Level": 0.99854,
        },
    },
    "fast, k=5": {
        "contigs": 70897,
        "n50": 150,
        "total_length": 10905529,
        "sha256": "29e8a04fdfc3da822d52521a26676cacf6397e1817dff08944f7c20468ea787c",
        "measures": {
            "Number of Contigs": 70897,
            "Genome Coverage": 1.0,
            "N50": 150,
            "Mismatch Rate Aligned Regions": 0.79492,
            "Mismatch Rate Genome Level": 0.79492,
        },
    },
}

# Phase 6a: run_for_params at phase 4's configuration, 3 iterations from
# random.Random(SEED) and np.random.RandomState(SEED); the JAX package's
# "<key> avg/std/raw" columns (recorded on the CPU; tests/test_torch_smoke.py
# re-runs the JAX package and asserts them).
SWEEP_ITERATIONS = 3
SWEEP_EXPECTED = {
    "num_reads avg": 10000.0, "read_length avg": 150.0,
    "error_prob avg": 0.01, "k avg": 5.0,
    "expected_coverage avg": 278.4998143334571, "num_iterations avg": 3.0,
    "Number of Contigs avg": 2692.6666666666665, "Genome Coverage avg": 1.0,
    "N50 avg": 172.0,
    "Mismatch Rate Aligned Regions avg": 0.9890456739695507,
    "Mismatch Rate Genome Level avg": 0.9890456739695507,
    "num_reads std": 0.0, "read_length std": 0.0, "error_prob std": 0.0,
    "k std": 0.0, "expected_coverage std": 0.0, "num_iterations std": 0.0,
    "Number of Contigs std": 44.25180473406957, "Genome Coverage std": 0.0,
    "N50 std": 0.816496580927726,
    "Mismatch Rate Aligned Regions std": 0.006730252120457415,
    "Mismatch Rate Genome Level std": 0.006730252120457415,
    "num_reads raw": [10000, 10000, 10000], "read_length raw": [150, 150, 150],
    "error_prob raw": [0.01, 0.01, 0.01], "k raw": [5, 5, 5],
    "expected_coverage raw": [278.4998143334571] * 3,
    "num_iterations raw": [3, 3, 3],
    "Number of Contigs raw": [2698, 2636, 2744],
    "Genome Coverage raw": [1.0, 1.0, 1.0], "N50 raw": [172, 173, 171],
    "Mismatch Rate Aligned Regions raw": [
        0.9834756776828816, 0.9851466765688823, 0.9985146676568882],
    "Mismatch Rate Genome Level raw": [
        0.9834756776828816, 0.9851466765688823, 0.9985146676568882],
}
# 6a fails when device memory after the last iteration exceeds that after
# the first by more than this
SWEEP_MEMORY_SLACK = 2 << 20

# Phase 6b: sha256 of each CSV that run_experiments writes on the CLI's
# --quick grids with one iteration, random.Random(SEED) and
# np.random.RandomState(SEED) passed through run_kw and no plots (the JAX
# package on the CPU; tests/test_torch_smoke.py re-runs it).
QUICK_EXPECTED = {
    "experiment_const_coverage/C_0.928/results.csv":
        "2ae0c1106b5be15f4e56a37476f4fa3b16be7b59177eaae79a8f5675a07858ba",
    "experiment_const_coverage/C_0.928/summary.csv":
        "97aaec9c3a4a83329b2d7521b84ac9789f1a8476b129bc75e0b7367b88904ba5",
    "experiment_const_coverage/C_2/results.csv":
        "4b150111a95e6ec23559c34cfcfa783b219ffb641ad803fab9647f34736ec979",
    "experiment_const_coverage/C_2/summary.csv":
        "0d381b8983ce0f0803470098c638ac9d89a9b1fcf4a94ca5c593dd1b9381f17e",
    "experiment_varying_l/fixed_n_100/results.csv":
        "52deaf5c1277f4eec3b33a1ed7d5d879973d64912b1a32e23b3b59865db4d490",
    "experiment_varying_l/fixed_n_100/summary.csv":
        "959e5cf98adefa3f010dfc7740de1e4a8554e795e5fae9f5fa0cc2c145d92b2b",
    "experiment_varying_l/fixed_n_200/results.csv":
        "1d79740c7cb8427f8617c158991d6f9b727a885af09b02ede4030c74392bbb45",
    "experiment_varying_l/fixed_n_200/summary.csv":
        "47cae7813808cfacca90bce4475c58f996da056716e7d5ed55cbcd97ca97d6df",
    "experiment_varying_n/fixed_l_100/results.csv":
        "09177c93c257c0bd6bb2b3f52337480390a87e8e3b93af48faf4b012732a3bcf",
    "experiment_varying_n/fixed_l_100/summary.csv":
        "5ba47ccf29c30ebca2059794d1db47f0e8b00246058d2f41faeecfb82b248374",
    "experiment_varying_n/fixed_l_50/results.csv":
        "16fef2b222e71dabed92789018a3f0ba4e955e18762172c7e1a4f91899eb09af",
    "experiment_varying_n/fixed_l_50/summary.csv":
        "2a27823bcbf5762ce1ddf5d4635a9434595f41268601176dd20a66ba92713166",
}

KERNEL_SOURCE = "genome_assembly_tpu_torch/csrc/overlap_allpairs.cu"
KERNEL_REPLACES = "genome_assembly_tpu/ops/overlap_allpairs.py:312"
PAIRS_SOURCE = "genome_assembly_tpu_torch/csrc/overlap_pairs.cu"
# an XLA program of the JAX package (not a Pallas kernel)
PAIRS_REPLACES = "genome_assembly_tpu/ops/overlap.py:71"
SW_SOURCE = "genome_assembly_tpu_torch/csrc/smith_waterman.cu"
# XLA programs of the JAX package (not Pallas kernels)
SW_FULL_REPLACES = "genome_assembly_tpu/ops/smith_waterman.py:157"
SW_BANDED_REPLACES = "genome_assembly_tpu/ops/smith_waterman.py:176"
# The SW kernels' fewest integer operations per DP cell (substitution
# select, DPX max of the three moves with the 0 clamp, code select),
# priced at 132 SMs x 64 int32 lanes x the SM clock.
SW_OPS_PER_CELL = 3
SMS, INT32_LANES = 132, 64
# The plain SW versions' traceback codes (one byte a DP cell) in one chunk
# of phase 5's comparison on a path's own calls.
PLAIN_CODES_BUDGET = 2 << 30


def long_genome() -> str:
    rng = random.Random(LONG["genome_seed"])
    return "".join(rng.choice("ACGT") for _ in range(LONG["genome_len"]))


class CallRecorder:
    """Wraps a function of ops/smith_waterman.py: passes every call through
    unchanged and keeps its inputs, so phase 5 can time the kernel on
    exactly the items a path gave it, and with `keep_results` its results
    (the warps a block the wrapper gave each launch; a kernel's outputs
    are not kept, so that they do not count in a later peak)."""

    def __init__(self, module, name, keep_results=False):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.keep_results = keep_results
        self.calls = []
        self.results = []

    def __enter__(self):
        def record(*args, **kwargs):
            self.calls.append((args, kwargs))
            out = self.inner(*args, **kwargs)
            if self.keep_results:
                self.results.append(out)
            return out

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


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


def pair_comparisons(a_len, b_len, L: int) -> int:
    """sum over listed pairs (a_len[p], b_len[p]) of
    sum_{j=1}^{b_len[p]} min(a_len[p], j)."""
    import numpy as np

    n = np.arange(L + 1, dtype=np.int64)[:, None]
    m = np.arange(L + 1, dtype=np.int64)[None, :]
    f = np.where(m <= n, m * (m + 1) // 2, n * (n + 1) // 2 + n * (m - n))
    return int(f[np.asarray(a_len), np.asarray(b_len)].sum())


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


def cut_queries(rs, genome_codes, lengths, subst: float = 0.02):
    """Queries cut from the genome at random offsets, with substitutions
    and, in every fourth, a short insertion and a deletion (gap moves)."""
    import numpy as np

    m = len(genome_codes)
    width = max(1, int(max(lengths)))
    q = np.full((len(lengths), width), 4, np.int8)
    for r, n in enumerate(lengths):
        if n == 0:
            continue
        start = rs.randint(0, max(1, m - n - 8))
        row = genome_codes[start:start + n + 8].copy()
        if r % 4 == 0 and n > 40:
            row = np.r_[row[:n // 3], rs.randint(0, 4, 3).astype(np.int8),
                        row[n // 3:2 * n // 3], row[2 * n // 3 + 2:]]
        row = row[:n]
        flip = rs.rand(len(row)) < subst
        row[flip] = (row[flip] + rs.randint(1, 4, flip.sum())) % 4
        q[r, :len(row)] = row
    return q, np.asarray(lengths, np.int32)


def sw_full_cases(rs, genome_codes):
    """(name, queries, q_len, genome, w_len, penalties) for phase 3."""
    import numpy as np

    m = len(genome_codes)
    cases = []
    q, ql = cut_queries(rs, genome_codes, rs.randint(1, 401, size=96))
    wl = np.where(rs.rand(96) < 0.3, ql, m).astype(np.int32)
    cases.append(("96 ragged queries (1-400) against the genome and tail "
                  "windows", q, ql, genome_codes, wl, (10, -1, -1)))
    two = np.tile(np.array([0, 1, 1, 0, 1], np.int8), 600)
    q, ql = cut_queries(rs, two, rs.randint(5, 200, size=48), subst=0.0)
    cases.append(("ties: 48 queries on a two-letter repeat genome", q, ql,
                  two, np.full(48, len(two), np.int32), (10, -1, -1)))
    g_n = genome_codes.copy()
    g_n[rs.randint(0, m, 40)] = 4
    q, ql = cut_queries(rs, g_n, rs.randint(50, 300, size=48))
    q[np.arange(48), rs.randint(0, 50, 48)] = 4
    cases.append(("N inside query and window", q, ql, g_n,
                  np.full(48, m, np.int32), (10, -1, -1)))
    q, ql = cut_queries(rs, genome_codes, np.r_[[0] * 6, rs.randint(1, 200,
                                                                     10)])
    wl = np.r_[np.full(3, m), np.zeros(3), np.zeros(4), np.full(6, m)]
    cases.append(("q_len 0 and window length 0", q, ql, genome_codes,
                  wl.astype(np.int32), (10, -1, -1)))
    q, ql = cut_queries(rs, genome_codes, np.full(40, 300))
    cases.append(("queries longer than their windows", q, ql, genome_codes,
                  rs.randint(1, 300, 40).astype(np.int32), (10, -1, -1)))
    lens = rs.randint(20, 150, size=40)
    q = np.full((40, 150), 4, np.int8)
    for r, n in enumerate(lens):
        q[r, :n] = genome_codes[m - n:]
        pos = rs.randint(0, n)
        q[r, pos] = (q[r, pos] + 1) % 4
    cases.append(("tail windows", q, lens.astype(np.int32), genome_codes,
                  lens.astype(np.int32), (10, -1, -1)))
    q, ql = cut_queries(rs, genome_codes, rs.randint(1, 300, size=48),
                        subst=0.1)
    cases.append(("penalties 5/-3/-2", q, ql, genome_codes,
                  np.full(48, m, np.int32), (5, -3, -2)))
    return cases


def sw_banded_cases(rs, genome_codes):
    """(name, queries, q_len, genome, d0, band, penalties) for phase 3:
    diagonals at the queries' own offsets, negative, 0, near m and wholly
    outside the genome."""
    import numpy as np

    m = len(genome_codes)
    cases = []
    for band, pen in ((1, (10, -1, -1)), (64, (10, -1, -1)),
                      (2048, (10, -1, -1)), (64, (5, -3, -2))):
        lens = rs.randint(100, 600, size=48)
        q = np.full((48, 600), 4, np.int8)
        d0 = np.zeros(48, np.int32)
        for r, n in enumerate(lens):
            start = rs.randint(0, m - n)
            q[r, :n] = genome_codes[start:start + n]
            flip = rs.rand(n) < 0.02
            q[r, :n][flip] = (q[r, :n][flip] + 1) % 4
            d0[r] = start + rs.randint(-band // 2 - 1, band // 2 + 2)
        d0[:8] = [-300, -band - 1, 0, m - 50, m - 1, m + band + 10,
                  -band - 700, 10 * m]
        cases.append((f"banded, band {band}, penalties {pen}", q, lens.astype(
            np.int32), genome_codes, d0, band, pen))
    return cases


def pair_cases(rs, main_codes, main_lens, dev):
    """(name, codes, lengths, ia, ib, match, mismatch) for phase 3 of the
    pair-list kernel; arrays are numpy, or device tensors where the case
    places them."""
    import numpy as np

    def pairs(u, n):
        return (rs.randint(0, u, n).astype(np.int32),
                rs.randint(0, u, n).astype(np.int32))

    cases = []
    c, cl = random_batch(rs, 400, 150, rs.choice(
        np.r_[[0, 1, 149, 150] * 20, np.arange(151)], size=400))
    cases.append(("ragged, lengths 0/1/L-1/L, W=150", c, cl,
                  *pairs(400, 50_000), 10, -1))
    c, cl = random_batch(rs, 64, 1023, rs.choice(
        np.r_[[0, 1, 1022, 1023] * 4, rs.randint(0, 1024, 48)], size=64))
    cases.append(("ragged, W=1023", c, cl, *pairs(64, 3000), 10, -1))
    c, cl = random_batch(rs, 300, 150)
    with_n(rs, c, cl)
    cases.append(("internal PAD", c, cl, *pairs(300, 30_000), 10, -1))
    c, cl = random_batch(rs, 200, 60)
    with_n(rs, c, cl)
    cases.append(("penalties 5/-4, W=60, internal PAD", c, cl,
                  *pairs(200, 20_000), 5, -4))
    c, cl = random_batch(rs, 100, 150)
    ia = np.r_[np.arange(100), [7] * 500, rs.randint(0, 100, 500)]
    ib = np.r_[np.arange(100), [9] * 500, [3] * 500]
    cases.append(("ia == ib and repeated pairs", c, cl, ia.astype(np.int32),
                  ib.astype(np.int32), 10, -1))
    c, cl = random_batch(rs, 150, 150)
    cases.append(("inputs at an odd address", at_odd_address(c, dev), cl,
                  *pairs(150, 10_000), 10, -1))
    cases.append(("main path reads, 100,000 random pairs", main_codes,
                  main_lens, *pairs(len(main_codes), 100_000), 10, -1))
    # runs of equal ia as the join emits them (1 to 118 pairs), across the
    # kernel's chunks of 32 pairs a warp
    c, cl = random_batch(rs, 4000, 150,
                         rs.choice([150] * 8 + [1, 33, 149], 4000))
    ia = np.repeat(np.arange(4000), rs.choice(
        [1, 2, 31, 32, 33, 64, 76, 118], 4000)).astype(np.int32)
    cases.append(("sorted runs across chunk boundaries", c, cl, ia,
                  rs.randint(0, 4000, len(ia)).astype(np.int32), 10, -1))
    c, cl = random_batch(rs, 300, 150, rs.randint(120, 151, 300))
    with_n(rs, c, cl, per_read=2)
    ia = np.repeat([1, 0, 3, 2, 5], 90).astype(np.int32)
    cases.append(("runs mixing clean reads and reads with an N", c, cl, ia,
                  rs.randint(0, 300, len(ia)).astype(np.int32), 10, -1))
    for w in (256, 257):
        c, cl = random_batch(rs, 200, w, rs.choice([0, 1, w - 33, w - 1, w],
                                                   200))
        with_n(rs, c[:60], cl[:60], per_read=2)
        ia = np.sort(rs.randint(0, 200, 20_000)).astype(np.int32)
        cases.append((f"W={w}, sorted", c, cl, ia,
                      rs.randint(0, 200, 20_000).astype(np.int32), 10, -1))
    return cases


def time_pairs(calls, reps: int) -> dict:
    """Time the pair-list kernels on recorded calls and hold their outputs
    on every pair against the plain version's. CUDA events over `reps`
    passes of the wrapper, of the launch entry alone (outputs, scratch, the
    pack kernel and the pair kernel) and of the wrapper's checks alone; the
    pack kernel and the pair kernel each alone in a profiler trace of
    `reps` more passes, with the launches of each the trace saw; the plain
    version's and the C++ engine's time on the same pairs; the comparisons
    and bytes of the bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import overlap as op

    outs = [op.overlap_scores_pairs(*a, **k) for a, k in calls]   # warm-up

    def checks(codes, lengths, ia, ib, match_score=10, mismatch=-1):
        op._check_pairs(codes, lengths, ia, ib, match_score, mismatch)

    def events_ms(fn) -> float:
        """Mean ms of one pass over the calls, CUDA events over `reps`."""
        for a, k in calls:
            fn(*a, **k)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            for a, k in calls:
                fn(*a, **k)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    ms = events_ms(op.overlap_scores_pairs)
    raw_ms, checks_ms = events_ms(op.launch), events_ms(checks)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for a, k in calls:
                op.overlap_scores_pairs(*a, **k)
        torch.cuda.synchronize()
    alone, traced = {}, {}
    for part in ("pack", "pairs"):
        mine = [e for e in prof.key_averages()
                if f"overlap_pairs_kernel_{part}" in e.key]
        us = sum(getattr(e, "device_time_total", 0) for e in mine) / reps
        alone[part] = us / 1e3 if us else None
        # launches the trace saw (reps x calls when it lost none)
        traced[part] = sum(e.count for e in mine)
    plain_ms, equal, err = 0.0, True, 0
    n_cmp = n_bytes = pairs = 0
    cpp_ms = 0.0
    for (args, kwargs), (s_k, e_k) in zip(calls, outs):
        codes, lengths, ia, ib = args
        torch.cuda.synchronize()
        t = time.perf_counter()
        s_p, e_p = op.overlap_scores_pairs_plain(*args, **kwargs)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t) * 1e3
        if s_k.numel():
            err = max(err, int((s_k - s_p).abs().max()),
                      int((e_k - e_p).abs().max()))
        equal = equal and torch.equal(s_k, s_p) and torch.equal(e_k, e_p)
        host = [x.cpu().numpy() for x in args]
        t = time.perf_counter()
        graphcore.overlap_nogap_pairs(*host, **kwargs)
        cpp_ms += (time.perf_counter() - t) * 1e3
        lens = host[1]
        n_cmp += pair_comparisons(lens[host[2]], lens[host[3]],
                                  codes.shape[1])
        # pairs in and outputs out at 8 B each, the reads and lengths once
        n_bytes += 16 * ia.numel() + codes.numel() + 4 * lengths.numel()
        pairs += ia.numel()
    ops_ms = OPS_PER_COMPARISON * n_cmp / PEAK_INT8_OPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {
        "pairs": pairs, "ms": ms, "raw_ms": raw_ms, "checks_ms": checks_ms,
        "alone_ms": alone, "traced": traced,
        "plain_ms": plain_ms, "cpp_ms": cpp_ms, "equal": equal,
        "max_abs_err": err, "comparisons": n_cmp, "bytes": n_bytes,
        "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def sw_equal(kernel_out, plain_out):
    """(equal, max abs err) over score, best_i, best_j, op streams and
    start_j of the kernel and the plain version."""
    import torch

    err = 0
    for a, b in zip(kernel_out, plain_out):
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return all(torch.equal(a, b) for a, b in zip(kernel_out, plain_out)), err


def shape_classes(kind: str, args):
    """A recorded call's items keyed by the JAX device path's shape class
    (length bucket, and window kind or band), as align_to_ref's host calls
    group them; returns (keys, lengths)."""
    import numpy as np

    from genome_assembly_tpu_torch.metrics.align_to_ref import _bucket

    queries, q_len, genome, per_item = args[:4]
    n = q_len.cpu().numpy()
    second = (per_item.cpu().numpy() == genome.numel() if kind == "full"
              else np.full(len(n), args[4]))
    return [(_bucket(int(a)), int(b)) for a, b in zip(n, second)], n


def run_plain(kind: str, args, kwargs, idx, n):
    """The plain version of a recorded call on the items `idx`, with the
    queries cut to their longest length."""
    import torch

    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    plain = sw.sw_full_width_plain if kind == "full" else sw.sw_banded_plain
    queries, q_len, genome, per_item = args[:4]
    sel = torch.tensor(idx, device=queries.device)
    width = int(n[idx].max()) or 1
    return plain(queries[sel, :width].contiguous(), q_len[sel], genome,
                 per_item[sel], *args[4:], **kwargs)


def check_calls(kind: str, calls, kernel_outs):
    """Hold the kernel's outputs on every item of the recorded calls
    against the plain version's: score, best_i, best_j, the op streams and
    start_j, exactly. The plain version runs in chunks of one shape class
    whose codes (one byte a cell) fit PLAIN_CODES_BUDGET, its outputs
    scattered back into item order. Returns (equal, max abs err)."""
    import torch

    from genome_assembly_tpu_torch.metrics import align_to_ref

    equal, err = True, 0
    for (args, kwargs), got in zip(calls, kernel_outs):
        keys, n = shape_classes(kind, args)
        cols = args[2].numel() + 1 if kind == "full" else 2 * args[4] + 1
        want = [torch.zeros_like(t) for t in got]
        for cls in align_to_ref._batches(keys, torch.device("cpu"),
                                         max(1, len(keys))):
            step = max(1, PLAIN_CODES_BUDGET
                       // (max(1, int(n[cls].max())) * cols))
            for lo in range(0, len(cls), step):
                idx = cls[lo:lo + step]
                sel = torch.tensor(idx, device=got[0].device)
                for w, o in zip(want, run_plain(kind, args, kwargs, idx, n)):
                    if w.dim() == 1:
                        w[sel] = o
                    else:
                        w[sel, :o.shape[1]] = o
        ok, e = sw_equal(got, want)
        equal, err = equal and ok, max(err, e)
    return equal, err


def time_sw(kind: str, calls, reps: int, sm_clock_hz: float,
            plain_subset: bool) -> dict:
    """Time one SW kernel on the recorded calls of a path and hold its
    outputs on every item against the plain version's (`check_calls`).

    The kernel: CUDA events over `reps` passes. The plain version: in the
    JAX device path's chunks (shape class, at most 128 items), every chunk;
    with `plain_subset`, the first chunk of each class of each call, its
    time scaled by the class's items over the chunk's. The C++ engine on
    the same items. With the DP cells, the bound and the design's code
    traffic."""
    from collections import Counter

    import numpy as np
    import torch

    from genome_assembly_tpu_torch.metrics import align_to_ref
    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    kernel = sw.sw_full_width if kind == "full" else sw.sw_banded
    dev = calls[0][0][0].device
    cells = n_bytes = code_written = items = 0
    for args, kwargs in calls:
        queries, q_len, genome, per_item = args[:4]
        n = q_len.cpu().numpy().astype(np.int64)
        B, n_pad = queries.shape
        items += B
        if kind == "full":
            w = per_item.cpu().numpy().astype(np.int64)
            cells += int((n * w).sum())
            strips = np.where((n > 0) & (w > 0), (n + 31) // 32, 0)
            code_written += int((strips * ((w + 46) // 16) * 128).sum())
            stride = n_pad + genome.numel()
        else:
            band = args[4]
            cells += int(n.sum()) * (2 * band + 1)
            strips = (n + 31) // 32
            code_written += int(strips.sum()) * ((2 * band + 78) // 16) * 128
            stride = 2 * n_pad + 2 * band + 1
        # each input read once (codes, genome, lengths), each output written
        # once (the op streams and four ints per item)
        n_bytes += B * n_pad + genome.numel() + 8 * B + B * stride + 16 * B

    def kernel_times():
        """CUDA events over `reps` passes of the calls (the wrappers' host
        planning and copies included), and the kernels' own device time in
        a profiler trace of one more pass (None: the trace held no device
        time for them)."""
        from torch.profiler import ProfilerActivity, profile

        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            for args, kwargs in calls:
                kernel(*args, **kwargs)
        stop.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for args, kwargs in calls:
                kernel(*args, **kwargs)
            torch.cuda.synchronize()
        # sw_kernel<banded, warps>: every instantiation of the kind
        name = "sw_kernel<false" if kind == "full" else "sw_kernel<true"
        device_us = sum(getattr(e, "device_time_total", 0)
                        for e in prof.key_averages() if name in e.key)
        # each launch's device time, in launch order
        per_launch = [round(e.time_range.elapsed_us() / 1e3, 4)
                      for e in prof.events() if name in e.name]
        return start.elapsed_time(stop) / reps, (
            device_us / 1e3 if device_us else None), per_launch

    # (items, band or None, most strips of an item, strips in all, mean
    # query length) of each call
    launch_shapes = [(a[0].shape[0], a[4] if kind != "full" else None,
                      int((a[1].max() + 31) // 32),
                      int(((a[1].long() + 31) // 32).sum()),
                      round(float(a[1].double().mean()), 2))
                     for a, _ in calls]
    torch.cuda.reset_peak_memory_stats(dev)
    outs = [kernel(*args, **kwargs) for args, kwargs in calls]  # warm-up
    code_read = 4 * sum(int((out[3] != 0).sum()) for out in outs)
    ms, kernel_only_ms, _ = kernel_times()
    peak = torch.cuda.max_memory_allocated(dev)
    # every block size the launch entries take, on the same calls: times,
    # and outputs equal to those at the wrapper's choice (which
    # `check_calls` holds against the plain version)
    by_warps = {}
    pick = sw._warps_per_item
    try:
        for warps in sw.WARPS_PER_ITEM:
            sw._warps_per_item = lambda strips, sms, w=warps: w
            same = all(sw_equal(kernel(*args, **kwargs), out)[0]
                       for (args, kwargs), out in zip(calls, outs))
            by_warps[warps] = (*kernel_times(), same)
    finally:
        sw._warps_per_item = pick

    plain_ms, plain_items = 0.0, 0
    for args, kwargs in calls:
        keys, n = shape_classes(kind, args)
        chunks = align_to_ref._batches(keys, torch.device("cpu"), 128)
        if plain_subset:
            per_class = Counter(keys)
            firsts: dict = {}
            for chunk in chunks:
                firsts.setdefault(keys[chunk[0]], chunk)
            todo = [(c, per_class[k] / len(c)) for k, c in firsts.items()]
        else:
            todo = [(c, 1.0) for c in chunks]
        for chunk, scale in todo:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_plain(kind, args, kwargs, chunk, n)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t) * 1e3 * scale
            plain_items += len(chunk)

    t = time.perf_counter()
    for args, kwargs in calls:
        queries, q_len, genome, per_item = (x.cpu().numpy()
                                            for x in args[:4])
        strings = ["".join("ACGTN"[c] for c in row[:k])
                   for row, k in zip(queries, q_len)]
        if kind == "full":
            graphcore.local_align_batch_suffix_windows(
                strings, genome, per_item, **kwargs)
        else:
            graphcore.local_align_banded_batch(strings, genome, per_item,
                                               args[4], **kwargs)
    cpp_ms = (time.perf_counter() - t) * 1e3

    equal, err = check_calls(kind, calls, outs)
    ops_ms = SW_OPS_PER_CELL * cells / (SMS * INT32_LANES * sm_clock_hz) \
        * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {
        "items": items, "cells": cells, "ms": ms,
        "gcups": cells / (ms * 1e-3) / 1e9,
        "ops_ms": ops_ms, "bytes": n_bytes, "bytes_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "code_bytes_written": code_written, "code_bytes_read": code_read,
        "peak": peak, "plain_ms": plain_ms, "plain_items": plain_items,
        "cpp_ms": cpp_ms, "kernel_only_ms": kernel_only_ms,
        "by_warps": by_warps, "launches": launch_shapes,
        "equal": equal and all(w[-1] for w in by_warps.values()),
        "max_abs_err": err,
    }


def sweep_params(genome: str) -> dict:
    """Phase 6a's config at phase 4's configuration, as the harness builds
    one."""
    return {"num_reads": NUM_READS, "read_length": READ_LENGTH,
            "error_prob": ERROR_PROB, "k": K, "reference_genome": genome,
            "expected_coverage": NUM_READS * READ_LENGTH / len(genome),
            "experiment_name": "sweep", "num_iterations": SWEEP_ITERATIONS,
            "contigs": None}


def csv_hashes(root: str) -> dict:
    """sha256 of every CSV under `root`, by its path relative to `root`."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".csv"):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root).replace(os.sep, "/")] = (
                        hashlib.sha256(f.read()).hexdigest())
    return out


def device_busy(trace: dict, span: str = "test_assembly"):
    """(span µs, device busy µs, µs by device event name) of a
    torch.profiler Chrome trace: busy is the union of the card's kernel,
    copy and memset intervals clipped to the first user annotation named
    `span`; the last maps each such event's name to its summed clipped
    time."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    marks = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"] == span]
    if not marks:
        raise ValueError(f"the trace holds no {span!r} annotation")
    t0, t1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    device = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1), e["name"])
              for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end, by_name = 0.0, t0, {}
    for a, b, name in sorted(device):
        by_name[name] = by_name.get(name, 0.0) + max(b - a, 0.0)
        if b > end:
            busy += b - max(a, end)
            end = b
    return t1 - t0, busy, by_name


def worker_ready() -> float:
    """Run in a spawned worker: import the port, open a CUDA context, load
    the kernel libraries and the C++ engine; the wall clock when done."""
    import torch

    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    torch.zeros(1, device="cuda")
    oa.load_kernel()
    sw.load_kernel()
    graphcore.load()
    return time.time()


def sweep_path(log, genome: str, card_line: str) -> bool:
    """Phase 6: the sweep runners, the harness, the process pool and the
    CLI on the card (see the module docstring); True when every check
    passed."""
    import copy
    import importlib.metadata
    import importlib.util
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from genome_assembly_tpu_torch.__main__ import quick_grids
    from genome_assembly_tpu_torch.experiments import harness, runner
    from genome_assembly_tpu_torch.ops import overlap as op
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    def reset_counts():
        oa.launches = op.launches = 0
        sw.full_width_launches = sw.banded_launches = 0

    t6 = time.perf_counter()
    dev = torch.device("cuda", 0)
    found = {m: (importlib.metadata.version(m)
                 if importlib.util.find_spec(m) else None)
             for m in ("pandas", "matplotlib", "joblib")}
    log(f"phase 6 host libraries here (version, null: absent): "
        f"{json.dumps(found)}")

    # ---- 6a: run_for_params, 3 iterations --------------------------------
    params = sweep_params(genome)
    iterations = []
    inner = runner.run_simulations

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        iterations.append((time.perf_counter() - t,
                           torch.cuda.memory_allocated(dev)))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    runner.run_simulations = timed
    reset_counts()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            agg = runner.run_for_params(
                params, path=tmp, rng=random.Random(SEED),
                np_rng=np.random.RandomState(SEED), device="cuda")
    finally:
        runner.run_simulations = inner
    launches = (oa.launches, sw.full_width_launches, sw.banded_launches)
    peak = torch.cuda.max_memory_allocated(dev)
    for i, (wall, mem) in enumerate(iterations, 1):
        log(f"phase 6a iteration {i}: {wall:.2f}s, memory allocated after "
            f"it {mem} B")
    log(f"phase 6a run_for_params: memory allocated before "
        f"{before} B, peak {peak} B; launches all-pairs {launches[0]}, SW "
        f"full width {launches[1]}, banded {launches[2]}")
    got = {k: v for k, v in agg.items()
           if k.endswith((" avg", " std", " raw"))}
    first = {m: agg[f"{m} raw"][0] for m in EXPECTED["measures"]}
    growth = iterations[-1][1] - iterations[0][1]
    if got != SWEEP_EXPECTED or any(agg[k] != v for k, v in params.items()):
        log(f"phase 6a FAILED: aggregate differs from the JAX package's:\n"
            f"  got      {got}\n  expected {SWEEP_EXPECTED}")
        return False
    if first != EXPECTED["measures"]:
        log(f"phase 6a FAILED: iteration 1 {first} != EXPECTED")
        return False
    if launches[:2] != (SWEEP_ITERATIONS, SWEEP_ITERATIONS):
        log("phase 6a FAILED: not one all-pairs and one full-width SW "
            "launch an iteration")
        return False
    if growth > SWEEP_MEMORY_SLACK:
        log(f"phase 6a FAILED: memory grew {growth} B from iteration 1 to "
            f"{len(iterations)}")
        return False
    log(f"phase 6a aggregate == JAX package's, iteration 1 == EXPECTED, "
        f"memory after iteration {len(iterations)} - after iteration 1 = "
        f"{growth} B")

    # ---- 6b: run_experiments on the --quick grids ------------------------
    reset_counts()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            CallRecorder(harness, "run_simulations_parallel") as sweeps:
        harness.run_experiments(
            file_path=GENOME, path_to_save_csvs=os.path.join(tmp, "results"),
            path_to_save_plots=os.path.join(tmp, "plots"), num_iterations=1,
            make_plots=False, grids=quick_grids(len(genome)),
            rng=random.Random(SEED), np_rng=np.random.RandomState(SEED),
            device="cuda")
        hashes = csv_hashes(os.path.join(tmp, "results"))
    configs = sum(len(args[0]) for args, _ in sweeps.calls)
    log(f"phase 6b run_experiments --quick: {time.perf_counter() - t:.2f}s, "
        f"{configs} configs, {len(hashes)} CSVs, launches all-pairs "
        f"{oa.launches}, SW full width {sw.full_width_launches}")
    if oa.launches < 1 or sw.full_width_launches < 1:
        log("phase 6b FAILED: the sweep did not launch both kernels")
        return False
    if hashes != QUICK_EXPECTED:
        bad = sorted(k for k in QUICK_EXPECTED.keys() | hashes.keys()
                     if hashes.get(k) != QUICK_EXPECTED.get(k))
        log(f"phase 6b FAILED: CSVs differ from the JAX package's: {bad}")
        return False
    log("phase 6b every CSV == JAX package's")

    # ---- 6c: run_simulations_parallel, 2 spawned workers -----------------
    exp1 = [p for args, _ in sweeps.calls[:2] for p in args[0]]
    rng0, np_rng0 = random.Random(SEED), np.random.RandomState(SEED)
    ctx = multiprocessing.get_context("spawn")
    t = time.time()
    with ProcessPoolExecutor(max_workers=2, mp_context=ctx) as pool:
        ready = [f.result() - t for f in
                 [pool.submit(worker_ready) for _ in range(2)]]
    log(f"phase 6c a spawned worker's start-up (import, CUDA context, "
        f"kernel libraries): {', '.join(f'{r:.2f}s' for r in ready)}")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        pooled = runner.run_simulations_parallel(
            exp1, path=tmp, n_jobs=2, rng=rng0, np_rng=np_rng0,
            device="cuda")
        pool_s = time.perf_counter() - t
        reset_counts()
        t = time.perf_counter()
        alone = [runner.run_for_params(
            p, path=tmp, rng=copy.deepcopy(rng0),
            np_rng=copy.deepcopy(np_rng0), device="cuda") for p in exp1]
        alone_s = time.perf_counter() - t
    log(f"phase 6c {len(exp1)} configs: pool of 2 {pool_s:.2f}s (workers' "
        f"launches are not counted here), sequential {alone_s:.2f}s "
        f"(launches all-pairs {oa.launches}, SW full width "
        f"{sw.full_width_launches})")
    if oa.launches < 1 or sw.full_width_launches < 1:
        log("phase 6c FAILED: the sequential runs did not launch both "
            "kernels")
        return False
    if pooled != alone:
        log("phase 6c FAILED: the pool's results differ from the sequential "
            "runs'")
        return False
    log("phase 6c pool == sequential runs from copies of the rngs")

    # ---- 6d: the CLI in subprocesses --------------------------------------
    cli = [sys.executable, "-m", "genome_assembly_tpu_torch"]
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        proc = subprocess.run(
            [*cli, "assemble", "--n", str(NUM_READS), "--l", str(READ_LENGTH),
             "--p", str(ERROR_PROB), "--k", str(K), "--seed", str(SEED),
             "--trace", "--profile", os.path.join(tmp, "trace"),
             "--plots", os.path.join(tmp, "plots")],
            capture_output=True, text=True, timeout=600)
        assemble_s = time.perf_counter() - t
        lines = proc.stdout.splitlines()
        want = [f"contigs: {EXPECTED['contigs']}"] + [
            f"{k}: {v}" for k, v in EXPECTED["measures"].items()]
        trace_path = os.path.join(tmp, "trace", "trace.json")
        trace_bytes = (os.path.getsize(trace_path)
                       if os.path.exists(trace_path) else None)
        log(f"phase 6d CLI assemble --profile: exit {proc.returncode}, "
            f"{assemble_s:.2f}s, trace {trace_bytes} B")
        for line in lines[len(want):]:
            if line.strip():
                log(f"phase 6d stage {line}")
        if proc.returncode != 0 or lines[:len(want)] != want:
            log(f"phase 6d FAILED: the CLI printed {lines[:len(want)]}, "
                f"expected {want}\n{proc.stderr[-4000:]}")
            return False
        if trace_bytes is None:
            log("phase 6d FAILED: the CLI wrote no trace.json")
            return False
        with open(trace_path) as f:
            span_us, busy_us, by_name = device_busy(json.load(f))
        traced = {k: any(k in name for name in by_name)
                  for k in ("overlap_allpairs_kernel", "sw_kernel<false")}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"phase 6d trace: test_assembly span {span_us / 1e6:.3f}s, device "
            f"busy (kernels, copies, memsets) {busy_us / 1e6:.4f}s, idle "
            f"share {1 - busy_us / span_us:.4f}; {len(by_name)} device "
            f"event names, named: {json.dumps(traced)}; most device time: "
            + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top)
            + f"; card {card_line}")
        if not all(traced.values()):
            log("phase 6d FAILED: the trace does not name both kernels")
            return False
        t = time.perf_counter()
        proc = subprocess.run(
            [*cli, "experiments", "--quick", "--iterations", "1",
             "--no-plots", "--results", os.path.join(tmp, "results"),
             "--plots", os.path.join(tmp, "plots")],
            capture_output=True, text=True, timeout=600)
        written = csv_hashes(os.path.join(tmp, "results"))
        log(f"phase 6d CLI experiments --quick --no-plots: exit "
            f"{proc.returncode}, {time.perf_counter() - t:.2f}s, "
            f"{len(written)} CSVs")
        if proc.returncode != 0 or written.keys() != QUICK_EXPECTED.keys():
            log(f"phase 6d FAILED: the sweep CLI\n{proc.stderr[-4000:]}")
            return False
    log(f"phase 6 sweep path passed: {time.perf_counter() - t6:.1f}s")
    return True


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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sm_clock_hz = float(clock.stdout.strip().splitlines()[0]) * 1e6
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
    from genome_assembly_tpu_torch.core.encoding import encode
    from genome_assembly_tpu_torch.graph import candidates
    from genome_assembly_tpu_torch.graph.build import (
        candidate_pairs_arrays,
        dedup_reads,
    )
    from genome_assembly_tpu_torch.metrics import align_to_ref
    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import overlap as op
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw
    from genome_assembly_tpu_torch.simulate import (
        generate_error_free_reads,
        generate_error_prone_reads,
        read_genome_from_fasta,
    )
    from genome_assembly_tpu_torch.utils.tracing import global_tracer

    dev = torch.device("cuda", 0)

    # ---- phase 2: build --------------------------------------------------
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = [pool.submit(oa.load_kernel), pool.submit(op.load_kernel),
                   pool.submit(sw.load_kernel), pool.submit(graphcore.load)]
        for f in futures:
            f.result()
    log(f"phase 2 build: nvcc overlap_allpairs "
        f"{_build.BUILD_SECONDS['overlap_allpairs']}s, nvcc overlap_pairs "
        f"{_build.BUILD_SECONDS['overlap_pairs']}s, nvcc smith_waterman "
        f"{_build.BUILD_SECONDS['smith_waterman']}s, g++ graphcore "
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

    def on_card(*arrays):
        return [x if torch.is_tensor(x)
                else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in arrays]

    pair_err = 0
    for name, c, cl, ia, ib, ms, mm in pair_cases(rs, main_codes, main_lens,
                                                   dev):
        args = on_card(c, cl, ia, ib)
        s_k, e_k = op.overlap_scores_pairs(*args, ms, mm)
        s_p, e_p = op.overlap_scores_pairs_plain(*args, ms, mm)
        torch.cuda.synchronize()
        err = max(int((s_k - s_p).abs().max()), int((e_k - e_p).abs().max()))
        pair_err = max(pair_err, err)
        if not (torch.equal(s_k, s_p) and torch.equal(e_k, e_p)):
            log(f"phase 3 FAILED: pair kernel != plain on {name} "
                f"(max abs err {err})")
            return 1
        log(f"phase 3 pair kernel == plain: {name} ({len(ia)} pairs)")

    sw_err = {"full": 0, "banded": 0}

    def check_sw(kind, name, args, kwargs) -> bool:
        if kind == "full":
            got = sw.sw_full_width(*args, **kwargs)
            want = sw.sw_full_width_plain(*args, **kwargs)
        else:
            got = sw.sw_banded(*args, **kwargs)
            want = sw.sw_banded_plain(*args, **kwargs)
        torch.cuda.synchronize()
        equal, err = sw_equal(got, want)
        sw_err[kind] = max(sw_err[kind], err)
        log(f"phase 3 SW {kind} kernel {'==' if equal else '!='} plain: "
            f"{name} (max abs err {err})")
        return equal

    phix_codes = encode(genome)
    lg = long_genome()
    lg_codes = encode(lg)
    for name, q, ql, g, wl, pen in sw_full_cases(rs, phix_codes):
        if not check_sw("full", name, on_card(q, ql, g, wl), dict(
                match_score=pen[0], mismatch=pen[1], indel=pen[2])):
            return 1
    for name, q, ql, g, d0, band, pen in sw_banded_cases(rs, lg_codes):
        if not check_sw("banded", name, (*on_card(q, ql, g, d0), band), dict(
                match_score=pen[0], mismatch=pen[1], indel=pen[2])):
            return 1

    # ---- phase 4: the main path ------------------------------------------
    tracer = global_tracer()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    oa.launches = op.launches = 0
    sw.full_width_launches = sw.banded_launches = 0
    t_main = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            CallRecorder(sw, "sw_full_width") as main_full_calls, \
            CallRecorder(sw, "_warps_per_item",
                         keep_results=True) as main_warps:
        contigs, measures, _, _ = test_assembly(
            genome, READ_LENGTH, NUM_READS, ERROR_PROB, K, "smoke", 1,
            path=tmp, rng=random.Random(SEED),
            np_rng=np.random.RandomState(SEED), device="cuda")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = oa.launches
    main_pair_launches = op.launches
    main_sw_launches = sw.full_width_launches
    main_peak = torch.cuda.max_memory_allocated(dev)
    stages = tracer.as_dict()
    got = {**contig_summary(contigs), "measures": measures}
    log(f"phase 4 main path: {main_s:.2f}s, U={len(unique)}, "
        f"pairs={stages['score.pairs']['items']}, "
        f"edges={stages['graph.remove_cycles']['items']}, "
        f"contigs={got['contigs']}, N50={got['n50']}, "
        f"total length={got['total_length']}, overlap kernel launches="
        f"{launches} (pair-list {main_pair_launches}), SW full-width "
        f"launches={main_sw_launches}, banded "
        f"{sw.banded_launches}, SW warps a block per launch="
        f"{main_warps.results}, peak device memory={main_peak} B")
    log(f"phase 4 measures: {json.dumps(measures)}")
    for line in tracer.report().splitlines():
        log(f"phase 4 stage {line}")
    if launches < 1 or main_sw_launches < 1:
        log("phase 4 FAILED: the main path did not launch both kernels")
        return 1
    if got != EXPECTED:
        log(f"phase 4 FAILED: result differs from the JAX package's:\n"
            f"  got      {json.dumps(got)}\n"
            f"  expected {json.dumps(EXPECTED)}")
        return 1
    log("phase 4 result == JAX package's")

    # ---- phase 4b: the long-genome path ---------------------------------
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    oa.launches = op.launches = 0
    sw.full_width_launches = sw.banded_launches = 0
    t_long = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            CallRecorder(sw, "sw_full_width") as long_full_calls, \
            CallRecorder(sw, "sw_banded") as long_banded_calls, \
            CallRecorder(sw, "_warps_per_item",
                         keep_results=True) as long_warps:
        long_contigs, long_measures, _, _ = test_assembly(
            lg, LONG["read_length"], LONG["num_reads"], LONG["error_prob"],
            LONG["k"], "long", 1, path=tmp,
            rng=random.Random(LONG["rng_seed"]),
            np_rng=np.random.RandomState(LONG["np_seed"]), device="cuda")
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t_long
    long_launches = {"overlap": oa.launches, "overlap_pairs": op.launches,
                     "full": sw.full_width_launches,
                     "banded": sw.banded_launches}
    long_peak = torch.cuda.max_memory_allocated(dev)
    long_got = {**contig_summary(long_contigs), "measures": long_measures}
    log(f"phase 4b long-genome path: {long_s:.2f}s, G={len(lg)}, "
        f"contigs={long_got['contigs']}, N50={long_got['n50']}, launches "
        f"{json.dumps(long_launches)}, banded calls "
        f"{len(long_banded_calls.calls)}, SW warps a block per launch (in "
        f"launch order, full width and banded)={long_warps.results}, peak "
        f"device memory={long_peak} B")
    log(f"phase 4b measures: {json.dumps(long_measures)}")
    for line in tracer.report().splitlines():
        log(f"phase 4b stage {line}")
    if long_launches["full"] < 1 or long_launches["banded"] < 1:
        log("phase 4b FAILED: the long-genome path did not launch both SW "
            "kernels")
        return 1
    if long_got != LONG_EXPECTED:
        log(f"phase 4b FAILED: result differs from the JAX package's:\n"
            f"  got      {json.dumps(long_got)}\n"
            f"  expected {json.dumps(LONG_EXPECTED)}")
        return 1
    log("phase 4b result == JAX package's")

    # ---- phase 4c: the long-genome path at N=90000, two rows -------------
    pair_calls, join_calls = [], []
    pair_launches = 0
    for row, kw in LONG90_ROWS:
        tracer.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        oa.launches = op.launches = 0
        sw.full_width_launches = sw.banded_launches = 0
        t_row = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, \
                CallRecorder(op, "overlap_scores_pairs") as row_pairs, \
                CallRecorder(candidates, "candidate_pairs_device") as row_join:
            row_contigs, row_measures, _, _ = test_assembly(
                lg, LONG90["read_length"], LONG90["num_reads"],
                LONG90["error_prob"], kw["k"], "long90", 1, path=tmp,
                rng=random.Random(LONG90["rng_seed"]),
                np_rng=np.random.RandomState(LONG90["np_seed"]),
                device="cuda", exact_parity=kw["exact_parity"])
        torch.cuda.synchronize()
        row_s = time.perf_counter() - t_row
        row_launches = {"overlap_pairs": op.launches,
                        "overlap_allpairs": oa.launches,
                        "device join": len(row_join.calls),
                        "full": sw.full_width_launches,
                        "banded": sw.banded_launches}
        row_peak = torch.cuda.max_memory_allocated(dev)
        row_got = {**contig_summary(row_contigs), "measures": row_measures}
        stages = tracer.as_dict()
        unique_count = (len(row_join.calls[0][0][0]) if row_join.calls
                        else None)
        log(f"phase 4c {row}: {row_s:.2f}s, G={len(lg)}, "
            f"N={LONG90['num_reads']}, U={unique_count}, "
            f"pairs={stages.get('score.pairs', {}).get('items')}, "
            f"contigs={row_got['contigs']}, N50={row_got['n50']}, launches "
            f"{json.dumps(row_launches)}, peak device memory={row_peak} B")
        log(f"phase 4c {row} measures: {json.dumps(row_measures)}")
        for line in tracer.report().splitlines():
            log(f"phase 4c {row} stage {line}")
        if (row_launches["overlap_pairs"] < 1
                or row_launches["device join"] < 1
                or row_launches["banded"] < 1):
            log(f"phase 4c FAILED: {row} did not run the pair kernel, the "
                f"device join and the banded SW kernel")
            return 1
        if row_got != LONG90_EXPECTED[row]:
            log(f"phase 4c FAILED: {row} differs from the JAX package's:\n"
                f"  got      {json.dumps(row_got)}\n"
                f"  expected {json.dumps(LONG90_EXPECTED[row])}")
            return 1
        log(f"phase 4c {row} result == JAX package's")
        pair_launches += row_launches["overlap_pairs"]
        pair_calls.append((row, row_pairs.calls))
        join_calls.append((row, row_join.calls))
        del row_contigs, row_measures

    # ---- phase 3 on the paths' own contigs --------------------------------
    _, main_full_window, _ = align_to_ref.split_contigs(
        contigs, genome, READ_LENGTH)
    q, ql = encode_batch(main_full_window[:64])
    if not check_sw("full", "64 main path contigs against the whole genome",
                    on_card(q, ql, phix_codes,
                            np.full(len(ql), len(genome), np.int32)), {}):
        return 1
    _, long_full_window, _ = align_to_ref.split_contigs(
        long_contigs, lg, LONG["read_length"])
    plan = align_to_ref._banded_plan(long_full_window[:64], lg, 64, 15, [])
    for band in sorted({bb for _, _, bb, _ in plan}):
        sel = [(c, d0) for c, d0, bb, _ in plan if bb == band]
        q, ql = encode_batch([c for c, _ in sel])
        d0 = np.array([d for _, d in sel], np.int32)
        if not check_sw("banded", f"{len(sel)} long-path contigs at their "
                        f"seeded centre, band {band}",
                        (*on_card(q, ql, lg_codes, d0), band), {}):
            return 1
    # every item of the long path's full-width calls (its banded calls and
    # the main path's full-width call: phase 5, which times them)
    equal, err = check_calls(
        "full", long_full_calls.calls,
        [sw.sw_full_width(*a, **k) for a, k in long_full_calls.calls])
    sw_err["full"] = max(sw_err["full"], err)
    log(f"phase 3 SW full kernel {'==' if equal else '!='} plain on every "
        f"item of the long path's {len(long_full_calls.calls)} full-width "
        f"call(s) (max abs err {err})")
    if not equal:
        return 1

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

    kernels = [{
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
    }]

    # ---- phase 5: the SW kernels at their paths' own items ---------------
    sw_paths = (
        ("full", "sw_full_width", main_full_calls.calls, main_sw_launches,
         SW_FULL_REPLACES, "PhiX main path"),
        ("banded", "sw_banded", long_banded_calls.calls,
         long_launches["banded"], SW_BANDED_REPLACES,
         "long-genome path"),
    )
    for kind, name, calls, n_launch, replaces, path in sw_paths:
        # the plain banded version takes 30-60 s over all 23,028 items in
        # the JAX chunks, so its time there comes from a subset
        timing = time_sw(kind, calls, reps=3, sm_clock_hz=sm_clock_hz,
                         plain_subset=kind == "banded")
        sw_err[kind] = max(sw_err[kind], timing["max_abs_err"])
        log(f"phase 5 SW {kind} kernel {'==' if timing['equal'] else '!='} "
            f"plain on every item of the {path}'s {len(calls)} call(s) "
            f"(max abs err {timing['max_abs_err']})")
        if not timing["equal"]:
            return 1
        plain_how = ("every chunk" if kind == "full" else
                     f"the first chunk of each class of each call, "
                     f"{timing['plain_items']} of {timing['items']} items, "
                     f"each scaled by its class's items")
        log(f"phase 5 {name} on the {path}'s {timing['items']} items in "
            f"{len(calls)} call(s): {timing['ms']:.3f} ms (mean of 3, CUDA "
            f"events around the wrapper calls); {timing['cells']} DP cells, "
            f"{timing['gcups']:.1f} GCUPS; the kernels alone (profiler) "
            f"{timing['kernel_only_ms'] or 'not measured'} ms; bound "
            f"{timing['bound_ms']:.3f} ms "
            f"by {timing['bound_by']} ({SW_OPS_PER_CELL} int ops a cell at "
            f"{SMS} SMs x {INT32_LANES} lanes x {sm_clock_hz / 1e6:.0f} MHz "
            f"-> {timing['ops_ms']:.3f} ms; {timing['bytes']} B -> "
            f"{timing['bytes_ms']:.4f} ms); kernel at "
            f"{timing['bound_ms'] / timing['ms']:.3f} of its bound; design's "
            f"code traffic {timing['code_bytes_written']} B written, "
            f"{timing['code_bytes_read']} B read by the walks; peak device "
            f"memory {timing['peak']} B; plain version "
            f"{timing['plain_ms']:.1f} ms (in the JAX device path's chunks: "
            f"shape classes, at most 128 items; timed over {plain_how}); "
            f"C++ engine on the host "
            f"{timing['cpp_ms']:.1f} ms ({graphcore._n_threads()} threads); "
            f"card {card_line}")
        log(f"phase 5 {name} calls (items, band, most strips an item, "
            f"strips in all, mean query length): "
            f"{timing['launches']}")
        for warps, (w_ms, w_alone, per_launch, same) in \
                timing["by_warps"].items():
            log(f"phase 5 {name} at W={warps} warps an item on the same "
                f"calls: {w_ms:.3f} ms (mean of 3, CUDA events), the "
                f"kernels alone {w_alone or 'not measured'} ms, "
                f"{timing['cells'] / (w_alone or w_ms) / 1e6:.1f} GCUPS, "
                f"per launch {per_launch} ms; outputs "
                f"{'==' if same else '!='} those at the wrapper's choice; "
                f"card {card_line}")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SW_SOURCE,
            "replaces": replaces,
            "launches": n_launch,
            "max_abs_err": sw_err[kind],
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,
        })
    # ---- phase 5: the pair-list kernel at phase 4c's calls ----------------
    pair_total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
                  "bytes_ms": 0.0}
    for row, calls in pair_calls:
        timing = time_pairs(calls, reps=3)
        pair_err = max(pair_err, timing["max_abs_err"])
        log(f"phase 5 pair kernel {'==' if timing['equal'] else '!='} plain "
            f"on every pair of {row}'s {len(calls)} call(s), "
            f"{timing['pairs']} pairs (max abs err {timing['max_abs_err']})")
        if not timing["equal"]:
            return 1
        alone = ", ".join(
            f"the {part} kernel {timing['alone_ms'][part] or 'not measured'}"
            f" ms ({timing['traced'][part]} of {3 * len(calls)} launches in "
            f"the trace)" for part in ("pack", "pairs"))
        log(f"phase 5 overlap_pairs on {row}: {timing['ms']:.3f} ms (mean of "
            f"3, CUDA events around the wrapper calls; the launch entry "
            f"alone {timing['raw_ms']:.3f} ms, the wrapper's checks alone "
            f"{timing['checks_ms']:.3f} ms); alone in a profiler trace "
            f"(mean of 3): {alone}; bound "
            f"{timing['bound_ms']:.4f} ms by {timing['bound_by']} "
            f"({timing['comparisons']} comparisons x {OPS_PER_COMPARISON} "
            f"int8 ops -> {timing['ops_ms']:.4f} ms; {timing['bytes']} B -> "
            f"{timing['bytes_ms']:.4f} ms); kernel at "
            f"{timing['bound_ms'] / timing['ms']:.3f} of its bound; plain "
            f"version {timing['plain_ms']:.1f} ms (every pair, chunks of "
            f"{op.PLAIN_CELLS} cells); C++ engine on the host "
            f"{timing['cpp_ms']:.1f} ms ({graphcore._n_threads()} threads); "
            f"library call: none; card {card_line}")
        for key in pair_total:
            pair_total[key] += timing[key]
    for row, calls in join_calls:
        for args, kwargs in calls:
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                candidates.candidate_pairs_device(*args, **kwargs)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            log(f"phase 5 device k-mer join on {row}: U={len(args[0])}, "
                f"k={args[1]}: {sum(times) / 3:.1f} ms (mean of 3, host "
                f"clock: encoding on the host, join on the card, pairs back "
                f"to the host); card {card_line}")

    # the pair kernel on PhiX's candidate pairs, beside the all-pairs kernel
    ia_x, ib_x = candidate_pairs_arrays(unique, K, device=dev)
    ia_d = torch.from_numpy(ia_x).to(dev)
    ib_d = torch.from_numpy(ib_x).to(dev)
    s_pair, e_pair = op.overlap_scores_pairs(codes, lens, ia_d, ib_d)
    s_mat, e_mat = oa.overlap_scores_all_pairs(codes, lens)
    torch.cuda.synchronize()
    same = (torch.equal(s_pair, s_mat[ia_d.long(), ib_d.long()])
            and torch.equal(e_pair, e_mat[ia_d.long(), ib_d.long()]))
    del s_mat, e_mat
    reps = 5
    phix_ms = {}
    for name, fn in (("wrapper", op.overlap_scores_pairs),
                     ("launch entry", op.launch)):
        start.record()
        for _ in range(reps):
            fn(codes, lens, ia_d, ib_d)
        stop.record()
        torch.cuda.synchronize()
        phix_ms[name] = start.elapsed_time(stop) / reps
    phix_cmp = pair_comparisons(main_lens[ia_x], main_lens[ib_x], L)
    log(f"phase 5 overlap_pairs on PhiX's {len(ia_x)} candidate pairs "
        f"(U={na}, L={L}): {phix_ms['wrapper']:.3f} ms (mean of {reps}, CUDA "
        f"events; the launch entry alone {phix_ms['launch entry']:.3f} ms), "
        f"against the all-pairs kernel's {kernel_ms:.3f} ms for "
        f"all {na}x{na} pairs; {phix_cmp} comparisons -> "
        f"{OPS_PER_COMPARISON * phix_cmp / PEAK_INT8_OPS * 1e3:.4f} ms at "
        f"the int8 peak; scores and ends "
        f"{'==' if same else '!='} the all-pairs kernel's gathered; card "
        f"{card_line}")
    if not same:
        log("phase 5 FAILED: the pair kernel and the all-pairs kernel "
            "disagree on PhiX's candidate pairs")
        return 1
    kernels.insert(1, {
        "name": "overlap_pairs",
        "route": "cuda",
        "source": PAIRS_SOURCE,
        "replaces": PAIRS_REPLACES,
        "launches": pair_launches,
        "max_abs_err": pair_err,
        "ms": pair_total["ms"],
        "plain_ms": pair_total["plain_ms"],
        "bound_ms": pair_total["bound_ms"],
        "bound_by": ("operations" if pair_total["ops_ms"]
                     >= pair_total["bytes_ms"] else "bytes"),
        "library_ms": None,
    })
    if not sweep_path(log, genome, card_line):
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"all phases passed; wall {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
