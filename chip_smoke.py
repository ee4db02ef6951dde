#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with the elapsed seconds as it ends:

1. device: a CUDA card must be present (exit 1 otherwise); prints the
   card's name and power limit as nvidia-smi gives them;
2. build: compiles the all-pairs and the pair-list overlap kernels, the
   two Smith-Waterman kernels and the sequence-parallel SW's kernel (nvcc,
   sm_90a, one call per source) and the C++ graph engine (g++) from the
   sources in this checkout, all in parallel, beside a cubin of the
   sequence-parallel kernel whose ``nvcc -Xptxas -v`` registers, spills
   and stack it prints;
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
   Prints which of pandas, matplotlib and joblib are installed here;
7. the string-graph and unitig pipelines, on the card: 7a
   ``test_assembly_new_pipeline`` at bench.py's workload (PhiX, N=1000,
   l=100, p=0.01, fuzz=5, seed 0), its contigs and measures equal to the
   JAX package's (NEW_PIPELINE_EXPECTED), the all-pairs and the
   full-width SW kernel launched, each kernel's outputs on the path's own
   inputs (the all-pairs kernel on the unique reads, diagonal included;
   the SW kernel on every contig) equal to its plain version's, its stage
   walls, peak memory and the max-plus reduction's time alone; 7b the unitig pipeline on 7a's first
   400 reads, equal to the JAX package's (UNITIG_EXPECTED), and on all
   1,000, equal to the port's run on the CPU; 7c ``score_pairs`` on reads
   with an N (N against N included) below 200,000 pairs equal to the C++
   scorer with no launch, at or above it equal to the plain all-pairs
   (dense) and pair-list (sparse) versions, and N-free reads on both
   kernels, the all-pairs route with self-pairs; 7d ``overlap_align_full``
   on the card equal to its CPU run and the C++ full DP at indel -2, -1
   and -2**25, and the device samplers held to their contract, each timed;
8. the parallel layer (``genome_assembly_tpu_torch/parallel``): one world
   of 8 ranks spawned on the card with gloo (the kernels built first), as
   the JAX README's make_mesh(8), and one of 1 rank on NCCL. 8a
   ``sharded_pipeline_step`` at the README's size (PhiX, l=100, N=8192,
   p=0.01, mesh 8), equal to the plain all-pairs version on the reads
   rebuilt by its generator rule and to their coverage; 8b
   ``sharded_pipeline_step_reads`` on those reads at meshes 1, 2, 4 and 8,
   bit-identical and equal to one all-pairs launch; 8c
   ``all_pairs_block_scores_2d`` at 2x2 and 2x4; 8d
   ``distributed_assemble_contigs`` on phase 4's reads at meshes 1 and 8,
   equal to phase 4's contigs, with the host layout timed apart; 8e
   ``pipelined_candidates_score`` on a 2-rank stage mesh, equal to the
   unpipelined composition and the plain pair-list version; 8f both seqpar
   variants at meshes 4 and 8 on the long genome against 64 of phase 4b's
   contigs, through the seqpar kernel on every member rank (two launches a
   DP row per-row, one a step pipelined), equal to the row scan on the
   replicated genome (each rank's code slice by fingerprint) and to the
   full-width SW kernel, the kernel's first and last step and row on every
   member rank held against the plain steps on copies of their inputs
   (exact; *pre* by its totals, its `run` being the kernel's scratch), and
   the seqpar traceback on 8 items; it prints the kernel's launch geometry
   at each 8f width (segments, cluster, blocks, shared memory, resident or
   tiled, the clusters that fit at once). The NCCL world repeats 8b and 8c
   at mesh 1 and 8f on one rank, where each variant must launch the kernel
   exactly n_blocks or 2 n_pad times a call and put at most 8 n_blocks + 32
   or 12 n_pad + 32 operations on the card, and times the kernel (a launch
   and a call by CUDA events, a call in a profiler trace), the plain steps
   and the full-width SW kernel on the same items, and splits one more
   call's host time between the wrappers, the exchanges and the rest.
   Each step prints its wall, each rank's peak device memory, the kernels'
   launches and the collectives;
9. the port's drivers, on the card: 9a ``bench_torch.run`` at its full
   size (PhiX, N=1000, l=100, 20 copies, 50 rounds), its JSON line printed,
   the kernel held to the plain version on copy 0 and launched once a
   sweep; 9b one ``ops.overlap_scores`` call (16,384 sampled pairs of
   those reads, ragged, with N) held to its plain version on the CPU; 9c
   ``scripts/dense_demo_torch.py``'s rows at C = 10 and 30, equal to the
   JAX package's (its EXPECTED); 9d ``scripts/long_genome_demo_torch.py``'s
   "fast, k=5" row (banded metrics, the 256-contig banded check all
   identical) equal to the JAX package's. Each path's launches are counted
   from 0 and must be non-zero.

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

# Phase 7a: test_assembly_new_pipeline (the string-graph pipeline) at
# bench.py's workload and BASELINE.json's config: PhiX, N = 1000, l = 100,
# p = 0.01, fuzz = 5 (its k slot in the measures), seed 0; what the JAX
# package returns there (recorded on the CPU;
# tests/test_torch_new_pipeline_smoke.py re-runs the JAX package and asserts
# these values).
NEW_PIPELINE = {"read_length": 100, "num_reads": 1000, "error_prob": 0.01,
                "fuzz": 5, "seed": 0}
NEW_PIPELINE_EXPECTED = {
    "contigs": 985,
    "n50": 100,
    "total_length": 97702,
    "sha256":
        "857b592d976dd8d3c484a49dc6ac74febde3e47d21991e019884104a79fc6ec3",
    "measures": {
        "Number of Contigs": 985,
        "Genome Coverage": 1.0,
        "N50": 100,
        "Mismatch Rate Aligned Regions": 0.22298551800965466,
        "Mismatch Rate Genome Level": 0.22298551800965466,
    },
}
# Phase 7b: models.unitig.assemble_contigs on the first UNITIG_READS of 7a's
# reads; the JAX package's unitigs (recorded on the CPU;
# tests/test_torch_unitig_smoke.py re-runs the JAX package).
UNITIG_READS = 400
UNITIG_EXPECTED = {
    "contigs": 15,
    "n50": 572,
    "total_length": 5222,
    "sha256":
        "0c38ea40332b9d3bd148ea07b9cac10efa5dc5de586f547e0b9f1653722fffaf",
}
# Phase 7c: the pair counts of its calls, on either side of the JAX
# package's pair threshold (core/dispatch.py MIN_DEVICE_PAIRS = 200,000).
SPARSE_UNIQUE = 17_000         # past graph/build.py DENSE_MAX_U = 16,384

KERNEL_SOURCE = "genome_assembly_tpu_torch/csrc/overlap_allpairs.cu"
KERNEL_REPLACES = "genome_assembly_tpu/ops/overlap_allpairs.py:312"
PAIRS_SOURCE = "genome_assembly_tpu_torch/csrc/overlap_pairs.cu"
# an XLA program of the JAX package (not a Pallas kernel)
PAIRS_REPLACES = "genome_assembly_tpu/ops/overlap.py:71"
SW_SOURCE = "genome_assembly_tpu_torch/csrc/smith_waterman.cu"
# XLA programs of the JAX package (not Pallas kernels)
SW_FULL_REPLACES = "genome_assembly_tpu/ops/smith_waterman.py:157"
SW_BANDED_REPLACES = "genome_assembly_tpu/ops/smith_waterman.py:176"
SEQPAR_SOURCE = "genome_assembly_tpu_torch/csrc/seqpar.cu"
# the per-device bodies of the JAX package's sequence-parallel SW (XLA
# scans under shard_map, not Pallas kernels)
SEQPAR_STEP_REPLACES = "genome_assembly_tpu/parallel/seqpar.py:193"
SEQPAR_ROW_REPLACES = "genome_assembly_tpu/parallel/seqpar.py:49"
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
    from genome_assembly_tpu_torch.metrics.measures import (
        contig_summary as summary,
    )

    return summary(contigs)


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
    from genome_assembly_tpu_torch.ops.overlap_allpairs import (
        OPS_PER_COMPARISON,
    )

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


def internal_n_reads(rs, count: int, l: int, genome_len: int,
                     with_n: bool = True) -> list[str]:
    """`count` distinct reads of 30 to `l` bases from a random genome of
    `genome_len` bases; with `with_n`, every 50th genome base is an N, so
    reads that overlap there put N against N."""
    import numpy as np

    chars = np.array(list("ACGT"))[rs.randint(0, 4, size=genome_len)]
    if with_n:
        chars[::50] = "N"
    g = "".join(chars)
    reads: dict[str, None] = {}
    while len(reads) < count:
        start = rs.randint(0, genome_len - l)
        reads.setdefault(g[start:start + rs.randint(30, l + 1)])
    return list(reads)


# The reference's substitution alphabet (generateErrorProneReads.py): the
# alternatives of each base, in the order a drawn index 0..2 picks them.
ALTERNATIVES = {"A": "CGT", "C": "AGT", "G": "ACT", "T": "ACG"}


def sampler_contract(sample, inject, genome_codes, l: int, n: int,
                     p: float, seed: int):
    """Phase 7d's checks of the device samplers on genome_codes' device:
    lengths == min(l, G - start) with the starts redrawn from the seed,
    each read equal to its genome window, PAD past each length, positions
    past a length never mutated, every mutation the alternative that
    ALTERNATIVES gives for its base and the redrawn index, and one seed one
    output. Returns a list of the checks that failed."""
    import torch

    dev = genome_codes.device
    gen = torch.Generator(device=dev)
    g = genome_codes.shape[0]
    reads, lengths = sample(gen.manual_seed(seed), genome_codes, l, n)
    starts = torch.randint(0, g, (n,), generator=gen.manual_seed(seed),
                           device=dev)
    pos = torch.arange(l, device=dev)[None, :]
    inside = pos < lengths[:, None]
    window = genome_codes[(starts[:, None] + pos).clamp(max=g - 1)]
    mutated = inject(gen.manual_seed(seed + 1), reads, lengths, p)
    u = torch.rand(reads.shape, generator=gen.manual_seed(seed + 1),
                   device=dev)
    idx = torch.randint(0, 3, reads.shape, generator=gen, device=dev,
                        dtype=torch.int8)
    table = torch.tensor([["ACGT".index(c) for c in ALTERNATIVES[b]]
                          for b in "ACGT"], dtype=torch.int8, device=dev)
    alt = table[reads.long().clamp(max=3), idx.long()]
    want = torch.where((u <= p) & inside, alt, reads)
    reads_again, lengths_again = sample(gen.manual_seed(seed), genome_codes,
                                        l, n)
    again = inject(gen.manual_seed(seed + 1), reads_again, lengths_again, p)
    changed = mutated != reads
    checks = {
        "lengths == min(l, G - start)":
            torch.equal(lengths.long(), torch.clamp(g - starts, max=l)),
        "reads == genome windows":
            bool(torch.where(inside, reads == window, reads == 4).all()),
        "PAD never mutates": bool((mutated[~inside] == 4).all()),
        "alternative-base order": torch.equal(mutated, want),
        "mutations change the base": bool(
            (changed == ((u <= p) & inside)).all()),
        "one seed, one output": torch.equal(again, mutated),
    }
    return [name for name, ok in checks.items() if not ok]


def new_pipelines(log, genome: str, card_line: str, sm_clock_hz: float,
                  device="cuda"):
    """Phase 7: the string-graph and unitig pipelines, the internal-N
    routes of score_pairs, the gapped overlap DP and the device samplers,
    on the card (`device`). Bounds: int32 operations at 132 SMs x 64 lanes
    x `sm_clock_hz`, bytes at PEAK_BYTES_PER_S. Returns the max abs err of
    7a's checks of the all-pairs and the full-width SW kernel against their
    plain versions, by kernel name, or None at the first failure
    (logged)."""
    import numpy as np
    import torch

    from genome_assembly_tpu_torch.core.encoding import encode, encode_batch
    from genome_assembly_tpu_torch.experiments.runner import (
        test_assembly_new_pipeline,
    )
    from genome_assembly_tpu_torch.graph.build import score_pairs
    from genome_assembly_tpu_torch.models import string_graph, unitig
    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import overlap as op
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw
    from genome_assembly_tpu_torch.simulate import (
        inject_errors_device,
        sample_reads_device,
    )
    from genome_assembly_tpu_torch.utils.tracing import global_tracer

    dev = torch.device(device)
    tracer = global_tracer()
    t7 = time.perf_counter()

    def zero_counts():
        tracer.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        oa.launches = op.launches = 0
        sw.full_width_launches = sw.banded_launches = 0

    def event_ms(fn, reps=3):
        """Mean ms of `reps` calls of fn() between two CUDA events, after
        one call that warms up."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def stage_walls(names):
        times = tracer.as_dict()
        return ", ".join(f"{label} {times[name]['seconds']:.3f}s"
                         if name in times else f"{label} not run"
                         for label, name in names)

    # ---- 7a: the string-graph pipeline --------------------------------------
    cfg = NEW_PIPELINE
    zero_counts()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            CallRecorder(oa, "overlap_scores_all_pairs") as pair_calls, \
            CallRecorder(sw, "sw_full_width") as full_calls:
        contigs, measures, _, reads = test_assembly_new_pipeline(
            genome, cfg["read_length"], cfg["num_reads"], "new_pipeline", 1,
            tmp, cfg["error_prob"], cfg["fuzz"],
            rng=random.Random(cfg["seed"]),
            np_rng=np.random.RandomState(cfg["seed"]), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"overlap_allpairs": oa.launches, "overlap_pairs": op.launches,
              "sw_full_width": sw.full_width_launches,
              "sw_banded": sw.banded_launches}
    peak = torch.cuda.max_memory_allocated(dev)
    stages = tracer.as_dict()
    got = {**contig_summary(contigs), "measures": measures}
    log(f"phase 7a string-graph pipeline (PhiX, N={cfg['num_reads']}, "
        f"l={cfg['read_length']}, p={cfg['error_prob']}, fuzz={cfg['fuzz']}, "
        f"seed {cfg['seed']}): {wall:.2f}s, "
        f"pairs={stages['score.pairs']['items']}, "
        f"edges={stages['graph.transitive_reduction']['items']}, "
        f"contigs={got['contigs']}, N50={got['n50']}, launches "
        f"{json.dumps(counts)}, peak device memory={peak} B; stage walls: "
        + stage_walls([("build", "graph.build"),
                       ("of it scoring", "score.pairs"),
                       ("reduction", "graph.transitive_reduction"),
                       ("walk", "graph.walk_contigs"),
                       ("metrics", "metrics.calculate")])
        + f"; card {card_line}")
    for line in tracer.report().splitlines():
        log(f"phase 7a stage {line}")
    if counts["overlap_allpairs"] < 1 or counts["sw_full_width"] < 1:
        log("phase 7a FAILED: the pipeline did not launch the all-pairs and "
            "the full-width SW kernel")
        return None
    if got != NEW_PIPELINE_EXPECTED:
        log(f"phase 7a FAILED: result differs from the JAX package's:\n"
            f"  got      {json.dumps(got)}\n"
            f"  expected {json.dumps(NEW_PIPELINE_EXPECTED)}")
        return None
    log("phase 7a result == JAX package's")
    # the path's two kernels on its own inputs against their plain versions,
    # exactly (these launches come after the counts were read)
    errs = {"overlap_allpairs": 0, "sw_full_width": 0}
    for args, kwargs in pair_calls.calls:
        codes, lengths = args
        got = oa.overlap_scores_all_pairs(codes, lengths, **kwargs)
        want = oa.overlap_scores_block_plain(codes, lengths, codes, lengths,
                                             **kwargs)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        errs["overlap_allpairs"] = max(errs["overlap_allpairs"], err)
        log(f"phase 7a all-pairs kernel {'==' if equal else '!='} plain on "
            f"the path's {codes.shape[0]} unique reads, L={codes.shape[1]}, "
            f"all {codes.shape[0] ** 2} pairs, diagonal included (max abs "
            f"err {err})")
        if not equal:
            return None
    equal, err = check_calls(
        "full", full_calls.calls,
        [sw.sw_full_width(*a, **k) for a, k in full_calls.calls])
    errs["sw_full_width"] = err
    log(f"phase 7a SW full kernel {'==' if equal else '!='} plain on every "
        f"item of the path's {len(full_calls.calls)} full-width call(s), "
        f"{sum(a[1].numel() for a, _ in full_calls.calls)} contigs (max abs "
        f"err {err})")
    if not equal:
        return None
    # the reduction alone on the card, on the same base pairs
    g = string_graph.build_string_graph(reads, device=dev)
    base = g.base_array()
    bu, bv = base[g.src].astype(np.int64), base[g.dst].astype(np.int64)
    _, first = np.unique(bu * g.num_unique + bv, return_index=True)
    args = (g.num_unique, bu[first], bv[first], g.weight[first], dev)
    reduce_ms = event_ms(lambda: string_graph.reduced_base_pairs(*args))
    int_ops_per_s = SMS * INT32_LANES * sm_clock_hz
    # an add and a max for each (v, w, x): 2 U^3 integer operations
    reduce_bound = 2 * g.num_unique ** 3 / int_ops_per_s * 1e3
    log(f"phase 7a max-plus reduction alone at U={g.num_unique}, "
        f"{len(first)} base pairs: {reduce_ms:.3f} ms (mean of 3, CUDA "
        f"events, the host-to-card copies included); bound {reduce_bound:.4f}"
        f" ms by operations (2 U^3 int ops); card {card_line}")
    del g

    # ---- 7b: the unitig pipeline -----------------------------------------
    zero_counts()
    t = time.perf_counter()
    unitigs = unitig.assemble_contigs(reads[:UNITIG_READS], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = contig_summary(unitigs)
    log(f"phase 7b unitigs of {UNITIG_READS} reads on the card: {wall:.2f}s, "
        f"unitigs={got['contigs']}, N50={got['n50']}, all-pairs launches "
        f"{oa.launches}; stage walls: "
        + stage_walls([("build", "graph.build"),
                       ("reduction", "graph.transitive_reduction"),
                       ("unitigs", "graph.unitigs")]))
    if oa.launches < 1:
        log("phase 7b FAILED: the unitig pipeline did not launch the "
            "all-pairs kernel")
        return None
    if got != UNITIG_EXPECTED:
        log(f"phase 7b FAILED: unitigs differ from the JAX package's:\n"
            f"  got      {json.dumps(got)}\n"
            f"  expected {json.dumps(UNITIG_EXPECTED)}")
        return None
    log(f"phase 7b {UNITIG_READS} reads: unitigs == JAX package's")
    zero_counts()
    t = time.perf_counter()
    on_card = unitig.assemble_contigs(reads, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    card_walls = stage_walls([("build", "graph.build"),
                              ("of it scoring", "score.pairs"),
                              ("reduction", "graph.transitive_reduction"),
                              ("unitigs", "graph.unitigs")])
    launched = oa.launches
    peak = torch.cuda.max_memory_allocated(dev)
    t = time.perf_counter()
    on_cpu = unitig.assemble_contigs(reads, device="cpu")
    cpu_s = time.perf_counter() - t
    log(f"phase 7b unitigs of all {len(reads)} reads: on the card "
        f"{card_s:.2f}s ({card_walls}; all-pairs launches {launched}, peak "
        f"device memory={peak} B), the port on the CPU {cpu_s:.2f}s; "
        f"{len(on_card)} unitigs; card {card_line}")
    if launched < 1 or on_card != on_cpu:
        log("phase 7b FAILED: the card's unitigs differ from the CPU run's "
            "or the all-pairs kernel did not launch")
        return None
    log("phase 7b all reads: card == CPU run")

    # ---- 7c: reads with an N around the pair threshold --------------------
    rs = np.random.RandomState(77)

    def routed(name, unique, ia, ib, want_route, want_counts, reference):
        zero_counts()
        s, e = score_pairs(unique, (ia, ib), device=dev)
        torch.cuda.synchronize()
        route = [r for r in ("host", "allpairs", "pairlist")
                 if f"score.pairs.{r}" in tracer.times]
        counts = (oa.launches, op.launches)
        left, lens = encode_batch(unique, align="left")
        cpp = graphcore.overlap_nogap_pairs(left, lens, ia, ib)
        ref = reference(left, lens, ia, ib)
        diff = int((s != cpp[0]).sum() + (e != cpp[1]).sum())
        ok = (route == [want_route] and counts == want_counts
              and np.array_equal(s, ref[0]) and np.array_equal(e, ref[1]))
        log(f"phase 7c {name}: U={len(unique)}, {len(ia)} pairs, route "
            f"{route}, launches (all-pairs, pair-list) {counts}; "
            f"{'==' if ok else '!='} its reference; {diff} scores and ends "
            f"differ from the C++ scorer's")
        return ok, diff

    def cpp_ref(left, lens, ia, ib):
        return graphcore.overlap_nogap_pairs(left, lens, ia, ib)

    def dense_plain(left, lens, ia, ib):
        c, ln = torch.from_numpy(left).to(dev), torch.from_numpy(lens).to(dev)
        sm, em = oa.overlap_scores_block_plain(c, ln, c, ln)
        a, b = torch.from_numpy(ia).long(), torch.from_numpy(ib).long()
        return sm.cpu()[a, b].numpy(), em.cpu()[a, b].numpy()

    def sparse_plain(left, lens, ia, ib):
        s, e = op.overlap_scores_pairs_plain(*(
            torch.from_numpy(x).to(dev) for x in (left, lens, ia, ib)))
        return s.cpu().numpy(), e.cpu().numpy()

    def all_pairs(u_count, diagonal=False):
        ia, ib = np.meshgrid(np.arange(u_count, dtype=np.int32),
                             np.arange(u_count, dtype=np.int32),
                             indexing="ij")
        keep = np.ones_like(ia, bool) if diagonal else ia != ib
        return ia[keep], ib[keep]

    def random_pairs(u_count, n_pairs):
        return (rs.randint(0, u_count, n_pairs).astype(np.int32),
                rs.randint(0, u_count, n_pairs).astype(np.int32))

    few = internal_n_reads(rs, 300, 60, 2_000)
    many = internal_n_reads(rs, 600, 60, 2_000)
    wide = internal_n_reads(rs, SPARSE_UNIQUE, 40, 20_000)
    clean = internal_n_reads(rs, 300, 60, 2_000, with_n=False)
    clean_wide = internal_n_reads(rs, SPARSE_UNIQUE, 40, 20_000,
                                  with_n=False)
    cases = [
        ("reads with N, below the threshold, all pairs and the diagonal",
         few, *all_pairs(len(few), diagonal=True), "host", (0, 0), cpp_ref,
         True),
        ("reads with N, below the threshold, sparse",
         wide, *random_pairs(len(wide), 150_000), "host", (0, 0), cpp_ref,
         True),
        ("reads with N, at or above the threshold, dense",
         many, *all_pairs(len(many)), "allpairs", (1, 0), dense_plain, True),
        ("reads with N, at or above the threshold, sparse",
         wide, *random_pairs(len(wide), 250_000), "pairlist", (0, 1),
         sparse_plain, True),
        ("reads without N, below the threshold, all pairs and the diagonal",
         clean, *all_pairs(len(clean), diagonal=True), "allpairs", (1, 0),
         cpp_ref, False),
        ("reads without N, below the threshold, sparse",
         clean_wide, *random_pairs(len(clean_wide), 50_000), "pairlist",
         (0, 1), cpp_ref, False),
    ]
    for name, unique, ia, ib, route, counts, reference, diverges in cases:
        ok, diff = routed(name, unique, ia, ib, route, counts, reference)
        if not ok:
            log(f"phase 7c FAILED: {name}")
            return None
        if diverges and route != "host" and diff == 0:
            log(f"phase 7c FAILED: {name}: no N against N changed a score, "
                f"so the case tests nothing")
            return None
    log("phase 7c every internal-N route == the JAX package's semantics")

    # ---- 7d: the gapped overlap DP and the device samplers ----------------
    codes, lens = encode_batch(reads[:256], align="left")
    partner = np.roll(np.arange(256), 1)
    args_cpu = [torch.from_numpy(x) for x in
                (codes, lens, codes[partner].copy(), lens[partner].copy())]
    args_card = [x.to(dev) for x in args_cpu]
    for indel in (-2, -1, -(2**25)):
        s_k, e_k = op.overlap_align_full(*args_card, indel=indel)
        t = time.perf_counter()
        s_c, e_c = op.overlap_align_full(*args_cpu, indel=indel)
        cpu_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        s_x, e_x = graphcore.overlap_baseline_batch(
            *(x.numpy() for x in args_cpu), indel=indel)
        cpp_ms = (time.perf_counter() - t) * 1e3
        same = (torch.equal(s_k.cpu(), s_c) and torch.equal(e_k.cpu(), e_c)
                and np.array_equal(s_c.numpy(), s_x)
                and np.array_equal(e_c.numpy(), e_x))
        card_ms = event_ms(lambda: op.overlap_align_full(*args_card,
                                                         indel=indel))
        cells = int((args_cpu[1].long() * args_cpu[3].long()).sum())
        log(f"phase 7d overlap_align_full, 256 pairs of 7a's reads, L="
            f"{codes.shape[1]}, indel {indel}: {'==' if same else '!='} its "
            f"CPU run and the C++ full DP; card {card_ms:.3f} ms (mean of 3, "
            f"CUDA events), the same torch ops on the host {cpu_ms:.1f} ms, "
            f"the C++ full DP on the host {cpp_ms:.1f} ms (one thread; host "
            f"clock); {cells} DP cells, bound "
            f"{SW_OPS_PER_CELL * cells / int_ops_per_s * 1e3:.3g} ms by "
            f"operations ({SW_OPS_PER_CELL} int ops a cell); card "
            f"{card_line}")
        if not same:
            log("phase 7d FAILED: overlap_align_full")
            return None
    genome_codes = torch.from_numpy(encode(genome)).to(dev)
    failed = sampler_contract(sample_reads_device, inject_errors_device,
                              genome_codes, cfg["read_length"],
                              cfg["num_reads"], 0.05, cfg["seed"])
    log(f"phase 7d device samplers on the card (PhiX, N={cfg['num_reads']}, "
        f"l={cfg['read_length']}, p=0.05): failed checks {failed}")
    if failed:
        log("phase 7d FAILED: the device samplers break their contract")
        return None
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    for n in (cfg["num_reads"], 1_000_000):
        sample_ms = event_ms(lambda: sample_reads_device(
            gen, genome_codes, cfg["read_length"], n))
        sampled = sample_reads_device(gen, genome_codes, cfg["read_length"],
                                      n)
        inject_ms = event_ms(lambda: inject_errors_device(
            gen, *sampled, cfg["error_prob"]))
        # bytes: the genome read once, the reads and lengths written;
        # the injector reads both and writes the reads
        out_bytes = n * (cfg["read_length"] + 4)
        sample_bound = (len(genome) + out_bytes) / PEAK_BYTES_PER_S * 1e3
        inject_bound = (out_bytes + n * cfg["read_length"]) \
            / PEAK_BYTES_PER_S * 1e3
        log(f"phase 7d sample_reads_device at N={n}, l="
            f"{cfg['read_length']}: {sample_ms:.3f} ms (bound "
            f"{sample_bound:.3g} ms by bytes), inject_errors_device "
            f"{inject_ms:.3f} ms (bound {inject_bound:.3g} ms by bytes); "
            f"means of 3, CUDA events; card {card_line}")
        del sampled
    log(f"phase 7 new pipelines passed: {time.perf_counter() - t7:.1f}s")
    return errs


# Phase 8: the parallel layer (genome_assembly_tpu_torch/parallel) in one
# world of PARALLEL_RANKS ranks sharing the one card (gloo: the JAX
# README's make_mesh(8)), and in a world of one rank on NCCL.
PARALLEL_RANKS = 8
# README.md's sharded_pipeline_step: PhiX, l = 100, N = 8,192, p = 0.01
PARALLEL_STEP = {"read_length": 100, "num_reads": 8192, "error_prob": 0.01,
                 "seed": 0}
PARALLEL_MESHES = (1, 2, 4, 8)
PARALLEL_MESHES_2D = ((2, 2), (2, 4))
PARALLEL_PIPELINE = {"k": 5, "cap": 32, "n_micro": 4}
# 8f: the long genome against 64 of phase 4b's contigs, longest first of
# those of at most 2,048 bases; R = 8 rows an exchange (the JAX default)
SEQPAR = {"items": 64, "max_len": 2048, "rows": 8, "meshes": (4, 8),
          "traceback_items": 8}
PARALLEL_TIMEOUT_S = 900
# the assembly's stages that distributed_assemble_contigs traces
LAYOUT_STAGES = ("graph.remove_cycles", "graph.topo_sort",
                 "graph.walk_contigs")


def digest(t) -> int:
    """A 64-bit fingerprint of an integer tensor's values in order: the sum
    of value_i * w_i mod 2**64, the w_i drawn in chunks of 2**24 from a
    torch generator seeded 0 on the tensor's device. Two tensors of one
    shape whose values differ get the same fingerprint only by a
    coincidence of 64-bit sums."""
    import torch

    flat = t.reshape(-1)
    gen = torch.Generator(device=flat.device).manual_seed(0)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    chunk = 1 << 24
    for lo in range(0, flat.numel(), chunk):
        part = flat[lo:lo + chunk].to(torch.int64)
        w = torch.randint(-2**63, 2**63 - 1, part.shape, generator=gen,
                          device=flat.device, dtype=torch.int64)
        total += (part * w).sum()
    return int(total)


def step_reads(inp: dict):
    """Phase 8a's reads, lengths and starts: what each mesh member draws in
    sharded_pipeline_step (inp["step"], on inp["ranks"] ranks) from a
    generator seeded inp["step"]["seed"] on inp["device"], by the rule its
    docstring states, in axis order."""
    import torch

    from genome_assembly_tpu_torch.parallel.sharded import split_generator
    from genome_assembly_tpu_torch.simulate import inject_errors_device
    from genome_assembly_tpu_torch.simulate.reads import reads_at_starts

    st, n_dev = inp["step"], inp["ranks"]
    device = torch.device(inp["device"], 0) if inp["device"] == "cuda" \
        else torch.device("cpu")
    genome = torch.as_tensor(inp["phix"], device=device)
    gens = split_generator(
        torch.Generator(device=device).manual_seed(st["seed"]), n_dev,
        device)
    reads, lens, starts = [], [], []
    for gen in gens:
        s = torch.randint(0, genome.shape[0], (st["num_reads"] // n_dev,),
                          generator=gen, device=device)
        r, ln = reads_at_starts(genome, s, st["read_length"])
        reads.append(inject_errors_device(gen, r, ln, st["error_prob"]))
        lens.append(ln)
        starts.append(s.to(torch.int32))
    return torch.cat(reads), torch.cat(lens), torch.cat(starts)


def coverage(starts, lens, genome_len: int):
    """Per-base read coverage from the starts' difference array."""
    import torch

    delta = torch.zeros(genome_len + 1, dtype=torch.int64,
                        device=starts.device)
    delta.index_add_(0, starts.long(), torch.ones_like(starts.long()))
    delta.index_add_(0, (starts + lens).long(), -torch.ones_like(starts.long()))
    return torch.cumsum(delta, 0)[:genome_len].to(torch.int32)


def seqpar_inputs(queries: list[str], lg: str, pad_to: int):
    """8f's queries and lengths, the genome padded with PAD to a multiple of
    `pad_to`, and its true length."""
    import numpy as np

    from genome_assembly_tpu_torch.core.encoding import encode, encode_batch

    q, ql = encode_batch(queries)
    g = encode(lg)
    g_pad = np.full(-(-len(g) // pad_to) * pad_to, 4, np.int8)
    g_pad[:len(g)] = g
    return q, ql, g_pad, len(g)


def row_scan(q, ql, g_pad, g_len: int):
    """The plain row scan (ops/smith_waterman.py::local_align_batch) of
    every query against the whole genome, on the queries' device: best,
    best_i, best_j, and the codes without the j = 0 column, padded with 0
    to the padded genome's width (the seqpar codes' layout)."""
    import torch

    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    b = q.shape[0]
    genome = g_pad[:g_len][None].expand(b, -1).contiguous()
    best, bi, bj, codes = sw.local_align_batch(
        q, ql, genome, torch.full((b,), g_len, dtype=torch.int32,
                                  device=q.device))
    codes = torch.nn.functional.pad(codes[:, :, 1:],
                                    (0, g_pad.shape[0] - g_len))
    return best, bi, bj, codes


def exact(got, want) -> tuple[bool, int]:
    """(all equal, max abs err) of two sequences of integer tensors."""
    import torch

    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want)), err


class Steps:
    """Phase 8's steps on one rank: each runs after a barrier, between
    zeroed launch and collective counts, and leaves its wall, peak device
    memory, launches and collectives in `records`."""

    def __init__(self, device):
        self.device = device
        self.records = {}

    def run(self, name: str, fn):
        import torch
        import torch.distributed as dist

        from genome_assembly_tpu_torch.ops import overlap as op
        from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
        from genome_assembly_tpu_torch.ops import seqpar as sq
        from genome_assembly_tpu_torch.ops import smith_waterman as sw
        from genome_assembly_tpu_torch.parallel import _comm
        from genome_assembly_tpu_torch.utils.tracing import global_tracer

        card = self.device.type == "cuda"
        dist.barrier()
        if card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        oa.launches = op.launches = 0
        sw.full_width_launches = sw.banded_launches = 0
        sq.step_launches = sq.row_launches = 0
        _comm.collectives = 0
        global_tracer().reset()
        t = time.perf_counter()
        result = fn()
        if card:
            torch.cuda.synchronize(self.device)
        self.records[name] = rec = {
            "wall": time.perf_counter() - t,
            "peak": (torch.cuda.max_memory_allocated(self.device) if card
                     else None),
            "launches": {"overlap_allpairs": oa.launches,
                         "overlap_pairs": op.launches,
                         "sw_full_width": sw.full_width_launches,
                         "seqpar_step": sq.step_launches,
                         "seqpar_row": sq.row_launches},
            "collectives": _comm.collectives,
            "member": result is not None,
        }
        return result, rec


def ptxas_report(source: str, out_dir: str) -> dict:
    """Registers, spills and stack frame of every kernel in a CUDA source,
    from `nvcc -Xptxas -v` building a cubin of it beside the library (with
    the library's flags)."""
    import re

    from genome_assembly_tpu_torch.ops.overlap_allpairs import (
        NVCC_FLAGS,
        _nvcc,
    )

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC")]
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(source))[0]
    proc = subprocess.run(
        [_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
         os.path.join(out_dir, f"{name}.cubin"), source],
        capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v {source} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    out, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d((?:[a-z]+_)+kernel)(ILb([01])E)?",
                          m.group(1))
            kernel = k.group(1) + ("" if not k.group(2) else
                                   "<true>" if k.group(3) == "1"
                                   else "<false>")
            out[kernel] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            out[kernel].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel]["registers"] = int(m.group(1))
    return out


def seqpar_geometry(widths: dict, items: int, card: bool) -> list[str]:
    """What the seqpar kernel launches at each 8f width: segments, cluster,
    blocks, threads, shared memory, resident or tiled, and (on a card) how
    many clusters fit at once."""
    from genome_assembly_tpu_torch.ops import seqpar as sq

    lines = []
    for label, gb in widths.items():
        for kind, step in (("step", True), ("pre/post", False)):
            geo = sq.plan(items, gb, step)
            fit = ([sq.max_active_clusters(k, geo)
                    for k in (("step",) if step else ("pre", "post"))]
                   if card else "not measured")
            lines.append(
                f"{label} Gb {gb}: {kind} S = {geo.segments} segments of "
                f"{geo.seg} columns, clusters of {geo.segments}, "
                f"{geo.blocks} blocks of {sq.THREADS} threads, "
                f"{geo.smem} B dynamic shared memory a block, "
                + ("the dp row resident in shared memory for the step"
                   if geo.resident else
                   f"tiles of {sq.TILE} columns through global memory")
                + f"; clusters that fit at once {fit}")
    return lines


class HostSplit:
    """While active, sums the host seconds spent inside the seqpar wrappers
    (checks, plan, launch) and inside the exchanges (all-gather, shift) of
    the calls made."""

    def __enter__(self):
        from genome_assembly_tpu_torch.ops import seqpar as sq
        from genome_assembly_tpu_torch.parallel import _comm

        self.targets = [(sq, "seqpar_row_pre", "wrappers"),
                        (sq, "seqpar_row_post", "wrappers"),
                        (sq, "seqpar_step", "wrappers"),
                        (_comm, "all_gather", "exchanges"),
                        (_comm, "ppermute_right", "exchanges")]
        self.seconds = {"wrappers": 0.0, "exchanges": 0.0}
        self.saved = [getattr(m, n) for m, n, _ in self.targets]
        for (m, n, kind), fn in zip(self.targets, self.saved):
            setattr(m, n, self._timed(fn, kind))
        return self

    def _timed(self, fn, kind):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[kind] += time.perf_counter() - t
        return timed

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.targets, self.saved):
            setattr(m, n, fn)


class SeqparCheck:
    """While active, the seqpar wrappers hold the kernel against the plain
    version on copies of the same inputs on the card: the pipelined
    variant's first and last active step, and the per-row variant's first
    and last row (pre by its totals, `run` being the kernel's scratch; post
    by everything it writes, its plain version reading the `run` the plain
    pre left). `checks`: (entry, max abs err) a held call; `inputs`: copies
    of the first held call's inputs of each entry, for `time_seqpar`. Used
    after the main path's counts were read, so its launches do not count."""

    def __enter__(self):
        from genome_assembly_tpu_torch.ops import seqpar as sq

        self.sq, self.checks, self.inputs = sq, [], {}
        self.plain_run = {}
        self.saved = (sq.seqpar_step, sq.seqpar_row_pre, sq.seqpar_row_post)
        step, pre, post = self.saved

        def checked_step(*a):
            row0, slab, codes = a[2], a[8], a[9]
            rows = slab.shape[1]
            if row0 not in (0, codes.shape[0] - rows):
                return step(*a)
            return self._held("seqpar_step", step, sq.seqpar_step_plain, a,
                              (6, 10, 11, 12),
                              (9, slice(row0, row0 + rows)))[0]

        def checked_pre(*a):
            if a[1] not in (1, a[0].shape[1]):
                return pre(*a)
            got, copies = self._held("seqpar_row_pre", pre,
                                     sq.seqpar_row_pre_plain, a, ())
            self.plain_run[a[1]] = copies[7]
            return got

        def checked_post(*a):
            if a[2] not in (1, a[0].shape[1]):
                return post(*a)
            return self._held("seqpar_row_post", post,
                              sq.seqpar_row_post_plain, a,
                              (7, 11, 12, 13, 14),
                              plain_args={9: self.plain_run.pop(a[2])})[0]

        sq.seqpar_step, sq.seqpar_row_pre, sq.seqpar_row_post = (
            checked_step, checked_pre, checked_post)
        return self

    def _held(self, name, kernel, plain, args, mutable, rows=None,
              plain_args=None):
        import torch

        copies = [x.clone() if torch.is_tensor(x) else x for x in args]
        for k, x in (plain_args or {}).items():
            copies[k] = x
        # the copies, as the plain version leaves them, replay the call in
        # time_seqpar
        self.inputs.setdefault(name, copies)
        got = kernel(*args)
        want = plain(*copies)
        pairs = [(got, want)] + [(args[k], copies[k]) for k in mutable]
        if rows is not None:
            pairs.append((args[rows[0]][rows[1]], copies[rows[0]][rows[1]]))
        self.checks.append((name, exact(*zip(*pairs))[1]))
        return got, copies

    def __exit__(self, *exc):
        sq = self.sq
        sq.seqpar_step, sq.seqpar_row_pre, sq.seqpar_row_post = self.saved


def held_seqpar(checks, per_row: bool, n_blocks: int) -> tuple[bool, int]:
    """(enough calls held and all exact, max abs err) of a SeqparCheck's
    list: both halves at two rows per-row; the first and the last step
    (one when there is one block) pipelined."""
    names = ({"seqpar_row_pre", "seqpar_row_post"} if per_row
             else {"seqpar_step"})
    mine = [err for name, err in checks if name in names]
    need = 4 if per_row else min(2, n_blocks)
    err = max(mine, default=0)
    return len(mine) >= need and err == 0, err


def time_seqpar(per_row: bool, call, inputs: dict, n_units: int,
                reps: int = 10) -> dict:
    """The seqpar kernel's time on the card at a call's inputs:
    - the kernels' device time in a profiler trace of one call, in all
      and per launch (None: the trace held no device time for them);
    - CUDA events around `reps` back-to-back calls of the wrappers on one
      recorded unit (a step; per-row, a row's pre and post) on copies of
      its inputs (the kernel's work does not depend on the values), the
      wrappers' host time included where it outlasts the kernel, and the
      plain version's the same way; a call is `n_units` units;
    - the call's wall by CUDA events.
    "ms" is the profiler's time of a call where the trace has it, else
    the events'."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from genome_assembly_tpu_torch.ops import seqpar as sq

    if per_row:
        pre, post = inputs["seqpar_row_pre"], inputs["seqpar_row_post"]
        kernel = lambda: (sq.seqpar_row_pre(*pre), sq.seqpar_row_post(*post))
        plain = lambda: (sq.seqpar_row_pre_plain(*pre),
                         sq.seqpar_row_post_plain(*post))
        names = ("seqpar_row_pre_kernel", "seqpar_row_post_kernel")
    else:
        args = inputs["seqpar_step"]
        kernel = lambda: sq.seqpar_step(*args)
        plain = lambda: sq.seqpar_step_plain(*args)
        names = ("seqpar_step_kernel",)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def events_ms(fn, n=reps):
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    unit_ms = events_ms(kernel)
    plain_unit_ms = events_ms(plain, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    entries = [e for e in prof.key_averages()
               if any(n in e.key for n in names)]
    device_us = sum(getattr(e, "device_time_total", 0) for e in entries)
    traced = sum(e.count for e in entries)
    call_ms = events_ms(call, 1)
    return {"unit_ms": unit_ms, "events_ms": unit_ms * n_units,
            "ms": device_us / 1e3 if device_us else unit_ms * n_units,
            "plain_unit_ms": plain_unit_ms,
            "plain_ms": plain_unit_ms * n_units,
            "alone_ms": device_us / 1e3 if device_us else None,
            "alone_launch_ms": (device_us / 1e3 / traced
                                if device_us else None),
            "traced_launches": traced, "call_ms": call_ms}


def parallel_rank(inp: dict) -> dict:
    """Phase 8a-8f on one rank of the gloo world. Every rank returns its
    records, its results' fingerprints and 8f's comparison of its code
    slices with the row scan's; rank 0 also 8a's and 8e's results, 8b's and
    8c's comparisons with its own all-pairs launch on all the reads, and
    8f's tracebacks."""
    import torch
    import torch.distributed as dist

    from genome_assembly_tpu_torch import parallel
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.parallel.seqpar import (
        gather_codes,
        traceback_host_seqpar,
    )
    from genome_assembly_tpu_torch.parallel.sharded import DIAGONAL_SCORE
    from genome_assembly_tpu_torch.utils.tracing import global_tracer

    rank = dist.get_rank()
    dev = parallel.make_mesh(device=inp["device"]).device
    steps = Steps(dev)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(dev), "steps": steps.records}
    st = inp["step"]

    def mesh_of(n, axis_name="data"):
        return parallel.make_mesh(n, axis_name=axis_name,
                                  device=inp["device"])

    # 8a: the step at the README's size
    phix = torch.as_tensor(inp["phix"], device=dev)
    mesh8 = mesh_of(inp["ranks"])
    gen = torch.Generator(device=dev).manual_seed(st["seed"])
    res, rec = steps.run("8a", lambda: parallel.sharded_pipeline_step(
        mesh8, gen, phix, st["read_length"], st["num_reads"],
        st["error_prob"]))
    rec["digest"] = [digest(x) for x in res]
    if rank == 0:
        out["8a"] = [x.cpu() for x in res]
    del res

    # 8b, 8c: the same reads, fixed, at every mesh; rank 0 holds each
    # result against one launch of the all-pairs kernel on all the reads
    reads, lens, starts = step_reads(inp)
    g_len = phix.shape[0]
    ref = None
    if rank == 0:
        ref = [*oa.overlap_scores_block(reads, lens, reads, lens),
               coverage(starts, lens, g_len)]
    for n in inp["meshes"]:
        mesh = mesh_of(n)
        res, rec = steps.run(f"8b mesh {n}", lambda: (
            parallel.sharded_pipeline_step_reads(mesh, reads, lens, starts,
                                                 g_len)))
        if res is not None:
            rec["digest"] = [digest(x) for x in res]
            if rank == 0:
                rec["equal"], rec["max_abs_err"] = exact(res, ref)
        del res
    if rank == 0:
        ref[0].fill_diagonal_(DIAGONAL_SCORE)
    for rows, cols in inp["meshes_2d"]:
        mesh = parallel.make_mesh_2d(rows, cols, device=inp["device"])
        res, rec = steps.run(f"8c {rows}x{cols}", lambda: (
            parallel.all_pairs_block_scores_2d(mesh, reads, lens)))
        if res is not None:
            rec["digest"] = [digest(x) for x in res]
            if rank == 0:
                rec["equal"], rec["max_abs_err"] = exact(res, ref[:2])
        del res
    del ref

    # 8d: the distributed assembly of phase 4's reads
    for n in (1, inp["ranks"]):
        mesh = mesh_of(n)
        res, rec = steps.run(f"8d mesh {n}", lambda: (
            parallel.distributed_assemble_contigs(mesh, inp["reads4"], k=K)))
        if res is not None:
            rec["summary"] = contig_summary(res)
            times = global_tracer().as_dict()
            rec["build_s"] = times["graph.build"]["seconds"]
            rec["layout_s"] = sum(times[s]["seconds"] for s in LAYOUT_STAGES)

    # 8e: the two-stage pipeline on 8a's reads
    mesh = mesh_of(2, axis_name="stage")
    res, rec = steps.run("8e", lambda: parallel.pipelined_candidates_score(
        mesh, reads, lens, **inp["pipeline"]))
    if res is not None:
        rec["digest"] = [digest(x.to(torch.int32)) for x in res]
        if rank == 0:
            out["8e"] = [x.cpu() for x in res]
    del res

    # 8f: sequence-parallel SW on the long genome
    q, ql, g_pad, g_len = seqpar_inputs(inp["queries"], inp["lg"],
                                        inp["ranks"])
    q, ql = torch.as_tensor(q, device=dev), torch.as_tensor(ql, device=dev)
    g_pad = torch.as_tensor(g_pad, device=dev)
    n_pad = q.shape[1]
    sp = inp["seqpar"]
    # every rank holds its slices against the row scan's, exactly
    ref = row_scan(q, ql, g_pad, g_len)
    for n in sp["meshes"]:
        mesh = mesh_of(n)
        rowwise, rec_r = steps.run(f"8f per-row mesh {n}", lambda: (
            parallel.local_align_batch_seqpar(mesh, q, ql, g_pad, g_len)))
        piped, rec_p = steps.run(f"8f pipelined mesh {n}", lambda: (
            parallel.local_align_batch_seqpar_pipelined(
                mesh, q, ql, g_pad, g_len,
                rows_per_exchange=sp["rows"])))
        if rowwise is None:
            continue
        gb = g_pad.shape[0] // n
        off = mesh.axis_index("data") * gb
        for rec, res in ((rec_r, rowwise), (rec_p, piped)):
            rec["best"] = [x.cpu().numpy() for x in res[:3]]
            rec["codes_shape"] = tuple(res[3].shape)
            rec["equal"], rec["max_abs_err"] = exact(
                [*res[:3], res[3][:n_pad]],
                [*ref[:3], ref[3][:, :, off:off + gb]])
        # the kernel against the plain steps on the rank, at the first and
        # last step and row of one more call of each variant
        with SeqparCheck() as held:
            parallel.local_align_batch_seqpar(mesh, q, ql, g_pad, g_len)
            parallel.local_align_batch_seqpar_pipelined(
                mesh, q, ql, g_pad, g_len, rows_per_exchange=sp["rows"])
        rec_r["held"] = rec_p["held"] = held.checks
        del held
        if n == max(sp["meshes"]):
            t = sp["traceback_items"]
            codes = gather_codes(mesh, rowwise[3][:, :t].contiguous())
            if rank == 0:
                bi, bj = rowwise[1].tolist(), rowwise[2].tolist()
                out["8f tracebacks"] = [traceback_host_seqpar(
                    codes[:, b, :].cpu().numpy(), bi[b], bj[b],
                    inp["queries"][b], inp["lg"]) for b in range(t)]
            del codes
        del rowwise, piped
    return out


def nccl_rank(inp: dict) -> dict:
    """Phase 8 in a world of one rank on NCCL: 8b's step and 8c's dense
    scores at mesh 1 (fingerprints), and 8f's two seqpar variants at mesh 1
    (the whole genome on one rank) against the row scan; records."""
    import torch
    import torch.distributed as dist

    from genome_assembly_tpu_torch import parallel
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    mesh = parallel.make_mesh(1, device=inp["device"])
    steps = Steps(mesh.device)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "steps": steps.records}
    reads, lens, starts = step_reads(inp)
    g_len = len(inp["phix"])
    res, rec = steps.run("8b mesh 1", lambda: (
        parallel.sharded_pipeline_step_reads(mesh, reads, lens, starts,
                                             g_len)))
    rec["digest"] = [digest(x) for x in res]
    res, rec = steps.run("8c 1-D", lambda: parallel.all_pairs_block_scores(
        mesh, reads, lens))
    rec["digest"] = [digest(x) for x in res]
    del res
    q, ql, g_pad, g_len = seqpar_inputs(inp["queries"], inp["lg"], 1)
    args = [torch.as_tensor(x, device=mesh.device) for x in (q, ql, g_pad)]
    ref = row_scan(*args, g_len)
    n_pad, rows = q.shape[1], inp["seqpar"]["rows"]
    n_blocks = -(-n_pad // rows)
    for name, fn, kw, units in (
            ("8f per-row", parallel.local_align_batch_seqpar, {}, n_pad),
            ("8f pipelined", parallel.local_align_batch_seqpar_pipelined,
             {"rows_per_exchange": rows}, n_blocks)):
        res, rec = steps.run(name, lambda: fn(mesh, *args, g_len, **kw))
        rec["equal"], rec["max_abs_err"] = exact(
            [*res[:3], res[3][:n_pad]], ref)
        del res
        rec["device_ops"] = device_ops(lambda: fn(mesh, *args, g_len, **kw))
        with SeqparCheck() as held:
            fn(mesh, *args, g_len, **kw)
        rec["held"] = held.checks
        if mesh.device.type == "cuda":
            rec["timing"] = time_seqpar(
                name == "8f per-row", lambda: fn(mesh, *args, g_len, **kw),
                held.inputs, units)
            torch.cuda.synchronize()
            with HostSplit() as split:
                t = time.perf_counter()
                fn(mesh, *args, g_len, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            rec["host_split"] = {"wall": wall, **split.seconds}
        del held
    if mesh.device.type == "cuda":
        # the full-width SW kernel on the same items and the whole genome
        tq, tql, g = args
        w_len = torch.full_like(tql, g_len)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        sw.sw_full_width(tq, tql, g[:g_len], w_len)
        start.record()
        for _ in range(3):
            sw.sw_full_width(tq, tql, g[:g_len], w_len)
        stop.record()
        torch.cuda.synchronize()
        out["sw_full_width_ms"] = start.elapsed_time(stop) / 3
    return out


def device_ops(fn):
    """The kernels, copies and memsets that one call of fn() puts on the
    card, counted in a torch.profiler trace (None where the trace holds
    no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def parallel_config(device="cuda", sm_clock_hz: float = 1.98e9) -> dict:
    """Phase 8's sizes and device, passed to every rank, and the SM clock
    its bounds take."""
    return {"device": device, "ranks": PARALLEL_RANKS, "step": PARALLEL_STEP,
            "meshes": PARALLEL_MESHES, "meshes_2d": PARALLEL_MESHES_2D,
            "pipeline": PARALLEL_PIPELINE, "seqpar": SEQPAR,
            "nccl": "nccl" if device == "cuda" else "gloo",
            "sm_clock_hz": sm_clock_hz}


def parallel_path(log, genome: str, reads4: list[str], contigs4_summary,
                  long_contigs, card_line: str, config=None):
    """Phase 8, run from the parent: the gloo world of PARALLEL_RANKS ranks
    on the card (8a-8f), the one-rank NCCL world, then every check against
    the references computed here on the card. `contigs4_summary`: phase
    4's contigs (the single-device assembly of `reads4`). `config`:
    ``parallel_config()`` (sizes and device; a CPU rehearsal passes smaller
    ones and device "cpu", where no kernel launches and the one-rank world
    uses gloo). Returns the max abs err of each kernel's checks by name and
    the seqpar kernels' entries of the kernels line (timed on the NCCL
    rank; none on the CPU), or None at the first failure (logged)."""
    import numpy as np
    import torch

    from genome_assembly_tpu_torch.core.encoding import encode
    from genome_assembly_tpu_torch.ops import overlap as op
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw
    from genome_assembly_tpu_torch.parallel.pipeline import (
        candidates_score_unpipelined,
    )
    from genome_assembly_tpu_torch.parallel.sharded import DIAGONAL_SCORE
    from genome_assembly_tpu_torch.parallel.spawn import spawn

    cfg = config or parallel_config()
    card = cfg["device"] == "cuda"
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    n_ranks, sp = cfg["ranks"], cfg["seqpar"]
    t8 = time.perf_counter()
    queries = sorted((c for c in long_contigs if len(c) <= sp["max_len"]),
                     key=len, reverse=True)[:sp["items"]]
    inp = {**cfg, "phix": encode(genome), "reads4": reads4,
           "queries": queries, "lg": long_genome()}
    t = time.perf_counter()
    ranks = spawn(parallel_rank, n_ranks, args=(inp,), device=cfg["device"],
                  timeout_s=PARALLEL_TIMEOUT_S)
    gloo_s = time.perf_counter() - t
    t = time.perf_counter()
    nccl = spawn(nccl_rank, 1, args=(inp,), device=cfg["device"],
                 backend=cfg["nccl"], timeout_s=PARALLEL_TIMEOUT_S)[0]
    nccl_s = time.perf_counter() - t
    worlds = {(r["backend"], r["world"], r["device"]) for r in ranks}
    log(f"phase 8 worlds: {n_ranks} ranks {sorted(worlds)} "
        f"{gloo_s:.2f}s (spawn, CUDA contexts, steps 8a-8f); 1 rank "
        f"({nccl['backend']}, world {nccl['world']}) {nccl_s:.2f}s; card "
        f"{card_line}")
    if worlds != {("gloo", n_ranks, str(dev))} or \
            (nccl["backend"], nccl["world"]) != (cfg["nccl"], 1):
        log("phase 8 FAILED: the worlds did not run on the expected backends")
        return None
    errs = {"overlap_allpairs": 0, "overlap_pairs": 0, "sw_full_width": 0,
            "seqpar_step": 0, "seqpar_row": 0}
    failed = []

    def report(step: str, extra: str = "", kernels=()):
        """Log a step's records over the ranks; fail it when a kernel it
        names was never launched or its members disagree."""
        recs = [r["steps"][step] for r in ranks]
        members = [r for r in recs if r["member"]]
        launches = {k: sum(r["launches"][k] for r in recs)
                    for k in recs[0]["launches"]}
        log(f"phase 8 {step}: wall {max(r['wall'] for r in recs):.3f}s "
            f"(slowest of {len(members)} member ranks; gloo, world "
            f"{n_ranks}), peak device memory a rank "
            f"{[r['peak'] for r in recs]} B, launches {launches}, "
            f"collectives a member rank {members[0]['collectives']}"
            f"{extra}")
        for k in kernels if card else ():
            if launches[k] < 1:
                failed.append(f"{step}: {k} never launched")
        digests = {json.dumps(r.get("digest")) for r in members}
        if len(digests) > 1:
            failed.append(f"{step}: member ranks returned different results")
        return members

    def check(step: str, ok: bool, err: int, kernel: str):
        errs[kernel] = max(errs[kernel], err)
        if not ok:
            failed.append(f"{step}: differs from its reference (max abs err "
                          f"{err})")

    # 8a: the step against the plain version on the rebuilt reads
    reads, lens, starts = step_reads(inp)
    t = time.perf_counter()
    plain = [*oa.overlap_scores_block_plain(reads, lens, reads, lens),
             coverage(starts, lens, len(genome))]
    if card:
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    got = [x.to(dev) for x in ranks[0]["8a"]]
    shapes = [tuple(x.shape) for x in got]
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, plain))
    check("8a", all(torch.equal(g, w) for g, w in zip(got, plain))
          and shapes == [(cfg["step"]["num_reads"],) * 2] * 2
          + [(len(genome),)], err,
          "overlap_allpairs")
    report("8a", f"; scores, ends, coverage {shapes} == the plain all-pairs "
                 f"version on the reads rebuilt by the generator rule and "
                 f"their starts' coverage: max abs err {err} (plain version "
                 f"{plain_s:.2f}s)", kernels=("overlap_allpairs",))
    plain_digest = [digest(x) for x in plain]
    del got
    # 8b: bit-identical over the meshes, equal to the plain version
    for n in cfg["meshes"]:
        members = report(f"8b mesh {n}", kernels=("overlap_allpairs",))
        r0 = ranks[0]["steps"][f"8b mesh {n}"]
        check(f"8b mesh {n}", r0["equal"]
              and members[0]["digest"] == plain_digest, r0["max_abs_err"],
              "overlap_allpairs")
    plain[0].fill_diagonal_(DIAGONAL_SCORE)
    masked_digest = [digest(x) for x in plain[:2]]
    del plain
    for rows, cols in cfg["meshes_2d"]:
        step = f"8c {rows}x{cols}"
        members = report(step, kernels=("overlap_allpairs",))
        r0 = ranks[0]["steps"][step]
        check(step, r0["equal"] and members[0]["digest"] == masked_digest,
              r0["max_abs_err"], "overlap_allpairs")
    # NCCL: the same step and dense scores on one rank
    nccl_ok = (nccl["steps"]["8b mesh 1"]["digest"] == plain_digest[:3]
               and nccl["steps"]["8c 1-D"]["digest"] == masked_digest)
    # 8d: the distributed assembly equals the single-device one (phase 4)
    want = contigs4_summary
    for n in (1, n_ranks):
        step = f"8d mesh {n}"
        members = report(step, kernels=("overlap_pairs",))
        summaries = [r["summary"] for r in members]
        r0 = members[0]
        log(f"phase 8 {step}: contigs {r0['summary']['contigs']}, sha256 "
            f"{r0['summary']['sha256'][:12]}..; build (join, sharded "
            f"scoring, fan-out) {r0['build_s']:.3f}s, host layout (cycles, "
            f"topological order, walk) {r0['layout_s']:.3f}s on rank 0, "
            f"{max(r['layout_s'] for r in members):.3f}s slowest")
        if any(s != want for s in summaries):
            failed.append(f"{step}: contigs differ from phase 4's: "
                          f"{summaries[0]}")
    # 8e: the pipeline against the unpipelined composition and the plain
    # pair-list version on the card
    members = report("8e", kernels=("overlap_pairs",))
    got = [x.to(dev) for x in ranks[0]["8e"]]
    pipe = cfg["pipeline"]
    want = candidates_score_unpipelined(reads, lens, k=pipe["k"],
                                        cap=pipe["cap"], device=dev)
    cap = pipe["cap"]
    a_idx = torch.arange(reads.shape[0], device=dev,
                         dtype=torch.int32).repeat_interleave(cap)
    b_idx = got[0].reshape(-1).clamp(min=0)
    s_p, e_p = op.overlap_scores_pairs_plain(reads, lens, a_idx, b_idx)
    valid = got[3]
    plain_e = [torch.where(valid, s_p.reshape(-1, cap), 0),
               torch.where(valid, e_p.reshape(-1, cap), 0)]
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got[1:3], plain_e))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    check("8e", same and err == 0, err, "overlap_pairs")
    log(f"phase 8 8e: (cand, scores, ends, valid) "
        f"{'==' if same else '!='} candidates_score_unpipelined on the card; "
        f"{int(valid.sum())} valid slots of {valid.numel()}; scores and "
        f"ends == the plain pair-list version: max abs err {err}")
    del got, want, s_p, e_p
    # 8f: seqpar against the row scan on the replicated genome and the
    # full-width SW kernel
    q, ql, g_pad, g_len = seqpar_inputs(queries, inp["lg"], n_ranks)
    n_pad = q.shape[1]
    tq, tql = torch.as_tensor(q, device=dev), torch.as_tensor(ql, device=dev)
    g_codes = torch.as_tensor(g_pad[:g_len], device=dev)
    t = time.perf_counter()
    ref = sw.local_align_batch(
        tq, tql, g_codes[None].expand(len(queries), -1).contiguous(),
        torch.full((len(queries),), g_len, dtype=torch.int32, device=dev))
    ref_s = time.perf_counter() - t
    best_ref = [x.cpu().numpy() for x in ref[:3]]
    sw.full_width_launches = 0
    kern = sw.sw_full_width(tq, tql, g_codes,
                            torch.full_like(tql, g_len))
    kern_launches = sw.full_width_launches
    kern = [x.cpu().numpy() for x in kern[:3]]
    err = max(int(np.abs(a.astype(np.int64) - b).max())
              for a, b in zip(kern, best_ref))
    check("8f SW kernel", err == 0 and (kern_launches > 0 or not card), err,
          "sw_full_width")
    log(f"phase 8 8f: {len(queries)} queries (lengths "
        f"{len(queries[-1])}-{len(queries[0])}, n_pad {n_pad}) against "
        f"G = {g_len}: the row scan on the replicated genome {ref_s:.2f}s "
        f"(codes {tuple(ref[3].shape)}); full-width SW kernel best/best_i/"
        f"best_j == it: max abs err {err}, {kern_launches} launch(es)")
    # the scan's bound: the DP cells the queries need at SW_OPS_PER_CELL int
    # ops over 132 SMs x 64 lanes x the SM clock, against its bytes (the
    # codes it writes, a byte a cell of the padded grid, and its inputs)
    cells = int(ql.astype(np.int64).sum()) * g_len
    ops_ms = SW_OPS_PER_CELL * cells / (SMS * INT32_LANES
                                        * cfg["sm_clock_hz"]) * 1e3
    n_bytes = n_pad * len(queries) * len(g_pad) + q.nbytes + ql.nbytes \
        + len(g_pad)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"phase 8 8f seqpar bound: {cells} DP cells -> {ops_ms:.4f} ms; "
        f"{n_bytes} B -> {bytes_ms:.4f} ms; bound {bound_ms:.4f} ms by "
        f"{bound_by}")
    widths = {"NCCL rank, mesh 1": len(g_pad),
              **{f"gloo mesh {n}": len(g_pad) // n for n in sp["meshes"]}}
    for line in seqpar_geometry(widths, len(queries), card):
        log(f"phase 8 8f seqpar geometry: {line}")
    n_blocks = -(-n_pad // sp["rows"])
    walls = {}
    for n in sp["meshes"]:
        for variant in ("per-row", "pipelined"):
            step = f"8f {variant} mesh {n}"
            kernel = "seqpar_row" if variant == "per-row" else "seqpar_step"
            members = report(step)
            held = [held_seqpar(r["held"], variant == "per-row", n_blocks)
                    for r in members]
            errs[kernel] = max([errs[kernel]] + [e for _, e in held])
            per_rank = [r["launches"][kernel] for r in members]
            log(f"phase 8 {step}: {kernel} kernel launches a member rank "
                f"{per_rank}; its first and last "
                f"{'rows' if variant == 'per-row' else 'steps'} on every "
                f"member rank == the plain version on copies of their "
                f"inputs: {all(ok for ok, _ in held)} (max abs err "
                f"{max(e for _, e in held)}, "
                f"{[len(r['held']) for r in members]} held calls a rank "
                f"over both variants)")
            if card and min(per_rank) < 1:
                failed.append(f"{step}: a member rank did not launch the "
                              f"{kernel} kernel")
            if not all(ok for ok, _ in held):
                failed.append(f"{step}: the {kernel} kernel differs from "
                              f"its plain version")
            walls[step] = max(r["wall"] for r in members)
            bests_ok = all(all(np.array_equal(a, b) for a, b in
                               zip(r["best"], best_ref)) for r in members)
            codes_ok = all(r["equal"] for r in members)
            seqpar_err = max(r["max_abs_err"] for r in members)
            log(f"phase 8 {step}: best, best_i, best_j "
                f"{'==' if bests_ok else '!='} the row scan here; each "
                f"rank's best and codes {members[0]['codes_shape']} "
                f"{'==' if codes_ok else '!='} its slice of the row scan on "
                f"the rank (max abs err {seqpar_err})")
            if not (bests_ok and codes_ok):
                failed.append(f"{step}: differs from the row scan")
        log(f"phase 8 8f mesh {n}: per-row {walls[f'8f per-row mesh {n}']:.3f}"
            f"s ({ranks[0]['steps'][f'8f per-row mesh {n}']['collectives']} "
            f"collectives a rank) vs pipelined "
            f"{walls[f'8f pipelined mesh {n}']:.3f}s "
            f"({ranks[0]['steps'][f'8f pipelined mesh {n}']['collectives']} "
            f"collectives a rank, R = {sp['rows']})")
    tracebacks = ranks[0]["8f tracebacks"]
    codes_np = ref[3][:, :len(tracebacks), :].cpu().numpy()
    bi, bj = best_ref[1], best_ref[2]
    want_tb = [sw.traceback_host(codes_np[:, b, :], int(bi[b]), int(bj[b]),
                                 queries[b], inp["lg"])
               for b in range(len(tracebacks))]
    tb_ok = tracebacks == want_tb
    log(f"phase 8 8f traceback_host_seqpar on {len(tracebacks)} items "
        f"{'==' if tb_ok else '!='} traceback_host on the row scan's codes "
        f"(alignment lengths {[len(a) for a, _, _ in tracebacks]})")
    if not tb_ok:
        failed.append("8f: tracebacks differ")
    del ref, codes_np
    if card:
        torch.cuda.empty_cache()
    nccl_ok &= all(nccl["steps"][step]["equal"]
                   for step in ("8f per-row", "8f pipelined"))
    seqpar_kernels = []
    for step, kernel, replaces, units, want, ops_cap in (
            ("8f per-row", "seqpar_row", SEQPAR_ROW_REPLACES, n_pad,
             2 * n_pad, 12 * n_pad + 32),
            ("8f pipelined", "seqpar_step", SEQPAR_STEP_REPLACES, n_blocks,
             n_blocks, 8 * n_blocks + 32)):
        r = nccl["steps"][step]
        ok, err = held_seqpar(r["held"], kernel == "seqpar_row", n_blocks)
        errs[kernel] = max(errs[kernel], err)
        launched, ops = r["launches"][kernel], r.get("device_ops")
        if not ok:
            failed.append(f"NCCL {step}: the {kernel} kernel differs from "
                          f"its plain version (max abs err {err})")
        if card and launched != want:
            failed.append(f"NCCL {step}: {launched} {kernel} launches, "
                          f"{want} expected")
        if card and ops is not None and ops > ops_cap:
            failed.append(f"NCCL {step}: {ops} device operations a call, "
                          f"more than {ops_cap}")
        t = r.get("timing")
        if t is None:
            continue
        log(f"phase 8 NCCL {step} ({kernel}, {units} "
            f"{'rows' if kernel == 'seqpar_row' else 'steps'} a call, "
            f"{launched} launches in the main run, device operations a call "
            f"{ops if ops is not None else 'not traced'} of at most "
            f"{ops_cap}): the kernel alone in a profiler trace of one call "
            f"{t['alone_ms']} ms over {t['traced_launches']} launches "
            f"({t['alone_launch_ms']} ms a launch); the wrappers "
            f"back-to-back {t['unit_ms']:.4f} ms a "
            f"{'row (pre and post)' if kernel == 'seqpar_row' else 'step'} "
            f"(CUDA events, x {units} -> {t['events_ms']:.3f} ms a call); "
            f"the call {t['call_ms']:.3f} ms (CUDA events); the "
            f"plain version {t['plain_unit_ms']:.4f} ms a unit -> "
            f"{t['plain_ms']:.3f} ms; the full-width SW kernel on the same "
            f"{len(queries)} items {nccl['sw_full_width_ms']:.3f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by}; card {card_line}")
        h = r["host_split"]
        log(f"phase 8 NCCL {step} host split of one more call: wall "
            f"{h['wall'] * 1e3:.3f} ms (host clock, ends in a synchronise) = "
            f"the seqpar wrappers {h['wrappers'] * 1e3:.3f} ms (checks, "
            f"plan, launches enqueued) + the exchanges (all-gather, shift) "
            f"{h['exchanges'] * 1e3:.3f} ms + the rest (the loop, "
            f"allocations, the wait for the card) "
            f"{(h['wall'] - h['wrappers'] - h['exchanges']) * 1e3:.3f} ms; "
            f"the kernels on the card {t['alone_ms']} ms (profiler)")
        seqpar_kernels.append({
            "name": kernel, "route": "cuda", "source": SEQPAR_SOURCE,
            "replaces": replaces, "launches": launched, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    log(f"phase 8 NCCL world (1 rank): "
        + ", ".join(f"{s} {r['wall']:.3f}s (peak {r['peak']} B, "
                    f"{r['collectives']} collectives, launches "
                    f"{r['launches']}, device operations in a profiler "
                    f"trace of one more call "
                    f"{r.get('device_ops', 'not traced')})"
                    for s, r in nccl["steps"].items())
        + f"; results {'==' if nccl_ok else '!='} the gloo world's and the "
          f"references")
    if not nccl_ok:
        failed.append("NCCL world: results differ")
    if failed:
        for msg in failed:
            log(f"phase 8 FAILED: {msg}")
        return None
    log(f"phase 8 parallel layer passed: {time.perf_counter() - t8:.1f}s; "
        f"max abs err {errs}; card {card_line}")
    return errs, seqpar_kernels


# Phase 9: the port's drivers of the path (bench_torch.py and the two
# scripts/*_torch.py demos; bench_scaling_torch.py and the demos' other
# rows are run on their own).
DRIVER_PAIRS = 16_384           # pairs of the one ops.overlap_scores call
DENSE_COVERAGES = (10.0, 30.0)
LONG_DRIVER_ROW = ("fast", 5)


def load_driver(rel: str):
    """A driver of the repo by its path (the scripts/ ones have no
    package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drivers(log, genome: str, card_line: str, device="cuda"):
    """Phase 9: ``bench_torch.run`` at its full size (its JSON line, the
    kernel held to the plain version on copy 0), one ``ops.overlap_scores``
    call held to its plain version, the dense demo at C = 10 and 30 and
    the long demo's "fast, k=5" row with its banded check, each against
    the JAX package's constants, each path's launches counted from 0.
    Returns the max abs err of the kernel checks by kernel name, or None
    at the first failure (logged)."""
    import numpy as np
    import torch

    from genome_assembly_tpu_torch.ops import overlap as op
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    dev = torch.device(device)
    t9 = time.perf_counter()
    bench = load_driver("bench_torch.py")
    t = time.perf_counter()
    oa.launches = 0
    res = bench.run(device=device, **bench.config_from_env({}))
    launches = oa.launches
    if not res["equal"]:
        log("phase 9a FAILED: bench_torch's kernel outputs differ from the "
            "plain version's on copy 0")
        return None
    line = {k: res[k] for k in (*bench.BENCH_KEYS, "kernel_alone_us",
                                "bound_us", "bound_by",
                                "baseline_pairs_per_sec")}
    log(f"phase 9a bench_torch.run: {time.perf_counter() - t:.1f}s, "
        f"all-pairs launches {launches}, kernel == plain on copy 0; card "
        f"{card_line}")
    log(f"phase 9a {json.dumps(line)}")
    if launches < res["sweeps_per_fetch"]:
        log("phase 9a FAILED: the bench did not launch the all-pairs kernel "
            "once a sweep")
        return None

    # one ops.overlap_scores call at the bench's reads: sampled pairs, a
    # right-aligned, every fourth read with an N, held to the plain version
    codes, lengths = bench.bench_reads(1000, 100)
    rs = np.random.RandomState(9)
    lengths = rs.randint(0, 101, size=len(lengths)).astype(np.int32)
    codes[np.arange(100)[None, :] >= lengths[:, None]] = 4
    for r in range(0, len(codes), 4):
        if lengths[r]:
            codes[r, rs.randint(0, lengths[r])] = 4
    ia = rs.randint(0, len(codes), DRIVER_PAIRS)
    ib = rs.randint(0, len(codes), DRIVER_PAIRS)
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (codes[ia], lengths[ia], codes[ib], lengths[ib])]
    args[0] = op.right_align(args[0], args[1])
    op.launches = 0
    s_k, e_k = op.overlap_scores(*(x.to(dev) for x in args))
    pair_launches = op.launches
    s_p, e_p = op.overlap_scores(*args)
    pair_err = max(int((s_k.cpu() - s_p).abs().max()),
                   int((e_k.cpu() - e_p).abs().max()))
    log(f"phase 9b ops.overlap_scores on {DRIVER_PAIRS} pairs (L=100, "
        f"ragged, N inside every fourth read): pair-list launches "
        f"{pair_launches}, kernel {'==' if pair_err == 0 else '!='} plain "
        f"(max abs err {pair_err})")
    if pair_err or pair_launches != 1:
        log("phase 9b FAILED: ops.overlap_scores")
        return None

    dense = load_driver(os.path.join("scripts", "dense_demo_torch.py"))
    for coverage in DENSE_COVERAGES:
        row = dense.run_row(genome, coverage, device=device)
        log(f"phase 9c dense demo C={coverage:g}: {json.dumps(row)}; card "
            f"{card_line}")
        if (row["launches"]["overlap_allpairs"] < 1
                or row["launches"]["sw_full_width"] < 1):
            log("phase 9c FAILED: the dense demo did not launch the "
                "all-pairs and the full-width SW kernel")
            return None
        if not row["equal"]:
            log(f"phase 9c FAILED: C={coverage:g} differs from the JAX "
                f"package's: {json.dumps(dense.EXPECTED[coverage])}")
            return None
    long_demo = load_driver(os.path.join("scripts",
                                         "long_genome_demo_torch.py"))
    lg, reads = long_demo.long_inputs()
    mode, k = LONG_DRIVER_ROW
    row = long_demo.run_row(lg, reads, k, mode, device=device,
                            full_delta=False,
                            expected=long_demo.EXPECTED[mode, k])
    log(f"phase 9d long demo \"{mode}, k={k}\" (banded metrics and the "
        f"256-contig banded check; its full-width pass runs with the "
        f"script): {json.dumps(row)}; card {card_line}")
    ran = row["launches"]
    if (ran["overlap_allpairs"] + ran["overlap_pairs"] < 1
            or ran["sw_banded"] < 1 or sw.full_width_launches < 1):
        log("phase 9d FAILED: the row did not launch an overlap kernel and "
            "both SW kernels")
        return None
    if not row["equal"]:
        log(f"phase 9d FAILED: the row differs from the JAX package's or "
            f"its banded check found a difference: "
            f"{json.dumps(long_demo.EXPECTED[mode, k])}")
        return None
    log(f"phase 9 drivers passed: {time.perf_counter() - t9:.1f}s; card "
        f"{card_line}")
    return {"overlap_allpairs": 0, "overlap_pairs": pair_err}


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
    from genome_assembly_tpu_torch.ops import seqpar as sq
    from genome_assembly_tpu_torch.ops import smith_waterman as sw
    from genome_assembly_tpu_torch.simulate import (
        generate_error_free_reads,
        generate_error_prone_reads,
        read_genome_from_fasta,
    )
    from genome_assembly_tpu_torch.utils.tracing import global_tracer

    dev = torch.device("cuda", 0)

    # ---- phase 2: build --------------------------------------------------
    with ThreadPoolExecutor(max_workers=6) as pool:
        futures = [pool.submit(oa.load_kernel), pool.submit(op.load_kernel),
                   pool.submit(sw.load_kernel), pool.submit(sq.load_kernel),
                   pool.submit(graphcore.load),
                   pool.submit(ptxas_report, sq.SOURCE, _build.BUILD_DIR)]
        for f in futures:
            f.result()
    log(f"phase 2 build: nvcc overlap_allpairs "
        f"{_build.BUILD_SECONDS['overlap_allpairs']}s, nvcc overlap_pairs "
        f"{_build.BUILD_SECONDS['overlap_pairs']}s, nvcc smith_waterman "
        f"{_build.BUILD_SECONDS['smith_waterman']}s, nvcc seqpar "
        f"{_build.BUILD_SECONDS['seqpar']}s, g++ graphcore "
        f"{_build.BUILD_SECONDS['graphcore']}s (None: already built)")
    for kernel, info in futures[-1].result().items():
        log(f"phase 2 nvcc -Xptxas -v seqpar: {kernel} {info}")

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

    OPS_PER_COMPARISON = oa.OPS_PER_COMPARISON
    n_cmp = oa.comparisons(main_lens, main_lens, L)
    ops_ms = OPS_PER_COMPARISON * n_cmp / PEAK_INT8_OPS * 1e3
    n_bytes = 2 * na * L + 2 * 4 * na + 2 * 4 * na * na
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    tc_ops = oa.tensor_core_ops(main_lens, main_lens)
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
    errs = new_pipelines(log, genome, card_line, sm_clock_hz)
    if errs is None:
        return 1
    par = parallel_path(log, genome, reads, contig_summary(contigs),
                        long_contigs, card_line,
                        parallel_config("cuda", sm_clock_hz))
    if par is None:
        return 1
    par_errs, seqpar_kernels = par
    kernels += seqpar_kernels
    driver_errs = drivers(log, genome, card_line)
    if driver_errs is None:
        return 1
    for entry in kernels:
        for found in (errs, par_errs, driver_errs):
            if entry["name"] in found:
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           found[entry["name"]])
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"all phases passed; wall {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
