"""k = 0 dense-regime demonstration of the PyTorch/CUDA port on one card.

The port's counterpart of ``scripts/dense_demo.py``: ``test_assembly`` on
PhiX at k = 0 (every ordered pair of unique reads scored, no k-mer
filter), l = 100, p = 0.01, seed 0, at coverage C with N = ceil(C * 5386 /
100) reads (N = 539 and 1,616 at the default C = 10 and 30). The
reference could not finish this regime (its cycle removal ran for 48
hours); here the all-pairs kernel scores the pairs, the C++ engine removes
the cycles and the full-width Smith-Waterman kernel aligns the contigs.

Each row has ``dense_demo.py``'s keys (stage walls from the tracer, the
pairs scored, the contig count, N50, coverage and genome-level mismatch)
plus the card's name, the kernels' launches, the contigs' sha256 and total
length, the five measures, and whether they equal the JAX package's run
(``EXPECTED``, recorded on the CPU; ``tests/test_torch_scripts.py``
re-runs the JAX package at C = 10 and asserts it, and the card's run of
this script holds C = 30). The script exits 1 when a row differs.

    python3 scripts/dense_demo_torch.py [C ...]      (default: 10 30)

Rows go to stdout and to DENSE_OUT (default
``results/dense_demo_torch.json``, which ``.gitignore`` lists); the
tracked ``DENSE_DEMO.json`` is the JAX package's and is never written.
Runs on the card only: without one it raises.
"""

from __future__ import annotations

import json
import math
import os
import random
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

L, P, K, SEED = 100, 0.01, 0, 0
DEFAULT_OUT = os.path.join(ROOT, "results", "dense_demo_torch.json")

# What the JAX package's test_assembly returns at (C, N) on PhiX, k = 0,
# l = 100, p = 0.01, rng Random(0), np_rng RandomState(0) (on the CPU).
EXPECTED = {
    10.0: {
        "contigs": 3,
        "n50": 5173,
        "total_length": 5349,
        "sha256": "cf93de27c4ddb5734365eaa5c0b05e0ccf4e7c8284d415aad028319a8ef1f04c",
        "measures": {
            "Number of Contigs": 3,
            "Genome Coverage": 1.0,
            "N50": 5173,
            "Mismatch Rate Aligned Regions": 0.3770887486075009,
            "Mismatch Rate Genome Level": 0.3770887486075009,
        },
    },
    30.0: {
        "contigs": 3,
        "n50": 5386,
        "total_length": 5402,
        "sha256": "dbe32e0c72ac0f855655fbe360e433e487898f16eb51b77260442e8d0b17c2b3",
        "measures": {
            "Number of Contigs": 3,
            "Genome Coverage": 1.0,
            "N50": 5386,
            "Mismatch Rate Aligned Regions": 0.01058299294467137,
            "Mismatch Rate Genome Level": 0.01058299294467137,
        },
    },
}


def phix() -> str:
    from genome_assembly_tpu_torch.simulate import read_genome_from_fasta

    return read_genome_from_fasta(os.path.join(ROOT, "data",
                                               "phix174.fasta"))


def reads_for(coverage: float, genome_len: int) -> int:
    """N = ceil(C * G / l) (the reference's experiments.py:271-276)."""
    return int(math.ceil(coverage * genome_len / L))


def run_row(genome: str, coverage: float, device="cuda") -> dict:
    """One ``test_assembly`` at coverage C on `device`; the row, with
    ``equal`` True, False, or None where no constant was recorded."""
    import torch

    from genome_assembly_tpu_torch.core.dispatch import resolve_device
    from genome_assembly_tpu_torch.experiments.runner import test_assembly
    from genome_assembly_tpu_torch.metrics.measures import contig_summary
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw
    from genome_assembly_tpu_torch.utils.tracing import global_tracer

    dev = resolve_device(device)
    n = reads_for(coverage, len(genome))
    tracer = global_tracer()
    tracer.reset()
    oa.launches = 0
    sw.full_width_launches = sw.banded_launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        contigs, measures, _, _ = test_assembly(
            genome, L, n, P, K, f"dense_k0_C{coverage}", 1, path=tmp,
            rng=random.Random(SEED), np_rng=np.random.RandomState(SEED),
            device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    got = {**contig_summary(contigs), "measures": measures}
    want = EXPECTED.get(float(coverage))
    row = {
        "C": float(coverage), "N": n, "l": L, "k": K, "p": P,
        "platform": dev.type,
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else None),
        "wall_seconds": wall,
        "stages": dict(tracer.times),
        "pairs_scored": int(tracer.items.get("score.pairs", 0)),
        "num_contigs": len(contigs),
        "n50": measures["N50"],
        "genome_coverage": float(measures["Genome Coverage"]),
        "mismatch_rate_genome": float(measures["Mismatch Rate Genome Level"]),
        "launches": {"overlap_allpairs": oa.launches,
                     "sw_full_width": sw.full_width_launches,
                     "sw_banded": sw.banded_launches},
        **{key: got[key] for key in ("sha256", "total_length", "measures")},
        "equal": None if want is None else got == want,
    }
    return row


def build(device) -> None:
    """Build the path's kernels and the C++ engine before the first row, so
    that no row's wall holds a compile and a failed build raises first."""
    from genome_assembly_tpu_torch.core.dispatch import resolve_device
    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    if resolve_device(device).type == "cuda":
        oa.load_kernel()
        sw.load_kernel()
    graphcore.load()


def write_rows(rows: list[dict], out: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rows, f, indent=1)


def main(argv: list[str]) -> int:
    coverages = [float(c) for c in argv] or [10.0, 30.0]
    build("cuda")
    genome = phix()
    rows = []
    for coverage in coverages:
        row = run_row(genome, coverage, device="cuda")
        rows.append(row)
        print(json.dumps(row), flush=True)
    write_rows(rows, os.environ.get("DENSE_OUT", DEFAULT_OUT))
    bad = [r["C"] for r in rows if r["equal"] is False]
    if bad:
        print(f"dense_demo_torch: rows at C={bad} differ from the JAX "
              f"package's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
