"""``chip_smoke.py``: its constants, and its refusal to run without a card."""

import hashlib
import importlib.util
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from genome_assembly_tpu.experiments.runner import (
    test_assembly as run_jax_assembly,
)
from genome_assembly_tpu.metrics.measures import calculate_n50
from genome_assembly_tpu.simulate import read_genome_from_fasta
from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly as run_port_assembly,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_constants_match_jax_test_assembly(tmp_path):
    """The JAX package reproduces the values chip_smoke.py holds the card's
    run to (PhiX, N=10000, l=150, p=0.01, k=5, seed 0)."""
    smoke = _load_smoke()
    genome = read_genome_from_fasta(os.path.join(ROOT, smoke.GENOME))
    contigs, measures, _, _ = run_jax_assembly(
        genome, smoke.READ_LENGTH, smoke.NUM_READS, smoke.ERROR_PROB,
        smoke.K, "smoke", 1, path=str(tmp_path),
        rng=random.Random(smoke.SEED),
        np_rng=np.random.RandomState(smoke.SEED))
    got = {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
        "measures": measures,
    }
    assert got == smoke.EXPECTED


def _long_run(run, smoke, tmp_path, **kwargs):
    lg = smoke.LONG
    contigs, measures, _, _ = run(
        smoke.long_genome(), lg["read_length"], lg["num_reads"],
        lg["error_prob"], lg["k"], "long", 1, path=str(tmp_path),
        rng=random.Random(lg["rng_seed"]),
        np_rng=np.random.RandomState(lg["np_seed"]), **kwargs)
    return {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
        "measures": measures,
    }


def test_long_genome_constants_match_jax_test_assembly(tmp_path):
    """The JAX package reproduces chip_smoke.py's long-genome constants (a
    50,000 bp genome: the metrics pass takes the banded route)."""
    smoke = _load_smoke()
    assert _long_run(run_jax_assembly, smoke, tmp_path) == smoke.LONG_EXPECTED


def test_port_long_genome_path_on_the_host(tmp_path):
    smoke = _load_smoke()
    assert (_long_run(run_port_assembly, smoke, tmp_path, device="cpu")
            == smoke.LONG_EXPECTED)


@pytest.mark.parametrize("row", ["exact, k=15", "fast, k=5"])
def test_long90_constants_match_jax_test_assembly(row, tmp_path):
    """The JAX package reproduces chip_smoke.py's constants for the
    long-genome path at LONG_GENOME.json's size (N=90000; the sparse
    route, and for "fast, k=5" the greedy layout with consensus)."""
    smoke = _load_smoke()
    lg = smoke.LONG90
    kw = dict(smoke.LONG90_ROWS)[row]
    contigs, measures, _, _ = run_jax_assembly(
        smoke.long_genome(), lg["read_length"], lg["num_reads"],
        lg["error_prob"], kw["k"], "long90", 1, path=str(tmp_path),
        rng=random.Random(lg["rng_seed"]),
        np_rng=np.random.RandomState(lg["np_seed"]),
        exact_parity=kw["exact_parity"])
    got = {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
        "measures": measures,
    }
    assert got == smoke.LONG90_EXPECTED[row]


def test_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, SMOKE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_smoke_bound_counts_comparisons():
    smoke = _load_smoke()
    rs = np.random.RandomState(0)
    a_len = rs.randint(0, 13, size=9)
    b_len = rs.randint(0, 13, size=7)
    brute = sum(min(n, j) for n in a_len for m in b_len
                for j in range(1, m + 1))
    assert smoke.comparisons(a_len, b_len, 12) == brute


def test_smoke_bound_counts_pair_list_comparisons():
    smoke = _load_smoke()
    rs = np.random.RandomState(1)
    a_len = rs.randint(0, 13, size=40)
    b_len = rs.randint(0, 13, size=40)
    brute = sum(min(n, j) for n, m in zip(a_len, b_len)
                for j in range(1, m + 1))
    assert smoke.pair_comparisons(a_len, b_len, 12) == brute
