"""``chip_smoke.py``: its constants, its trace reading, and its refusal to
run without a card."""

import hashlib
import importlib.util
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from genome_assembly_tpu.experiments.harness import run_experiments
from genome_assembly_tpu.experiments.runner import run_for_params
from genome_assembly_tpu.experiments.runner import (
    test_assembly as run_jax_assembly,
)
from genome_assembly_tpu.metrics.measures import calculate_n50
from genome_assembly_tpu.simulate import read_genome_from_fasta
from genome_assembly_tpu_torch.__main__ import quick_grids
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


def test_sweep_constants_match_jax_run_for_params(tmp_path):
    """The JAX package's run_for_params reproduces phase 6a's aggregate
    (PhiX, N=10000, l=150, p=0.01, k=5, 3 iterations, seed 0); its first
    iteration is phase 4's run."""
    smoke = _load_smoke()
    genome = read_genome_from_fasta(os.path.join(ROOT, smoke.GENOME))
    params = smoke.sweep_params(genome)
    agg = run_for_params(params, path=str(tmp_path),
                         rng=random.Random(smoke.SEED),
                         np_rng=np.random.RandomState(smoke.SEED))
    got = {k: v for k, v in agg.items()
           if k.endswith((" avg", " std", " raw"))}
    assert got == smoke.SWEEP_EXPECTED
    assert [type(v) for v in got["expected_coverage raw"]] == [
        type(params["expected_coverage"])] * smoke.SWEEP_ITERATIONS
    assert {m: v[0] for m, v in ((m, agg[f"{m} raw"])
                                 for m in smoke.EXPECTED["measures"])} == (
        smoke.EXPECTED["measures"])
    assert all(agg[k] == v for k, v in params.items())


def test_quick_constants_match_jax_run_experiments(tmp_path):
    """The JAX package's run_experiments on the --quick grids, seeded
    through run_kw, writes the 12 CSVs whose hashes phase 6b holds."""
    smoke = _load_smoke()
    fasta = os.path.join(ROOT, smoke.GENOME)
    run_experiments(fasta, str(tmp_path / "results"), str(tmp_path / "plots"),
                    num_iterations=1, make_plots=False,
                    grids=quick_grids(len(read_genome_from_fasta(fasta))),
                    rng=random.Random(smoke.SEED),
                    np_rng=np.random.RandomState(smoke.SEED))
    assert smoke.csv_hashes(str(tmp_path / "results")) == smoke.QUICK_EXPECTED


def test_smoke_device_busy_unions_intervals():
    smoke = _load_smoke()

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        ev("user_annotation", "other", 0, 1000),
        ev("user_annotation", "test_assembly", 100, 100),
        ev("kernel", "void k1()", 90, 20),          # clipped to 100..110
        ev("kernel", "void k2()", 105, 10),         # overlaps k1: 110..115
        ev("gpu_memcpy", "Memcpy HtoD", 150, 10),   # 150..160
        ev("gpu_memset", "Memset", 195, 30),        # clipped to 195..200
        ev("cpu_op", "aten::add", 100, 100),        # host: not counted
        ev("kernel", "void k3()", 300, 5),          # outside the span
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 120},
    ]}
    span, busy, by_name = smoke.device_busy(trace)
    assert span == 100
    assert busy == 15 + 10 + 5
    assert by_name == {"void k1()": 10, "void k2()": 10, "Memcpy HtoD": 10,
                       "Memset": 5, "void k3()": 0}
    with pytest.raises(ValueError, match="test_assembly"):
        smoke.device_busy({"traceEvents": trace["traceEvents"][:1]})
