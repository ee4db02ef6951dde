"""The port's drivers (``bench_torch.py``, ``bench_scaling_torch.py``,
``scripts/dense_demo_torch.py``, ``scripts/long_genome_demo_torch.py``)
at tiny sizes on the CPU, against the JAX package on the same inputs:

- ``bench_torch.run`` (BENCH_QUICK shapes): its checksums equal the same
  fold over JAX ``overlap_scores_all_pairs_xla`` on ``bench.py``'s reads;
- the dense demo's row at C = 2 against JAX ``test_assembly``;
- the long demo's four rows on a small genome against JAX
  ``assemble_contigs_using_overlap_graphs`` + ``calculate_measures``
  (banded and full width) and the JAX banded check;
- the scaling script at meshes 1 and 2 in a world of two gloo ranks: its
  checksums against the JAX fold, equal across the members;
- the recorded constants: the dense demo at C = 10 and the long demo's
  fast rows re-run through the JAX package, the "exact, k=15" row against
  ``chip_smoke.py``'s LONG_EXPECTED.
"""

import hashlib
import importlib
import importlib.util
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest

from genome_assembly_tpu.core.encoding import encode_batch as jax_encode_batch
from genome_assembly_tpu.experiments.runner import (
    test_assembly as run_jax_assembly,
)
from genome_assembly_tpu.metrics.align_to_ref import (
    align_contigs_to_reference as jax_align,
)
from genome_assembly_tpu.metrics.measures import (
    calculate_measures as jax_measures,
    calculate_n50 as jax_n50,
)
from genome_assembly_tpu.models.overlap_graph import (
    assemble_contigs_using_overlap_graphs as jax_assemble,
)
from genome_assembly_tpu.ops.overlap_allpairs import (
    overlap_scores_all_pairs_xla as jax_all_pairs,
)
from genome_assembly_tpu.simulate import (
    generate_error_free_reads,
    generate_error_prone_reads,
    read_genome_from_fasta,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel: str):
    """A driver by its path in the repo; those at the root by import (the
    scaling script's rank function is pickled by its module's name)."""
    path = os.path.join(ROOT, rel)
    name = os.path.splitext(os.path.basename(path))[0]
    if os.path.dirname(path) == ROOT:
        return importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(contigs, measures):
    return {"contigs": len(contigs), "n50": jax_n50(contigs),
            "total_length": sum(len(c) for c in contigs),
            "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
            "measures": measures}


def _jax_bench_codes(n, l):
    genome = read_genome_from_fasta(os.path.join(ROOT, "data",
                                                 "phix174.fasta"))
    reads = generate_error_free_reads(genome, l, n, rng=random.Random(0))
    reads = generate_error_prone_reads(reads, 0.01,
                                       rs=np.random.RandomState(0))
    return jax_encode_batch(reads, width=l, align="left")


def _jax_fold(codes, lengths, mask_diagonal=False):
    s, e = (np.asarray(x, np.int64)
            for x in jax_all_pairs(jnp.asarray(codes), jnp.asarray(lengths)))
    total = int(s.sum() + e.sum())
    return total - int(np.trace(s)) if mask_diagonal else total


def test_bench_checksum_matches_the_jax_fold():
    bench = _load("bench_torch.py")
    cfg = bench.config_from_env({"BENCH_QUICK": "1"})
    assert (cfg["n"], cfg["l"], cfg["rep"], cfg["rounds"]) == (128, 32, 4, 2)
    res = bench.run(device="cpu", baseline=False, **cfg)
    assert res["equal"]
    codes, lengths = _jax_bench_codes(cfg["n"], cfg["l"])
    port_codes, port_lengths = bench.bench_reads(cfg["n"], cfg["l"])
    np.testing.assert_array_equal(port_codes, codes)
    np.testing.assert_array_equal(port_lengths, lengths)
    folds = [_jax_fold(np.roll(codes, i + 1, axis=0), lengths)
             for i in range(cfg["rep"])]
    assert res["first_checksum"] == folds[0]
    assert res["chain_checksum"] == cfg["rounds"] * sum(folds)
    assert res["metric"] == "overlap_pairs_per_sec_per_chip(N=128,l=32,cpu)"
    assert set(bench.BENCH_KEYS) <= set(res)
    assert res["sweeps_per_fetch"] == cfg["rep"] * cfg["rounds"]


def test_bench_refuses_pallas():
    bench = _load("bench_torch.py")
    with pytest.raises(ValueError, match="no Pallas kernel"):
        bench.config_from_env({"BENCH_IMPL": "pallas"})
    assert bench.config_from_env({"BENCH_IMPL": "xla"})["impl"] == "xla"


def test_bench_work_counts():
    from genome_assembly_tpu_torch.ops.overlap_allpairs import (
        comparisons,
        tensor_core_ops,
    )

    lens = np.array([0, 1, 7, 8, 9, 16, 17])
    # the kernel issues 8 ceil(j/8) positions x 4 channels, a multiply-add
    # each, for every j <= len(b), for every a
    brute = 2 * 4 * len(lens) * sum(8 * -(-j // 8) for n in lens
                                    for j in range(1, n + 1))
    assert tensor_core_ops(lens, lens) == brute
    assert tensor_core_ops(lens, lens) >= 6 * comparisons(lens, lens, 17)


def test_dense_demo_row_matches_jax():
    dense = _load("scripts/dense_demo_torch.py")
    genome = dense.phix()
    row = dense.run_row(genome, 2.0, device="cpu")
    contigs, measures, _, _ = run_jax_assembly(
        genome, 100, dense.reads_for(2.0, len(genome)), 0.01, 0, "t", 1,
        path="unused", rng=random.Random(0),
        np_rng=np.random.RandomState(0))
    want = _summary(contigs, measures)
    assert row["N"] == 108 and row["k"] == 0 and row["platform"] == "cpu"
    assert row["equal"] is None
    assert {k: row[k] for k in ("sha256", "total_length", "measures")} == {
        k: want[k] for k in ("sha256", "total_length", "measures")}
    assert (row["num_contigs"], row["n50"]) == (want["contigs"], want["n50"])
    assert row["pairs_scored"] > 0 and "graph.remove_cycles" in row["stages"]
    assert dense.reads_for(10, len(genome)) == 539
    assert dense.reads_for(30, len(genome)) == 1616


@pytest.mark.parametrize("mode, k", [("fast", 15), ("exact", 15),
                                     ("fast", 5), ("exact", 5)])
def test_long_demo_row_matches_jax(mode, k):
    long_demo = _load("scripts/long_genome_demo_torch.py")
    genome, reads = long_demo.long_inputs(4000, 400, 100)
    contigs = jax_assemble(reads, k=k, exact_parity=mode == "exact")
    banded, _ = jax_measures(contigs, reads, 400, 100, long_demo.P, k,
                             genome, "t", 1, path="unused", banded=True)
    full, _ = jax_measures(contigs, reads, 400, 100, long_demo.P, k, genome,
                           "t", 1, path="unused", banded=False)
    want = _summary(contigs, banded)
    row = long_demo.run_row(genome, reads, k, mode, device="cpu",
                            expected=want)
    assert row["equal"] is True
    assert row["full_width_measures"] == full
    assert row["metric_delta_banded_minus_full"] == {
        "coverage": banded["Genome Coverage"] - full["Genome Coverage"],
        "mismatch_genome": banded["Mismatch Rate Genome Level"]
        - full["Mismatch Rate Genome Level"],
        "n50": banded["N50"] - full["N50"]}
    if mode == "fast":
        sample = [c for c in dict.fromkeys(contigs) if len(c) >= 100][:256]
        d_band = jax_align(sample, genome, 100, banded=True)
        d_full = jax_align(sample, genome, 100, banded=False)
        check = row["banded_check"]
        assert check["sample"] == len(sample)
        assert check["details_identical"] == sum(
            d_band[c] == d_full[c] for c in sample)
    else:
        assert "banded_check" not in row


def test_long_demo_row_flags_a_wrong_constant():
    long_demo = _load("scripts/long_genome_demo_torch.py")
    genome, reads = long_demo.long_inputs(3000, 200, 100)
    row = long_demo.run_row(genome, reads, 15, "exact", device="cpu",
                            full_delta=False,
                            expected={"contigs": -1, "n50": 0,
                                      "total_length": 0, "sha256": "",
                                      "measures": {}})
    assert row["equal"] is False


def test_scaling_rows_at_meshes_1_and_2_on_gloo(tmp_path):
    scaling = _load("bench_scaling_torch.py")
    cfg = scaling.config_from_env({"SCALE_N_PER_DEV": "16", "SCALE_L": "24",
                                   "SCALE_REP": "2", "SCALE_ROUNDS": "2",
                                   "SCALE_SEQPAR": "0"})
    report = scaling.run(cfg, device="cpu", world_size=2, timeout_s=300,
                         workdir=str(tmp_path))
    rows = report["rows"]
    assert [(r["mesh_size"], r["wrapper"]) for r in rows] == [
        (1, "direct"), (1, "sharded"), (2, "sharded")]
    assert all(r["backend"] == "gloo" and r["world_size"] == 2
               and r["ranks_per_card"] is None for r in rows)
    codes, lengths = _jax_bench_codes(16, 24)
    assert rows[0]["checksum"] == _jax_fold(np.roll(codes, 1, axis=0),
                                            lengths)
    assert rows[1]["checksum"] == _jax_fold(np.roll(codes, 1, axis=0),
                                            lengths, mask_diagonal=True)
    codes, lengths = _jax_bench_codes(32, 24)
    assert rows[2]["checksum"] == _jax_fold(np.roll(codes, 1, axis=0),
                                            lengths, mask_diagonal=True)
    assert rows[2]["checksums_agree"]
    assert rows[1]["scaling_efficiency"] == 1.0


def test_scaling_world_and_meshes():
    scaling = _load("bench_scaling_torch.py")
    assert scaling.default_world(1) == 8 and scaling.default_world(4) == 4
    strong = scaling.config_from_env({"SCALE_MODE": "strong",
                                      "SCALE_N": "12"})
    assert scaling.mesh_sizes(strong, 8) == [1, 2, 4]
    weak = scaling.config_from_env({})
    assert scaling.mesh_sizes(weak, 4) == [1, 2, 4]
    assert [scaling.reads_at(weak, m) for m in (1, 8)] == [512, 4096]


def test_dense_constant_at_c10_matches_jax():
    dense = _load("scripts/dense_demo_torch.py")
    genome = dense.phix()
    contigs, measures, _, _ = run_jax_assembly(
        genome, 100, 539, 0.01, 0, "t", 1, path="unused",
        rng=random.Random(0), np_rng=np.random.RandomState(0))
    assert _summary(contigs, measures) == dense.EXPECTED[10.0]


@pytest.mark.parametrize("k", [15, 5])
def test_long_fast_constants_match_jax(k):
    long_demo = _load("scripts/long_genome_demo_torch.py")
    genome, reads = long_demo.long_inputs()
    contigs = jax_assemble(reads, k=k, exact_parity=False)
    measures, _ = jax_measures(contigs, reads, long_demo.N,
                               long_demo.READ_LENGTH, long_demo.P, k, genome,
                               "t", 1, path="unused", banded=True)
    assert _summary(contigs, measures) == long_demo.EXPECTED["fast", k]


def test_long_exact_k15_constant_is_the_smokes():
    long_demo = _load("scripts/long_genome_demo_torch.py")
    smoke = _load("chip_smoke.py")
    assert long_demo.EXPECTED["exact", 15] == smoke.LONG_EXPECTED
    assert (smoke.LONG["genome_len"], smoke.LONG["num_reads"],
            smoke.LONG["read_length"], smoke.LONG["error_prob"]) == (
        long_demo.G, long_demo.N, long_demo.READ_LENGTH, long_demo.P)
