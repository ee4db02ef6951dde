"""The port's slice end to end against the JAX package's ``test_assembly``.

Same genome, same seeded ``random.Random`` / ``np.random.RandomState`` into
both; contigs, measures, details and reads must be identical.
"""

import hashlib
import importlib.util
import os
import random

import numpy as np
import pytest

from genome_assembly_tpu.experiments.runner import (
    test_assembly as run_jax_assembly,
)
from genome_assembly_tpu.simulate import (
    generate_error_free_reads as jax_error_free,
    generate_error_prone_reads as jax_error_prone,
    read_genome_from_fasta as jax_read_fasta,
)
from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly as run_assembly,
)
from genome_assembly_tpu_torch.metrics.measures import calculate_n50
from genome_assembly_tpu_torch.simulate import (
    generate_error_free_reads,
    generate_error_prone_reads,
    read_genome_from_fasta,
)
from genome_assembly_tpu_torch.utils.tracing import global_tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHIX = os.path.join(ROOT, "data", "phix174.fasta")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(contigs, measures):
    return {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
        "measures": measures,
    }


def test_host_samplers_bit_identical():
    genome = read_genome_from_fasta(PHIX)
    assert genome == jax_read_fasta(PHIX)
    reads = generate_error_prone_reads(
        generate_error_free_reads(genome, 90, 300, rng=random.Random(3)),
        0.05, rs=np.random.RandomState(3))
    ref = jax_error_prone(
        jax_error_free(genome, 90, 300, rng=random.Random(3)),
        0.05, rs=np.random.RandomState(3))
    assert reads == ref


@pytest.mark.parametrize("k", [5, 0])
def test_slice_matches_jax(k, tmp_path):
    genome = read_genome_from_fasta(PHIX)
    got = run_assembly(genome, 100, 200, 0.01, k, "parity", 1,
                       path=str(tmp_path), rng=random.Random(0),
                       np_rng=np.random.RandomState(0), device="cpu")
    ref = run_jax_assembly(genome, 100, 200, 0.01, k, "parity", 1,
                           path=str(tmp_path), rng=random.Random(0),
                           np_rng=np.random.RandomState(0))
    contigs, measures, details, reads = got
    assert reads == ref[3]
    assert contigs == ref[0]
    assert measures == ref[1]
    assert details == ref[2]


def test_slice_at_smoke_configuration_on_cpu(tmp_path):
    """The port on the CPU (host scorer) reproduces the smoke's constants and
    its stage counts: only the all-pairs kernel is left to the card."""
    smoke = _chip_smoke()
    tracer = global_tracer()
    tracer.reset()
    genome = read_genome_from_fasta(PHIX)
    contigs, measures, _, _ = run_assembly(
        genome, smoke.READ_LENGTH, smoke.NUM_READS, smoke.ERROR_PROB,
        smoke.K, "smoke", 1, path=str(tmp_path),
        rng=random.Random(smoke.SEED),
        np_rng=np.random.RandomState(smoke.SEED), device="cpu")
    assert _summary(contigs, measures) == smoke.EXPECTED
    stages = tracer.as_dict()
    assert stages["score.pairs"]["items"] == 136317
    assert stages["graph.remove_cycles"]["items"] == 150467
