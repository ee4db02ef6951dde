"""``chip_smoke.py`` phase 7b's constants: the JAX package's unitig
pipeline on the first UNITIG_READS of phase 7a's reads reproduces
UNITIG_EXPECTED (~110 s of its Python path search on a CPU), and so does
the port on the CPU (under a second)."""

import hashlib
import importlib.util
import os
import random

import numpy as np

from genome_assembly_tpu.metrics.measures import calculate_n50
from genome_assembly_tpu.models.unitig import (
    assemble_contigs as jax_unitigs,
)
from genome_assembly_tpu.simulate import read_genome_from_fasta
from genome_assembly_tpu.simulate.errors import generate_error_prone_reads
from genome_assembly_tpu.simulate.reads import generate_error_free_reads
from genome_assembly_tpu_torch.models.unitig import (
    assemble_contigs as port_unitigs,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reads(smoke):
    """Phase 7a's error-prone reads (test_assembly_new_pipeline draws them
    first), cut to the first UNITIG_READS."""
    cfg = smoke.NEW_PIPELINE
    genome = read_genome_from_fasta(os.path.join(ROOT, smoke.GENOME))
    reads = generate_error_prone_reads(
        generate_error_free_reads(genome, cfg["read_length"],
                                  cfg["num_reads"],
                                  rng=random.Random(cfg["seed"])),
        cfg["error_prob"], rs=np.random.RandomState(cfg["seed"]))
    return reads[:smoke.UNITIG_READS]


def _summary(contigs):
    return {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
    }


def test_unitig_constants_match_jax():
    smoke = _load_smoke()
    assert _summary(jax_unitigs(_reads(smoke))) == smoke.UNITIG_EXPECTED


def test_port_reproduces_the_unitig_constants_on_the_cpu():
    smoke = _load_smoke()
    assert (_summary(port_unitigs(_reads(smoke), device="cpu"))
            == smoke.UNITIG_EXPECTED)
