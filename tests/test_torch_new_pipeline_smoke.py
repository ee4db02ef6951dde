"""``chip_smoke.py`` phase 7a's constants: the JAX package's
``test_assembly_new_pipeline`` reproduces NEW_PIPELINE_EXPECTED (PhiX,
N = 1000, l = 100, p = 0.01, fuzz = 5, seed 0; ~150 s of its Python Myers
reduction on a CPU), and so does the port on the CPU (~6 s)."""

import hashlib
import importlib.util
import os
import random

import numpy as np

from genome_assembly_tpu.experiments.runner import (
    test_assembly_new_pipeline as jax_new_pipeline,
)
from genome_assembly_tpu.metrics.measures import calculate_n50
from genome_assembly_tpu.simulate import read_genome_from_fasta
from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly_new_pipeline as port_new_pipeline,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
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


def _run(run, smoke, tmp_path, **kwargs):
    cfg = smoke.NEW_PIPELINE
    genome = read_genome_from_fasta(os.path.join(ROOT, smoke.GENOME))
    contigs, measures, _, _ = run(
        genome, cfg["read_length"], cfg["num_reads"], "new_pipeline", 1,
        str(tmp_path), cfg["error_prob"], cfg["fuzz"],
        rng=random.Random(cfg["seed"]),
        np_rng=np.random.RandomState(cfg["seed"]), **kwargs)
    return _summary(contigs, measures)


def test_new_pipeline_constants_match_jax(tmp_path):
    smoke = _load_smoke()
    assert (_run(jax_new_pipeline, smoke, tmp_path)
            == smoke.NEW_PIPELINE_EXPECTED)


def test_port_reproduces_the_new_pipeline_constants_on_the_cpu(tmp_path):
    smoke = _load_smoke()
    assert (_run(port_new_pipeline, smoke, tmp_path, device="cpu")
            == smoke.NEW_PIPELINE_EXPECTED)
