"""The port's host route at the long-genome path's recorded size (N=90000):
both rows of ``chip_smoke.py``'s phase 4c on the CPU give the JAX package's
constants (``LONG90_EXPECTED``, guarded by tests/test_torch_smoke.py)."""

import hashlib
import importlib.util
import os
import random

import numpy as np
import pytest

from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly as run_port_assembly,
)
from genome_assembly_tpu_torch.metrics.measures import calculate_n50

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row", ["exact, k=15", "fast, k=5"])
def test_port_long90_path_on_the_host(row, tmp_path):
    smoke = _load_smoke()
    lg = smoke.LONG90
    kw = dict(smoke.LONG90_ROWS)[row]
    contigs, measures, _, _ = run_port_assembly(
        smoke.long_genome(), lg["read_length"], lg["num_reads"],
        lg["error_prob"], kw["k"], "long90", 1, path=str(tmp_path),
        rng=random.Random(lg["rng_seed"]),
        np_rng=np.random.RandomState(lg["np_seed"]), device="cpu",
        exact_parity=kw["exact_parity"])
    got = {
        "contigs": len(contigs),
        "n50": calculate_n50(contigs),
        "total_length": sum(len(c) for c in contigs),
        "sha256": hashlib.sha256("\n".join(contigs).encode()).hexdigest(),
        "measures": measures,
    }
    assert got == smoke.LONG90_EXPECTED[row]
