"""The port's sweep runners against the JAX package's, on the CPU.

- ``run_simulations``, ``_aggregate`` and ``run_for_params`` return what the
  JAX package's return (a 300 bp random genome, N = 30, l = 20, k = 5, 3
  iterations, seeded), scalar types included;
- ``run_simulations_parallel`` with ``n_jobs=2`` (spawned workers) equals
  ``run_for_params`` run per config from a copy of the rngs, and with
  ``n_jobs=1`` equals the JAX package's ``n_jobs=1``;
- ``**kw`` reaches ``test_assembly`` (``device``, ``banded``,
  ``exact_parity``).
"""

import copy
import random

import numpy as np
import pytest
import torch

from genome_assembly_tpu.experiments import runner as jax_runner
from genome_assembly_tpu_torch.experiments import runner


def _genome(n=300, seed=0):
    r = random.Random(seed)
    return "".join(r.choice("ACGT") for _ in range(n))


def _params(**over):
    g = _genome()
    p = {"num_reads": 30, "read_length": 20, "error_prob": 0.01, "k": 5,
         "reference_genome": g, "expected_coverage": 30 * 20 / len(g),
         "experiment_name": "sweep", "num_iterations": 3, "contigs": None}
    p.update(over)
    return p


def _rngs(seed=7):
    return {"rng": random.Random(seed), "np_rng": np.random.RandomState(seed)}


def _types(x):
    if isinstance(x, dict):
        return {k: _types(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_types(v) for v in x]
    return type(x)


def test_run_simulations_matches_jax(tmp_path):
    configs = [_params(), _params(num_reads=40, k=3, error_prob=0.0)]
    got = runner.run_simulations(configs, 1, path=str(tmp_path), **_rngs(),
                                 device="cpu")
    want = jax_runner.run_simulations(configs, 1, path=str(tmp_path),
                                      **_rngs())
    assert got == want
    assert _types(got) == _types(want)


def test_aggregate_matches_jax():
    rows = [{"num_reads": 30, "N50": 20, "Genome Coverage": 0.5,
             "rate": np.float64(0.25), "name": "x", "flag": True,
             "contigs": ["ACG"]},
            {"num_reads": 30, "N50": 23, "Genome Coverage": 0.75,
             "rate": np.float64(0.5), "name": "x", "flag": False,
             "contigs": []}]
    params = _params()
    got = runner._aggregate(rows, params)
    want = jax_runner._aggregate(rows, params)
    assert got == want
    assert list(got) == list(want)
    assert _types(got) == _types(want)


def test_run_for_params_matches_jax(tmp_path, capsys):
    got = runner.run_for_params(_params(), path=str(tmp_path), **_rngs(),
                                device="cpu")
    port_out = capsys.readouterr().out
    want = jax_runner.run_for_params(_params(), path=str(tmp_path),
                                     **_rngs())
    assert capsys.readouterr().out == port_out
    assert got == want
    assert list(got) == list(want)
    assert _types(got) == _types(want)
    assert len(got["N50 raw"]) == 3


def test_parallel_pool_equals_copied_sequential_runs(tmp_path):
    configs = [_params(num_iterations=2),
               _params(num_iterations=1, num_reads=25, k=4),
               _params(num_iterations=2, read_length=25, error_prob=0.0)]
    kw = _rngs(11)
    pooled = runner.run_simulations_parallel(
        configs, path=str(tmp_path), n_jobs=2, device="cpu", **kw)
    alone = [runner.run_for_params(p, path=str(tmp_path), device="cpu",
                                   **copy.deepcopy(kw)) for p in configs]
    assert pooled == alone
    assert _types(pooled) == _types(alone)
    # the pool consumed none of the caller's rngs
    assert kw["rng"].random() == random.Random(11).random()


def test_sequential_matches_jax_n_jobs_1(tmp_path):
    configs = [_params(num_iterations=1), _params(num_iterations=2, k=4)]
    got = runner.run_simulations_parallel(configs, path=str(tmp_path),
                                          n_jobs=1, device="cpu", **_rngs())
    want = jax_runner.run_simulations_parallel(configs, path=str(tmp_path),
                                               n_jobs=1, **_rngs())
    assert got == want


@pytest.mark.parametrize("kw", [
    {"banded": True}, {"banded": False},
    {"exact_parity": False}, {"exact_parity": False, "banded": True},
], ids=["banded", "full-width", "fast-layout", "fast-layout-banded"])
def test_keywords_reach_test_assembly(kw, tmp_path):
    p = _params(num_iterations=2)
    got = runner.run_for_params(p, path=str(tmp_path), device="cpu",
                                **_rngs(), **kw)
    want = jax_runner.run_for_params(p, path=str(tmp_path), **_rngs(), **kw)
    assert got == want


def test_device_reaches_test_assembly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_for_params(_params(num_iterations=1), path=str(tmp_path),
                              **_rngs())
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_simulations_parallel([_params(num_iterations=1)],
                                        path=str(tmp_path), n_jobs=2,
                                        device="cuda", **_rngs())
