"""The port's experiment harness against the JAX package's, on the CPU.

On a toy genome and a tiny grid, with seeded rngs through ``run_kw``:
- ``default_grids`` and ``filter_results`` return what the JAX package's
  return;
- ``experiment_const_coverage``, ``experiment_varying_value`` and
  ``run_experiments`` without plots return the same results, print the
  same lines and write every CSV byte-equal to the JAX package's;
- with plots, ``experiment_const_coverage`` draws the same PNG files (by
  relative path);
- the ``data_replace_experiment`` reload path hands the comparison plots
  the same groups of reloaded rows;
- ``plot_reconstructed_coverage`` raises ValueError in both packages (it
  unpacks four of the six values the alignment returns).
"""

import math
import os
import random

import numpy as np
import pytest

from genome_assembly_tpu import plots as jax_plots
from genome_assembly_tpu.experiments import harness as jax_harness
from genome_assembly_tpu_torch import plots
from genome_assembly_tpu_torch.experiments import harness

GRIDS = ([0.5, 1], np.array([20, 40]), np.array([20, 30]), np.array([0.01]),
         np.array([5]))


def _genome(n=400, seed=3):
    r = random.Random(seed)
    return "".join(r.choice("ACGT") for _ in range(n))


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("genome") / "toy.fasta"
    path.write_text(">toy\n" + _genome() + "\n")
    return str(path)


def _kw(port: bool):
    kw = {"rng": random.Random(5), "np_rng": np.random.RandomState(5)}
    if port:
        kw["device"] = "cpu"
    return kw


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _both(tmp_path, capsys, call):
    """Run `call(module, root, port)` for both packages; (results, files,
    printed) of each, with the root in printed lines replaced."""
    out = {}
    for name, module in (("jax", jax_harness), ("port", harness)):
        root = str(tmp_path / name)
        value = call(module, root, name == "port")
        printed = capsys.readouterr().out.replace(root, "<root>")
        out[name] = value, _files(root), printed
    return out["jax"], out["port"]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("genome_length", [5386, 400, 50_000])
def test_default_grids_match_jax(genome_length):
    want = jax_harness.default_grids(genome_length)
    got = harness.default_grids(genome_length)
    assert got[0] == want[0]
    assert [type(c) for c in got[0]] == [type(c) for c in want[0]]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_filter_results_matches_jax():
    rows = [{"k": 5, "p": 0.1}, {"k": 10, "p": 0.01}, {"k": 5, "p": 0.01}]
    for key, values in [("k", 5), ("k", [10, 5]), ("k", (5,)),
                        ("k", np.array([10, 15])), ("p", 0.01),
                        ("p", np.array([0.01, 0.1]))]:
        assert (harness.filter_results(rows, key, values)
                == jax_harness.filter_results(rows, key, values))


@pytest.mark.parametrize("axis", ["n_values", "l_values"])
def test_experiment_const_coverage_matches_jax(axis, tmp_path, capsys):
    values = {"n_values": [20, 40], "l_values": [20, 30]}[axis]

    def call(module, root, port):
        return module.experiment_const_coverage(
            _genome(), 1, [0.0, 0.01], [4, 5], **{axis: values},
            experiment_name="cc", paths=[root + "/csv", root + "/plots"],
            num_iterations=2, return_results=True, make_plots=False,
            **_kw(port))

    want, got = _both(tmp_path, capsys, call)
    assert got[0] == want[0]
    assert got[1] == want[1] and len(got[1]) == 2
    assert got[2] == want[2]


def test_experiment_const_coverage_refuses_both_axes():
    for module in (jax_harness, harness):
        with pytest.raises(ValueError, match="not both"):
            module.experiment_const_coverage(
                _genome(), 1, [0.01], [5], n_values=[20], l_values=[20],
                make_plots=False)


@pytest.mark.parametrize("varying", ["n", "l"])
def test_experiment_varying_value_matches_jax(varying, tmp_path, capsys):
    n_values, l_values = (([20, 40], [25]) if varying == "n"
                          else ([30], [20, 30]))

    def call(module, root, port):
        return module.experiment_varying_value(
            _genome(), n_values, l_values, [0.01], [4, 5],
            expected_coverage=[0.5, 1, 2], experiment_name=f"vary_{varying}",
            paths=[root + "/csv", root + "/plots"], num_iterations=1,
            separator=25, return_results=True, make_plots=False,
            **_kw(port))

    want, got = _both(tmp_path, capsys, call)
    assert got[0] == want[0]
    assert got[1] == want[1] and len(got[1]) == 2
    assert got[2] == want[2]


def test_run_experiments_csvs_match_jax(fasta, tmp_path, capsys):
    def call(module, root, port):
        module.run_experiments(
            fasta, root + "/results", root + "/plots", num_iterations=1,
            make_plots=False, grids=GRIDS, **_kw(port))

    want, got = _both(tmp_path, capsys, call)
    assert len(want[1]) == 12
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_plots_draw_the_jax_packages_files(tmp_path, capsys):
    def call(module, root, port):
        module.experiment_const_coverage(
            _genome(), 1, [0.01], [5], l_values=[20],
            experiment_name="cc", paths=[root + "/csv", root + "/plots"],
            num_iterations=1, make_plots=True, **_kw(port))

    want, got = _both(tmp_path, capsys, call)
    pngs = sorted(p for p in want[1] if p.endswith(".png"))
    assert len(pngs) >= 10
    assert sorted(got[1]) == sorted(want[1])
    assert {p: b for p, b in got[1].items() if p.endswith(".csv")} == {
        p: b for p, b in want[1].items() if p.endswith(".csv")}


@pytest.mark.parametrize("experiment", [1, 2, 3])
def test_data_replace_reload_matches_jax(experiment, fasta, tmp_path,
                                         monkeypatch, capsys):
    """Both packages reload the same saved CSVs and hand the comparison
    plots the same rows grouped by expected coverage."""
    results = str(tmp_path / "results")
    jax_harness.run_experiments(fasta, results, str(tmp_path / "plots"),
                                num_iterations=1, make_plots=False,
                                grids=GRIDS, rng=random.Random(5),
                                np_rng=np.random.RandomState(5))
    handed = {}
    for name, module, plot_module in (("jax", jax_harness, jax_plots),
                                      ("port", harness, plots)):
        calls = handed.setdefault(name, [])
        monkeypatch.setattr(
            plot_module, "plot_coverage_comparison",
            lambda rows, g, path, calls=calls: calls.append(
                (rows, g, os.path.relpath(path, str(tmp_path)))))
        module.run_experiments(
            fasta, results, str(tmp_path / "plots"), skip_1=True,
            skip_2=True, skip_3=True, data_replace_experiment=experiment,
            num_iterations=1, make_plots=True, grids=GRIDS)
    capsys.readouterr()
    assert len(handed["jax"]) == 2
    assert all(rows for rows, _, _ in handed["jax"])
    assert _same(handed["port"], handed["jax"])


def test_plot_reconstructed_coverage_raises_in_both(tmp_path):
    genome = _genome()
    contigs, reads = [genome[10:60], genome[100:150]], [genome[20:40]]
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_plots.plot_reconstructed_coverage(
            contigs, reads, 1, 20, genome, "r", 1, str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="too many values to unpack"):
        plots.plot_reconstructed_coverage(
            contigs, reads, 1, 20, genome, "r", 1, str(tmp_path / "port"),
            device="cpu")
