"""``python -m genome_assembly_tpu_torch`` against the JAX package's CLI.

- ``assemble --seed 0 --device cpu`` prints the lines the JAX CLI prints
  on the CPU;
- ``experiments --quick --iterations 1 --no-plots --device cpu`` writes
  the JAX CLI's file tree with the same CSV headers (the sweep is
  unseeded, so the numbers are not compared);
- ``--profile DIR`` writes DIR/trace.json, a Chrome trace holding the
  ``test_assembly`` span; ``profile(enabled=False)`` does nothing;
- ``--device cuda`` raises without a card, before any work;
- ``--help`` of each command exits 0.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from genome_assembly_tpu.__main__ import main as jax_main
from genome_assembly_tpu_torch.__main__ import main
from genome_assembly_tpu_torch.utils.tracing import profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fasta(tmp_path):
    r = random.Random(2)
    path = tmp_path / "toy.fasta"
    path.write_text(">toy\n" + "".join(r.choice("ACGT") for _ in range(500))
                    + "\n")
    return str(path)


@pytest.fixture(autouse=True)
def no_jax_cache(monkeypatch):
    # the JAX CLI would otherwise set up a persistent compile cache
    monkeypatch.setenv("GA_TPU_CACHE_DIR", "off")


@pytest.mark.parametrize("flags", [
    [], ["--full-width"], ["--banded"], ["--fast-layout"], ["--consensus"],
], ids=["default", "full-width", "banded", "fast-layout", "consensus"])
def test_assemble_prints_the_jax_clis_lines(flags, fasta, tmp_path, capsys):
    argv = ["assemble", "--fasta", fasta, "--n", "60", "--l", "40",
            "--p", "0.01", "--k", "5", "--seed", "0",
            "--plots", str(tmp_path), *flags]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert main([*argv, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("contigs: ")


def test_experiments_quick_writes_the_jax_clis_tree(fasta, tmp_path,
                                                    capsys):
    def tree(root):
        out = {}
        for dirpath, _, files in os.walk(root):
            for name in files:
                with open(os.path.join(dirpath, name)) as f:
                    out[os.path.relpath(os.path.join(dirpath, name),
                                        root)] = f.readline()
        return out

    trees = {}
    for name, fn, extra in (("jax", jax_main, []),
                            ("port", main, ["--device", "cpu"])):
        root = tmp_path / name
        assert fn(["experiments", "--fasta", fasta, "--quick",
                   "--iterations", "1", "--no-plots",
                   "--results", str(root / "results"),
                   "--plots", str(root / "plots"), *extra]) == 0
        trees[name] = tree(root)
    capsys.readouterr()
    assert len(trees["jax"]) == 12
    assert trees["port"] == trees["jax"]


def test_profile_writes_a_chrome_trace(fasta, tmp_path, capsys):
    out = tmp_path / "trace"
    assert main(["assemble", "--fasta", fasta, "--n", "40", "--l", "30",
                 "--seed", "1", "--device", "cpu", "--trace",
                 "--profile", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "-- stage trace --" in printed
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "user_annotation"
               and e.get("name") == "test_assembly" for e in events)


def test_profile_disabled_does_nothing(tmp_path):
    with profile(str(tmp_path / "off"), enabled=False) as prof:
        torch.ones(3).sum()
    assert prof is None
    assert not (tmp_path / "off").exists()


def test_device_cuda_raises_without_a_card(fasta, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for argv in (["assemble", "--fasta", fasta, "--n", "40"],
                 ["assemble", "--fasta", fasta, "--device", "cuda"],
                 ["experiments", "--fasta", fasta, "--quick",
                  "--results", str(tmp_path / "r"),
                  "--plots", str(tmp_path / "p")]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("command", [[], ["assemble"], ["experiments"]])
def test_help_exits_zero(command):
    proc = subprocess.run(
        [sys.executable, "-m", "genome_assembly_tpu_torch", *command,
         "--help"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "usage: genome_assembly_tpu_torch" in proc.stdout
    if command:
        assert "--device" in proc.stdout
