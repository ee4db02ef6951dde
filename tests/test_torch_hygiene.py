"""The port stands alone and never runs on the CPU by accident.

- every module of the port, and chip_smoke.py, imports with JAX and the JAX
  package blocked, and none of their sources imports either;
- the entry points default to the card and raise without one;
- a failed build of the C++ engine or of the kernel raises; nothing falls
  back.
"""

import os
import pkgutil
import random
import re
import subprocess
import sys

import pytest
import torch

import genome_assembly_tpu_torch
from genome_assembly_tpu_torch import _build
from genome_assembly_tpu_torch.experiments.runner import (
    test_assembly as run_assembly,
)
from genome_assembly_tpu_torch.graph.build import candidate_pairs_arrays
from genome_assembly_tpu_torch.graph.greedy import assemble_contigs_greedy
from genome_assembly_tpu_torch.native import graphcore
from genome_assembly_tpu_torch.ops import overlap, overlap_allpairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(genome_assembly_tpu_torch.__file__))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="genome_assembly_tpu_torch."))


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_imports_with_jax_blocked():
    code = (
        "import importlib, importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genome_assembly_tpu'] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'genome_assembly_tpu.')) for m, v in sys.modules.items() "
        "if v is not None)\n"
        "print('imported', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax\b|genome_assembly_tpu(?!_torch)\b)", re.M)
    offenders = [p for p in _port_sources()
                 if pattern.search(open(p, encoding="utf-8").read())]
    assert offenders == []
    assert len(list(_port_sources())) > 20


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_assembly("ACGT" * 50, 20, 10, 0.0, 3, "t", 1,
                     rng=random.Random(0))


def test_wrapper_never_falls_back_off_the_cpu():
    codes = torch.zeros((2, 4), dtype=torch.int8, device="meta")
    lens = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        overlap_allpairs.overlap_scores_block(codes, lens, codes, lens)


def test_failed_engine_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "graphcore.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(graphcore, "SOURCE", str(broken))
    monkeypatch.setattr(graphcore, "_LIB", None)
    with pytest.raises(RuntimeError, match="graphcore.*failed"):
        graphcore.load()
    assert graphcore._LIB is None
    assert not any((tmp_path / "build").iterdir())


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(overlap_allpairs, "_LIB", None)
    monkeypatch.setattr(overlap_allpairs, "_nvcc",
                        lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="overlap_allpairs.*failed"):
        overlap_allpairs.load_kernel()


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        candidate_pairs_arrays(["ACGTA", "CGTAC"], 3)
    with pytest.raises(RuntimeError, match="cuda"):
        assemble_contigs_greedy(["ACGTA", "CGTAC"], k=3)
    with pytest.raises(RuntimeError, match="cuda"):
        run_assembly("ACGT" * 50, 20, 10, 0.0, 3, "t", 1,
                     rng=random.Random(0), exact_parity=False)


def test_pair_wrapper_never_falls_back_off_the_cpu():
    codes = torch.zeros((2, 4), dtype=torch.int8, device="meta")
    lens = torch.zeros((2,), dtype=torch.int32, device="meta")
    idx = torch.zeros((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        overlap.overlap_scores_pairs(codes, lens, idx, idx)


def test_failed_pair_kernel_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(overlap, "_LIB", None)
    monkeypatch.setattr(overlap_allpairs, "_nvcc",
                        lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="overlap_pairs.*failed"):
        overlap.load_kernel()
    assert overlap._LIB is None
