"""The port stands alone and never runs on the CPU by accident.

- every module of the port, and chip_smoke.py, imports with JAX and the JAX
  package blocked, and none of their sources imports either;
- the sweep path (runner, harness, persist, the CLI) imports and runs a
  tiny sweep without plots with pandas, matplotlib and joblib blocked, as
  on the card machine;
- the entry points default to the card and raise without one;
- a failed build of the C++ engine or of the kernel raises; nothing falls
  back;
- the parallel layer: the spawned ranks' test entry module imports no JAX,
  a mesh on the card raises without one, NCCL for ranks that share a card
  raises rather than switching to gloo, and a failed or hung world raises;
- the drivers (``bench_torch.py``, ``bench_scaling_torch.py`` and the two
  ``scripts/*_torch.py`` demos) import no JAX, exit non-zero without a card
  and write no tracked file, and a failed kernel build raises in each.
"""

import hashlib
import importlib.util
import os
import pkgutil
import random
import re
import subprocess
import sys
import time

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
DRIVERS = ("bench_torch.py", "bench_scaling_torch.py",
           os.path.join("scripts", "dense_demo_torch.py"),
           os.path.join("scripts", "long_genome_demo_torch.py"))
SCRIPTS = ("chip_smoke.py", *DRIVERS)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="genome_assembly_tpu_torch."))


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for rel in DRIVERS:
        yield os.path.join(ROOT, rel)


def test_imports_with_jax_blocked():
    code = (
        "import importlib, importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genome_assembly_tpu'] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"for path in {[os.path.join(ROOT, p) for p in SCRIPTS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('m', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


def test_sweep_path_runs_without_pandas_matplotlib_and_joblib(tmp_path):
    r = random.Random(4)
    fasta = tmp_path / "toy.fasta"
    fasta.write_text(">toy\n" + "".join(r.choice("ACGT") for _ in range(300))
                     + "\n")
    results = tmp_path / "results"
    code = (
        "import sys\n"
        "for name in ('jax', 'genome_assembly_tpu', 'pandas', 'matplotlib',"
        " 'joblib'):\n"
        "    sys.modules[name] = None\n"
        "import genome_assembly_tpu_torch.experiments.runner\n"
        "import genome_assembly_tpu_torch.experiments.harness\n"
        "from genome_assembly_tpu_torch import persist\n"
        "from genome_assembly_tpu_torch.__main__ import main\n"
        f"assert main(['experiments', '--fasta', {str(fasta)!r}, '--quick', "
        "'--iterations', '1', '--no-plots', '--jobs', '1', '--device', "
        f"'cpu', '--results', {str(results)!r}, '--plots', "
        f"{str(tmp_path / 'plots')!r}]) == 0\n"
        f"rows = persist.load_and_combine_results("
        f"{str(results / 'experiment_varying_l')!r})\n"
        "assert len(rows) == 4 and isinstance(rows[0]['N50 raw'], list)\n"
        "assert not any(sys.modules.get(m) for m in ('pandas', 'matplotlib',"
        " 'joblib'))\n"
        "print('swept')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "swept" in proc.stdout
    csvs = [f for _, _, files in os.walk(results) for f in files]
    assert len(csvs) == 12


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


def test_parallel_workers_module_imports_no_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genome_assembly_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch_parallel_workers\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'genome_assembly_tpu.')) for m, v in sys.modules.items() "
        "if v is not None)\n"
        "print('imported')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_mesh_on_the_card_raises_without_one():
    from genome_assembly_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        make_mesh_hosts_chips,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for build in (make_mesh, lambda: make_mesh_2d(1, 1),
                  make_mesh_hosts_chips):
        with pytest.raises(RuntimeError, match="cuda"):
            build()


def test_nccl_for_ranks_sharing_a_card_raises(tmp_path):
    import torch.distributed as dist

    from genome_assembly_tpu_torch.parallel.mesh import (
        init_distributed,
        pick_backend,
    )

    assert pick_backend("cuda", 8, 1) == "gloo"
    assert pick_backend("cuda", 1, 1) == "nccl"
    assert pick_backend("cuda", 4, 4) == "nccl"
    assert pick_backend("cpu", 2, 0) == "gloo"
    with pytest.raises(ValueError, match="NCCL needs a card a rank"):
        pick_backend("cuda", 2, 1, requested="nccl")
    with pytest.raises(ValueError, match="NCCL needs a card a rank"):
        init_distributed(f"file://{tmp_path / 'store'}", 2, 0, device="cpu",
                         backend="nccl")
    assert not dist.is_initialized()


def test_a_failed_or_hung_world_raises(tmp_path):
    import torch_parallel_workers as workers

    from genome_assembly_tpu_torch.parallel.spawn import spawn

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(workers.fail_on, 2, args=(1,), device="cpu", timeout_s=120,
              workdir=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn(workers.sleep, 2, args=(600,), device="cpu", timeout_s=10,
              workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def _tracked_outputs():
    """The JAX package's recorded runs, which the drivers must not touch."""
    names = sorted(f for f in os.listdir(ROOT)
                   if f.endswith(".json") and f.startswith(
                       ("BENCH", "DENSE_DEMO", "LONG_GENOME", "SCALING")))
    assert len(names) >= 8
    out = {}
    for name in names:
        with open(os.path.join(ROOT, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("driver", DRIVERS)
def test_drivers_fail_without_a_card_and_write_no_tracked_file(driver):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    before = _tracked_outputs()
    outs = [os.path.join(ROOT, "results", name) for name in (
        "dense_demo_torch.json", "long_genome_torch.json",
        "scaling_torch.json")]
    stamps = {p: os.path.getmtime(p) for p in outs if os.path.exists(p)}
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DENSE_", "LONG_GENOME_", "SCALE_"))}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, driver)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert proc.stdout == ""
    assert _tracked_outputs() == before
    assert {p: os.path.getmtime(p) for p in outs
            if os.path.exists(p)} == stamps


def _driver(rel):
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(rel))[0], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("driver", DRIVERS)
def test_a_failed_kernel_build_raises_in_each_driver(driver, tmp_path,
                                                     monkeypatch):
    """With a card reported and nvcc missing, each driver raises the
    build's error before it puts anything on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(overlap_allpairs, "_LIB", None)
    monkeypatch.setattr(overlap_allpairs, "_nvcc",
                        lambda: str(tmp_path / "no-such-nvcc"))
    mod = _driver(driver)
    start = {
        "bench_torch.py": lambda: mod.run(n=8, l=8, rep=1, rounds=1),
        "bench_scaling_torch.py": lambda: mod.run(mod.config_from_env({}),
                                                  world_size=2),
    }.get(driver, lambda: mod.build("cuda"))
    with pytest.raises(RuntimeError, match="overlap_allpairs.*failed"):
        start()
