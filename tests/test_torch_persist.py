"""The port's persistence against the JAX package's pandas route.

- ``save_results`` writes the same bytes as the JAX package's
  ``DataFrame(results).to_csv(index=False)`` for result lists holding None,
  NaN, lists of numpy and Python scalars, strings with commas, quotes and
  line breaks, bools, ints beside floats and rows with different keys;
- each loader returns records equal to the JAX package's on those files
  (NaN equal to NaN), and prints the same messages;
- floats read back as pandas' default parser reads them, which is not
  correctly rounded;
- ``create_paths`` and ``parse_list_with_numpy`` as in the JAX package.
"""

import io
import math
import os
import random
import re
from contextlib import redirect_stdout

import numpy as np
import pandas as pd
import pytest

from genome_assembly_tpu import persist as jax_persist
from genome_assembly_tpu_torch import persist
from genome_assembly_tpu_torch.persist import csv_io

RESULT_LISTS = {
    "sweep rows": [
        {"num_reads": 100, "read_length": 50, "error_prob": 0.01, "k": 5,
         "reference_genome": "ACGT" * 5, "expected_coverage":
             np.float64(0.928332714444857), "experiment_name": "C_0.928",
         "num_iterations": 2, "contigs": None,
         "N50 avg": 50.0, "N50 std": 0.0, "N50 raw": [50, 50],
         "Genome Coverage avg": 0.5, "Genome Coverage std": 0.1,
         "Genome Coverage raw": [np.float64(0.4), np.float64(0.6)],
         "expected_coverage raw": [np.float64(0.928332714444857)] * 2},
        {"num_reads": 200, "read_length": 100, "error_prob": 0.1, "k": 15,
         "reference_genome": "ACGT" * 5, "expected_coverage": 2,
         "experiment_name": "C_2", "num_iterations": 2, "contigs": None,
         "N50 avg": 61.5, "N50 std": 1.5,
         "N50 raw": [np.int64(60), np.int64(63)],
         "Genome Coverage avg": 0.25, "Genome Coverage std": 0.0,
         "Genome Coverage raw": [0.25, 0.25],
         "expected_coverage raw": [2, 2]},
    ],
    "None, NaN and missing keys": [
        {"a": 1, "b": None, "c": "x", "d": float("nan")},
        {"a": None, "c": None, "e": 2.5},
        {"b": 3, "d": np.float64(1e-05), "e": np.nan},
    ],
    "strings with commas, quotes and line breaks": [
        {"name": 'say "hi", then go', "note": "a,b", "empty": ""},
        {"name": "line\nbreak", "note": "NA", "empty": "None"},
        {"name": "plain", "note": "True", "empty": "007"},
    ],
    "bools, ints beside floats, wide ints": [
        {"flag": True, "mixed": 1, "big": 2**70, "i64": np.int64(-3),
         "f": 1e16},
        {"flag": False, "mixed": 2.5, "big": 1, "i64": np.int64(4),
         "f": -0.0},
        {"flag": None, "mixed": np.int64(7), "big": 12, "i64": 0,
         "f": float("inf")},
    ],
    "lists of numpy and Python scalars": [
        {"x raw": [np.int64(1), 2], "y raw": [np.float64(0.1), 0.2, 3],
         "z raw": []},
        {"x raw": [np.int64(5)], "y raw": [1e-7], "z raw": [None]},
    ],
    "a row without an avg column": [{"num_reads": 3}, {"other": 4}],
    "no rows": [],
}


def _save_both(results, tmp_path):
    out = {}
    for name, module in (("jax", jax_persist), ("port", persist)):
        path = str(tmp_path / name)
        buf = io.StringIO()
        with redirect_stdout(buf):
            module.save_results(results, "exp", path=path)
        out[name] = path, buf.getvalue().replace(path, "<path>")
    return out


def _same(a, b):
    """Equal records, NaN equal to NaN and types included."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def _printed(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        value = fn(*args)
    return value, re.sub(r" at 0x[0-9a-f]+", "", buf.getvalue())


@pytest.mark.parametrize("case", list(RESULT_LISTS))
def test_save_results_writes_the_jax_packages_bytes(case, tmp_path):
    both = _save_both(RESULT_LISTS[case], tmp_path)
    (jax_dir, jax_out), (port_dir, port_out) = both["jax"], both["port"]
    assert port_out == jax_out
    for name in ("results.csv", "summary.csv"):
        with open(os.path.join(jax_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            assert f.read() == want, name


@pytest.mark.parametrize("case", list(RESULT_LISTS))
def test_loaders_return_the_jax_packages_records(case, tmp_path):
    jax_dir, _ = _save_both(RESULT_LISTS[case], tmp_path)["jax"]
    for name in ("results.csv", "summary.csv"):
        path = os.path.join(jax_dir, name)
        want = _printed(jax_persist.load_results_from_csv, path)
        got = _printed(persist.load_results_from_csv, path)
        assert _same(got[0], want[0]) and got[1] == want[1], name
    want = _printed(jax_persist.load_and_clean_results, jax_dir)
    got = _printed(persist.load_and_clean_results, jax_dir)
    assert _same(got[0], want[0]) and got[1] == want[1]


def test_directory_loaders_match_jax(tmp_path):
    for i, case in enumerate(["sweep rows", "lists of numpy and Python "
                              "scalars", "no rows"]):
        with redirect_stdout(io.StringIO()):
            jax_persist.save_results(RESULT_LISTS[case], "exp",
                                     path=str(tmp_path / f"C_{i + 1}.5"))
    (tmp_path / "C_x").mkdir()
    (tmp_path / "C_9").mkdir()
    (tmp_path / "C_9" / "results.csv").write_text("")
    (tmp_path / "notes.txt").write_text("not a directory")
    base = str(tmp_path)
    for fn in ("load_and_combine_results", "load_all_results"):
        want = _printed(getattr(jax_persist, fn), base)
        got = _printed(getattr(persist, fn), base)
        assert _same(list(got[0]) if isinstance(got[0], tuple) else got[0],
                     list(want[0]) if isinstance(want[0], tuple)
                     else want[0]), fn
        assert got[1] == want[1], fn
    want = _printed(jax_persist.load_coverage_results_from_csv, base, "C_")
    got = _printed(persist.load_coverage_results_from_csv, base, "C_")
    assert _same(got[0], want[0]) and got[1] == want[1]


def test_missing_and_empty_files_print_as_jax(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "results.csv").write_text("\n")
    for fn, arg in [("load_results_from_csv", str(tmp_path / "none.csv")),
                    ("load_results_from_csv", str(empty / "results.csv")),
                    ("load_and_clean_results", str(tmp_path / "none")),
                    ("load_and_clean_results", str(empty))]:
        want = _printed(getattr(jax_persist, fn), arg)
        assert _printed(getattr(persist, fn), arg) == want


def test_float_parsing_matches_pandas():
    """pandas' default parser is not correctly rounded (a quarter of these
    values read back an ulp off); the port reads as it does."""
    r = random.Random(0)
    values = ([r.random() * 10 ** r.randint(-30, 30) for _ in range(20000)]
              + [r.random() for _ in range(5000)]
              + [0.9834756776828816, 1e16, 5e-324, 1.7976931348623157e308,
                 -0.0, 123456789012345678901234.0])
    texts = [repr(v) for v in values] + ["1e5", ".5", "5.", "+3", "-2E-3",
                                         "1e400", "-1e400", "0e999",
                                         "1e-400", "Infinity", "-inf",
                                         "0x10", "1_0", "e5", "1e5x"]
    frame = pd.read_csv(io.StringIO("x\n" + "\n".join(texts[:-4]) + "\n"))
    want = frame["x"].tolist()
    got = [csv_io._parse_float(t) for t in texts[:-4]]
    assert got == want
    assert sum(g != v for g, v in zip(got, values)) > 1000
    for t in texts[-4:]:
        assert csv_io._parse_float(t) is None
        frame = pd.read_csv(io.StringIO(f"x\n{t}\n1.5\n"))
        assert frame["x"].tolist() == [t, "1.5"]


def test_parse_list_with_numpy_matches_jax():
    for x, col in [("[np.int64(3), np.int64(4)]", "N50 raw"),
                   ("[np.float64(0.5)]", "Genome Coverage raw"),
                   ("[1, 2]", "error_prob raw"), ("7", "N50 raw"),
                   ("[np.float32(1.5)]", "other raw"), ("x", "N50 raw")]:
        assert (_printed(persist.parse_list_with_numpy, x, col)
                == _printed(jax_persist.parse_list_with_numpy, x, col))


def test_create_paths_matches_jax(tmp_path):
    specs = [("results", "exp/sub"), ("plots", "a/b/c"), ("flat", "leaf")]
    want = jax_persist.create_paths(
        [(str(tmp_path / "jax" / b), e) for b, e in specs])
    got = persist.create_paths(
        [(str(tmp_path / "port" / b), e) for b, e in specs])
    assert [p.replace("/port/", "/jax/") for p in got] == want
    for root in ("jax", "port"):
        made = sorted(os.path.relpath(d, tmp_path / root)
                      for d, _, _ in os.walk(tmp_path / root))
        assert made == sorted(os.path.relpath(d, tmp_path / "jax")
                              for d, _, _ in os.walk(tmp_path / "jax"))
