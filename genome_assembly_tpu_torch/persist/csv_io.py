"""CSV round-trip for experiment results (reference createAndSave.py:32-242),
written with the standard library.

The JAX package reads and writes these files through pandas. The card
machine has no pandas, so this module reproduces what pandas does on the
files the harness writes, byte for byte and record for record:

- ``save_results`` writes what ``pd.DataFrame(results).to_csv(index=False)``
  writes: the union of keys in first-seen order; per column the type
  pandas infers (ints with a missing value become floats, so ``1`` is
  written ``1.0``); ``""`` for ``None``, NaN and missing keys; floats of a
  numeric column as ``repr`` of a float64; anything else, lists
  included, as ``str``; minimal quoting and ``\\n`` line ends.
- the loaders return what ``pd.read_csv(path).to_dict("records")``
  returns: pandas' missing-value strings read as NaN; a column is int,
  float, bool or str as pandas infers it; floats are parsed as pandas'
  default C parser parses them (``_pandas_float``), which is not
  correctly rounded, so that a value reads back as the JAX package reads
  it. Integers outside the int64 range read back as Python ints (floats
  beside a missing value); pandas reads them inconsistently (as strings,
  objects or NaN), which is not reproduced: no result the harness writes
  holds one.

Schema contract:
- ``results.csv`` — one row per parameter config; aggregate columns are
  named "<key> avg" / "<key> std" / "<key> raw" (raw holds a stringified
  Python list), exactly as the reference writes them
  (experiments.py:528-533, createAndSave.py:47).
- ``summary.csv`` — the "avg" columns plus the identifying parameter
  columns (createAndSave.py:50-54).

Loaders parse stringified raw lists back to typed Python lists, including
legacy ``np.int64(...)`` / ``np.float64(...)`` reprs that appear in CSVs
written by recent NumPy (createAndSave.py:117-139).
"""

from __future__ import annotations

import ast
import csv
import math
import os
import re

import numpy as np

_SUMMARY_ID_COLS = ["num_reads", "read_length", "error_prob",
                    "expected_coverage"]

_INT_RAW_COLS = {"num_reads raw", "read_length raw", "k raw",
                 "Number of Contigs raw", "N50 raw"}
_FLOAT_RAW_COLS = {"error_prob raw", "Mismatch Rate Aligned Regions raw",
                   "Mismatch Rate Genome Level raw", "expected_coverage raw",
                   "Genome Coverage raw"}

_NP_INT = re.compile(r"np\.int\d*\((-?\d+)\)")
_NP_FLOAT = re.compile(r"np\.float\d*\(([-\d.eE+]+)\)")

# pandas' default missing-value strings (pandas._libs.parsers.STR_NA_VALUES)
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_TRUE_STRINGS = frozenset({"True", "TRUE", "true"})
_FALSE_STRINGS = frozenset({"False", "FALSE", "false"})
_INF_STRINGS = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
                "infinity": math.inf, "+infinity": math.inf,
                "-infinity": -math.inf}
_INT_TEXT = re.compile(r"\s*[+-]?\d+\s*")
_POW10 = [float(f"1e{i}") for i in range(309)]
_SPACE = " \t\n\r\f\v"


def _is_null(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _is_bool(v) -> bool:
    return isinstance(v, (bool, np.bool_))


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not _is_bool(v)


def _column_cells(values: list) -> list[str]:
    """One column's cells as pandas writes them: the column's type is
    inferred from its values (None, NaN and missing keys are null)."""
    present = [v for v in values if not _is_null(v)]
    has_null = len(present) < len(values)
    ints = all(_is_int(v) for v in present)
    if ints and present and not has_null:
        return [str(int(v)) for v in values]
    numeric = all(_is_int(v) or isinstance(v, float) for v in present)
    fits = all(-2**63 <= v < 2**64 for v in present if _is_int(v))
    if numeric and fits:
        # a float64 column: ints among floats or nulls become floats
        return ["" if _is_null(v) else repr(float(v)) for v in values]
    return ["" if _is_null(v) else str(v) for v in values]


def _write_csv(path: str, columns: list, cells: dict, n_rows: int) -> None:
    rows = zip(*(cells[c] for c in columns)) if columns else [[]] * n_rows
    with open(path, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([str(c) for c in columns])
        writer.writerows(rows)


def save_results(results: list[dict], experiment_name: str,
                 path: str = "results") -> None:
    """Write results.csv (full) and summary.csv (avg columns) under `path`."""
    columns: dict = {}
    for row in results:
        columns.update(dict.fromkeys(row))
    columns = list(columns)
    cells = {c: _column_cells([row.get(c) for row in results])
             for c in columns}
    os.makedirs(path, exist_ok=True)
    _write_csv(os.path.join(path, "results.csv"), columns, cells,
               len(results))
    keep = [c for c in columns if "avg" in c or c in _SUMMARY_ID_COLS]
    _write_csv(os.path.join(path, "summary.csv"), keep, cells, len(results))
    print(f"Results saved to {path}/results.csv")
    print(f"Summary results saved to {path}/summary.csv")


def _pandas_float(text: str) -> float | None:
    """``text`` as pandas' default float parser reads it (its C tokenizer's
    ``precise_xstrtod``), or None when it is no float.

    Up to 17 significant digits are accumulated in a double
    (``n = n * 10 + d``) and scaled by one multiply or divide by a power of
    ten, so the result can sit an ulp from the correctly rounded value.
    """
    p, n = 0, len(text)
    while p < n and text[p] in _SPACE:
        p += 1
    negative = p < n and text[p] == "-"
    if p < n and text[p] in "+-":
        p += 1
    number, exponent, digits = 0.0, 0, 0
    while p < n and text[p].isdigit() and text[p].isascii():
        if digits < 17:
            number = number * 10.0 + int(text[p])
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and text[p] == ".":
        p += 1
        decimals = 0
        while (digits < 17 and p < n and text[p].isdigit()
               and text[p].isascii()):
            number = number * 10.0 + int(text[p])
            digits += 1
            decimals += 1
            p += 1
        while p < n and text[p].isdigit() and text[p].isascii():
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if p < n and text[p] in "eE":
        q = p + 1
        exp_negative = q < n and text[q] == "-"
        if q < n and text[q] in "+-":
            q += 1
        e, e_digits = 0, 0
        while (e_digits < 17 and q < n and text[q].isdigit()
               and text[q].isascii()):
            e = e * 10 + int(text[q])
            e_digits += 1
            q += 1
        if e_digits:
            exponent += -e if exp_negative else e
            p = q
    while p < n and text[p] in _SPACE:
        p += 1
    if p != n:
        return None
    if exponent > 308:
        return math.copysign(math.inf, number) if number else 0.0
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return number


def _parse_float(text: str) -> float | None:
    value = _pandas_float(text)
    if value is None:
        value = _INF_STRINGS.get(text.lower())
    return value


def _column_values(texts: list[str]) -> list:
    """One column's values as ``pd.read_csv`` infers and
    ``to_dict("records")`` boxes them: int, else float, else bool, else
    str; missing values are NaN (and turn an int column into floats)."""
    nan = float("nan")
    present = [t for t in texts if t not in _NA_STRINGS]
    if len(present) == len(texts) and all(_INT_TEXT.fullmatch(t)
                                          for t in present):
        return [int(t) for t in texts]
    floats = [_parse_float(t) for t in present]
    if all(v is not None for v in floats):
        it = iter(floats)
        return [nan if t in _NA_STRINGS else next(it) for t in texts]
    if all(t in _TRUE_STRINGS or t in _FALSE_STRINGS for t in present):
        return [nan if t in _NA_STRINGS else t in _TRUE_STRINGS
                for t in texts]
    return [nan if t in _NA_STRINGS else t for t in texts]


def _applied_column(values: list) -> list:
    """What ``Series.apply`` makes of a column of results: numbers with a
    null or a float among them become floats (None becomes NaN); anything
    else stays as it is."""
    present = [v for v in values if not _is_null(v)]
    if (present and all(_is_int(v) or isinstance(v, float) for v in present)
            and (len(present) < len(values)
                 or not all(_is_int(v) for v in present))):
        return [float("nan") if _is_null(v) else float(v) for v in values]
    return values


class _EmptyCSV(Exception):
    """The file holds no header (pandas' EmptyDataError)."""


def _read_records(file_path: str) -> list[dict]:
    """The records ``pd.read_csv(file_path).to_dict("records")`` gives for
    the files ``save_results`` writes."""
    with open(file_path, encoding="utf-8", newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise _EmptyCSV(file_path)
    header, body = rows[0], rows[1:]
    width = len(header)
    body = [(r + [""] * width)[:width] for r in body]
    columns = [_column_values([r[i] for r in body]) for i in range(width)]
    return [dict(zip(header, values)) for values in zip(*columns)]


def load_results_from_csv(file_path: str) -> list[dict] | None:
    try:
        return _read_records(file_path)
    except FileNotFoundError:
        print(f"Error: File not found at {file_path}")
    except _EmptyCSV:
        print(f"Warning: {file_path} is empty.")
    except Exception as e:  # pragma: no cover - parity with reference
        print(f"An error occurred while loading {file_path}: {e}")
    return None


def parse_list_with_numpy(x, col: str):
    """Parse a stringified list cell; coerce per-column element types.

    Accepts legacy numpy scalar reprs inside the string
    (createAndSave.py:123-124). Non-list literals are returned as-is.
    """
    try:
        x = _NP_INT.sub(r"\1", x)
        x = _NP_FLOAT.sub(r"\1", x)
        value = ast.literal_eval(x)
        if not isinstance(value, list):
            return value
        if col in _INT_RAW_COLS:
            return [int(v) for v in value]
        if col in _FLOAT_RAW_COLS:
            return [float(v) for v in value]
        return value
    except (ValueError, SyntaxError) as e:
        print(f"Error converting column: {e} - value: {x}")
        return None


def load_and_clean_results(folder_path: str) -> list[dict] | None:
    """Load `folder_path`/results.csv with raw-list columns parsed back to
    typed Python lists (createAndSave.py:142-179)."""
    file_path = os.path.join(folder_path, "results.csv")
    try:
        records = _read_records(file_path)
        raw_cols = [c for c in (records[0] if records else ())
                    if c.endswith("raw")]
        for col in raw_cols:
            parsed = _applied_column(
                [parse_list_with_numpy(r[col], col) for r in records])
            for r, value in zip(records, parsed):
                r[col] = value
        return records
    except FileNotFoundError:
        print(f"Error: File not found at {file_path}")
    except _EmptyCSV:
        print(f"Warning: {file_path} is empty.")
    except Exception as e:  # pragma: no cover
        print(f"An error occurred while loading or cleaning {file_path}: {e}")
    return None


def load_coverage_results_from_csv(base_path: str,
                                   name_pattern: str) -> dict:
    """Map coverage level -> results list from `base_path`/<pattern><C>/
    results.csv directories (createAndSave.py:84-114)."""
    out: dict[float, list | None] = {}
    for dir_name in os.listdir(base_path):
        if not dir_name.startswith(name_pattern):
            continue
        try:
            coverage = float(dir_name.split("_")[1])
        except (IndexError, ValueError):
            print(f"Skipping directory {dir_name} - could not extract coverage")
            continue
        out[coverage] = load_results_from_csv(
            os.path.join(base_path, dir_name, "results.csv"))
    return out


def load_and_combine_results(base_path: str) -> list[dict]:
    """Concatenate cleaned results from every immediate subdirectory
    (createAndSave.py:182-218)."""
    combined: list[dict] = []
    for dir_name in sorted(os.listdir(base_path)):
        subdir = os.path.join(base_path, dir_name)
        if os.path.isdir(subdir):
            results = load_and_clean_results(subdir)
            if results:
                combined.extend(results)
    return combined


def load_all_results(base_path: str) -> tuple[dict, list]:
    """(subdir name -> results, list of result lists)
    (createAndSave.py:221-241)."""
    by_name: dict[str, list] = {}
    as_list: list[list] = []
    for dir_name in sorted(os.listdir(base_path)):
        subdir = os.path.join(base_path, dir_name)
        if os.path.isdir(subdir):
            results = load_and_clean_results(subdir)
            if results:
                by_name[dir_name] = results
                as_list.append(results)
    return by_name, as_list
