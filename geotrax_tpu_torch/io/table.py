"""CSV tables without pandas (the card's machine has none).

``read_csv`` reads a headed CSV into columns typed as pandas' ``read_csv``
types them by default: a column whose cells all parse as integers is int64
(float64 when one is missing), as numbers float64, else strings with NaN for
the missing ones (pandas' default NA strings). ``write_csv`` writes columns
as ``DataFrame.to_csv(index=False)`` writes them: float64 cells as numpy
prints them (the shortest repr) and NaN empty, integers as digits, object
cells through ``str`` with None and NaN empty, quoted where the csv module's
minimal quoting quotes them.
"""

from __future__ import annotations

import csv
import math
import re

import numpy as np

# pandas.read_csv's default NA strings
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(r"^\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\s*$",
                    re.IGNORECASE)


def infer_column(cells: list) -> np.ndarray:
    """One column of strings as pandas types it (see the module's docstring)."""
    missing = [c in NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return np.full(len(cells), np.nan)
    if all(_INT.match(c) for c in present):
        if not any(missing):
            return np.array([int(c) for c in cells], dtype=np.int64)
        return np.array([np.nan if m else float(int(c)) for c, m in zip(cells, missing)])
    if all(_FLOAT.match(c) for c in present):
        return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)])
    return np.array([np.nan if m else c for c, m in zip(cells, missing)], dtype=object)


def read_csv(path) -> dict:
    """{column name: typed numpy column}, in the file's column order."""
    with open(path, newline="", encoding="utf-8") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        raise ValueError(f"'{path}' has no header row")
    header, body = rows[0], [r for r in rows[1:] if r]
    width = len(header)
    body = [(r + [""] * width)[:width] for r in body]
    return {name: infer_column([r[i] for r in body]) for i, name in enumerate(header)}


def _is_missing(x) -> bool:
    return x is None or (isinstance(x, float) and math.isnan(x))


def format_column(values) -> list:
    """One column's cells as ``DataFrame.to_csv`` writes them."""
    arr = np.asarray(values)
    if arr.dtype.kind == "f":
        out = arr.astype(str)
        out[np.isnan(arr)] = ""
        return out.tolist()
    if arr.dtype.kind in "iuU":
        return arr.astype(str).tolist()
    if arr.dtype.kind == "b":
        return np.where(arr, "True", "False").tolist()
    return ["" if _is_missing(x) else repr(float(x)) if isinstance(x, float) else str(x)
            for x in arr.tolist()]


def write_csv(path, columns: dict) -> None:
    """Write {name: column} as ``pd.DataFrame(columns).to_csv(path,
    index=False)`` does; None columns are left out."""
    names = [k for k, v in columns.items() if v is not None]
    cells = [format_column(columns[k]) for k in names]
    with open(path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        writer.writerow(names)
        writer.writerows(zip(*cells))
