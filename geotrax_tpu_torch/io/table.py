"""CSV tables without pandas (the card's machine has none).

``read_csv`` reads a headed CSV into columns typed as pandas' ``read_csv``
types them by default: a column whose cells all parse as integers is int64
(float64 when one is missing), as numbers float64, else strings with NaN for
the missing ones (pandas' default NA strings). ``write_csv`` writes columns
as ``DataFrame.to_csv(index=False)`` writes them: float64 cells as numpy
prints them (the shortest repr) and NaN empty, integers as digits, object
cells through ``str`` with None and NaN empty, quoted where the csv module's
minimal quoting quotes them. ``from_records`` types a column of Python values
as ``pd.DataFrame(rows)`` does, ``concat`` joins tables as ``pd.concat(...,
ignore_index=True)`` does, and ``to_numeric`` is ``pd.to_numeric(col,
errors="coerce")``.
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
                    re.IGNORECASE | re.ASCII)
_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_BLOCK = 1 << 16  # rows parsed at a time, to bound the temporaries


def parse_floats(cells: list) -> np.ndarray:
    """Cells ``_FLOAT`` matches, as pandas' C parser reads them by default
    (``precise_xstrtod``): the first 17 digits of the mantissa (leading zeros
    count) accumulated in a double, then one product or quotient by a power
    of ten. The first 16 steps are exact in int64 and the 16th rounds once,
    as int64 -> float64 rounds; the 17th digit is the one double step. Up to
    15 digits with a decimal exponent within 22 this is the correctly rounded
    value; a 16- or 17-digit cell (the shortest repr of most doubles) can land
    one unit in the last place from it, and the port reads what pandas reads."""
    text = [c.strip() for c in cells]
    out = np.empty(len(text))
    for start in range(0, len(text), _BLOCK):
        out[start:start + _BLOCK] = _parse_block(text[start:start + _BLOCK])
    return out


def _parse_block(text: list) -> np.ndarray:
    raw = np.array(text, dtype="S")
    u = raw.view(np.uint8).reshape(len(text), raw.dtype.itemsize).astype(np.int64)
    width = u.shape[1]
    is_e = (u == ord("e")) | (u == ord("E"))
    end = np.where(is_e.any(1), is_e.argmax(1), width)  # the mantissa's end
    is_dot = u == ord(".")
    dot = np.where(is_dot.any(1), is_dot.argmax(1), end)
    exponent = np.zeros(len(text), np.int64)
    for i in np.nonzero(end < width)[0]:
        exponent[i] = max(-9999, min(9999, int(text[i][end[i] + 1:])))
    head = np.zeros(len(text), np.int64)
    digit17 = np.zeros(len(text), np.int64)
    seen = np.zeros(len(text), np.int64)
    whole = np.zeros(len(text), np.int64)
    for j in range(width):
        d = u[:, j] - ord("0")
        is_digit = (d >= 0) & (d <= 9) & (j < end)
        head = np.where(is_digit & (seen < 16), head * 10 + d, head)
        digit17 = np.where(is_digit & (seen == 16), d, digit17)
        seen += is_digit
        whole += is_digit & (j < dot)
    number = head.astype(np.float64)
    number = np.where(seen > 16, number * 10.0 + digit17, number)
    e = exponent + whole - np.minimum(seen, 17)
    with np.errstate(over="ignore"):
        value = np.where(e > 0, number * _POW10[np.clip(e, 0, 308)],
                         number / _POW10[np.clip(-e, 0, 308)])
        deep = number / _POW10[np.clip(-308 - e, 0, 308)] / _POW10[308]
    value = np.where(e < -308, deep, value)
    value = np.where(e > 308, np.where(number == 0, 0.0, np.inf), value)
    value = np.where(u[:, 0] == ord("-"), -value, value)
    value[e < -616] = 0.0  # pandas' zero here has no sign, nor has 0e400's
    value[(e > 308) & (number == 0)] = 0.0
    for i in np.nonzero(seen == 0)[0]:  # inf, infinity
        value[i] = float(text[i])
    return value


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
        out = np.full(len(cells), np.nan)
        out[~np.array(missing)] = parse_floats(present)
        return out
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


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, (bool, np.bool_))


def record_column(values: list) -> np.ndarray:
    """A column of Python values as ``pd.DataFrame`` types it: int64 when
    every value is an integer, float64 (None as NaN) when every value is a
    number or None and one is a number, else objects (None as NaN unless
    every value is None)."""
    present = [v for v in values if v is not None]
    if present and all(_is_int(v) for v in values):
        return np.array(values, dtype=np.int64)
    if present and all(_is_int(v) or isinstance(v, (float, np.floating)) for v in present):
        return np.array([np.nan if v is None else float(v) for v in values])
    out = np.empty(len(values), dtype=object)
    out[:] = [np.nan if v is None and present else v for v in values]
    return out


def from_records(rows: list, columns=None) -> dict:
    """{column name: typed column} of a list of dicts, the columns in
    ``columns``' order or in the order of first appearance; a key a row
    lacks is None there."""
    if columns is None:
        columns = list(dict.fromkeys(k for r in rows for k in r))
    return {name: record_column([r.get(name) for r in rows]) for name in columns}


def concat_column(parts: list) -> np.ndarray:
    """One column of several tables, typed as ``pd.concat`` types it: one
    dtype kind stays as it is, integers and floats together become float64,
    other mixtures objects."""
    kinds = {p.dtype.kind for p in parts}
    if len(kinds) == 1:
        return np.concatenate(parts)
    if kinds <= {"i", "u", "f"}:
        return np.concatenate([p.astype(np.float64) for p in parts])
    return np.concatenate([p.astype(object) for p in parts])


def concat(tables: list) -> dict:
    """The rows of several tables one after another over the union of their
    columns (first-seen order), as ``pd.concat(..., ignore_index=True)``
    joins them: a column a table lacks is NaN in its rows, and each column
    is typed by ``concat_column``."""
    names = list(dict.fromkeys(k for t in tables for k in t))
    out = {}
    for name in names:
        parts = []
        for t in tables:
            n = len(next(iter(t.values()))) if t else 0
            parts.append(t[name] if name in t else np.full(n, np.nan))
        out[name] = concat_column(parts)
    return out


def to_numeric(column) -> np.ndarray:
    """float64 values of a column, NaN where a cell is missing or is not a
    number (``pd.to_numeric(errors="coerce")``; integers come back as
    floats)."""
    arr = np.asarray(column)
    if arr.dtype.kind in "iufb":
        return arr.astype(np.float64)
    out = np.full(len(arr), np.nan)
    for i, x in enumerate(arr.tolist()):
        if _is_missing(x):
            continue
        try:
            out[i] = float(x)
        except (TypeError, ValueError):
            pass
    return out


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
