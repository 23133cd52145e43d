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

For the tools: ``read_columns`` (``usecols``), ``to_datetime_ns``,
``diff_seconds``, ``seconds_to_ns`` and ``format_datetime_ns`` (timestamps
as int64 nanoseconds, as ``pd.to_datetime`` reads and writes them),
``idxmax_by`` (``groupby().idxmax()``), ``argsort_descending``
(``sort_values(ascending=False)``), ``merge_inner`` (``merge``'s row
order) and ``to_string`` (``DataFrame.to_string(index=False)``).
"""

from __future__ import annotations

import calendar
import csv
import datetime
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


def read_columns(path, usecols) -> dict:
    """``read_csv`` of the named columns only (``usecols``); a name the
    header lacks raises ValueError, as pandas does."""
    with open(path, newline="", encoding="utf-8") as fh:
        header = next(csv.reader(fh), None)
    if header is None:
        raise ValueError(f"'{path}' has no header row")
    missing = [c for c in usecols if c not in header]
    if missing:
        raise ValueError(f"Usecols do not match columns, columns expected but not found: "
                         f"{missing}")
    table = read_csv(path)
    return {name: table[name] for name in header if name in usecols}


# ---------------------------------------------------------------------------
# Timestamps (pd.to_datetime(..., errors="coerce") on the flight logs' forms)
# ---------------------------------------------------------------------------

_DATETIME = re.compile(
    r"^(\s*)(\d{4})-(\d{1,2})-(\d{1,2})"
    r"(?:([ T])(\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:([.,])(\d{1,9}))?)?)?(\s*)$")
_TIME = re.compile(r"^\s*(\d{1,2}):(\d{1,2}):(\d{1,2})(?:[.,](\d{1,9}))?\s*$")
_EPOCH_ORDINAL = 719163  # date(1970, 1, 1).toordinal()
NS = 1_000_000_000


def _to_ns(year, month, day, hour=0, minute=0, second=0, fraction=None):
    """Nanoseconds since the epoch; None for a date or time out of range."""
    if not (1 <= month <= 12 and hour < 24 and minute < 60 and second < 60):
        return None
    if not 1 <= day <= calendar.monthrange(year, month)[1]:
        return None
    days = datetime.date(year, month, day).toordinal() - _EPOCH_ORDINAL
    frac = int(fraction.ljust(9, "0")) if fraction else 0
    return ((days * 24 + hour) * 60 + minute) * 60 * NS + second * NS + frac


def _parse_cell(cell: str):
    """(nanoseconds or None, layout) of one cell; the layout (whitespace
    around it, separator, seconds, fraction mark) is None when the cell is
    no ISO date."""
    m = _DATETIME.match(cell)
    if m:
        g = m.groups()
        value = _to_ns(int(g[1]), int(g[2]), int(g[3]), int(g[5] or 0), int(g[6] or 0),
                       int(g[7] or 0), g[9])
        return value, (g[0], g[4], g[7] is not None, g[8], g[10])
    t = _TIME.match(cell)
    if t:
        today = datetime.date.today()
        return _to_ns(today.year, today.month, today.day, int(t.group(1)), int(t.group(2)),
                      int(t.group(3)), t.group(4)), None
    return None, None


def to_datetime_ns(cells) -> tuple:
    """(int64 nanoseconds, missing mask) of a column of timestamps as
    ``pd.to_datetime(col, errors="coerce")`` reads the flight logs' forms
    (``YYYY-MM-DD``, with `` `` or ``T`` and ``HH:MM[:SS[.f|,f]]`` of 1 to 9
    fraction digits). When the first present cell is a valid date its exact
    layout (whitespace around it included) is the column's format, and a
    cell of another layout or an invalid date is missing (NaT). Otherwise
    (also for a ``,`` before the fraction)
    pandas guesses no format and reads each cell alone: then every valid
    cell parses, a bare ``HH:MM:SS[,fff]`` (an SRT timecode) on today's
    date. Numeric columns are nanoseconds already."""
    arr = np.asarray(cells)
    n = len(arr)
    ns = np.zeros(n, np.int64)
    missing = np.ones(n, bool)
    if arr.dtype.kind in "iu":
        return arr.astype(np.int64), np.zeros(n, bool)
    if arr.dtype.kind == "f":
        ok = np.isfinite(arr)
        ns[ok] = arr[ok].astype(np.int64)
        return ns, ~ok
    form = False  # not seen yet; None: no format (each cell alone)
    for i, cell in enumerate(arr.tolist()):
        if not isinstance(cell, str):
            continue
        value, layout = _parse_cell(cell)
        if form is False:  # pandas guesses no format for a comma fraction
            guessed = value is not None and layout is not None and layout[3] != ","
            form = layout if guessed else None
        if value is not None and (form is None or layout == form):
            ns[i] = value
            missing[i] = False
    return ns, missing


def seconds_to_ns(seconds) -> np.ndarray:
    """``pd.to_datetime(seconds, unit="s")`` of float seconds, as int64
    nanoseconds: the whole seconds, plus the fraction rounded to 9 decimals
    in nanoseconds (truncated)."""
    seconds = np.asarray(seconds, np.float64)
    base = seconds.astype(np.int64)
    frac = np.round(seconds - base, 9)
    return base * NS + (frac * 1e9).astype(np.int64)


def diff_seconds(ns: np.ndarray, missing: np.ndarray) -> np.ndarray:
    """``stamps.diff().dt.total_seconds()``: float64 seconds from the row
    before, NaN in the first row and next to a missing stamp."""
    out = np.full(len(ns), np.nan)
    if len(ns) > 1:
        ok = ~(missing[1:] | missing[:-1])
        out[1:][ok] = (ns[1:] - ns[:-1])[ok] / 1e9
    return out


def format_datetime_ns(ns: np.ndarray) -> list:
    """``pd.to_datetime(ns, unit="ns").strftime("%Y-%m-%d %H:%M:%S.%f")``
    (``%f``: the microseconds, six digits)."""
    epoch = datetime.datetime(1970, 1, 1)
    return [(epoch + datetime.timedelta(microseconds=int(v) // 1000))
            .strftime("%Y-%m-%d %H:%M:%S.%f") for v in np.asarray(ns, np.int64).tolist()]


# ---------------------------------------------------------------------------
# Grouping, sorting, joining (pandas' orders)
# ---------------------------------------------------------------------------

def idxmax_by(keys, values) -> tuple:
    """``values.groupby(keys).idxmax()`` over row positions: (the keys in
    ascending order, the position of each key's first largest value)."""
    keys = np.asarray(keys)
    values = np.asarray(values, np.float64)
    groups = np.unique(keys)
    best = np.empty(len(groups), np.int64)
    for g, key in enumerate(groups.tolist()):
        rows = np.nonzero(keys == key)[0]
        best[g] = rows[int(np.argmax(values[rows]))]
    return groups, best


def argsort_descending(values) -> np.ndarray:
    """``series.sort_values(ascending=False)``'s row order: pandas'
    ``nargsort`` (reverse, numpy's default sort, reverse back; NaN last)."""
    values = np.asarray(values, np.float64)
    nan = np.isnan(values)
    idx = np.arange(len(values))[~nan][::-1]
    order = idx[values[~nan][::-1].argsort(kind="quicksort")][::-1]
    return np.concatenate([order, np.nonzero(nan)[0]])


def _factorize(first: np.ndarray, second: np.ndarray) -> tuple:
    """Labels of two key arrays in order of first appearance, ``first``'s
    keys numbered first (pandas' factorizer)."""
    codes: dict = {}
    lab1 = np.array([codes.setdefault(k, len(codes)) for k in first.tolist()], np.int64)
    lab2 = np.array([codes.setdefault(k, len(codes)) for k in second.tolist()], np.int64)
    return lab1, lab2, len(codes)


def _group_sort(labels: np.ndarray, groups: int) -> tuple:
    """pandas' ``groupsort_indexer``: (a stable order by label, counts)."""
    return np.argsort(labels, kind="stable"), np.bincount(labels, minlength=groups)


def _inner_join_rows(lkeys: np.ndarray, rkeys: np.ndarray) -> tuple:
    """(left rows, right rows) of ``pd.merge(how="inner", sort=False)``:
    with unique right keys each left row in order with its match (the hash
    join); otherwise pandas' ``libjoin.inner_join``: pairs grouped by key,
    then put back in left order, by the left rows' inverse order when the
    join has exactly as many rows as the left table (pandas' shortcut, which
    assumes one match per left row)."""
    numeric = lkeys.dtype.kind in "iufb"
    if numeric and len(np.unique(rkeys)) == len(rkeys):
        where = {k: j for j, k in enumerate(rkeys.tolist())}
        pairs = [(i, where[k]) for i, k in enumerate(lkeys.tolist()) if k in where]
        return (np.array([p[0] for p in pairs], np.int64),
                np.array([p[1] for p in pairs], np.int64))
    if numeric:  # the right keys are numbered first on this path
        rlab, llab, groups = _factorize(rkeys, lkeys)
    else:
        llab, rlab, groups = _factorize(lkeys, rkeys)
    lsort, lcount = _group_sort(llab, groups)
    rsort, rcount = _group_sort(rlab, groups)
    lidx, ridx = [], []
    lpos = rpos = 0
    for g in range(groups):
        lc, rc = int(lcount[g]), int(rcount[g])
        for j in range(lc if rc else 0):
            lidx += [lpos + j] * rc
            ridx += range(rpos, rpos + rc)
        lpos += lc
        rpos += rc
    lidx = lsort[np.array(lidx, np.int64)]
    ridx = rsort[np.array(ridx, np.int64)]
    if len(lidx) == len(lkeys):
        rev = np.empty(len(lkeys), np.int64)
        rev[lsort] = np.arange(len(lkeys))
    else:
        rev = np.argsort(lidx, kind="stable")
    return lidx[rev], ridx[rev]


def merge_inner(left: dict, right: dict, left_on: str, right_on: str,
                suffixes=("", "_y")) -> dict:
    """``left.merge(right, left_on=..., right_on=..., suffixes=...)`` (an
    inner join, rows in pandas' order: ``_inner_join_rows``); a column name
    both tables have gets the suffixes."""
    li, ri = _inner_join_rows(np.asarray(left[left_on]), np.asarray(right[right_on]))
    out = {}
    for name, col in left.items():
        clash = name in right and name != left_on
        out[name + suffixes[0] if clash else name] = np.asarray(col)[li]
    for name, col in right.items():
        clash = name in left and name != right_on
        out[name + suffixes[1] if clash else name] = np.asarray(col)[ri]
    return out


# ---------------------------------------------------------------------------
# DataFrame.to_string(index=False)
# ---------------------------------------------------------------------------

_PRECISION = 6  # display.precision
_NUMBER = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")


def _trim_zeros(cells: list) -> list:
    """pandas' ``_trim_zeros_float``: drop a trailing zero from every
    fixed-point cell while all of them end in one, keep one decimal."""
    def numbers(values):
        return [x for x in values if _NUMBER.match(x)]

    while numbers(cells) and all(x.endswith("0") for x in numbers(cells)):
        cells = [x[:-1] if _NUMBER.match(x) else x for x in cells]
    return [x + "0" if _NUMBER.match(x) and x.endswith(".") else x for x in cells]


def _float_cells(values: np.ndarray) -> list:
    def fmt(spec):
        cells = ["NaN" if np.isnan(v) else format(v, spec) for v in values.tolist()]
        return _trim_zeros(cells)

    cells = fmt(f".{_PRECISION}f")
    finite = np.abs(values[~np.isnan(values)])
    too_long = bool(cells) and max(len(x) for x in cells) > _PRECISION + 6
    small = bool(((finite < 10.0 ** -_PRECISION) & (finite > 0)).any())
    if small or (too_long and bool((finite > 1e6).any())):
        cells = fmt(f".{_PRECISION}e")
    return cells


def _object_cell(x) -> str:
    if x is None:
        return "None"
    if isinstance(x, (float, np.floating)):
        if math.isnan(x):
            return "NaN"
        s = format(float(x), f" .{_PRECISION}f").rstrip("0")
        return s + "0" if s.endswith(".") else s
    if isinstance(x, str):
        return x.replace("\t", "\\t").replace("\r", "\\r").replace("\n", "\\n")
    return str(x)


def to_string(columns: dict) -> str:
    """``pd.DataFrame(columns).to_string(index=False)`` with no column width
    limit (``display.max_colwidth=None``): each column right-justified to its
    widest cell or its header (numeric headers get one space more), cells
    joined by one space; floats to six decimals with common trailing zeros
    trimmed (exponents where a value is tiny, or huge and long), integers as
    digits, objects as ``str`` with None and NaN spelt out."""
    names = list(columns)
    cols = []
    for name in names:
        arr = np.asarray(columns[name])
        if arr.dtype.kind == "f":
            cells, numeric = _float_cells(arr), True
        elif arr.dtype.kind in "iu":
            cells, numeric = [str(int(v)) for v in arr.tolist()], True
        elif arr.dtype.kind == "b":
            cells, numeric = [str(bool(v)) for v in arr.tolist()], True
        else:
            cells, numeric = [_object_cell(v) for v in arr.tolist()], False
        header = (" " if numeric else "") + str(name)
        width = max([len(header)] + [len(c) for c in cells])
        cols.append([header.rjust(width)] + [c.rjust(width) for c in cells])
    if not cols or len(cols[0]) == 1:
        return f"Empty DataFrame\nColumns: [{', '.join(map(str, names))}]\nIndex: []"
    return "\n".join(" ".join(col[r] for col in cols) for r in range(len(cols[0])))
