"""Fill a flight log's missing timestamps by linear interpolation at the
video's frame rate: the port of ``tools/interpolate_missing_timestamps.py``.

Timestamps between two valid ones are interpolated by frame number; before
the first and after the last valid one they are extrapolated at ``--fps``.
The log goes through ``io/table.py`` (pandas' typing and CSV text) and
its timestamps through ``table.to_datetime_ns`` (``pd.to_datetime`` with
``errors="coerce"``); they are written back as ``%Y-%m-%d %H:%M:%S.%f``
cut to milliseconds.

Usage:
  python -m geotrax_tpu_torch.tools.interpolate_missing_timestamps LOG.csv [--fps 29.97] [-o OUT.csv]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table


def fill_timestamps(log: dict, fps: float) -> tuple[dict, int]:
    """(the log with every timestamp filled, the number filled)."""
    log = dict(log)
    frames = np.asarray(log["frame"])
    ns, missing = table.to_datetime_ns(log["timestamp"])
    valid = ~missing
    if valid.sum() < 1:
        raise ValueError("No valid timestamps to anchor the interpolation.")
    ns = np.where(valid, ns, np.iinfo(np.int64).min).astype(np.float64)
    period_ns = 1e9 / fps
    filled = np.interp(frames, frames[valid], ns[valid])
    first, last = np.nonzero(valid)[0][[0, -1]]
    before = frames < frames[first]
    after = frames > frames[last]
    filled[before] = ns[first] - (frames[first] - frames[before]) * period_ns
    filled[after] = ns[last] + (frames[after] - frames[last]) * period_ns
    cells = table.format_datetime_ns(filled.astype("int64"))
    log["timestamp"] = np.array([c[:-3] for c in cells], dtype=object)
    return log, int((~valid).sum())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("log", type=Path, help="Flight-log CSV with frame/timestamp columns")
    parser.add_argument("--fps", type=float, default=30000 / 1001)
    parser.add_argument("--out", "-o", type=Path, default=None,
                        help="Output CSV (default: in-place)")
    args = parser.parse_args(argv)

    fixed, n = fill_timestamps(table.read_csv(args.log), args.fps)
    out = args.out or args.log
    table.write_csv(out, fixed)
    print(f"Filled {n} missing timestamp(s) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
