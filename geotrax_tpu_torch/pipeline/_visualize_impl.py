"""The visualize stage's geometry and readers, in numpy (no pandas).

The counterparts of ``geotrax_tpu/pipeline/_visualize_impl.py``'s helpers:
the polygon and segment clips, the heading, clip-extent and fallback
dimension estimates of the oriented modes, and the readers of the tracks,
transforms and georeferenced files. Tables are numpy arrays whose columns
are the reference's slim layouts, in the order of the file's rows. Three
pandas behaviours are kept by hand: a row's values are float64 (``int()``
truncates toward zero), groups come in sorted key order, and where a
vehicle appears twice in one frame of the georeferenced table the first
row wins.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.ops.filters import gaussian_filter1d_np
from geotrax_tpu_torch.utils.file_utils import detect_delimiter


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def clip_poly_to_rect(corners, xmin, ymin, xmax, ymax) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex polygon to an axis-aligned rect."""
    poly = [np.asarray(c, float) for c in corners]
    for axis, bound, sign in (("x", xmin, 1), ("x", xmax, -1), ("y", ymin, 1), ("y", ymax, -1)):
        if not poly:
            break
        ai = 0 if axis == "x" else 1
        out = []
        n = len(poly)
        for i in range(n):
            cur, prev = poly[i], poly[(i - 1) % n]
            cur_in = sign * (cur[ai] - bound) >= 0
            prev_in = sign * (prev[ai] - bound) >= 0
            if cur_in:
                if not prev_in:
                    out.append(_axis_intersect(prev, cur, ai, bound))
                out.append(cur)
            elif prev_in:
                out.append(_axis_intersect(prev, cur, ai, bound))
        poly = out
    return np.array(poly, np.float32) if poly else np.empty((0, 2), np.float32)


def _axis_intersect(p0, p1, axis, bound):
    denom = p1[axis] - p0[axis]
    t = 0.0 if denom == 0 else (bound - p0[axis]) / denom
    return p0 + t * (p1 - p0)


def clip_segment_to_rect(p0, p1, xmin, ymin, xmax, ymax):
    """Liang-Barsky segment clip; None if entirely outside."""
    p0 = np.asarray(p0, float)
    d = np.asarray(p1, float) - p0
    t0, t1 = 0.0, 1.0
    for pi, qi in ((-d[0], p0[0] - xmin), (d[0], xmax - p0[0]),
                   (-d[1], p0[1] - ymin), (d[1], ymax - p0[1])):
        if pi == 0:
            if qi < 0:
                return None
            continue
        t = qi / pi
        if pi < 0:
            t0 = max(t0, t)
        else:
            t1 = min(t1, t)
        if t0 > t1:
            return None
    return p0 + t0 * d, p0 + t1 * d


def _project(points: np.ndarray, h_inv: np.ndarray) -> np.ndarray:
    pts = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    mapped = pts @ h_inv.T
    return mapped[:, :2] / mapped[:, 2:3]


# ---------------------------------------------------------------------------
# Per-track estimates
# ---------------------------------------------------------------------------

def _groups(keys: np.ndarray):
    """(key, row indices) per distinct key in sorted key order, the rows of
    a group in table order (pandas' groupby)."""
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    bounds = list(starts[1:]) + [len(order)]
    return [(k, order[s:e]) for k, s, e in zip(uniq.tolist(), starts.tolist(), bounds)]


def _by_frame(tracks: np.ndarray, rows: np.ndarray) -> np.ndarray:
    return rows[np.argsort(tracks[rows, 0], kind="stable")]


def _fill(values: np.ndarray) -> np.ndarray:
    """Forward then backward fill of NaN (pandas' ffill().bfill())."""
    out = values.copy()
    valid = ~np.isnan(out)
    if not valid.any():
        return out
    idx = np.where(valid, np.arange(len(out)), 0)
    np.maximum.accumulate(idx, out=idx)
    out = out[idx]
    first = int(np.argmax(valid))
    out[:first] = values[first]
    return out


def compute_headings(tracks: np.ndarray, smoothing: float, min_speed: float,
                     logger) -> np.ndarray:
    """Per-row heading (radians, image coords) of each track's stabilized
    trajectory (columns 6, 7 of the 14-column tracks); held over unreliable
    frames, bbox-aspect fallback when the track never moves."""
    headings = np.full(len(tracks), np.nan)
    sigma = max(float(smoothing), 1e-6)
    for _, rows in _groups(tracks[:, 1]):
        rows = _by_frame(tracks, rows)
        aspect_fallback = (np.pi / 2 if np.median(tracks[rows, 5]) > np.median(tracks[rows, 4])
                           else 0.0)
        if len(rows) < 2:
            headings[rows] = aspect_fallback
            continue
        dx = gaussian_filter1d_np(np.gradient(tracks[rows, 6]), sigma, mode="reflect")
        dy = gaussian_filter1d_np(np.gradient(tracks[rows, 7]), sigma, mode="reflect")
        reliable = np.hypot(dx, dy) >= min_speed
        if not reliable.any():
            headings[rows] = aspect_fallback
            continue
        headings[rows] = _fill(np.where(reliable, np.arctan2(dy, dx), np.nan))
    return headings


def smooth_clip_dims(oriented: np.ndarray, smoothing: float) -> np.ndarray:
    """Per-track Gaussian smoothing of the clip-rectangle extents (columns
    10, 11 of the oriented layout): an (N, 2) array."""
    sigma = max(float(smoothing), 1e-6)
    out = oriented[:, 10:12].astype(float).copy()
    for _, rows in _groups(oriented[:, 1]):
        rows = _by_frame(oriented, rows)
        for j, col in enumerate((10, 11)):
            out[rows, j] = gaussian_filter1d_np(oriented[rows, col].astype(float), sigma,
                                                mode="reflect")
    return out


def estimate_fallback_dims(tracks: np.ndarray) -> tuple:
    """Per-vehicle Q25 of raw bbox max/min extents (columns 4, 5), per row."""
    longer = np.fmax(tracks[:, 4], tracks[:, 5])
    shorter = np.fmin(tracks[:, 4], tracks[:, 5])
    fl, fw = np.empty(len(tracks)), np.empty(len(tracks))
    for _, rows in _groups(tracks[:, 1]):
        fl[rows] = np.percentile(longer[rows], 25)
        fw[rows] = np.percentile(shorter[rows], 25)
    return fl, fw


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def read_numeric(path: Path) -> np.ndarray:
    """A headerless numeric text table (tracks, transforms) as float64 rows."""
    return np.loadtxt(path, delimiter=detect_delimiter(path), ndmin=2, dtype=np.float64)


def read_tracks(tracks_path: Path, class_names: dict, args, logger, frame_size=None) -> tuple:
    """Column-count dispatch over the 10/11/14/15-column formats; returns
    (tracks, tracks_plotting) with the reference's slim layouts.
    ``frame_size`` (w, h) serves the oriented modes' border test."""
    tracks = read_numeric(tracks_path)

    if args.viz_mode in (3, 4):
        return read_tracks_oriented(tracks, tracks_path, class_names, args, logger, frame_size)

    ncols = tracks.shape[1]
    is_interpolated = None
    if ncols in (11, 15):
        is_interpolated = tracks[:, -1]
        tracks = tracks[:, :-1]
    if tracks.shape[1] == 10 or tracks.shape[1] >= 14:
        tracks = tracks[:, :12]
    if args.plot_trajectories and tracks.shape[1] < 11:
        logger.error(f"No stabilized boxes in '{tracks_path}'; disable --plot-trajectories.")
        sys.exit(1)
    tracks_plotting = tracks[:, [0, 6, 7, 10]].copy() if tracks.shape[1] >= 11 else None
    if args.viz_mode > 0:
        if tracks.shape[1] < 11:
            logger.error(f"No stabilized boxes in '{tracks_path}' for viz mode {args.viz_mode}.")
            sys.exit(1)
        tracks = np.delete(tracks, np.s_[2:6], axis=1)
    elif tracks.shape[1] > 10:
        tracks = np.delete(tracks, np.s_[6:10], axis=1)
    elif tracks.shape[1] < 7:
        logger.error(f"No valid tracking results in '{tracks_path}'.")
        sys.exit(1)
    if is_interpolated is not None:
        tracks = np.concatenate([tracks, is_interpolated[:, None]], axis=1)

    _check_class_names(tracks[:, 6], class_names, logger)
    return tracks, tracks_plotting


def _check_class_names(classes: np.ndarray, class_names: dict, logger) -> None:
    top = np.nanmax(classes) if len(classes) else np.nan
    if len(class_names) < top + 1:
        logger.error(f"At least {int(top) + 1} class names required.")
        sys.exit(1)


def read_tracks_oriented(tracks, tracks_path, class_names, args, logger, frame_size=None) -> tuple:
    """Slim oriented layout [frame, id, stab_x, stab_y, length, width, class,
    conf, heading, is_dashed, clip_w, clip_h, on_border]."""
    if tracks.shape[1] < 14:
        logger.error(
            f"Viz modes 3/4 need stabilized tracks with dimension estimates (14 cols) in '{tracks_path}'."
        )
        sys.exit(1)
    tracks_plotting = tracks[:, [0, 6, 7, 10]].copy()

    headings = compute_headings(tracks, args.heading_smoothing, args.heading_min_speed, logger)
    is_fallback = np.isnan(tracks[:, 12])
    is_interp = (tracks[:, 14] != 0) if tracks.shape[1] >= 15 else np.zeros(len(tracks), bool)
    is_dashed = is_fallback | is_interp
    fb_l, fb_w = estimate_fallback_dims(tracks)
    length = np.where(is_fallback, fb_l, tracks[:, 12])
    width = np.where(is_fallback, fb_w, tracks[:, 13])

    eps = getattr(args, "edge_clip_margin", None)
    eps = 3 if eps is None else eps  # 0 is a legal value
    w_frame, h_frame = frame_size if frame_size is not None else (np.inf, np.inf)
    xc, yc, w, h = tracks[:, 2], tracks[:, 3], tracks[:, 4], tracks[:, 5]
    on_border = ((xc - w / 2 <= eps) | (yc - h / 2 <= eps)
                 | (xc + w / 2 >= w_frame - 1 - eps) | (yc + h / 2 >= h_frame - 1 - eps))

    oriented = np.stack([
        tracks[:, 0], tracks[:, 1], tracks[:, 6], tracks[:, 7], length, width,
        tracks[:, 10], tracks[:, 11], headings, is_dashed.astype(float),
        tracks[:, 8], tracks[:, 9], on_border.astype(float)], axis=1)
    win = getattr(args, "edge_clip_smoothing", None)
    win = 5 if win is None else win  # 0 disables smoothing
    oriented[:, 10:12] = smooth_clip_dims(oriented, win)

    _check_class_names(oriented[:, 6], class_names, logger)
    return oriented, tracks_plotting


def read_transforms(path: Path, logger) -> dict:
    """{frame_id: 3x3 float32 homography}; exits on non-positive determinants."""
    data = read_numeric(path)
    mats = data[:, 1:].reshape(-1, 3, 3)
    if not np.all(np.linalg.det(mats) > 0):
        logger.error(f"Invalid transformations found in '{path}'.")
        sys.exit(1)
    frames = data[:, 0].astype(int)
    if len(frames) and not np.all(np.diff(frames) == 1):
        logger.warning(f"Missing frame ids in '{path}'.")
    return {int(f): m.astype(np.float32) for f, m in zip(frames, mats)}


def _missing(x) -> bool:
    return x is None or (isinstance(x, float) and math.isnan(x))


def read_georeferenced_results(path: Path, logger):
    """Speed/lane columns keyed by Frame_ID (reconstructed from Timestamp
    order when Frame_Number is absent, as in legacy CSVs): a dict with
    ``Frame_ID``, ``Vehicle_ID``, ``Vehicle_Speed`` and ``Lane_Number``
    columns, or None."""
    df = table.read_csv(path)
    if "Frame_Number" in df:
        frame_id = df["Frame_Number"]
    elif "Timestamp" in df:
        stamps = df["Timestamp"]
        mapping = {t: i for i, t in enumerate(sorted({s for s in stamps.tolist()
                                                      if not _missing(s)}))}
        frame_id = np.array([mapping.get(t, np.nan) for t in stamps.tolist()], dtype=object)
    else:
        logger.warning(f"No frame reference in '{path}'; speed/lane display disabled.")
        return None
    cols = ["Vehicle_ID", "Vehicle_Speed", "Lane_Number"]
    missing = [c for c in cols if c not in df]
    if missing:
        logger.warning(f"Columns {missing} absent from '{path}'; speed/lane display disabled.")
        return None
    return {"Frame_ID": frame_id, **{c: df[c] for c in cols}}


def speed_lane_by_frame(speed_lane: dict) -> dict:
    """{frame id: {vehicle id: (speed, lane)}}, the first row of a vehicle
    seen twice in one frame winning (the reference's ``.loc`` then
    ``iloc[0]``)."""
    out: dict = {}
    for fid, vid, speed, lane in zip(speed_lane["Frame_ID"].tolist(),
                                     speed_lane["Vehicle_ID"].tolist(),
                                     speed_lane["Vehicle_Speed"].tolist(),
                                     speed_lane["Lane_Number"].tolist()):
        if _missing(fid):
            continue
        out.setdefault(int(fid), {}).setdefault(int(vid), (speed, lane))
    return out


def speed_and_lane(entry, speed_unit: str, speed_deadzone) -> tuple:
    """(speed, lane) to print for one vehicle's (speed, lane) cells."""
    s_val, lane_val = entry
    speed = lane = None
    if not _missing(s_val):
        speed = int(s_val * 0.621371) if speed_unit == "mi/h" else int(s_val)
        if speed <= speed_deadzone:
            speed = 0
    if not (lane_val in ("", None) or _missing(lane_val)):
        lane = int(lane_val)
    return speed, lane
