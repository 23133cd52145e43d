"""Extraction post-processing: short-track removal, class voting, azimuth
dimension estimation, gap interpolation.

The port's copy of ``geotrax_tpu/pipeline/postprocess.py`` (plain numpy),
applied by ``pipeline/extract.py:extract`` in the order of the reference's
``_extract_impl.py:run_extraction`` to the rows of the fused chunk step,
so that the port writes the reference's tracks file:

- remove_short_tracks: drop track ids with fewer than min_length rows.
- vote_track_classes: per track, sum detection confidences per class; the
  winning class is the highest total, ties resolving to the LOWEST class id.
- estimate_vehicle_dimensions (+2 columns, length and width in px):
  (1) visibility filter — the UNSTABILIZED box must be > eps px inside every
  frame edge; (2) per-row length=max(w,h), width=min(w,h) collected per
  track with (stabilized, when available) centers; (3) azimuth filter — walk
  the centers, and each time the displacement from the last anchor reaches
  r0/gsd px, compute the azimuth (y up); rows in [anchor, current) count only
  when the azimuth is within theta_bar deg of a cardinal direction; a track
  that never moves that far falls back to keeping rows with
  length >= width * tau_c[class]; (4) per-track dimensions = 25th percentile
  of the kept rows (NaN if none); (5) appended as two columns to every row
  of the track.
- interpolate_tracks (+1 column, the is_interpolated flag): linear in every
  column across frame gaps of 2..max_gap (max_gap = the active tracker's
  track_buffer); output lexsorted by (track, frame).
"""

from __future__ import annotations

import numpy as np

CARDINALS = np.array([0.0, np.pi / 2, np.pi, -np.pi / 2, -np.pi])


def remove_short_tracks(tracks: np.ndarray, min_length: int, logger=None) -> np.ndarray:
    if tracks.size == 0:
        return tracks
    ids, counts = np.unique(tracks[:, 1], return_counts=True)
    short = set(ids[counts < min_length].tolist())
    if short and logger:
        logger.info(f"{len(short)} short tracks removed.")
    if not short:
        return tracks
    keep = ~np.isin(tracks[:, 1], list(short))
    return tracks[keep]


def vote_track_classes(tracks: np.ndarray) -> np.ndarray:
    """Confidence-weighted per-track class vote; ties -> lowest class id.
    Class is the second-to-last column, confidence the last.

    One scatter-add into a (tracks x classes) total matrix + a row argmax
    (first maximum = lowest class id on ties) — O(rows), no per-track scan
    (a campaign's table holds hundreds of thousands of trajectories)."""
    if tracks.size == 0:
        return tracks
    out = tracks.copy()
    _, tinv = np.unique(tracks[:, 1], return_inverse=True)
    classes = tracks[:, -2].astype(int)
    cls_ids, cinv = np.unique(classes, return_inverse=True)
    totals = np.zeros((tinv.max() + 1, len(cls_ids)))
    np.add.at(totals, (tinv, cinv), tracks[:, -1])
    winner = cls_ids[np.argmax(totals, axis=1)]  # argmax: first max -> lowest id
    out[:, -2] = winner[tinv]
    return out


def _azimuth_mask(x: np.ndarray, y: np.ndarray, radius_threshold: float,
                  theta_bar_rad: float):
    """Step-3 walk; returns (mask, saw_azimuth)."""
    n = len(x)
    mask = np.zeros(n, dtype=bool)
    saw = False
    anchor = 0
    ax, ay = x[0], y[0]
    for i in range(1, n):
        dist = np.hypot(x[i] - ax, y[i] - ay)
        if dist >= radius_threshold:
            azimuth = np.arctan2(-(y[i] - ay), x[i] - ax)  # y-up convention
            saw = True
            ax, ay = x[i], y[i]
            if np.any(np.abs(azimuth - CARDINALS) <= theta_bar_rad):
                mask[anchor:i] = True
            anchor = i
    return mask, saw


def estimate_vehicle_dimensions(tracks: np.ndarray, dim_cfg: dict,
                                frame_w: int, frame_h: int) -> np.ndarray:
    """Append per-track (length, width) columns (pixels); see module doc."""
    if tracks.size == 0:
        return tracks
    eps = float(dim_cfg["eps"])
    r0 = float(dim_cfg["r0"])
    gsd = float(dim_cfg["gsd"])
    theta_bar_rad = np.deg2rad(float(dim_cfg["theta_bar"]))
    tau_c = {int(k): float(v) for k, v in dim_cfg["tau_c"].items()}
    radius_threshold = r0 / gsd

    has_stab = tracks.shape[1] > 8
    idx_x, idx_y, idx_c = (6, 7, 10) if has_stab else (2, 3, 6)

    # Step 1: visibility filter on the unstabilized box.
    vis = (
        (tracks[:, 2] - tracks[:, 4] / 2 > eps)
        & (tracks[:, 3] - tracks[:, 5] / 2 > eps)
        & (tracks[:, 2] + tracks[:, 4] / 2 < frame_w - 1 - eps)
        & (tracks[:, 3] + tracks[:, 5] / 2 < frame_h - 1 - eps)
    )
    valid = tracks[vis]

    # group rows per track by one sort + split (O(N log N), not O(T*N))
    order = np.argsort(valid[:, 1], kind="stable")
    sorted_valid = valid[order]
    uniq_ids, starts = np.unique(sorted_valid[:, 1], return_index=True)
    groups = np.split(sorted_valid, starts[1:])

    id2length: dict[int, float] = {}
    id2width: dict[int, float] = {}
    for track_id, rows in zip(uniq_ids.astype(int), groups):
        lengths = np.maximum(rows[:, 4], rows[:, 5])
        widths = np.minimum(rows[:, 4], rows[:, 5])
        mask, saw = _azimuth_mask(rows[:, idx_x], rows[:, idx_y],
                                  radius_threshold, theta_bar_rad)
        if not saw:
            # stationary fallback: elongation test against the class ratio
            cls = int(rows[0, idx_c])
            mask = lengths >= widths * tau_c.get(cls, tau_c.get(-1, 1.7))
        kept_l = lengths[mask]
        kept_w = widths[mask]
        id2length[track_id] = float(np.percentile(kept_l, 25)) if kept_l.size else np.nan
        id2width[track_id] = float(np.percentile(kept_w, 25)) if kept_w.size else np.nan

    # map per-track dims back to rows with a searchsorted lookup
    all_ids = np.asarray(sorted(id2length), dtype=np.int64)
    lengths_arr = np.asarray([id2length[t] for t in all_ids])
    widths_arr = np.asarray([id2width[t] for t in all_ids])
    row_ids = tracks[:, 1].astype(np.int64)
    pos = np.searchsorted(all_ids, row_ids)
    in_table = (pos < len(all_ids))
    safe = np.clip(pos, 0, max(len(all_ids) - 1, 0))
    found = in_table & (all_ids[safe] == row_ids) if len(all_ids) else np.zeros(len(tracks), bool)
    dims = np.full((len(tracks), 2), np.nan)
    if len(all_ids):
        dims[found, 0] = lengths_arr[safe[found]]
        dims[found, 1] = widths_arr[safe[found]]
    return np.concatenate([tracks, dims], axis=1)


def interpolate_tracks(tracks: np.ndarray, max_gap: int, logger=None) -> np.ndarray:
    """Fill 2..max_gap frame gaps by linear interpolation; append flag column."""
    if tracks.size == 0:
        return tracks
    # fully vectorized gap fill: sort by (track, frame), find same-track
    # consecutive pairs with 1 < gap <= max_gap, then expand each pair into
    # gap-1 interpolated rows with a repeat + cumulative-count alpha ramp
    # (O(rows + filled), no per-track or per-gap Python loop)
    srt = tracks[np.lexsort((tracks[:, 0], tracks[:, 1]))]
    same_track = srt[1:, 1] == srt[:-1, 1]
    gaps = (srt[1:, 0] - srt[:-1, 0]).astype(np.int64)
    fill = same_track & (gaps > 1) & (gaps <= max_gap)
    skipped = int(np.count_nonzero(same_track & (gaps > max_gap)))
    if skipped and logger:
        logger.warning(
            f"Skipped {skipped} frame gap(s) exceeding track_buffer ({max_gap}); left unfilled."
        )
    flag = np.zeros((len(tracks), 1), dtype=tracks.dtype)
    tracks = np.concatenate([tracks, flag], axis=1)
    if fill.any():
        pair_idx = np.nonzero(fill)[0]          # index of the gap's left row in srt
        counts = gaps[pair_idx] - 1             # interpolated rows per gap
        rep = np.repeat(pair_idx, counts)       # left-row index per new row
        # step within the gap: 1..gap-1 via cumulative count per segment
        ends = np.cumsum(counts)
        step = np.arange(ends[-1]) - np.repeat(ends - counts, counts) + 1
        alpha = (step / gaps[rep])[:, None]
        interp = srt[rep] * (1.0 - alpha) + srt[rep + 1] * alpha
        interp[:, 0] = srt[rep, 0] + step
        interp = np.concatenate(
            [interp, np.ones((len(interp), 1), dtype=tracks.dtype)], axis=1
        )
        tracks = np.concatenate([tracks, interp], axis=0)
        tracks = tracks[np.lexsort((tracks[:, 0], tracks[:, 1]))]
        if logger:
            logger.info(f"Interpolated {len(interp)} missing frame row(s).")
    return tracks
