"""`python -m geotrax_tpu_torch georeference <video>`: pixel tracks to WGS84
and a local CRS, with kinematics.

The port of ``geotrax_tpu/pipeline/georeference.py`` and
``_georeference_impl.py``. Stabilized pixel tracks are mapped to the
orthophoto by a homography (reference frame -> master frame -> ortho, the
master -> ortho hop cached per location, or reference -> ortho with
``--no-master``), then to geographic coordinates by the ortho's affine
parameters, then to a local projected CRS; speed and acceleration are
smoothed per track, dimensions converted to metres, visibility and the lane
and road section assigned. The registrations run on the card (the RootSIFT
``Stabilizer``), and so does the lane assignment (``ops/polygon.py``); the
CRS, smoothing, kinematics and files stay on the host in float64 numpy, as
the reference keeps them. Writes ``<stem>_geo.csv`` (16-18 columns, the
bytes ``DataFrame.to_csv`` writes) and ``<stem>_geo_transf.txt``.

``get_video_data`` and ``compute_homography`` are module-level so that
callers (and tests) can replace them.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.io import geoassets, table
from geotrax_tpu_torch.ops.filters import gaussian_filter1d_np, savgol_filter_np
from geotrax_tpu_torch.ops.tmerc import geo2local as tmerc_geo2local
from geotrax_tpu_torch.utils.cli_utils import add_common_args
from geotrax_tpu_torch.utils.file_utils import (
    build_result_path,
    check_if_results_exist,
    detect_delimiter,
    determine_location_id,
    get_ortho_folder,
    get_output_dir,
)

UNDEFINED_TIMESTAMP = "0000-00-00 00:00:00.000"


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def get_tracking_data(source: Path, logger, output_cfg=None) -> tuple:
    exists, path = check_if_results_exist(source, "processed", output_cfg=output_cfg)
    if not exists:
        logger.critical(f"No tracking data for '{source}'; run 'geotrax extract' first.")
        sys.exit(1)
    tracks = np.loadtxt(path, delimiter=detect_delimiter(path), dtype=np.float64)
    if tracks.size == 0 or tracks.ndim != 2:
        logger.critical(f"No valid tracking data in '{path}'.")
        sys.exit(1)
    if tracks.shape[1] < 14:
        logger.critical(
            f"Invalid tracking data format in '{path}': expected >= 14 columns "
            "(stabilized layout). Re-run extraction with stabilization enabled."
        )
        sys.exit(1)
    is_interp = tracks[:, 14].astype(int) if tracks.shape[1] >= 15 else None
    return (
        tracks[:, 1].astype(int),    # track_id
        tracks[:, 0].astype(int),    # frame_num
        tracks[:, 2:6],              # bbox_unstab
        tracks[:, 6],                # x_stab
        tracks[:, 7],                # y_stab
        tracks[:, 10].astype(int),   # class_id
        tracks[:, 12:14],            # dimensions px
        is_interp,
    )


def get_timestamps(source: Path, frame_num: np.ndarray, logger) -> np.ndarray:
    """Each row's timestamp from the flight log ``<video>.csv`` (columns
    ``frame`` and ``timestamp``), rebased to start at frame 0; the first
    row wins where a frame repeats; frames without one get
    ``UNDEFINED_TIMESTAMP``. Empty when there is no log."""
    path = source.with_suffix(".csv")
    if not path.exists() and source.with_suffix(".CSV").exists():
        path = source.with_suffix(".CSV")
    if not path.exists():
        logger.warning(f"No flight-log timestamps at '{path}'; frame numbers used instead.")
        return np.array([])
    log = table.read_csv(path)
    frames, stamps = log["frame"], log["timestamp"]
    if len(frames) == 0:
        logger.warning(f"Flight log '{path}' has no rows; frame numbers used instead.")
        return np.array([])
    if frames[0] != 0:
        logger.warning("Flight log does not start at frame 0; rebasing indices.")
        frames = frames - frames[0]
    lookup = {}
    for f, t in zip(frames.tolist(), stamps.tolist()):
        lookup.setdefault(f, t)
    out = [lookup.get(f, UNDEFINED_TIMESTAMP) for f in frame_num.tolist()]
    logger.info(f"Loaded timestamps from '{path}'.")
    return np.asarray(out)


def get_video_data(source: Path, ref_frame_num: int, logger) -> tuple:
    from geotrax_tpu_torch.io.video import VideoReader, probe_video

    info = probe_video(source)
    if not info.fps:
        logger.critical(f"Cannot read FPS from '{source}'.")
        sys.exit(1)
    ref_frame = VideoReader(source).read_frame(ref_frame_num)
    logger.info(
        f"Reference frame {ref_frame_num} loaded from '{source}' "
        f"({info.height}x{info.width} @ {info.fps:.2f} fps)."
    )
    return ref_frame, (info.height, info.width), info.fps


# ---------------------------------------------------------------------------
# Homography chain
# ---------------------------------------------------------------------------

def compute_homography(img_src, img_dst, src_dst, logger, device="cuda", **matching_cfg):
    from geotrax_tpu_torch.utils.registration import estimate_homography

    homography, inliers, n_matches, (n_src, n_dst) = estimate_homography(
        img_src, img_dst, logger, device=device, **matching_cfg
    )
    if homography is None:
        sys.exit(1)
    stats = (
        f"Keypoints in {src_dst[0]} frame: {n_src}, in {src_dst[1]}: {n_dst}. "
        f"Inliers: {inliers} out of {n_matches} matches"
    )
    (logger.warning if inliers < 50 else logger.info)(stats)
    return homography, stats


def compute_hash(image: np.ndarray) -> str:
    return hashlib.md5(image.tobytes()).hexdigest()


def get_master_to_ortho_homography(
    master_frame, ortho_folder, master_folder, location_id, recompute, matching_cfg, logger,
    device="cuda",
):
    folder = master_folder if master_folder is not None else ortho_folder / "master_frames"
    cache_path = Path(folder) / f"{location_id}.txt"
    current_hash = compute_hash(master_frame)

    if cache_path.exists() and not recompute:
        try:
            lines = cache_path.read_text().splitlines()
            h = np.array([float(v) for v in lines[0].split(",")]).reshape(3, 3)
            saved_hash = lines[3].strip().split(": ")[1]
            if saved_hash == current_hash:
                logger.info(f"Loaded cached master->ortho homography from '{cache_path}'.")
                return h
            logger.warning("Master frame changed; recomputing master->ortho homography.")
        except Exception as exc:  # noqa: BLE001 — an unreadable cache ends the run
            logger.error(f"Failed to read homography cache '{cache_path}': {exc}")
            sys.exit(1)

    ortho = geoassets.get_orthophoto(ortho_folder, location_id, logger)
    h, stats = compute_homography(master_frame, ortho, ("master", "ortho"), logger,
                                  device=device, **matching_cfg)
    try:
        with open(cache_path, "w") as fh:
            np.savetxt(fh, h.reshape(1, -1), fmt="%.20g", delimiter=",")
            fh.write("\n# Hash of the master frame\n")
            fh.write(f"Hash: {current_hash}\n")
            fh.write("\n# Image matching stats\n")
            fh.write(f"Stats: {stats}\n")
    except OSError as exc:
        logger.error(f"Failed to save homography cache '{cache_path}': {exc}")
        sys.exit(1)
    logger.info(f"Computed and cached master->ortho homography at '{cache_path}'.")
    return h


# ---------------------------------------------------------------------------
# Coordinate math (host, float64)
# ---------------------------------------------------------------------------

def apply_homography_np(x: np.ndarray, y: np.ndarray, h: np.ndarray) -> tuple:
    pts = np.column_stack([x, y, np.ones(len(x))])
    mapped = pts @ h.T
    return mapped[:, 0] / mapped[:, 2], mapped[:, 1] / mapped[:, 2]


def ortho2geo(ortho_x, ortho_y, ortho_params) -> tuple:
    lng0, lat0, dlng, dlat, skew_x, skew_y = ortho_params
    longitude = lng0 + dlng * ortho_x + skew_x * ortho_y
    latitude = lat0 + dlat * ortho_y + skew_y * ortho_x
    return latitude, longitude


def geo2local(latitude, longitude, source_crs: str, target_crs: str) -> tuple:
    return tmerc_geo2local(latitude, longitude, source_crs, target_crs, xp=np)


def frame2local(points_px, homography, ortho_params, source_crs, target_crs) -> np.ndarray:
    ox, oy = apply_homography_np(points_px[:, 0], points_px[:, 1], homography)
    lat, lng = ortho2geo(ox, oy, ortho_params)
    x, y = geo2local(lat, lng, source_crs, target_crs)
    return np.stack([x, y], axis=-1)


def convert_dimensions(track_ids, veh_dim_px, frame_size, homography, ortho_params,
                       source_crs, target_crs) -> tuple:
    """Per-track px -> metre dimensions from probe points at the frame's
    center, all tracks in one batched transform."""
    length_px, width_px = veh_dim_px.T
    center = np.array([frame_size[1] / 2, frame_size[0] / 2])
    uniq, first_idx, inv = np.unique(track_ids, return_index=True, return_inverse=True)
    lp = length_px[first_idx]
    wp = width_px[first_idx]
    ok = ~(np.isnan(lp) | np.isnan(wp))
    lr_u = np.full(len(uniq), np.nan)
    wr_u = np.full(len(uniq), np.nan)
    if ok.any():
        lp_ok, wp_ok = lp[ok], wp[ok]
        k = len(lp_ok)
        probes = np.empty((3 * k, 2))
        probes[0::3] = center
        probes[1::3] = center + np.stack([np.zeros(k), wp_ok / 2], axis=1)
        probes[2::3] = center + np.stack([lp_ok / 2, np.zeros(k)], axis=1)
        pts = frame2local(probes, homography, ortho_params, source_crs, target_crs)
        p1, p2, p3 = pts[0::3], pts[1::3], pts[2::3]
        lr_u[ok] = 2 * np.linalg.norm(p1 - p3, axis=1)
        wr_u[ok] = 2 * np.linalg.norm(p1 - p2, axis=1)
    return lr_u[inv], wr_u[inv]


def calculate_visibility(track_ids, bbox_unstab, frame_size, visibility_margin: int = 4):
    x, y, w, h = bbox_unstab.T
    frame_w, frame_h = frame_size[1], frame_size[0]
    visible_x = (x - w / 2 > visibility_margin) & (x + w / 2 < frame_w - visibility_margin - 1)
    visible_y = (y - h / 2 > visibility_margin) & (y + h / 2 < frame_h - visibility_margin - 1)
    return visible_x & visible_y


# ---------------------------------------------------------------------------
# Kinematics (host, float64)
# ---------------------------------------------------------------------------

def apply_filter(data: np.ndarray, kernel_size: int, filter_type: str = "gaussian"):
    if filter_type == "gaussian":
        return gaussian_filter1d_np(data, kernel_size, mode="reflect", truncate=3.0)
    if filter_type == "savgol":
        return savgol_filter_np(data, kernel_size, polyorder=2, mode="nearest")
    raise ValueError(f"Invalid filter type '{filter_type}' (gaussian|savgol).")


def compute_speed(x, y, fps: float) -> np.ndarray:
    return np.hypot(np.diff(x), np.diff(y)) * fps


def compute_acceleration(speed, fps: float) -> np.ndarray:
    return np.diff(speed) * fps


def interpolate_missing_points(frames, x, y) -> tuple:
    """Densify frame gaps linearly; returns (x_dense, y_dense, present_idx)."""
    frames = np.asarray(frames, dtype=np.int64)
    dense = np.arange(frames[0], frames[-1] + 1)
    x_dense = np.interp(dense, frames, x)
    y_dense = np.interp(dense, frames, y)
    present = frames - frames[0]
    return x_dense, y_dense, present


def compute_kinematics(track_ids, frame_num, x_local, y_local, visibility, fps,
                       filter_type, kernel_size, is_interpolated=None,
                       conversion_factor: float = 3.6) -> tuple:
    """Speed [km/h] and acceleration [m/s^2] per row; only visible, real
    (non-interpolated) points take part."""
    speed = np.full(len(track_ids), np.nan)
    acceleration = np.full(len(track_ids), np.nan)
    order = np.argsort(track_ids, kind="stable")
    _, starts = np.unique(track_ids[order], return_index=True)
    bounds = list(starts[1:]) + [len(order)]
    for s, e in zip(starts, bounds):
        idx = np.sort(order[s:e])
        real = (is_interpolated[idx] == 0) if is_interpolated is not None else np.ones(len(idx), bool)
        usable = visibility[idx] & real
        if usable.sum() < 3:
            continue
        frames = frame_num[idx][usable]
        xs = x_local[idx][usable]
        ys = y_local[idx][usable]
        x_dense, y_dense, present = interpolate_missing_points(frames, xs, ys)
        speed_vals = compute_speed(x_dense, y_dense, fps)
        speed_vals = apply_filter(speed_vals, kernel_size, filter_type)
        accel_vals = compute_acceleration(speed_vals, fps)
        speed_vals = speed_vals * conversion_factor
        speed_vals = np.insert(speed_vals, 0, np.nan)
        accel_vals = np.insert(accel_vals, 0, [np.nan] * 2)
        speed[idx[usable]] = speed_vals[present]
        acceleration[idx[usable]] = accel_vals[present]
    return speed, acceleration


# ---------------------------------------------------------------------------
# Lane assignment (device)
# ---------------------------------------------------------------------------

def assign_road_section_lane(ortho_x, ortho_y, segmentation: dict, device="cuda") -> tuple:
    """(road section, lane) of each point: the first lane polygon of the
    segmentation (section, lane, four corners) that holds it, tested on
    ``device``; (None, None) without a segmentation."""
    columns = list(segmentation.values())
    if not columns or len(columns[0]) == 0:
        return None, None
    from geotrax_tpu_torch.ops.polygon import assign_first_polygon

    sections, lanes, coords = columns[0], columns[1], columns[2:10]
    polys = np.stack([np.stack([coords[2 * i], coords[2 * i + 1]], axis=-1) for i in range(4)],
                     axis=1).astype(np.float32)  # (M,4,2): tl, bl, br, tr
    points = np.stack([ortho_x, ortho_y], axis=-1).astype(np.float32)
    dev = torch.device(device)
    hit = assign_first_polygon(torch.as_tensor(points, device=dev),
                               torch.as_tensor(polys, device=dev)).cpu().numpy()
    first = np.clip(hit, 0, len(sections) - 1)
    section = np.where(hit >= 0, sections[first], None)
    lane = np.where(hit >= 0, lanes.astype(float)[first], np.nan)
    return section, lane


# ---------------------------------------------------------------------------
# Output
# ---------------------------------------------------------------------------

def create_georeferenced_columns(
    track_id, timestamps, frame_num, x_ortho, y_ortho, x_local, y_local,
    latitude, longitude, veh_dim_real, class_id, speed, acceleration,
    road_section, lane_number, visibility, min_traj_length,
    is_interpolated=None, *, logger,
) -> dict:
    """The output table as {column: values}, in the reference's column order
    and rounding, absent columns left out, tracks with fewer than
    ``min_traj_length`` (real) points removed."""
    data = {
        "Vehicle_ID": track_id,
        "Timestamp": timestamps if timestamps.size > 0 else None,
        "Frame_Number": frame_num,
        "Ortho_X": np.round(x_ortho, 1),
        "Ortho_Y": np.round(y_ortho, 1),
        "Local_X": np.round(x_local, 2),
        "Local_Y": np.round(y_local, 2),
        "Latitude": np.round(latitude, 7),
        "Longitude": np.round(longitude, 7),
        "Vehicle_Length": np.round(veh_dim_real[0], 2),
        "Vehicle_Width": np.round(veh_dim_real[1], 2),
        "Vehicle_Class": class_id,
        "Vehicle_Speed": np.round(speed, 1),
        "Vehicle_Acceleration": np.round(acceleration, 2),
        "Road_Section": road_section,
        "Lane_Number": lane_number,
        "Visibility": visibility.astype(int),
        "Is_Interpolated": is_interpolated,
    }
    columns = {k: np.asarray(v) for k, v in data.items() if v is not None}
    if "Lane_Number" in columns:
        ln = columns["Lane_Number"].astype(float)
        out = np.full(len(ln), "", dtype=object)
        mask = ~np.isnan(ln)
        if mask.any():
            out[mask] = ln[mask].astype(np.int64).astype(str)
        columns["Lane_Number"] = out
    if min_traj_length > 0:
        ids = columns["Vehicle_ID"]
        uniq, inv = np.unique(ids, return_inverse=True)
        if "Is_Interpolated" in columns:
            counts = np.bincount(inv, weights=(columns["Is_Interpolated"] == 0))
        else:
            counts = np.bincount(inv)
        keep = counts[inv] >= min_traj_length
        columns = {k: v[keep] for k, v in columns.items()}
        removed = len(uniq) - len(np.unique(columns["Vehicle_ID"]))
        if removed:
            logger.info(f"Removed {removed} vehicles with fewer than {min_traj_length} points.")
    return columns


# ---------------------------------------------------------------------------
# Main flow
# ---------------------------------------------------------------------------

class _Progress:
    """One log line per step of the stage (the port has no progress bar),
    each step's seconds kept for the caller."""

    def __init__(self, name: str, steps: int, logger):
        self.name, self.steps, self.logger = name, steps, logger
        self.done, self.seconds, self._step, self._t = 0, {}, None, time.perf_counter()

    def step(self, what: str) -> None:
        self._close()
        self._step = what
        self.logger.info(f"{self.name} - georeferencing [{self.done + 1}/{self.steps}]: {what}")

    def _close(self) -> None:
        now = time.perf_counter()
        if self._step is not None:
            self.seconds[self._step] = now - self._t
            self.done += 1
        self._step, self._t = None, now

    def close(self) -> dict:
        self._close()
        return self.seconds


def run_georeferencing(args, logger: logging.Logger) -> dict:
    """``georeference``'s stage for one video; returns the seconds of each
    step and the paths written."""
    from geotrax_tpu_torch.utils.config_utils import backfill_args_from_config, load_config_all

    device = resolve_device(getattr(args, "device", None) or "cuda")
    full_config = load_config_all(args, logger, needs_model=False)
    config = full_config["georef"]
    gproc = config["processing"]
    folders = full_config["main"]["input"]
    out_cfg_raw = full_config["main"].get("output", {})
    backfill_args_from_config(args, {
        "ref_frame": gproc["ref_frame"],
        "recompute": gproc["recompute"],
        "geo_source": gproc["geo_source"],
        "no_master": not gproc["use_master"],
        "ortho_folder": Path(folders["ortho_folder"]) if folders.get("ortho_folder") else None,
        "master_folder": Path(folders["master_folder"]) if folders.get("master_folder") else None,
        "segmentation_folder": Path(folders["segmentation_folder"]) if folders.get("segmentation_folder") else None,
        "output_folder": out_cfg_raw.get("folder", "results"),
    })
    out_cfg = {**out_cfg_raw, "folder": args.output_folder}
    source = Path(args.source)

    progress = _Progress(source.name, 8 if args.no_master else 10, logger)
    progress.step("loading tracking data")
    location_id = determine_location_id(source, logger)
    (track_id, frame_num, bbox_unstab, x_stab, y_stab, class_id,
     veh_dim_px, is_interpolated) = get_tracking_data(source, logger, out_cfg)
    timestamps = get_timestamps(source, frame_num, logger)

    progress.step("reading reference frame")
    reference_frame, frame_size, fps = get_video_data(source, args.ref_frame, logger)

    progress.step("loading orthophoto data")
    ortho_folder = get_ortho_folder(source, args.ortho_folder, logger)
    geo_source = geoassets.get_geo_params_source(args.geo_source, ortho_folder, location_id, logger)
    ortho_params = geoassets.get_ortho_parameters(
        ortho_folder, location_id, geo_source, config["transformation"]["cutout_width_px"], logger
    )
    segmentation = geoassets.get_road_section_lane_geometry(
        ortho_folder, args.segmentation_folder, location_id, logger
    )

    matching_cfg = config["matching"]
    if args.no_master:
        progress.step("computing reference -> orthophoto homography")
        ortho = geoassets.get_orthophoto(ortho_folder, location_id, logger)
        h_ref_to_ortho, _ = compute_homography(
            reference_frame, ortho, ("reference", "ortho"), logger, device=device, **matching_cfg
        )
        del ortho
    else:
        progress.step("loading master frame")
        master_frame = geoassets.get_master_frame(ortho_folder, args.master_folder, location_id, logger)
        progress.step("computing reference -> master homography")
        h_ref_to_master, _ = compute_homography(
            reference_frame, master_frame, ("reference", "master"), logger, device=device,
            **matching_cfg
        )
        progress.step("computing master -> orthophoto homography")
        h_master_to_ortho = get_master_to_ortho_homography(
            master_frame, ortho_folder, args.master_folder, location_id,
            args.recompute, matching_cfg, logger, device=device,
        )
        h_ref_to_ortho = h_master_to_ortho @ h_ref_to_master

    progress.step("transforming coordinates")
    x_ortho, y_ortho = apply_homography_np(x_stab, y_stab, h_ref_to_ortho)
    latitude, longitude = ortho2geo(x_ortho, y_ortho, ortho_params)
    source_crs = config["transformation"]["source_crs"]
    target_crs = config["transformation"]["target_crs"]
    x_local, y_local = geo2local(latitude, longitude, source_crs, target_crs)
    veh_dim_real = convert_dimensions(
        track_id, veh_dim_px, frame_size, h_ref_to_ortho, ortho_params, source_crs, target_crs
    )
    visibility = calculate_visibility(
        track_id, bbox_unstab, frame_size, config["filtering"]["visibility_margin"]
    )

    progress.step("computing kinematics")
    speed, acceleration = compute_kinematics(
        track_id, frame_num, x_local, y_local, visibility, fps,
        config["filtering"]["filter_type"], config["filtering"]["kernel_size"],
        is_interpolated=is_interpolated,
    )

    progress.step("assigning road sections")
    road_section, lane_number = assign_road_section_lane(x_ortho, y_ortho, segmentation, device)

    progress.step("saving results")
    columns = create_georeferenced_columns(
        track_id, timestamps, frame_num, x_ortho, y_ortho, x_local, y_local,
        latitude, longitude, veh_dim_real, class_id, speed, acceleration,
        road_section, lane_number, visibility, config["filtering"]["min_traj_length"],
        is_interpolated, logger=logger,
    )
    out_path = build_result_path(source, "georeferenced", out_cfg)
    get_output_dir(source, out_cfg).mkdir(parents=True, exist_ok=True)
    table.write_csv(out_path, columns)
    logger.info(f"Georeferenced data saved to '{out_path}'.")

    geo_transf_path = build_result_path(source, "geo_transformations", out_cfg)
    np.savetxt(geo_transf_path, h_ref_to_ortho.reshape(1, -1), fmt="%.20g", delimiter=",")
    logger.info(f"Reference->ortho homography saved to '{geo_transf_path}'.")
    return {"seconds": progress.close(), "csv": out_path, "geo_transf": geo_transf_path,
            "rows": int(len(columns["Vehicle_ID"])), "h_ref_to_ortho": h_ref_to_ortho}


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def georeference(args, logger: logging.Logger) -> dict:
    """The georeference stage for one video (the library entry point that
    ``batch`` calls): ``run_georeferencing``."""
    return run_georeferencing(args, logger)


def add_georeferencing_args(group) -> None:
    """The georeferencing flags (all default to None and are backfilled
    from the config)."""
    group.add_argument("--ortho-folder", "-orf", type=Path, default=None,
                       help="Folder with orthophotos (.png, .txt); default auto-detect ORTHOPHOTOS.")
    group.add_argument("--geo-source", "-gs", choices=["metadata-tif", "text-file", "center-text-file"],
                       default=None, help="Source of georeferencing parameters (default: auto-detect).")
    group.add_argument("--ref-frame", "-rf", type=int, default=None,
                       help="Reference frame number (must match the stabilization reference frame).")
    group.add_argument("--no-master", "-nm", action="store_const", const=True, default=None,
                       help="Disable the master-frame approach regardless of config.")
    group.add_argument("--master-folder", "-mf", type=Path, default=None,
                       help="Folder containing master frame files (.png).")
    group.add_argument("--recompute", "-r", action="store_const", const=True, default=None,
                       help="Force recompute of the master->ortho homography even if cached.")
    group.add_argument("--segmentation-folder", "-osf", type=Path, default=None,
                       help="Folder with lane-segmentation CSV files for lane assignment.")


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m geotrax_tpu_torch georeference",
        description="Georeference tracking data using orthophotos (PyTorch/CUDA)")
    parser.add_argument("source", type=Path, help="Path to the input video file.")
    optional = parser.add_argument_group("Optional arguments")
    add_common_args(optional)
    georef = parser.add_argument_group("Georeferencing arguments")
    add_georeferencing_args(georef)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from geotrax_tpu_torch.utils.logging_utils import setup_logger

    args = parse_cli_args(argv)
    logger = setup_logger("geotrax.georeference", args.verbose, args.log_path)
    run_georeferencing(args, logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
