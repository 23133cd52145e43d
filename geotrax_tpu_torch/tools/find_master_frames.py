"""Pick a master frame per video for consistent georeferencing: the port
of ``tools/find_master_frames.py``.

The master frame should come from the most stable hover (closest to the
mean hover position in the flight log) and show the best detection
coverage: a frame crowded with tracked vehicles registers more reliably
against the orthophoto, because the moving-object mask still leaves the
road structure visible. Among the frames whose GPS position is within
--hover-radius of the mean hover position, the tool takes the one with the
most detections in the extraction results (--results, the stage-1 tracks
.txt), ties broken by the smallest deviation; without results the smallest
deviation; without a flight log the middle of the video. Host only: the
flight log through ``io/table.py``, the frame through ``io/video.py`` and
``io/geoassets.py:save_image``.

Usage:
  python -m geotrax_tpu_torch.tools.find_master_frames VIDEO_OR_DIR -o master_frames/ \
      [--results RESULTS_DIR] [--hover-radius 2.0]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.io.geoassets import save_image
from geotrax_tpu_torch.io.video import VideoReader, probe_video
from geotrax_tpu_torch.utils.constants import VIDEO_FORMATS
from geotrax_tpu_torch.utils.file_utils import determine_location_id


def detections_per_frame(tracks_txt: Path) -> dict[int, int]:
    """frame id -> detection count from a stage-1 tracks file (col 0 is the
    frame id in every layout)."""
    try:
        data = np.loadtxt(tracks_txt, delimiter=",", ndmin=2)
    except (OSError, ValueError):
        return {}
    if data.size == 0:
        return {}
    frames, counts = np.unique(data[:, 0].astype(int), return_counts=True)
    return dict(zip(frames.tolist(), counts.tolist()))


def pick_frame_index(video: Path, results_dir: Path | None,
                     hover_radius: float) -> int:
    """Best master-frame index: hover stability + detection coverage."""
    log = video.with_suffix(".csv")
    info = probe_video(video)
    if not log.exists():
        return max(info.frame_count // 2, 0)
    df = table.read_csv(log)
    if not {"latitude", "longitude"} <= set(df):
        return max(info.frame_count // 2, 0)
    lat = np.asarray(df["latitude"], np.float64)
    lon = np.asarray(df["longitude"], np.float64)
    mean_lat, mean_lon = np.nanmean(lat), np.nanmean(lon)
    dev = np.hypot((lat - mean_lat) * 111320.0,
                   (lon - mean_lon) * 111320.0 * np.cos(np.deg2rad(mean_lat)))
    frames = np.asarray(df["frame"]).astype(int)
    stable = dev <= hover_radius
    if not stable.any():
        stable = dev <= np.nanpercentile(dev, 10)

    coverage = {}
    if results_dir is not None:
        tracks = results_dir / f"{video.stem}.txt"
        if tracks.exists():
            coverage = detections_per_frame(tracks)
    if coverage:
        # maximize detections among stable frames; tie-break by deviation
        cand = [(coverage.get(int(f), 0), -float(d), int(f))
                for f, d, s in zip(frames, dev, stable) if s and np.isfinite(d)]
        if cand:
            _, _, idx = max(cand)
            return min(idx, max(info.frame_count - 1, 0))
    idx = int(frames[int(np.nanargmin(np.where(stable, dev, np.inf)))])
    return min(idx, max(info.frame_count - 1, 0))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Pick a master frame per video for consistent georeferencing.")
    parser.add_argument("input", type=Path, help="Video file or directory of videos")
    parser.add_argument("--out", "-o", type=Path, required=True)
    parser.add_argument("--results", type=Path, default=None,
                        help="Extraction results dir (stage-1 tracks .txt) for the "
                             "detection-coverage criterion")
    parser.add_argument("--hover-radius", type=float, default=2.0,
                        help="Max GPS deviation [m] from the mean hover position for "
                             "a frame to count as stable")
    args = parser.parse_args(argv)

    videos = ([args.input] if args.input.is_file()
              else sorted(p for p in args.input.rglob("*") if p.suffix.lower() in VIDEO_FORMATS))
    args.out.mkdir(parents=True, exist_ok=True)
    for video in videos:
        location = determine_location_id(video)
        idx = pick_frame_index(video, args.results, args.hover_radius)
        frame = VideoReader(video).read_frame(idx)
        out = args.out / f"{location}.png"
        save_image(out, frame)
        print(f"{video.name}: frame {idx} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
