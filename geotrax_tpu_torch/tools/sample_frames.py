"""Sample frames from drone videos into an image folder (annotation or
training): the port of ``tools/sample_frames.py``.

- Two sampling modes: GLOBAL (default: uniform over the combined frame pool
  of every discovered video, so longer videos contribute proportionally
  more) and BALANCED (--balanced: the total quota spread as evenly as
  possible across videos, shorter videos first so that their deficit goes
  to larger ones). --stride takes every Nth eligible frame instead.
- Skip windows: --skip-start/--skip-end drop takeoff and landing frames
  from every video's pool.
- Metadata filters: repeatable --srt-filter / --csv-filter 'field:min:max'
  criteria (an empty bound is unbounded) on the companion DJI .srt/.SRT log
  (``dji_srt``) or the companion .csv of the cut tools. All criteria must
  hold; a field absent from the log passes. Videos without the required
  companion are left out while a filter is active. --min-alt/--max-alt and
  --bbox translate into the same criteria.
- --name-filter restricts discovery to stems containing a keyword (default
  'merged'; '' for every video), ignored for a single file.
- --dry-run logs the planned frames without writing; --seed makes every
  mode deterministic (``np.random.default_rng(seed)``, the reference's
  draws).

Frames are decoded by ``io/video.py`` and written by the port's PNG writer
(``io/geoassets.py:save_image``; a .jpg through Pillow).

Usage:
  python -m geotrax_tpu_torch.tools.sample_frames PROCESSED/ -o frames/ -n 200 --balanced
  python -m geotrax_tpu_torch.tools.sample_frames PROCESSED/ -o frames/ -n 200 \
      --srt-filter rel_alt:130:160 --srt-filter iso::400
  python -m geotrax_tpu_torch.tools.sample_frames clip.mp4 -o frames/ --stride 30
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.io.video import VideoReader, probe_video
from geotrax_tpu_torch.tools import dji_srt
from geotrax_tpu_torch.tools._common import save_frame
from geotrax_tpu_torch.utils.constants import VIDEO_FORMATS
from geotrax_tpu_torch.utils.logging_utils import NOTICE_LEVEL, setup_logger


def parse_filters(strings: list[str] | None) -> dict[str, tuple[float | None, float | None]]:
    """'field:min:max' (empty bound = unbounded) -> {field: (min, max)}."""
    out: dict[str, tuple[float | None, float | None]] = {}
    for s in strings or []:
        parts = s.split(":")
        if len(parts) != 3:
            raise SystemExit(f"bad filter '{s}': expected field:min:max")
        field, lo, hi = (p.strip() for p in parts)
        lo_v = float(lo) if lo else None
        hi_v = float(hi) if hi else None
        if lo_v is None and hi_v is None:
            raise SystemExit(f"filter '{s}' needs at least one bound")
        out[field] = (lo_v, hi_v)
    return out


def flight_log_frame(video: Path, want_csv: bool):
    """The per-frame flight-log table for a video: the companion .csv when
    --csv-filter is active, else the parsed DJI SRT falling back to the
    companion .csv (cut clips carry only the .csv log the cut tool wrote).
    Columns are normalized to dji_srt's canonical spellings either way;
    None when no log is usable."""
    return dji_srt.flight_log(video, prefer="csv" if want_csv else "srt")


def filtered_pool(video: Path, total: int, filters, want_csv: bool,
                  logger=None) -> np.ndarray | None:
    """Frame indices whose flight-log row satisfies every 'field:min:max'
    criterion. None = video has no usable log (caller excludes it);
    a field missing from the log never rejects."""
    df = flight_log_frame(video, want_csv)
    if df is None or "frame" not in df:
        return None
    ok = np.ones(dji_srt.table_rows(df), bool)
    for field, (lo, hi) in filters.items():
        if field not in df:
            msg = f"field '{field}' absent from {video.name}'s log; criterion skipped"
            logger.warning(msg) if logger else print(f"warning: {msg}")
            continue
        # non-numeric log values (e.g. shutter '1/1000') coerce to NaN = absent
        col = table.to_numeric(df[field])
        present = ~np.isnan(col)
        if lo is not None:
            ok &= ~present | (col >= lo)
        if hi is not None:
            ok &= ~present | (col <= hi)
    frames = np.asarray(df["frame"])[ok]
    return np.unique(frames[(frames >= 0) & (frames < total)].astype(int))


def video_pool(video: Path, args, logger=None) -> np.ndarray | None:
    """Eligible frame indices for one video after skip windows + metadata
    filters; None excludes the video (no usable companion log)."""
    total = probe_video(video).frame_count
    lo, hi = args.skip_start, total - args.skip_end
    if hi <= lo:
        return np.empty(0, int)
    filters = dict(args.filters)
    if not filters:
        return np.arange(lo, hi)
    pool = filtered_pool(video, total, filters, want_csv=bool(args.csv_filter),
                         logger=logger)
    if pool is None:
        return None
    return pool[(pool >= lo) & (pool < hi)]


def plan_global(pools: dict[Path, np.ndarray], n: int, rng) -> dict[Path, np.ndarray]:
    """Uniform draw over the union pool — longer videos proportionally
    more represented (the default mode)."""
    videos = sorted(pools)
    sizes = np.array([len(pools[v]) for v in videos])
    total = int(sizes.sum())
    n = min(n, total)
    flat = np.sort(rng.choice(total, size=n, replace=False))
    bounds = np.cumsum(sizes)
    out = {}
    for i, v in enumerate(videos):
        lo = bounds[i - 1] if i else 0
        local = flat[(flat >= lo) & (flat < bounds[i])] - lo
        if len(local):
            out[v] = pools[v][local]
    return out


def plan_balanced(pools: dict[Path, np.ndarray], n: int, rng) -> dict[Path, np.ndarray]:
    """Even quota across videos. Ascending pool-size order lets an
    under-capacity video's deficit flow to the remaining larger ones."""
    order = sorted(pools, key=lambda v: len(pools[v]))
    out = {}
    remaining = min(n, sum(len(p) for p in pools.values()))
    for i, v in enumerate(order):
        quota = min(remaining // (len(order) - i), len(pools[v]))
        remaining -= quota
        if quota:
            out[v] = np.sort(rng.choice(pools[v], size=quota, replace=False))
    return out


def extract(video: Path, frames: np.ndarray, out: Path, root: Path, args,
            logger) -> int:
    """Decode the selected frames (single forward pass) and save images."""
    rel = video.relative_to(root).with_suffix("") if root in video.parents else Path(video.stem)
    safe = str(rel).replace("/", "_").replace(".", "_")
    wanted = set(int(i) for i in frames)
    saved = 0
    for idx in sorted(wanted):
        name = f"frame_{safe}_{idx:06d}.{args.output_format}"
        if args.dry_run:
            logger.info(f"[dry-run] {name}  (frame {idx} of {video.name})")
            saved += 1
    if args.dry_run:
        return saved
    for idx, frame in VideoReader(video):
        if idx in wanted:
            save_frame(out / f"frame_{safe}_{idx:06d}.{args.output_format}", frame)
            saved += 1
            if saved == len(wanted):
                break
    return saved


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Sample frames from drone videos into an image folder (annotation/training).")
    parser.add_argument("input", type=Path, help="A video file or a directory of videos")
    parser.add_argument("--out", "-o", type=Path, required=True)
    parser.add_argument("--num", "-n", type=int, default=None,
                        help="TOTAL frames to extract across all videos (default 100)")
    parser.add_argument("--stride", type=int, default=None,
                        help="Every Nth eligible frame per video instead of random sampling")
    parser.add_argument("--balanced", "-b", action="store_true",
                        help="Spread the quota evenly across videos (default: global pool)")
    parser.add_argument("--name-filter", "-nf", default="merged",
                        help="Keyword the video stem must contain ('' = all; default 'merged'). "
                             "Ignored for single-file input.")
    parser.add_argument("--skip-start", "-ss", type=int, default=0,
                        help="Drop the first N frames of each video (takeoff)")
    parser.add_argument("--skip-end", "-se", type=int, default=0,
                        help="Drop the last N frames of each video (landing)")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--srt-filter", action="append", metavar="FIELD:MIN:MAX",
                       help="Companion-SRT criterion (repeatable; empty bound = unbounded)")
    group.add_argument("--csv-filter", action="append", metavar="FIELD:MIN:MAX",
                       help="Companion-CSV criterion (same syntax)")
    parser.add_argument("--output-format", "-of", choices=("png", "jpg", "jpeg"),
                        default="png")
    parser.add_argument("--seed", "-s", type=int, default=42)
    parser.add_argument("--dry-run", "-dr", action="store_true")
    parser.add_argument("--log-path", "-lp", type=Path, default=None,
                        help="Log file or directory (default: the platform log dir)")
    parser.add_argument("--quiet", "-q", action="store_true",
                        help="Console shows NOTICE-and-up only (file log keeps INFO)")
    # convenience sugar (kept from earlier revisions) — folds into --srt-filter
    parser.add_argument("--min-alt", type=float, default=None,
                        help="Shorthand for --srt-filter rel_alt:MIN:")
    parser.add_argument("--max-alt", type=float, default=None,
                        help="Shorthand for --srt-filter rel_alt::MAX")
    parser.add_argument("--bbox", type=float, nargs=4, default=None,
                        metavar=("LAT_MIN", "LON_MIN", "LAT_MAX", "LON_MAX"),
                        help="Shorthand for latitude/longitude box criteria")
    args = parser.parse_args(argv)

    # --log-path / --quiet: a NOTICE-level console under -q, the platform
    # directory's file log otherwise
    logger = setup_logger("sample_frames", verbose=False,
                          log_path=args.log_path, dry_run=args.dry_run)
    if args.quiet:
        import logging

        for h in logger.handlers:
            if isinstance(h, logging.StreamHandler) and not isinstance(
                    h, logging.FileHandler):
                h.setLevel(NOTICE_LEVEL)

    args.filters = parse_filters(args.srt_filter or args.csv_filter)
    if args.min_alt is not None or args.max_alt is not None:
        args.filters["rel_alt"] = (args.min_alt, args.max_alt)
    if args.bbox is not None:
        la0, lo0, la1, lo1 = args.bbox
        args.filters["latitude"] = (la0, la1)
        args.filters["longitude"] = (lo0, lo1)

    if args.input.is_file():
        videos, root = [args.input], args.input.parent
    else:
        kw = args.name_filter.lower()
        videos = sorted(p for p in args.input.rglob("*")
                        if p.suffix.lower() in VIDEO_FORMATS and kw in p.stem.lower())
        root = args.input
    if not videos:
        logger.error(f"no video files{f' matching *{args.name_filter}*' if args.name_filter else ''} "
                     f"under {args.input}")
        return 1

    pools = {}
    for v in videos:
        pool = video_pool(v, args, logger)
        label = str(v.relative_to(root)) if root in v.parents else v.name
        if pool is None:
            logger.warning(f"no flight log for {label}; excluded while a metadata filter is active")
        elif len(pool) == 0:
            logger.info(f"{label}: no frames pass the filters/skip windows")
        else:
            pools[v] = pool
    if not pools:
        logger.error("no eligible frames in any video")
        return 1

    rng = np.random.default_rng(args.seed)
    if args.stride:
        plan = {v: p[::args.stride] for v, p in pools.items()}
    elif args.balanced:
        plan = plan_balanced(pools, args.num or 100, rng)
    else:
        plan = plan_global(pools, args.num or 100, rng)

    if not args.dry_run:
        args.out.mkdir(parents=True, exist_ok=True)
    total = sum(extract(v, f, args.out, root, args, logger) for v, f in plan.items())
    mode = "stride" if args.stride else "balanced" if args.balanced else "global"
    logger.notice(f"Sampled {total} frame(s) ({mode}) from {len(plan)}/{len(videos)} "
                  f"video(s) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
