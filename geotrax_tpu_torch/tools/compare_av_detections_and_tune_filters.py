"""Compare pipeline trajectories against RTK probe-vehicle ground truth and
tune the kinematics smoothing filter: the port of
``tools/compare_av_detections_and_tune_filters.py``.

Two input modes:

DATASET mode (the positional argument is a folder):
  <data>/av_trajectories/sec_nsec_lon_lat_*.txt   RTK fixes (sec nsec lon lat)
  <data>/av_trajectories/sec_nsec_horSpd_*.txt    RTK speeds (sec nsec m/s)
  <data>/<results>/<video>.csv                    georeferenced pipeline CSVs
  --probe-map map.yaml                            {video: {id, start, end}}

SIMPLE mode (the positional argument is one pipeline CSV):
  --probe probe.csv with columns frame,x,y[,speed_kmh]; the probe is matched
  to the pipeline vehicle with the lowest mean position error (an inner
  join on the frame number).

Shared analysis: the probe log is clipped to the pass (the fixes closest to
the trajectory's first and last positions); positional error is the
distance from each moving probe fix to the segment through the two nearest
extracted points; speed error is the probe's speed less the
inverse-distance-weighted speed of those two points; both are aggregated
per video and per intersection (the first letter of the video's stem).
``--tune`` sweeps the smoothing parameter (gaussian sigma 1..25 step 0.5 or
savgol window 30..80 step 3, or ``--grid``) with speeds recomputed from the
raw positions (``pipeline/georeference.py``'s ``compute_speed`` and
``apply_filter``, ``ops/filters.gaussian_filter1d_np`` for fractional
sigmas) and reports the best setting per intersection under both criteria.
``--save`` writes the LaTeX rows and, when matplotlib is installed, the PDF
figures (the orthophoto background of ``--coords ortho`` through
``io/geoassets.load_image``).

Tables are ``{column: numpy array}`` (``io/table.py``); timestamps are int64
nanoseconds (``table.to_datetime_ns``, ``table.seconds_to_ns``), RTK
positions go to local metres through ``ops/tmerc.geo2local``.

Usage:
  python -m geotrax_tpu_torch.tools.compare_av_detections_and_tune_filters data/ \
      --probe-map probes.yaml --tune --filter gaussian --save
  python -m geotrax_tpu_torch.tools.compare_av_detections_and_tune_filters run_geo.csv \
      --probe probe.csv --tune
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.pipeline.georeference import apply_filter, compute_speed
from geotrax_tpu_torch.tools._common import pyplot

DEFAULT_FPS = 30000 / 1001
STOP_THRESHOLD_KMH = 1.0  # probe fixes slower than this are stationary noise


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def _rows(t: dict, keep) -> dict:
    """The rows ``keep`` (a mask or positions) of every column."""
    return {k: np.asarray(v)[keep] for k, v in t.items()}


def _len(t: dict) -> int:
    return len(next(iter(t.values()))) if t else 0


def _stamps(t: dict) -> np.ndarray:
    """The Timestamp column as int64 nanoseconds (parsed when it is text)."""
    col = np.asarray(t["Timestamp"])
    return col if col.dtype == np.int64 else table.to_datetime_ns(col)[0]


def _has_stamps(t: dict) -> bool:
    """A Timestamp column with no missing cell (``notna().all()``)."""
    if "Timestamp" not in t:
        return False
    col = np.asarray(t["Timestamp"])
    return col.dtype == np.int64 or not any(table._is_missing(x) for x in col.tolist())


# ---------------------------------------------------------------------------
# Probe (RTK) ingestion
# ---------------------------------------------------------------------------

def load_rtk_logs(folder: Path, local_crs: str) -> dict:
    """RTK logs (sec_nsec_lon_lat_*.txt, sec_nsec_horSpd_*.txt) as
    {Timestamp, Local_X, Local_Y[, speed_kmh]}."""
    from geotrax_tpu_torch.ops.tmerc import geo2local

    pos_files = sorted(folder.glob("sec_nsec_lon_lat_*.txt"))
    spd_files = sorted(folder.glob("sec_nsec_horSpd_*.txt"))
    if not pos_files:
        raise SystemExit(f"no sec_nsec_lon_lat_*.txt under {folder}")
    pos = np.vstack([np.loadtxt(p, ndmin=2) for p in pos_files])
    t = pos[:, 0] + pos[:, 1] * 1e-9
    x, y = geo2local(pos[:, 3], pos[:, 2], target_crs=local_crs, xp=np)
    df = {"Timestamp": table.seconds_to_ns(t), "Local_X": np.asarray(x),
          "Local_Y": np.asarray(y)}
    if spd_files:
        spd = np.vstack([np.loadtxt(p, ndmin=2) for p in spd_files])
        ts = spd[:, 0] + spd[:, 1] * 1e-9
        # each position's speed: the nearest speed fix in time
        idx = np.searchsorted(ts, t).clip(0, len(ts) - 1)
        prev = (idx - 1).clip(0)
        use_prev = np.abs(ts[prev] - t) < np.abs(ts[idx] - t)
        df["speed_kmh"] = spd[np.where(use_prev, prev, idx), 2] * 3.6
    return df


def load_probe_map(path: Path) -> dict:
    """{video: {id: int, start: iso-ts, end: iso-ts}} from YAML or JSON."""
    text = path.read_text()
    if path.suffix in (".yaml", ".yml"):
        from geotrax_tpu_torch.io import yaml_load

        return yaml_load.safe_load(text)
    return json.loads(text)


# ---------------------------------------------------------------------------
# Error model
# ---------------------------------------------------------------------------

def _two_nearest(dist: np.ndarray) -> tuple[int, int]:
    i1 = int(np.argmin(dist))
    if i1 == 0:
        return i1, 1
    if i1 == len(dist) - 1:
        return i1, len(dist) - 2
    return i1, i1 - 1 if dist[i1 - 1] < dist[i1 + 1] else i1 + 1


def trajectory_errors(probe: dict, ext: dict, stop_threshold: float) -> tuple:
    """Per probe fix (positional error in m, speed error in km/h); NaN
    where the probe stands still."""
    ex, ey = np.asarray(ext["Local_X"]), np.asarray(ext["Local_Y"])
    es = np.asarray(ext["Vehicle_Speed"]) if "Vehicle_Speed" in ext else np.full(len(ex), np.nan)
    n = _len(probe)
    pos_err = np.full(n, np.nan)
    spd_err = np.full(n, np.nan)
    has_speed = "speed_kmh" in probe
    for k, (px, py) in enumerate(zip(np.asarray(probe["Local_X"]),
                                     np.asarray(probe["Local_Y"]))):
        if has_speed and probe["speed_kmh"][k] < stop_threshold:
            continue
        d = np.hypot(ex - px, ey - py)
        i1, i2 = _two_nearest(d)
        seg = np.array([ex[i2] - ex[i1], ey[i2] - ey[i1]])
        seg_len = np.linalg.norm(seg)
        if seg_len < 1e-9:
            pos_err[k] = d[i1]
        else:  # the 2-D cross product, in np.cross's order of operations
            to_fix = (ex[i1] - px, ey[i1] - py)
            pos_err[k] = abs(seg[0] * to_fix[1] - seg[1] * to_fix[0]) / seg_len
        if has_speed:
            s1, s2 = es[i1], es[i2]
            if np.isnan(s1) and np.isnan(s2):
                continue
            if np.isnan(s1):
                interp = s2
            elif np.isnan(s2):
                interp = s1
            else:
                w1 = d[i2] / max(d[i1] + d[i2], 1e-9)
                interp = w1 * s1 + (1 - w1) * s2
            spd_err[k] = probe["speed_kmh"][k] - interp
    return pos_err, spd_err


def refine_window(probe: dict, ext: dict) -> dict:
    """The probe log clipped to the extracted pass: the fixes closest to
    the trajectory's first and last positions bound the window."""
    if _len(ext) == 0 or _len(probe) == 0:
        return probe
    stamps = _stamps(probe)

    def closest_ts(x, y):
        d = np.hypot(np.asarray(probe["Local_X"]) - x, np.asarray(probe["Local_Y"]) - y)
        return stamps[int(np.argmin(d))]

    t0 = closest_ts(ext["Local_X"][0], ext["Local_Y"][0])
    t1 = closest_ts(ext["Local_X"][-1], ext["Local_Y"][-1])
    if t1 < t0:
        t0, t1 = t1, t0
    return _rows(probe, (stamps >= t0) & (stamps <= t1))


def path_length(df: dict) -> float:
    dx = np.diff(np.asarray(df["Local_X"]))
    dy = np.diff(np.asarray(df["Local_Y"]))
    return float(np.hypot(dx, dy).sum())


# ---------------------------------------------------------------------------
# Kinematics recomputation (the sweep and the kinematics figures)
# ---------------------------------------------------------------------------

def smoothed_speed(ext: dict, param: float, filter_type: str, fps: float) -> np.ndarray:
    """Speed [km/h] from the raw Local_X/Y under one smoothing setting
    (gaussian sigma or savgol window, as cfg georef.filtering)."""
    raw = compute_speed(np.asarray(ext["Local_X"]), np.asarray(ext["Local_Y"]), fps)
    if filter_type == "gaussian":
        # fractional sigmas: apply_filter's kernel is an integer
        from geotrax_tpu_torch.ops.filters import gaussian_filter1d_np

        smooth = gaussian_filter1d_np(raw, param)
    else:
        smooth = apply_filter(raw, max(int(round(param)), 1), filter_type)
    return np.insert(smooth * 3.6, 0, np.nan)


def compute_kinematics(ext: dict, param: float, filter_type: str, fps: float) -> dict:
    """Vehicle_Speed [km/h] and Vehicle_Acceleration [m/s^2] recomputed
    from the raw Local_X/Y under one smoothing setting (the acceleration is
    the centred gradient of the smoothed speed), plus Elapsed_Time."""
    out = dict(ext)
    spd_kmh = smoothed_speed(ext, param, filter_type, fps)
    out["Vehicle_Speed"] = spd_kmh
    spd_mps = np.asarray(spd_kmh, float) / 3.6
    acc = np.full(_len(out), np.nan)
    if _len(out) > 2:
        acc[1:] = np.gradient(spd_mps[1:], 1.0 / fps)
    out["Vehicle_Acceleration"] = acc
    out["Elapsed_Time"] = elapsed_seconds(out, fps)
    return out


def elapsed_seconds(df: dict, fps: float) -> np.ndarray:
    """Seconds since the first row: from Timestamp when every row has one,
    else Frame_Number / fps."""
    if _has_stamps(df):
        ns = _stamps(df)
        return (ns - ns[0]) / 1e9
    if "Frame_Number" in df:
        f = np.asarray(df["Frame_Number"], float)
        return (f - f[0]) / fps
    return np.arange(_len(df), dtype=float) / fps


def probe_acceleration(probe: dict) -> np.ndarray:
    """Probe acceleration [m/s^2]: the time gradient of the RTK speed."""
    if "speed_kmh" not in probe or _len(probe) < 3:
        return np.full(_len(probe), np.nan)
    ns = _stamps(probe)
    secs = (ns - ns[0]) / 1e9
    if np.any(np.diff(secs) <= 0):
        return np.full(_len(probe), np.nan)
    return np.gradient(np.asarray(probe["speed_kmh"], float) / 3.6, secs)


def default_grid(filter_type: str) -> np.ndarray:
    if filter_type == "gaussian":
        return np.linspace(1, 25, 49)  # step 0.5
    return np.arange(30, 81, 3, dtype=float)  # savgol windows


# ---------------------------------------------------------------------------
# Aggregation and reports
# ---------------------------------------------------------------------------

def summarize(pairs: dict, stop_threshold: float):
    """(per-video stats, per-intersection stats, per-intersection length
    and duration) of {video: (probe window, extracted trajectory)}."""
    vstats, ierr, imeta = {}, {}, {}
    for video, (probe_f, ext) in sorted(pairs.items()):
        pos, spd = trajectory_errors(probe_f, ext, stop_threshold)
        stamps = _stamps(probe_f)
        dur = (stamps[-1] - stamps[0]) / 1e9 if len(stamps) > 1 else 0.0
        length = path_length(probe_f)
        vstats[video] = {
            "pos_mean": np.nanmean(pos), "pos_std": np.nanstd(pos),
            "spd_mean": np.nanmean(np.abs(spd)), "spd_std": np.nanstd(np.abs(spd)),
            "length": length, "duration": dur,
        }
        inter = video[0]
        ierr.setdefault(inter, ([], []))
        ierr[inter][0].append(pos)
        ierr[inter][1].append(spd)
        meta = imeta.setdefault(inter, {"length": 0.0, "duration": 0.0})
        meta["length"] += length
        meta["duration"] += dur
    istats = {}
    for inter, (pos_list, spd_list) in ierr.items():
        pos = np.concatenate(pos_list)
        spd = np.abs(np.concatenate(spd_list))
        istats[inter] = {
            "pos_mean": np.nanmean(pos), "pos_std": np.nanstd(pos),
            "spd_mean": np.nanmean(spd), "spd_std": np.nanstd(spd),
        }
    return vstats, istats, imeta


def print_stats(vstats: dict, istats: dict, imeta: dict) -> None:
    for video, s in sorted(vstats.items()):
        print(f"Video {video:<8}: position {s['pos_mean']:.3f} +/- {s['pos_std']:.3f} m, "
              f"speed {s['spd_mean']:.3f} +/- {s['spd_std']:.3f} km/h, "
              f"length {s['length']:.1f} m, duration {s['duration']:.1f} s")
    for inter, s in sorted(istats.items()):
        m = imeta[inter]
        print(f"Intersection {inter}: position {s['pos_mean']:.3f} +/- {s['pos_std']:.3f} m, "
              f"speed {s['spd_mean']:.3f} +/- {s['spd_std']:.3f} km/h, "
              f"length {m['length']:.1f} m, duration {m['duration']:.1f} s")


def save_latex(vstats: dict, istats: dict, imeta: dict, out_dir: Path) -> None:
    """The per-video and per-intersection LaTeX table rows."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "AV_errors_per_video.tex", "w") as f:
        for video, s in sorted(vstats.items()):
            f.write(f"    {video} & ${s['pos_mean']:.3f} \\pm {s['pos_std']:.3f}$ & "
                    f"${s['spd_mean']:.3f} \\pm {s['spd_std']:.3f}$ & "
                    f"{s['length']:.2f} & {s['duration']:.2f}\\\\\n")
    with open(out_dir / "AV_errors_per_intersection.tex", "w") as f:
        for inter, s in sorted(istats.items()):
            m = imeta[inter]
            f.write(f"    {inter} & ${s['pos_mean']:.3f} \\pm {s['pos_std']:.3f}$ & "
                    f"${s['spd_mean']:.3f} \\pm {s['spd_std']:.3f}$ & "
                    f"{m['length']:.2f} & {m['duration']:.2f}\\\\\n")
    print(f"LaTeX tables -> {out_dir}")


# ---------------------------------------------------------------------------
# Figures (matplotlib, host only)
# ---------------------------------------------------------------------------

def _video_grid(plt, n: int, cols: int = 4):
    cols = min(max(n, 1), cols)
    rows = (n + cols - 1) // cols
    fig, axs = plt.subplots(rows, cols, figsize=(4 * cols, 3.2 * rows), squeeze=False)
    for ax in axs.flat[n:]:
        ax.axis("off")
    return fig, axs


def _finish(plt, fig, name: str, args, out_dir: Path) -> None:
    fig.tight_layout()
    if args.save:
        out_dir.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_dir / f"AV_{name}.pdf", bbox_inches="tight")
    if args.show:
        plt.show()
    plt.close(fig)


_COORD_COLS = {
    # probe columns, extracted columns, equal aspect
    "local": (("Local_X", "Local_Y"), ("Local_X", "Local_Y"), True),
    "global": (("Longitude", "Latitude"), ("Longitude", "Latitude"), False),
    "ortho": ((None, None), ("Ortho_X", "Ortho_Y"), True),
}


def plot_trajectories(plt, pairs: dict, args, out_dir: Path) -> None:
    """Probe against extracted trajectory per video, in local metres,
    lon/lat, or orthophoto pixels (over ``--ortho-image``)."""
    (pcx, pcy), (ecx, ecy), equal = _COORD_COLS[args.coords]
    bg = None
    if args.coords == "ortho" and args.ortho_image is not None:
        from geotrax_tpu_torch.io.geoassets import load_image

        bg = load_image(args.ortho_image)
    fig, axs = _video_grid(plt, len(pairs))
    for ax, (video, (probe_f, ext)) in zip(axs.flat, sorted(pairs.items())):
        if bg is not None:
            ax.imshow(bg)
        if pcx is not None and pcx in probe_f:
            ax.plot(probe_f[pcx], probe_f[pcy], "k-", lw=1.2, label="RTK probe")
        if ecx in ext:
            ax.plot(ext[ecx], ext[ecy], "--", lw=1.2, label="extracted")
        ax.set_title(video, fontsize=9)
        if equal and bg is None:
            ax.set_aspect("equal", adjustable="datalim")
        if args.coords == "ortho" and bg is None:
            ax.invert_yaxis()  # pixel frame: y grows downward
        ax.tick_params(labelsize=7)
    axs.flat[0].legend(fontsize=7)
    _finish(plt, fig, f"trajectories_{args.coords}", args, out_dir)


def plot_trajectories_all(plt, pairs: dict, args, out_dir: Path) -> None:
    """Every extracted pass on one axes, coloured by speed, probe in black."""
    (pcx, pcy), (ecx, ecy), equal = _COORD_COLS[
        args.coords if args.coords != "ortho" else "local"]
    fig, ax = plt.subplots(figsize=(8, 7))
    last = None
    for video, (probe_f, ext) in sorted(pairs.items()):
        if pcx in probe_f:
            ax.plot(probe_f[pcx], probe_f[pcy], "k-", lw=0.8, alpha=0.7)
        if "Vehicle_Speed" in ext:
            last = ax.scatter(ext[ecx], ext[ecy], c=ext["Vehicle_Speed"], s=3, cmap="viridis")
        else:
            ax.plot(ext[ecx], ext[ecy], lw=1.0)
    if last is not None:
        fig.colorbar(last, ax=ax, label="speed (km/h)")
    if equal:
        ax.set_aspect("equal", adjustable="datalim")
    ax.set_title("all passes (probe black, extracted speed-colored)", fontsize=10)
    _finish(plt, fig, "trajectories_all", args, out_dir)


def plot_kinematics(plt, pairs: dict, args, out_dir: Path, variable: str) -> None:
    """Speed or acceleration against elapsed time per video, probe in
    black, with y-limits shared across the panels."""
    ext_col = "Vehicle_Speed" if variable == "speed" else "Vehicle_Acceleration"
    unit = "km/h" if variable == "speed" else "m/s$^2$"
    fig, axs = _video_grid(plt, len(pairs))
    lo, hi = np.inf, -np.inf
    drawn = []
    for ax, (video, (probe_f, ext)) in zip(axs.flat, sorted(pairs.items())):
        pt = elapsed_seconds(probe_f, args.fps)
        et = (np.asarray(ext["Elapsed_Time"]) if "Elapsed_Time" in ext
              else elapsed_seconds(ext, args.fps))
        pv = (np.asarray(probe_f["speed_kmh"], float)
              if variable == "speed" and "speed_kmh" in probe_f
              else probe_acceleration(probe_f) if variable == "acceleration"
              else np.full(_len(probe_f), np.nan))
        ev = (np.asarray(ext[ext_col], float) if ext_col in ext
              else np.full(_len(ext), np.nan))
        if len(pt):  # the extracted trace clipped to the probe window
            keep = et <= pt[-1] + 1.0
            et, ev = et[keep], ev[keep]
        ax.plot(pt, pv, "k-", lw=1.0, label="RTK probe")
        ax.scatter(pt, pv, color="k", s=2)
        ax.plot(et, ev, lw=1.0, alpha=0.85, label="extracted")
        ax.scatter(et, ev, s=2, alpha=0.85)
        ax.set_title(video, fontsize=9)
        ax.set_xlabel("elapsed time (s)", fontsize=8)
        ax.set_ylabel(f"{variable} ({unit})", fontsize=8)
        ax.tick_params(labelsize=7)
        for v in (pv, ev):
            v = v[np.isfinite(v)]
            if v.size:
                lo, hi = min(lo, v.min()), max(hi, v.max())
        drawn.append(ax)
    if np.isfinite(lo) and np.isfinite(hi):
        step = 5.0 if variable == "speed" else 1.0
        lo = step * np.floor(lo / step)
        hi = step * np.ceil(hi / step)
        for ax in drawn:
            ax.set_ylim(lo, hi)
    if drawn:
        drawn[0].legend(fontsize=7)
    _finish(plt, fig, f"{variable}_comparison", args, out_dir)


def plot_error_summary(plt, vstats: dict, args, out_dir: Path) -> None:
    """Per-video mean +/- std positional and speed errors."""
    videos = sorted(vstats)
    xs = np.arange(len(videos))
    fig, (a0, a1) = plt.subplots(1, 2, figsize=(max(8, 1.2 * len(videos)), 4))
    a0.errorbar(xs, [vstats[v]["pos_mean"] for v in videos],
                yerr=[vstats[v]["pos_std"] for v in videos], fmt="o", capsize=3)
    a0.set_ylabel("positional error (m)")
    a1.errorbar(xs, [vstats[v]["spd_mean"] for v in videos],
                yerr=[vstats[v]["spd_std"] for v in videos], fmt="o", capsize=3)
    a1.set_ylabel("|speed error| (km/h)")
    for ax in (a0, a1):
        ax.set_xticks(xs)
        ax.set_xticklabels(videos, rotation=45, ha="right", fontsize=7)
        ax.grid(alpha=0.3)
    _finish(plt, fig, "positional_and_speed_errors", args, out_dir)


def plot_sweep(plt, sweep: dict, args, out_dir: Path) -> None:
    """One panel per intersection, both best settings marked."""
    fig, axs = _video_grid(plt, len(sweep), cols=3)
    for ax, (inter, (grid, means, stds)) in zip(axs.flat, sorted(sweep.items())):
        ax.plot(grid, means, label="mean |err|")
        ax.plot(grid, stds, "--", alpha=0.7, label="std")
        i_m = int(np.nanargmin(means))
        i_s = int(np.nanargmin(stds))
        ax.axvline(grid[i_m], color="C0", ls=":", alpha=0.8)
        ax.axvline(grid[i_s], color="C1", ls=":", alpha=0.8)
        ax.set_title(f"intersection {inter} "
                     f"(best mean {grid[i_m]:g}, best std {grid[i_s]:g})", fontsize=8)
        ax.set_xlabel("smoothing parameter", fontsize=8)
        ax.set_ylabel("speed error (km/h)", fontsize=8)
        ax.tick_params(labelsize=7)
    axs.flat[0].legend(fontsize=7)
    _finish(plt, fig, "speed_error_sweep", args, out_dir)


def plot_sampling_diff(plt, pairs: dict, args, out_dir: Path) -> None:
    """(--debug) Successive timestamp differences of the probe logs and the
    extracted CSVs, with mean and std guides."""
    fig, (a0, a1) = plt.subplots(1, 2, figsize=(13, 5))
    probe_d = [np.diff(_stamps(p)) / 1e9 for p, _ in pairs.values() if "Timestamp" in p]
    ext_d = [np.diff(_stamps(e)) / 1e9 for _, e in pairs.values() if _has_stamps(e)]
    for ax, series, title in ((a0, probe_d, "probe"), (a1, ext_d, "extracted")):
        if not series:
            ax.set_title(f"{title}: no timestamps")
            continue
        cat = np.concatenate(series)
        ax.plot(cat, color="black", lw=0.7)
        m, s = cat.mean(), cat.std(ddof=1)
        ax.axhline(m, color="r", ls="--", label=f"mean {m:.3f}")
        ax.axhline(m + s, color="g", ls="--", label=f"+/- std {s:.3f}")
        ax.axhline(m - s, color="g", ls="--")
        ax.set_xlabel("sample")
        ax.set_ylabel("time difference (s)")
        ax.set_title(f"sampling differences: {title}")
        ax.legend(fontsize=7)
    _finish(plt, fig, "sampling_diff", args, out_dir)


def save_plots(pairs: dict, vstats: dict, sweep: dict | None, args, out_dir: Path) -> None:
    """Every figure: per-video trajectories, all passes, speed and
    acceleration traces, the error summary, the sweep panels and (--debug)
    the sampling differences."""
    plt = pyplot("Plots", show=args.show)
    if plt is None:
        return
    plot_trajectories(plt, pairs, args, out_dir)
    plot_trajectories_all(plt, pairs, args, out_dir)
    plot_kinematics(plt, pairs, args, out_dir, "speed")
    plot_kinematics(plt, pairs, args, out_dir, "acceleration")
    plot_error_summary(plt, vstats, args, out_dir)
    if sweep:
        plot_sweep(plt, sweep, args, out_dir)
    if args.debug:
        plot_sampling_diff(plt, pairs, args, out_dir)
    if args.save:
        print(f"Plots -> {out_dir}")


# ---------------------------------------------------------------------------
# Sweep
# ---------------------------------------------------------------------------

def tune(pairs: dict, filter_type: str, grid: np.ndarray, fps: float, stop_threshold: float):
    """For each smoothing setting: speeds recomputed from the raw positions,
    speed errors aggregated per intersection; the best setting under both
    criteria is printed."""
    sweep = {}  # inter -> (grid, mean_abs, std)
    imeta = {}
    by_inter: dict[str, list[str]] = {}
    for video in pairs:
        by_inter.setdefault(video[0], []).append(video)
    for inter, videos in sorted(by_inter.items()):
        means, stds = [], []
        for param in grid:
            errs = []
            for video in videos:
                probe_f, ext = pairs[video]
                ext2 = {**ext, "Vehicle_Speed": smoothed_speed(ext, param, filter_type, fps)}
                _, spd = trajectory_errors(probe_f, ext2, stop_threshold)
                errs.append(spd)
            err = np.abs(np.concatenate(errs))
            means.append(np.nanmean(err))
            stds.append(np.nanstd(err))
        sweep[inter] = (grid, np.asarray(means), np.asarray(stds))
        imeta[inter] = sum(path_length(pairs[v][0]) for v in videos)

    for crit, idx_fn in (("mean |speed error|", lambda m, s: int(np.nanargmin(m))),
                         ("speed error std", lambda m, s: int(np.nanargmin(s)))):
        print(f"\nBest smoothing ({filter_type}) by lowest {crit}:")
        best_sum = best_weighted = weight_sum = 0.0
        for inter, (g, means, stds) in sorted(sweep.items()):
            i = idx_fn(means, stds)
            print(f"  intersection {inter}: param {g[i]:g} "
                  f"-> {means[i]:.3f} +/- {stds[i]:.3f} km/h")
            best_sum += g[i]
            best_weighted += g[i] * imeta[inter]
            weight_sum += imeta[inter]
        print(f"  average best param: {best_sum / len(sweep):.2f}; "
              f"length-weighted: {best_weighted / max(weight_sum, 1e-9):.2f}")
    return sweep


# ---------------------------------------------------------------------------
# Input assembly
# ---------------------------------------------------------------------------

def pairs_from_dataset(args) -> dict:
    """{video: (refined probe window, extracted trajectory)} of a data tree
    and a probe map."""
    if args.probe_map is None:
        raise SystemExit("dataset mode needs --probe-map (video -> {id,start,end})")
    probe_map = load_probe_map(args.probe_map)
    probe = load_rtk_logs(args.data / "av_trajectories", args.local_crs)
    stamps = probe["Timestamp"]
    results = args.data / args.results_folder
    pairs = {}
    for video, spec in probe_map.items():
        csv = next(iter(sorted(results.glob(f"{video}*.csv"))), None)
        if csv is None:
            print(f"warning: no pipeline CSV for '{video}' under {results}")
            continue
        df = table.read_csv(csv)
        keep = np.asarray(df["Vehicle_ID"]) == int(spec["id"])
        if "Visibility" in df:
            keep &= np.asarray(df["Visibility"]) == 1
        ext = _rows(df, keep)
        if _len(ext) < 2:
            print(f"warning: vehicle {spec['id']} absent/short in {csv.name}")
            continue
        start, end = (table.to_datetime_ns(np.array([str(spec[k])], dtype=object))[0][0]
                      for k in ("start", "end"))
        window = _rows(probe, (stamps >= start) & (stamps <= end))
        pairs[video] = (refine_window(window, ext), ext)
    if not pairs:
        raise SystemExit("no usable (probe, extraction) pairs")
    return pairs


def pairs_from_single_csv(args) -> dict:
    """Simple mode: the probe matched to the pipeline vehicle with the
    lowest mean frame-aligned position error."""
    if args.probe is None:
        raise SystemExit("single-CSV mode needs --probe probe.csv (frame,x,y[,speed_kmh])")
    pipeline = table.read_csv(args.data)
    probe = {{"x": "Local_X", "y": "Local_Y"}.get(k, k): v
             for k, v in table.read_csv(args.probe).items()}
    if "Timestamp" not in probe:
        probe["Timestamp"] = table.seconds_to_ns(np.asarray(probe["frame"]) / args.fps)
    best_id, best_err, best_n = None, np.inf, 0
    ids = np.asarray(pipeline["Vehicle_ID"])
    for vid in np.unique(ids):
        grp = _rows(pipeline, ids == vid)
        joined = table.merge_inner(grp, probe, "Frame_Number", "frame", suffixes=("", "_gt"))
        if _len(joined) < 10:
            continue
        err = np.hypot(joined["Local_X"] - joined["Local_X_gt"],
                       joined["Local_Y"] - joined["Local_Y_gt"]).mean()
        if err < best_err:
            best_id, best_err, best_n = vid, err, _len(joined)
    if best_id is None:
        raise SystemExit("no pipeline vehicle overlaps the probe log")
    print(f"Probe matched to Vehicle_ID {best_id}: mean aligned position error "
          f"{best_err:.3f} m over {best_n} frames")
    ext = _rows(pipeline, ids == best_id)
    video = args.data.stem.split(".")[0] or "V"
    return {video: (refine_window(probe, ext), ext)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("data", type=Path,
                        help="Dataset directory (with av_trajectories/ + results) "
                             "or a single georeferenced pipeline CSV")
    parser.add_argument("--probe", type=Path, default=None,
                        help="[single-CSV mode] probe CSV: frame,x,y[,speed_kmh]")
    parser.add_argument("--probe-map", type=Path, default=None,
                        help="[dataset mode] YAML/JSON {video: {id,start,end}}")
    parser.add_argument("--results-folder", default="results",
                        help="Subfolder with the pipeline CSVs (default: results)")
    parser.add_argument("--local-crs", default="epsg:5186",
                        help="Projected CRS for RTK lon/lat -> local metres")
    parser.add_argument("--fps", type=float, default=DEFAULT_FPS)
    parser.add_argument("--tune", "-t", action="store_true",
                        help="Sweep the smoothing grid instead of the default setting only")
    parser.add_argument("--filter", "-f", choices=("gaussian", "savgol"), default="gaussian")
    parser.add_argument("--grid", type=float, nargs="+", default=None,
                        help="Override the sweep grid (default: 1..25/0.5 gaussian "
                             "or 30..80/3 savgol)")
    parser.add_argument("--stop-threshold", type=float, default=STOP_THRESHOLD_KMH,
                        help="Probe fixes below this speed [km/h] are excluded")
    parser.add_argument("--save", action="store_true",
                        help="Write LaTeX tables + PDF plots next to the results")
    parser.add_argument("--show", action="store_true", help="Display plots interactively")
    parser.add_argument("--coords", choices=("local", "global", "ortho"), default="local",
                        help="Trajectory plot frame: local metres, global lon/lat, "
                             "or orthophoto pixels")
    parser.add_argument("--ortho-image", type=Path, default=None,
                        help="[--coords ortho] orthophoto PNG drawn under the pixel "
                             "trajectories")
    parser.add_argument("--smooth", type=float, default=None,
                        help="Recompute extracted speed+acceleration from raw "
                             "positions with this smoothing parameter before "
                             "the analysis (e.g. the tuned sigma)")
    parser.add_argument("--debug", "-d", action="store_true",
                        help="Extra diagnostics: sampling-difference plots")
    parser.add_argument("--out", type=Path, default=None,
                        help="Output folder for --save (default: <data>/plots)")
    parser.add_argument("--cfg", "-c", type=Path, default=None,
                        help="Pipeline config: resolves the results subfolder "
                             "name from output.folder; --results-folder overrides")
    parser.add_argument("--log-path", "-lp", type=Path, default=None,
                        help="Log file or directory (default: platform log dir)")
    parser.add_argument("--quiet", "-q", action="store_true",
                        help="Console shows NOTICE-and-up only")
    args = parser.parse_args(argv)

    import logging

    from geotrax_tpu_torch.utils.logging_utils import NOTICE_LEVEL, setup_logger

    logger = setup_logger("compare_av_detections_and_tune_filters", verbose=False,
                          log_path=args.log_path)
    if args.quiet:
        for h in logger.handlers:
            if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler):
                h.setLevel(NOTICE_LEVEL)

    if args.cfg is not None and args.results_folder == "results":
        # the config's output.folder names the per-video results subfolder
        from geotrax_tpu_torch.io import yaml_load
        from geotrax_tpu_torch.utils.config_utils import resolve_config_path

        cfg = yaml_load.safe_load(Path(resolve_config_path(args.cfg)).read_text())
        args.results_folder = (cfg.get("output", {}) or {}).get("folder", "results")

    pairs = (pairs_from_dataset(args) if args.data.is_dir()
             else pairs_from_single_csv(args))

    if args.smooth is not None:
        pairs = {v: (p, compute_kinematics(e, args.smooth, args.filter, args.fps))
                 for v, (p, e) in pairs.items()}

    vstats, istats, imeta = summarize(pairs, args.stop_threshold)
    print_stats(vstats, istats, imeta)

    sweep = None
    if args.tune:
        grid = np.asarray(args.grid, float) if args.grid else default_grid(args.filter)
        sweep = tune(pairs, args.filter, grid, args.fps, args.stop_threshold)

    out = args.out or ((args.data if args.data.is_dir() else args.data.parent) / "plots")
    if args.save:
        save_latex(vstats, istats, imeta, out)
    if args.save or args.show:
        save_plots(pairs, vstats, sweep, args, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
