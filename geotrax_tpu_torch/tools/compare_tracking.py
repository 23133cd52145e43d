"""Compare tracking results across trackers or runs: the port of
``tools/compare_tracking.py``.

For two or more result folders of ``<stem>.txt`` track files: each run's
trajectory-length distribution, missing-frame gaps, track and class counts,
and the symmetric KL divergence between the runs' length and gap
distributions; ``--plot`` writes a histogram PDF (matplotlib, when it is
installed; else one line says it was skipped).

Usage:
  python -m geotrax_tpu_torch.tools.compare_tracking runA/results runB/results [--plot out.pdf]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.tools._common import pyplot


def track_stats(folder: Path) -> dict:
    lengths, gaps, vehicles = [], [], 0
    classes: dict[int, int] = {}
    per_video: dict[str, dict] = {}
    for txt in sorted(Path(folder).glob("*.txt")):
        if "transf" in txt.stem:
            continue
        data = np.loadtxt(txt, delimiter=",")
        if data.ndim != 2 or data.shape[1] < 7:
            continue
        v_lengths = []
        for tid in np.unique(data[:, 1]):
            rows = data[data[:, 1] == tid]
            frames = np.sort(rows[:, 0].astype(int))
            lengths.append(len(frames))
            v_lengths.append(len(frames))
            gaps.extend((np.diff(frames) - 1)[np.diff(frames) > 1].tolist())
            vehicles += 1
            # the track's class: column -4 in the 14/15-column layouts, -2 in the 8-column
            cls_col = -4 if rows.shape[1] >= 12 else -2
            c = int(rows[0, cls_col])
            classes[c] = classes.get(c, 0) + 1
        per_video[txt.stem] = {
            "tracks": len(v_lengths),
            "mean_len": float(np.mean(v_lengths)) if v_lengths else 0.0,
        }
    return {"lengths": np.asarray(lengths), "gaps": np.asarray(gaps),
            "vehicles": vehicles, "classes": classes, "per_video": per_video}


def kl_divergence(a: np.ndarray, b: np.ndarray, bins: int = 30) -> float:
    """Symmetric KL between two samples over a shared histogram."""
    lo = min(a.min(initial=0), b.min(initial=0))
    hi = max(a.max(initial=1), b.max(initial=1))
    pa, edges = np.histogram(a, bins=bins, range=(lo, hi), density=False)
    pb, _ = np.histogram(b, bins=edges, density=False)
    pa = (pa + 1e-9) / (pa.sum() + 1e-9 * bins)
    pb = (pb + 1e-9) / (pb.sum() + 1e-9 * bins)
    return float(0.5 * (np.sum(pa * np.log(pa / pb)) + np.sum(pb * np.log(pb / pa))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("folders", nargs="+", type=Path, help="Result folders to compare")
    parser.add_argument("--plot", type=Path, default=None, help="Write a comparison PDF")
    args = parser.parse_args(argv)

    stats = {f: track_stats(f) for f in args.folders}
    for folder, s in stats.items():
        lens = s["lengths"]
        if not len(lens):
            print(f"{folder}: no tracks found")
            continue
        print(
            f"{folder}: {s['vehicles']} tracks | length mean {lens.mean():.1f} "
            f"median {np.median(lens):.0f} p10 {np.percentile(lens, 10):.0f} "
            f"p90 {np.percentile(lens, 90):.0f} | gaps {len(s['gaps'])} "
            f"(max {s['gaps'].max() if len(s['gaps']) else 0})"
        )

    for folder, s_ in stats.items():
        if s_["per_video"]:
            for stem, pv in sorted(s_["per_video"].items()):
                print(f"  {folder.name}/{stem}: {pv['tracks']} tracks, "
                      f"mean length {pv['mean_len']:.1f}")
        if s_["classes"]:
            dist = ", ".join(f"{c}: {n}" for c, n in sorted(s_["classes"].items()))
            print(f"  {folder.name} class distribution: {dist}")

    # pairwise KL of both metrics: trajectory lengths and missing-frame gaps
    folders = [f for f in args.folders if len(stats[f]["lengths"])]
    for metric in ("lengths", "gaps"):
        for i in range(len(folders)):
            for j in range(i + 1, len(folders)):
                a, b = stats[folders[i]][metric], stats[folders[j]][metric]
                if not (len(a) and len(b)):
                    continue
                kl = kl_divergence(a, b)
                print(f"KL[{metric}]({folders[i].name} || {folders[j].name}) = {kl:.4f}")

    if args.plot and folders:
        plt = pyplot("Plot")
        if plt is not None:
            fig, ax = plt.subplots(figsize=(8, 5))
            for f in folders:
                ax.hist(stats[f]["lengths"], bins=30, alpha=0.5, label=str(f.parent.name or f))
            ax.set_xlabel("Trajectory length [frames]")
            ax.set_ylabel("Tracks")
            ax.legend()
            fig.savefig(args.plot, bbox_inches="tight")
            print(f"Plot written to {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
