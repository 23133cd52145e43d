"""Per-image annotation counts of a YOLO label folder: the port of
``tools/find_max_annotations.py``.

Reports the number of label files, the largest and the mean count and the
most-annotated files, and exposes ``find_max_annotations()`` for
``viz_annotations``.

Usage:
  python -m geotrax_tpu_torch.tools.find_max_annotations LABELS_DIR [--top 10]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from geotrax_tpu_torch.tools._common import load_yolo_labels


def find_max_annotations(labels_dir: Path, top_n: int | None = None,
                         types: list | None = None) -> list:
    """[(count, label_path)] sorted by count, largest first (a stable
    sort); ``types`` counts only those class ids, ``top_n`` truncates."""
    counts = []
    for p in sorted(Path(labels_dir).rglob("*.txt")):
        labels = load_yolo_labels(p)
        if types is not None and len(labels):
            labels = labels[[int(c) in set(types) for c in labels[:, 0]]]
        counts.append((len(labels), p))
    counts.sort(key=lambda t: -t[0])
    return counts[:top_n] if top_n else counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("labels", type=Path)
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args(argv)

    counts = find_max_annotations(args.labels)
    if not counts:
        print("No label files found.")
        return 1
    values = [c for c, _ in counts]
    print(f"{len(values)} label files; max {values[0]}, mean {sum(values) / len(values):.1f}")
    for count, path in counts[: args.top]:
        print(f"  {count:>5}  {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
