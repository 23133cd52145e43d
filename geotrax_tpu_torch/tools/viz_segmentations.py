"""Lane and section polygons of the segmentation CSVs over their
orthophotos: the port of ``tools/viz_segmentations.py``.

For each orthophoto ``<loc>.png`` with a ``<loc>.csv`` (10 columns: section,
lane, 4 corner points) the lane quads are filled on a copy, outlined
(2 px) and labelled ``section/lane`` on the image, and the two are blended
35/65: the overlay the plotting stage uses as a background
(``plotting.use_segmentations``). Drawing is cv2's default ``LINE_8``
through ``ops/draw.py`` (``fill_poly`` and ``polylines_8``: cv2's pixels for
quads inside the image; the label in cv2's font at 0.6 / 2), colours from
``PlotColors`` applied in the reference's channel order; images through
``io/geoassets.py``, the CSV through ``io/table.py``.

Usage:
  python -m geotrax_tpu_torch.tools.viz_segmentations ORTHO_FOLDER [-sf SEG_FOLDER] [-o OUT]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.ops import draw
from geotrax_tpu_torch.utils.data_utils import PlotColors

SEGMENTATION_COLUMNS = 10


def _row_values(columns: list, i: int) -> list:
    """Row ``i`` as ``DataFrame.iterrows`` gives it: all-numeric columns
    become floats when one of them is (pandas' common dtype); else each
    cell keeps its column's type."""
    cells = [np.asarray(c)[i] for c in columns]
    kinds = {np.asarray(c).dtype.kind for c in columns}
    if kinds <= {"i", "u", "f"} and "f" in kinds:
        return [np.float64(v) for v in cells]
    return cells


def overlay(ortho: np.ndarray, seg: dict) -> np.ndarray:
    out = ortho.copy()
    colors = PlotColors()
    layer = out.copy()
    columns = list(seg.values())[:SEGMENTATION_COLUMNS]
    n = len(columns[0]) if columns else 0
    for i in range(n):
        row = _row_values(columns, i)
        quad = np.array([[row[2], row[3]], [row[4], row[5]],
                         [row[6], row[7]], [row[8], row[9]]], np.int32)
        hex_color = colors(int(row[1]) if str(row[1]).isdigit() else i)
        bgr = tuple(int(hex_color[j:j + 2], 16) for j in (5, 3, 1))
        draw.fill_poly(layer, quad, bgr)
        draw.polylines_8(out, quad, True, bgr, 2)
        center = quad.mean(axis=0).astype(int)
        draw.put_text(out, f"{row[0]}/{row[1]}", tuple(center), "seg", (255, 255, 255))
    return draw.add_weighted(layer, 0.35, out, 0.65, 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ortho_folder", type=Path)
    parser.add_argument("--segmentation-folder", "-sf", type=Path, default=None)
    parser.add_argument("--out", "-o", type=Path, default=None,
                        help="Output folder (default: the segmentation folder)")
    args = parser.parse_args(argv)

    seg_folder = args.segmentation_folder or args.ortho_folder / "segmentations"
    out_folder = args.out or seg_folder
    out_folder.mkdir(parents=True, exist_ok=True)

    from geotrax_tpu_torch.io.geoassets import load_image, save_image

    count = 0
    for csv_path in sorted(Path(seg_folder).glob("*.csv")):
        ortho_path = args.ortho_folder / f"{csv_path.stem}.png"
        if not ortho_path.exists():
            print(f"skip {csv_path.stem}: no orthophoto")
            continue
        seg = dict(list(table.read_csv(csv_path).items())[:SEGMENTATION_COLUMNS])
        img = overlay(load_image(ortho_path), seg)
        save_image(out_folder / f"{csv_path.stem}.png", img)
        lanes = len(next(iter(seg.values()))) if seg else 0
        print(f"{csv_path.stem}: {lanes} lanes -> {out_folder / (csv_path.stem + '.png')}")
        count += 1
    if not count:
        print("No segmentation CSVs found.")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
