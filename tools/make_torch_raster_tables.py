"""Derive the glyph and circle tables of the PyTorch port's rasterizer from cv2.

OpenCV 5 draws ``FONT_HERSHEY_SIMPLEX`` with a built-in TrueType face, not
with Hershey strokes. The visualize stage writes labels with that font at
``fontScale = line_width / 3`` and ``thickness = max(line_width - 1, 1)``
under ``LINE_AA``. For each line width 1..6 and each printable ASCII
character this script renders the character alone with ``cv2.putText``
(white on black) and keeps:

- its coverage bitmap (the rendered grey level, cropped to its ink) and the
  bitmap's offset from the text origin;
- its advance: ``cv2.getTextSize`` of a string is one plus the sum of its
  characters' advances, where an advance is the width of the character
  alone less one (checked here on random strings);
- the text height, which ``getTextSize`` gives whatever the characters.

It then checks that compositing the bitmaps (``dst * (1 - a) + color * a``,
rounded) reproduces ``cv2.putText`` of random strings within one grey
level. It also keeps the pixel mask of ``cv2.circle`` (``LINE_8``) for
radii 0..CIRCLE_RADII-1 and thicknesses 1..6 about an integer centre (the
stage's track tails and trajectory overlay; a mask does not depend on where
the centre lies, which is checked), and writes
``geotrax_tpu_torch/ops/raster_tables.npz``. Last it prints the mean
coverage cv2 gives a ``LINE_AA`` stroke's pixels by their distance beyond
the stroke's edge, on random oblique and axis-aligned segments of
thickness 2 to 6: the source of ``ops/draw.py``'s ``OBLIQUE_PROFILE``
(kept in the code, not in the table), and the check of its hand-fitted
``AXIS_PROFILE`` on a side's whole-pixel distances.

    python tools/make_torch_raster_tables.py [--out PATH] [--checks N]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

LINE_WIDTHS = range(1, 7)
CIRCLE_RADII = 16
CHARS = [chr(c) for c in range(32, 127)]
DEFAULT_OUT = Path(__file__).resolve().parent.parent / "geotrax_tpu_torch" / "ops" / "raster_tables.npz"


def font_args(line_width: int) -> tuple:
    return line_width / 3, max(line_width - 1, 1)


def glyph(cv2, char: str, line_width: int) -> tuple:
    """(dx, dy, bitmap) of ``char`` drawn alone: the bitmap's top-left corner
    lies at (org.x + dx, org.y + dy)."""
    scale, thickness = font_args(line_width)
    size = 40 * line_width
    ox, oy = size // 2, size // 2
    canvas = np.zeros((size, size, 3), np.uint8)
    cv2.putText(canvas, char, (ox, oy), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255),
                thickness, cv2.LINE_AA)
    if not (np.array_equal(canvas[..., 0], canvas[..., 1])
            and np.array_equal(canvas[..., 0], canvas[..., 2])):
        raise AssertionError(f"{char!r}: channels differ")
    alpha = canvas[..., 0]
    ys, xs = np.nonzero(alpha)
    if len(ys) == 0:
        return 0, 0, np.zeros((0, 0), np.uint8)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    if min(y0, x0) == 0 or y1 == size or x1 == size:
        raise AssertionError(f"{char!r} at line width {line_width} touches the canvas edge")
    return int(x0 - ox), int(y0 - oy), alpha[y0:y1, x0:x1].copy()


def composite(img, text, org, color, table) -> np.ndarray:
    """The port's putText on a copy of ``img`` (the check's own copy of
    ops/draw.py's algorithm, so the table is checked before it is used)."""
    out = img.astype(np.float32)
    x = org[0]
    for ch in text:
        dx, dy, bm = table["glyphs"][ch]
        if bm.size:
            h, w = bm.shape
            a = bm.astype(np.float32)[..., None] / 255
            sub = out[org[1] + dy:org[1] + dy + h, x + dx:x + dx + w]
            sub[:] = sub * (1 - a) + np.asarray(color, np.float32) * a
        x += table["advance"][ch]
    return np.rint(out).astype(np.uint8)


def stroke_profile(cv2, rng, axis_aligned: bool, lines: int = 300) -> list:
    """(distance beyond the edge, mean cv2 coverage) at the profile's knots,
    over random ``LINE_AA`` segments of thickness 2 to 6 (half width
    ``t / 2``, one more half pixel for an odd ``t``, as cv2 fills them),
    either axis-aligned or at any other angle."""
    knots = np.arange(0.0, 1.51, 0.25)
    sums, counts = np.zeros(len(knots)), np.zeros(len(knots))
    yy, xx = np.mgrid[0:100, 0:100].astype(np.float64)
    for _ in range(lines):
        t = int(rng.integers(2, 7))
        half = t / 2 + 0.5 * (t % 2)
        a, b = rng.integers(20, 80, 2).astype(float), rng.integers(20, 80, 2).astype(float)
        if axis_aligned:  # the same y (horizontal) or the same x (vertical)
            k = int(rng.integers(0, 2))
            b[k] = a[k]
        elif a[0] == b[0] or a[1] == b[1]:
            continue
        img = np.zeros((100, 100), np.uint8)
        cv2.line(img, tuple(int(v) for v in a), tuple(int(v) for v in b), 255, t, cv2.LINE_AA)
        d = b - a
        u = np.clip(((xx - a[0]) * d[0] + (yy - a[1]) * d[1]) / max(d @ d, 1e-9), 0, 1)
        beyond = np.hypot(xx - a[0] - u * d[0], yy - a[1] - u * d[1]) - half
        near = np.abs(beyond[..., None] - knots) < 0.125
        sums += (near * (img[..., None] / 255.0)).sum((0, 1))
        counts += near.sum((0, 1))
    return list(zip(knots.tolist(), (sums / np.maximum(counts, 1)).round(3).tolist()))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT, help="Output .npz path.")
    parser.add_argument("--checks", type=int, default=200,
                        help="Random strings checked per line width.")
    args = parser.parse_args(argv)
    import cv2

    rng = np.random.default_rng(0)
    arrays = {"cv2_version": np.array(cv2.__version__)}
    for lw in LINE_WIDTHS:
        scale, thickness = font_args(lw)
        sizes = [cv2.getTextSize(c, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)[0] for c in CHARS]
        heights = {h for _, h in sizes}
        if len(heights) != 1:
            raise AssertionError(f"line width {lw}: text heights {heights}")
        table = {"advance": {c: w - 1 for c, (w, _) in zip(CHARS, sizes)},
                 "glyphs": {c: glyph(cv2, c, lw) for c in CHARS}}
        worst = 0
        for _ in range(args.checks):
            text = "".join(rng.choice(CHARS, int(rng.integers(1, 30))))
            (w, h), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
            if (w, h) != (1 + sum(table["advance"][c] for c in text), heights.copy().pop()):
                raise AssertionError(f"line width {lw}: getTextSize({text!r}) = {(w, h)}")
            bg = rng.integers(0, 256, (20 * lw, w + 20 * lw, 3)).astype(np.uint8)
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            org = (10 * lw, 14 * lw)
            ref = bg.copy()
            cv2.putText(ref, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness,
                        cv2.LINE_AA)
            mine = composite(bg, text, org, color, table)
            worst = max(worst, int(np.abs(mine.astype(int) - ref.astype(int)).max()))
        if worst > 1:
            raise AssertionError(f"line width {lw}: composite differs from cv2 by {worst}")
        boxes, flat = [], []
        offset = 0
        for c in CHARS:
            dx, dy, bm = table["glyphs"][c]
            boxes.append((dx, dy, bm.shape[0], bm.shape[1], offset))
            flat.append(bm.ravel())
            offset += bm.size
        arrays[f"advance_{lw}"] = np.array([table["advance"][c] for c in CHARS], np.int16)
        arrays[f"boxes_{lw}"] = np.array(boxes, np.int32)
        arrays[f"alpha_{lw}"] = np.concatenate(flat).astype(np.uint8)
        arrays[f"height_{lw}"] = np.array(heights.pop(), np.int16)
        print(f"line width {lw}: {len(CHARS)} glyphs, {offset} coverage bytes, "
              f"composite within {worst} grey level(s) of cv2 on {args.checks} strings")
    for thickness in LINE_WIDTHS:
        masks = []
        for r in range(CIRCLE_RADII):
            reach = r + thickness + 2
            seen = []
            for cx, cy in ((3 * reach, 3 * reach), (3 * reach + 1, 3 * reach + 4)):
                canvas = np.zeros((6 * reach, 6 * reach), np.uint8)
                cv2.circle(canvas, (cx, cy), r, 255, thickness)
                seen.append(canvas[cy - reach:cy + reach + 1, cx - reach:cx + reach + 1] > 0)
                if canvas.sum() != seen[-1].sum() * 255:
                    raise AssertionError(f"circle r={r} t={thickness} reaches past {reach}")
            if not np.array_equal(*seen):
                raise AssertionError(f"circle r={r} t={thickness} depends on its centre")
            ys, xs = np.nonzero(seen[0])
            masks.append(np.stack([xs - reach, ys - reach], 1))
        arrays[f"circle_counts_{thickness}"] = np.array([len(m) for m in masks], np.int32)
        arrays[f"circle_offsets_{thickness}"] = np.concatenate(masks).astype(np.int16)
    print(f"circle masks for radii 0..{CIRCLE_RADII - 1}, thicknesses {list(LINE_WIDTHS)}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")
    for axis_aligned in (False, True):
        print(f"LINE_AA coverage by distance beyond the edge [px], "
              f"{'axis-aligned' if axis_aligned else 'oblique'} segments:",
              stroke_profile(cv2, rng, axis_aligned))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
