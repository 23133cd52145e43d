"""The port's rasterizer: the drawing primitives of the visualize stage, in
numpy on the host, on (H,W,3) uint8 images in place (as cv2 draws).

The card's machine has no cv2. These are the primitives the reference's
stage calls, each computed over the bounding box of its shape with array
operations (no Python loop over pixels):

- ``line`` / ``polylines`` / ``rectangle`` outlines: anti-aliased strokes
  (cv2's ``LINE_AA``) as capsules of cv2's half width (``thickness / 2``,
  one more half pixel for an odd thickness above 1, 0 for 1), each pixel
  blended into the image by the coverage OpenCV 5 gives, on average, a
  pixel that far beyond the stroke's edge (``OBLIQUE_PROFILE``, or
  ``AXIS_PROFILE`` for horizontal and vertical strokes; measured by
  ``tools/make_torch_raster_tables.py``);
- ``rectangle`` with ``thickness < 0``: the filled box, both corners
  included, with the profile's one-pixel fringe outside;
- ``circles``: cv2's ``LINE_8`` rings of ``thickness``, many at once, from
  masks taken from cv2 for radii below 16 and thicknesses 1 to 6 (a ring of
  ``|distance - radius| <= thickness / 2`` outside them);
- ``add_weighted``: ``saturate(round(a * alpha + b * beta + gamma))``;
- ``text_size`` / ``put_text``: cv2's ``FONT_HERSHEY_SIMPLEX`` at
  ``fontScale = line_width / 3`` and ``thickness = max(line_width - 1, 1)``
  under ``LINE_AA``. OpenCV 5 draws that font from a built-in TrueType face;
  ``raster_tables.npz`` holds its coverage bitmaps and advances for line
  widths 1 to 6 (and the circle masks), derived from cv2 by
  ``tools/make_torch_raster_tables.py``. Sizes
  there equal cv2's ``getTextSize``; drawn text is within one grey level of
  cv2's. Other line widths scale the width-6 table (an approximation), and a
  character outside printable ASCII is drawn as ``?``.

Strokes and rings are not cv2's bit for bit (cv2 fills polygons in fixed
point); tests/test_torch_draw.py states how far they are.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

TABLES = Path(__file__).resolve().parent / "raster_tables.npz"
TABLE_WIDTHS = range(1, 7)
FIRST_CHAR, LAST_CHAR = 32, 126
# cv2's mean coverage of a pixel whose centre lies ``e`` px beyond a
# LINE_AA stroke's edge, at these knots, on oblique segments (printed by
# tools/make_torch_raster_tables.py). Horizontal and vertical strokes (the
# stage's boxes) take a profile fitted to cv2's by hand: full cover on the
# edge, 0.22 one pixel out (cv2's fill fringe, 53-58 of 255), its round
# ends between; tests/test_torch_draw.py holds both to cv2.
PROFILE_KNOTS = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5], np.float32)
OBLIQUE_PROFILE = np.array([0.966, 0.791, 0.603, 0.362, 0.14, 0.037, 0.004], np.float32)
AXIS_PROFILE = np.array([1.0, 0.8, 0.53, 0.25, 0.22, 0.015, 0.0], np.float32)
# a 1-px stroke's centre line (OpenCV 5's thin line never reaches full cover)
THIN_PEAK = 0.91


def _box(img: np.ndarray, xmin: float, ymin: float, xmax: float, ymax: float):
    """Integer pixel ranges [x0, x1) x [y0, y1) of a float box, clipped to
    the image; None when empty."""
    h, w = img.shape[:2]
    x0, y0 = max(int(np.floor(xmin)), 0), max(int(np.floor(ymin)), 0)
    x1, y1 = min(int(np.ceil(xmax)) + 1, w), min(int(np.ceil(ymax)) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return None
    return x0, y0, x1, y1


def _blend(region: np.ndarray, coverage: np.ndarray, color) -> None:
    """``region = round(region * (1 - c) + color * c)`` (exact where c is 0
    or 1, so the whole box is blended rather than masked)."""
    c = coverage[..., None]
    out = region * (1 - c) + np.asarray(color, np.float32) * c
    region[...] = np.rint(out).astype(np.uint8)


def half_width(thickness: int) -> float:
    """cv2's half width of a ``LINE_AA`` stroke (0 for a 1-px line)."""
    t = int(thickness)
    return 0.0 if t <= 1 else t / 2.0 + 0.5 * (t % 2)


def _coverage(beyond: np.ndarray, profile: np.ndarray) -> np.ndarray:
    return np.interp(beyond, PROFILE_KNOTS, profile).astype(np.float32)


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """An anti-aliased segment of ``thickness`` with round ends."""
    half = half_width(thickness)
    (ax, ay), (bx, by) = (float(p0[0]), float(p0[1])), (float(p1[0]), float(p1[1]))
    reach = half + PROFILE_KNOTS[-1]
    box = _box(img, min(ax, bx) - reach, min(ay, by) - reach,
               max(ax, bx) + reach, max(ay, by) + reach)
    if box is None:
        return
    x0, y0, x1, y1 = box
    xs = np.arange(x0, x1, dtype=np.float32)[None, :]
    ys = np.arange(y0, y1, dtype=np.float32)[:, None]
    dx, dy = bx - ax, by - ay
    length2 = dx * dx + dy * dy
    if length2 > 0:
        t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / length2, 0.0, 1.0)
    else:
        t = np.zeros((1, 1), np.float32)
    profile = AXIS_PROFILE if dx == 0 or dy == 0 else OBLIQUE_PROFILE
    cov = _coverage(np.hypot(xs - (ax + t * dx), ys - (ay + t * dy)) - half, profile)
    if half == 0.0:
        cov = np.minimum(cov, THIN_PEAK)
    _blend(img[y0:y1, x0:x1], cov, color)


def polylines(img: np.ndarray, points, closed: bool, color, thickness: int = 1) -> None:
    """Anti-aliased segments through ``points`` ((N,2)), closed or open."""
    pts = np.asarray(points).reshape(-1, 2)
    n = len(pts)
    for i in range(n if closed else n - 1):
        line(img, pts[i], pts[(i + 1) % n], color, thickness)


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """The box with corners ``p1`` and ``p2`` (both included): filled when
    ``thickness < 0``, else its anti-aliased outline."""
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    if thickness < 0:
        box = _box(img, xa - 2, ya - 2, xb + 2, yb + 2)
        if box is not None:
            x0, y0, x1, y1 = box
            ex = np.maximum(np.maximum(xa - np.arange(x0, x1), np.arange(x0, x1) - xb), 0)
            ey = np.maximum(np.maximum(ya - np.arange(y0, y1), np.arange(y0, y1) - yb), 0)
            # inside: full cover; one pixel out: an axis-aligned edge's fringe
            cov = (np.where(ey == 0, 1.0, _coverage(ey, AXIS_PROFILE))[:, None]
                   * np.where(ex == 0, 1.0, _coverage(ex, AXIS_PROFILE)))
            _blend(img[y0:y1, x0:x1], cov, color)
        return
    polylines(img, [(xa, ya), (xb, ya), (xb, yb), (xa, yb)], True, color, thickness)


@lru_cache(maxsize=None)
def circle_offsets(radius: int, thickness: int) -> np.ndarray:
    """(K, 2) pixel offsets (x, y) from the centre of one ``LINE_8`` circle
    of ``radius`` and ``thickness``."""
    t = _tables()
    if thickness in TABLE_WIDTHS and f"circle_counts_{thickness}" in t:
        counts = t[f"circle_counts_{thickness}"]
        if 0 <= radius < len(counts):
            start = int(counts[:radius].sum())
            return t[f"circle_offsets_{thickness}"][start:start + counts[radius]].astype(np.int64)
    reach = radius + max(thickness, 1)
    yy, xx = np.mgrid[-reach:reach + 1, -reach:reach + 1]
    d = np.hypot(xx, yy)
    half = max(thickness, 1) / 2.0
    ys, xs = np.nonzero((d <= radius + half) & (d >= radius - half))
    return np.stack([xs - reach, ys - reach], 1)


def circles(img: np.ndarray, centers, radii, color, thickness: int = 1) -> None:
    """``LINE_8`` circles of ``thickness`` at integer ``centers`` ((N,2))
    with integer ``radii`` ((N,)), in one scatter. ``color`` is one colour
    or one per circle ((N,3)); where circles of different colours overlap
    the later one wins, as when cv2 draws them one after another."""
    centers = np.asarray(centers, np.int64).reshape(-1, 2)
    radii = np.asarray(radii, np.int64).reshape(-1)
    if not len(centers):
        return
    h, w = img.shape[:2]
    ys, xs, owner = [], [], []
    for r in np.unique(radii):
        off = circle_offsets(int(r), int(thickness))
        idx = np.nonzero(radii == r)[0]
        xs.append((centers[idx, 0:1] + off[None, :, 0]).ravel())
        ys.append((centers[idx, 1:2] + off[None, :, 1]).ravel())
        owner.append(np.repeat(idx, len(off)))
    ys, xs, owner = np.concatenate(ys), np.concatenate(xs), np.concatenate(owner)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = ys[inside] * w + xs[inside]
    colors = np.asarray(color, np.uint8)
    if colors.ndim == 1:
        img[flat // w, flat % w] = colors
        return
    last = np.full(h * w, -1, np.int64)
    np.maximum.at(last, flat, owner[inside])
    hit = np.unique(flat)
    img[hit // w, hit % w] = colors[last[hit]]


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """cv2.addWeighted for uint8 images."""
    out = a.astype(np.float32) * np.float32(alpha) + b.astype(np.float32) * np.float32(beta)
    return np.clip(np.rint(out + np.float32(gamma)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Text
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(TABLES) as data:
        return {k: data[k] for k in data.files}


@lru_cache(maxsize=None)
def _font(line_width: int) -> tuple:
    """(advances, glyphs, height) for ``line_width``: ``glyphs[i]`` is
    (dx, dy, coverage float32) of character ``FIRST_CHAR + i``."""
    t = _tables()
    lw = line_width if line_width in TABLE_WIDTHS else TABLE_WIDTHS[-1]
    adv, boxes, alpha = t[f"advance_{lw}"], t[f"boxes_{lw}"], t[f"alpha_{lw}"]
    height = int(t[f"height_{lw}"])
    glyphs = []
    for dx, dy, gh, gw, off in boxes.tolist():
        glyphs.append((dx, dy, alpha[off:off + gh * gw].reshape(gh, gw).astype(np.float32) / 255))
    if lw == line_width:
        return adv.astype(np.int64), glyphs, height
    f = max(line_width, 1) / lw  # outside the table: scale the width-6 glyphs
    scaled = []
    for dx, dy, cov in glyphs:
        gh, gw = (max(int(round(s * f)), 1) if s else 0 for s in cov.shape)
        iy = np.minimum((np.arange(gh) / f).astype(np.int64), cov.shape[0] - 1)
        ix = np.minimum((np.arange(gw) / f).astype(np.int64), cov.shape[1] - 1)
        scaled.append((int(round(dx * f)), int(round(dy * f)),
                       cov[iy][:, ix] if cov.size else cov))
    return np.rint(adv * f).astype(np.int64), scaled, int(round(height * f))


def _codes(text: str) -> np.ndarray:
    codes = np.frombuffer(str(text).encode("utf-32-le"), np.uint32).astype(np.int64)
    return np.where((codes >= FIRST_CHAR) & (codes <= LAST_CHAR), codes, ord("?")) - FIRST_CHAR


def text_size(text: str, line_width: int) -> tuple:
    """(width, height) of ``text`` as cv2.getTextSize gives them for the
    stage's font at ``line_width``."""
    adv, _, height = _font(int(line_width))
    if not text:
        return 0, 0
    return int(1 + adv[_codes(text)].sum()), height


def put_text(img: np.ndarray, text: str, org, line_width: int, color) -> None:
    """Draw ``text`` with its baseline's left end at ``org``."""
    adv, glyphs, _ = _font(int(line_width))
    x, y = int(org[0]), int(org[1])
    h, w = img.shape[:2]
    for code in _codes(text).tolist():
        dx, dy, cov = glyphs[code]
        if cov.size:
            gx, gy = x + dx, y + dy
            gh, gw = cov.shape
            cx0, cy0 = max(gx, 0), max(gy, 0)
            cx1, cy1 = min(gx + gw, w), min(gy + gh, h)
            if cx0 < cx1 and cy0 < cy1:
                _blend(img[cy0:cy1, cx0:cx1], cov[cy0 - gy:cy1 - gy, cx0 - gx:cx1 - gx], color)
        x += int(adv[code])
