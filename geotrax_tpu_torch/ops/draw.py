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

The tools draw with cv2's default ``LINE_8`` too, which is integer
rasterization and reproduced pixel for pixel: ``fill_poly`` (fillPoly's
edge table), ``polylines_8`` (Bresenham lines; thick ones as cv2's
fixed-point quads with disc caps) and ``fill_rect`` (a FILLED rectangle).
Their labels use the fonts ``"ann<lw>"`` (``viz_annotations``: fontScale
``max(0.35, 0.18 * lw)``, thickness ``lw // 2``) and ``"seg"``
(``viz_segmentations``: 0.6 / 2), with ``text_baseline`` beside
``text_size``.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

TABLES = Path(__file__).resolve().parent / "raster_tables.npz"
TABLE_WIDTHS = range(1, 7)
ANNOTATION_WIDTHS = range(1, 9)
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


def fill_rect(img: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(..., cv2.FILLED) with the default ``LINE_8``: the box
    with corners ``p1`` and ``p2``, both included, clipped; no fringe."""
    h, w = img.shape[:2]
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    if xb >= 0 and yb >= 0 and xa < w and ya < h:
        img[max(ya, 0):min(yb, h - 1) + 1, max(xa, 0):min(xb, w - 1) + 1] = color


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


def annotation_scale(line_width: int) -> float:
    """``viz_annotations``' label fontScale for a box line width."""
    return max(0.35, 0.18 * line_width)


def _font_key(font) -> tuple:
    """(table key, scale factor) of a font: an int is the stage font of that
    line width (outside 1..6 the width-6 glyphs scaled), ``"ann<lw>"`` the
    annotation labels (outside 1..8 the width-8 glyphs scaled), ``"seg"``
    the lane labels."""
    if isinstance(font, str):
        if font.startswith("ann"):
            lw = int(font[3:])
            if lw in ANNOTATION_WIDTHS:
                return font, 1.0
            top = ANNOTATION_WIDTHS[-1]
            return f"ann{top}", annotation_scale(lw) / annotation_scale(top)
        return font, 1.0
    lw = int(font)
    if lw in TABLE_WIDTHS:
        return str(lw), 1.0
    return str(TABLE_WIDTHS[-1]), max(lw, 1) / TABLE_WIDTHS[-1]


@lru_cache(maxsize=None)
def _font(font) -> tuple:
    """(advances, glyphs, height, baselines) of a font (see ``_font_key``):
    ``glyphs[i]`` is (dx, dy, coverage float32) of character
    ``FIRST_CHAR + i``; ``baselines`` is None for the stage fonts."""
    t = _tables()
    key, f = _font_key(font)
    adv, boxes, alpha = t[f"advance_{key}"], t[f"boxes_{key}"], t[f"alpha_{key}"]
    height = int(t[f"height_{key}"])
    base = t.get(f"baseline_{key}")
    glyphs = []
    for dx, dy, gh, gw, off in boxes.tolist():
        glyphs.append((dx, dy, alpha[off:off + gh * gw].reshape(gh, gw).astype(np.float32) / 255))
    if f == 1.0:
        return adv.astype(np.int64), glyphs, height, base
    # outside the tables: scale the largest one's glyphs (an approximation)
    scaled = []
    for dx, dy, cov in glyphs:
        gh, gw = (max(int(round(s * f)), 1) if s else 0 for s in cov.shape)
        iy = np.minimum((np.arange(gh) / f).astype(np.int64), cov.shape[0] - 1)
        ix = np.minimum((np.arange(gw) / f).astype(np.int64), cov.shape[1] - 1)
        scaled.append((int(round(dx * f)), int(round(dy * f)),
                       cov[iy][:, ix] if cov.size else cov))
    return (np.rint(adv * f).astype(np.int64), scaled, int(round(height * f)),
            None if base is None else np.rint(base * f).astype(np.int64))


def _codes(text: str) -> np.ndarray:
    codes = np.frombuffer(str(text).encode("utf-32-le"), np.uint32).astype(np.int64)
    return np.where((codes >= FIRST_CHAR) & (codes <= LAST_CHAR), codes, ord("?")) - FIRST_CHAR


def text_size(text: str, font) -> tuple:
    """(width, height) of ``text`` as cv2.getTextSize gives them for a font
    (the stage's font of a line width, or a key of ``_font_key``)."""
    adv, _, height, _ = _font(font)
    if not text:
        return 0, 0
    return int(1 + adv[_codes(text)].sum()), height


def text_baseline(text: str, font: str) -> int:
    """cv2.getTextSize's baseline of ``text``: its characters' largest."""
    base = _font(font)[3]
    return int(base[_codes(text)].max()) if text else 0


def put_text(img: np.ndarray, text: str, org, font, color) -> None:
    """Draw ``text`` in ``font`` with its baseline's left end at ``org``."""
    adv, glyphs, _, _ = _font(font)
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


# ---------------------------------------------------------------------------
# LINE_8 polygons (integer rasterization, cv2's pixels)
# ---------------------------------------------------------------------------

XY_SHIFT = 16  # cv2's fixed point for thick lines
XY_ONE = 1 << XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, p1: tuple, p2: tuple) -> tuple:
    """cv2.clipLine: (visible, p1, p2) of a segment clipped to [0, w) x [0, h)."""
    if w <= 0 or h <= 0:
        return False, p1, p2
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(w: int, h: int, p1: tuple, p2: tuple) -> tuple:
    """(xs, ys) of cv2's 1-px ``LINE_8`` segment (its LineIterator, left to
    right, after clipping): the Bresenham steps in closed form."""
    p1, p2 = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        visible, p1, p2 = _clip_line(w, h, p1, p2)
        if not visible:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy, p1 = -dx, -dy, p2
    step = 1
    if dy < 0:
        dy, step = -dy, -1
    vertical = dy > dx
    if vertical:
        dx, dy = dy, dx
    major = np.arange(dx + 1)
    minor = (2 * dy * major + dx - 1) // (2 * dx) if dx else major
    if vertical:
        return p1[0] + minor, p1[1] + step * major
    return p1[0] + major, p1[1] + step * minor


def _line2(w: int, h: int, p1: tuple, p2: tuple) -> tuple:
    """(xs, ys) of cv2's ``Line2``: a LINE_8 segment between XY_SHIFT
    fixed-point ends (a thick line's outline)."""
    visible, (x1, y1), (x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not visible:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = x2 - x1, y2 - y1
    end = ((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if abs(dx) > abs(dy):
        if dx < 0:
            dy = -dy
            x1, x2, y1 = x2, x1, y2
        n = ((x2 - x1) >> XY_SHIFT) + 1
        y_step = _cdiv(dy << XY_SHIFT, abs(dx) | 1)
        k = np.arange(max(n, 0), dtype=np.int64)
        xs = ((x1 + (XY_ONE >> 1)) >> XY_SHIFT) + k
        ys = (y1 + (XY_ONE >> 1) + k * y_step) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            y1, y2, x1 = y2, y1, x2
        n = ((y2 - y1) >> XY_SHIFT) + 1
        x_step = _cdiv(dx << XY_SHIFT, abs(dy) | 1)
        k = np.arange(max(n, 0), dtype=np.int64)
        xs = (x1 + (XY_ONE >> 1) + k * x_step) >> XY_SHIFT
        ys = ((y1 + (XY_ONE >> 1)) >> XY_SHIFT) + k
    return np.append(xs, end[0]), np.append(ys, end[1])


def _put(img: np.ndarray, xs, ys, color) -> None:
    h, w = img.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[inside], xs[inside]] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    """Pixels x1..x2 of row y, clipped."""
    h, w = img.shape[:2]
    if 0 <= y < h and x1 < w and x2 >= 0:
        img[y, max(x1, 0):min(x2, w - 1) + 1] = color


def _fill_convex_fixed(img: np.ndarray, v: list, color) -> None:
    """cv2's FillConvexPoly under LINE_8 for XY_SHIFT fixed-point corners:
    the outline by ``_line2``, then spans between the two edge chains,
    rounded to the nearest pixel."""
    h, w = img.shape[:2]
    n = len(v)
    half = XY_ONE >> 1
    imin = min(range(n), key=lambda i: (v[i][1], i))
    p0 = v[-1]
    for p in v:
        _put(img, *_line2(w, h, p0, p), color)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    xmin, xmax = (min(xs) + half) >> XY_SHIFT, (max(xs) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    chains = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
              {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges, y = n, ymin
    while True:
        for e in chains:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    e.update(ye=ty, x=v[idx0][0], idx=idx,
                             dx=_cdiv((v[idx][0] - v[idx0][0]) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            a, b = sorted((chains[0]["x"], chains[1]["x"]))
            _hline(img, y, (a + half) >> XY_SHIFT, (b + half) >> XY_SHIFT, color)
        for e in chains:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def _disc(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """cv2's filled LINE_8 circle (its midpoint loop), a thick line's cap."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            _hline(img, y, x1, x2, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line8(img: np.ndarray, p0: tuple, p1: tuple, thickness: int, caps: int,
                 color) -> None:
    """cv2's ThickLine under LINE_8: the segment's quad of half width
    ``thickness / 2`` (corner offsets rounded in fixed point), and a disc
    at each end whose bit is set in ``caps`` (1: start, 2: end)."""
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    fixed = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (fixed + (thickness & 1) * XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_fixed(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                                 (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], color)
    for bit, p in ((1, p0), (2, p1)):
        if caps & bit:
            _disc(img, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                  (fixed + (XY_ONE >> 1)) >> XY_SHIFT, color)


def polylines_8(img: np.ndarray, points, closed: bool, color, thickness: int = 1) -> None:
    """cv2.polylines with the default ``LINE_8``: 1-px Bresenham segments,
    or thick segments (a quad and a disc at each segment's end; an open
    line's first point gets one too). cv2's pixels, but for a thick segment
    leaving the image, whose outline cv2 clips in fixed point otherwise."""
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    if not pts:
        return
    h, w = img.shape[:2]
    p0 = pts[-1] if closed else pts[0]
    caps = 2 if closed else 3
    for p in pts[0 if closed else 1:]:
        if thickness <= 1:
            _put(img, *_line8(w, h, p0, p), color)
        else:
            _thick_line8(img, p0, p, int(thickness), caps, color)
        p0, caps = p, 2


def fill_poly(img: np.ndarray, points, color) -> None:
    """cv2.fillPoly of one polygon with the default ``LINE_8``: its edges as
    1-px segments, then each row's spans between the edges crossing it (an
    edge spans [top, bottom) rows, x in 16-bit fixed point, ceil on the
    left, floor on the right), any polygon shape (even-odd). An edge that
    leaves the image takes its slope from its clipped part, as cv2 does;
    OpenCV 5 also fills a polygon's part beyond the image along the border
    column, which this does not (tests/test_torch_draw.py)."""
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    h, w = img.shape[:2]
    edges = []
    p0 = pts[-1]
    for p in pts:
        _put(img, *_line8(w, h, p0, p), color)
        if p0[1] != p[1]:
            (xa, ya), (xb, yb) = p0, p
            if not (0 <= xa < w and 0 <= xb < w and 0 <= ya < h and 0 <= yb < h):
                _, c0, c1 = _clip_line(w, h, p0, p)
                if c0[1] != c1[1]:
                    (xa, ya), (xb, yb) = c0, c1
            slope = _cdiv((xb - xa) << XY_SHIFT, yb - ya)
            top, bottom = sorted((p0[1], p[1]))
            # x at the unclipped top row, along the clipped slope
            x_top = (xa << XY_SHIFT) + (top - ya) * slope
            edges.append((top, bottom, x_top, slope))
        p0 = p
    if len(edges) < 2:
        return
    for y in range(max(min(e[0] for e in edges), 0), min(max(e[1] for e in edges), h)):
        xs = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges if y0 <= y < y1)
        for a, b in zip(xs[0::2], xs[1::2]):
            _hline(img, y, (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT, color)
