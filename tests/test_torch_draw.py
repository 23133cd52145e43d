"""The port's rasterizer (ops/draw.py) against cv2 (OpenCV 5).

- ``text_size`` equals ``cv2.getTextSize`` for every printable character
  and for labels, at line widths 1 to 6 (font scale ``lw / 3``, thickness
  ``max(lw - 1, 1)``, as the visualize stage calls it);
- ``put_text`` is within 1 grey level of ``cv2.putText`` (``LINE_AA``);
- ``circles`` equal ``cv2.circle`` (``LINE_8``) pixel for pixel for radii
  0-15 and thicknesses 1-6, and keep cv2's drawing order where colours
  overlap; ``add_weighted`` equals ``cv2.addWeighted``;
- strokes (``LINE_AA``), over the pixels either draws: axis-aligned
  rectangle outlines within a mean of 1.5 grey levels and filled ones
  within 0.25; segments at any angle within a mean of 3 levels (OpenCV 5
  fills its anti-aliased polygons in fixed point; the port's capsules
  follow its mean coverage profiles);
- the tools' primitives: ``fill_poly``, ``polylines_8`` (thickness 1-4, open
  and closed) and ``fill_rect`` equal cv2's ``LINE_8`` ``fillPoly``,
  ``polylines`` and ``FILLED`` rectangle pixel for pixel for shapes inside
  the image (convex, concave and self-crossing; a polygon leaving the
  image differs only on the border columns); the annotation labels
  (``ann1``-``ann8``) and the lane labels (``seg``, 0.6 / 2) have cv2's
  sizes and baselines and are drawn within 1 grey level of it.
"""

import numpy as np
import pytest

from geotrax_tpu_torch.ops import draw

cv2 = pytest.importorskip("cv2")
PRINTABLE = "".join(chr(c) for c in range(32, 127))
LABELS = ["id:1", "id:12 car", "id:1234 motorcycle 88 km/h L3 0.97", "id:7 truck 45 mi/h",
          "id:3 {odd} [name] ~!@#$%^&*()_+|"]


def font(lw):
    return lw / 3, max(lw - 1, 1)


@pytest.mark.parametrize("lw", range(1, 7))
def test_text_size_equals_cv2(lw):
    scale, thickness = font(lw)
    for text in list(PRINTABLE) + LABELS + [PRINTABLE]:
        (w, h), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        assert draw.text_size(text, lw) == (w, h), (text, lw)


@pytest.mark.parametrize("lw", range(1, 7))
def test_put_text_within_one_level_of_cv2(lw):
    rng = np.random.default_rng(lw)
    scale, thickness = font(lw)
    for text in LABELS + [PRINTABLE[:40], PRINTABLE[40:]]:
        w, h = draw.text_size(text, lw)
        img = rng.integers(0, 256, (h + 20 * lw, w + 20 * lw, 3)).astype(np.uint8)
        org = (int(rng.integers(-5, 10 * lw)), int(h + rng.integers(0, 10 * lw)))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        want, got = img.copy(), img.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness, cv2.LINE_AA)
        draw.put_text(got, text, org, lw, color)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, text


def test_text_outside_the_table_and_outside_ascii():
    # line widths past the table scale the width-6 glyphs; a character past
    # printable ASCII is drawn (and measured) as '?'
    assert draw.text_size("id:5", 9)[1] == 81
    assert draw.text_size("aéb", 2) == draw.text_size("a?b", 2)
    img = np.zeros((100, 300, 3), np.uint8)
    draw.put_text(img, "id:5 car", (5, 90), 9, (255, 255, 255))
    assert img.any()


@pytest.mark.parametrize("thickness", range(1, 7))
def test_circles_equal_cv2(thickness):
    for r in range(16):
        want, got = np.zeros((60, 60, 3), np.uint8), np.zeros((60, 60, 3), np.uint8)
        cv2.circle(want, (29, 31), r, (10, 200, 30), thickness)
        draw.circles(got, [(29, 31)], [r], (10, 200, 30), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"r={r}")


@pytest.mark.parametrize("reach", ["inside", "across_the_border"])
def test_circles_keep_the_drawing_order(reach):
    """Many circles in one call equal cv2's one after another. Where a ring
    crosses the image's border, cv2 rasterizes its clipped pieces and a few
    pixels there differ (at most 0.5 % of those drawn)."""
    rng = np.random.default_rng(0)
    lo, hi = (12, 28) if reach == "inside" else (-5, 45)
    centers = rng.integers(lo, hi, (40, 2))
    radii = rng.integers(0, 10, 40)
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    want, got = np.zeros((40, 40, 3), np.uint8), np.zeros((40, 40, 3), np.uint8)
    for c, r, col in zip(centers, radii, colors):
        cv2.circle(want, tuple(int(v) for v in c), int(r), tuple(int(v) for v in col), 2)
    draw.circles(got, centers, radii, colors, 2)
    if reach == "inside":
        np.testing.assert_array_equal(got, want)
    else:
        differ = (got != want).any(-1).sum()
        assert differ <= 0.005 * (want.any(-1) | got.any(-1)).sum(), differ


def test_add_weighted_equals_cv2():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
    want = np.empty_like(a)
    cv2.addWeighted(a, 0.75, b, 0.25, 0, want)
    np.testing.assert_array_equal(draw.add_weighted(a, 0.75, b, 0.25, 0), want)


def stroke_error(draw_cv, draw_port, shapes, rng) -> float:
    total = pixels = 0
    for _ in range(shapes):
        img = np.empty((120, 160, 3), np.uint8)
        img[:] = rng.integers(0, 256, 3)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        p = [int(v) for v in rng.uniform(-20, 180, 4)]
        t = int(rng.integers(1, 7))
        want, got = img.copy(), img.copy()
        draw_cv(want, p, color, t)
        draw_port(got, p, color, t)
        ink = (want != img).any(-1) | (got != img).any(-1)
        total += np.abs(got.astype(int) - want.astype(int)).max(-1)[ink].sum()
        pixels += ink.sum()
    return total / pixels


@pytest.mark.parametrize("shape,bound", [("outline", 1.5), ("filled", 0.25), ("segment", 3.0)])
def test_strokes_within_the_stated_bound_of_cv2(shape, bound):
    rng = np.random.default_rng({"outline": 0, "filled": 1, "segment": 2}[shape])
    if shape == "segment":
        err = stroke_error(
            lambda im, p, c, t: cv2.line(im, (p[0], p[1]), (p[2], p[3]), c, t, cv2.LINE_AA),
            lambda im, p, c, t: draw.line(im, (p[0], p[1]), (p[2], p[3]), c, t), 200, rng)
    else:
        th = -1 if shape == "filled" else None
        err = stroke_error(
            lambda im, p, c, t: cv2.rectangle(im, (p[0], p[1]), (p[2], p[3]), c, th or t,
                                              cv2.LINE_AA),
            lambda im, p, c, t: draw.rectangle(im, (p[0], p[1]), (p[2], p[3]), c, th or t),
            200, rng)
    assert err <= bound, err


# ---------------------------------------------------------------------------
# The tools' LINE_8 primitives and label fonts
# ---------------------------------------------------------------------------

def _polygons(seed, n, lo=0, hi=50):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield rng.integers(lo, hi, (int(rng.integers(2, 7)), 2))


@pytest.mark.parametrize("seed", range(4))
def test_fill_poly_equals_cv2(seed):
    for pts in _polygons(seed, 150):
        if len(pts) < 3:
            continue
        want = np.zeros((50, 60, 3), np.uint8)
        got = want.copy()
        cv2.fillPoly(want, [pts.astype(np.int32)], (10, 200, 30))
        draw.fill_poly(got, pts, (10, 200, 30))
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def test_fill_poly_leaving_the_image():
    """Where a polygon leaves the image, OpenCV 5 also fills its outside
    part along the border column; elsewhere the pixels are cv2's."""
    for pts in _polygons(11, 300, -15, 75):
        if len(pts) < 3:
            continue
        want = np.zeros((50, 60, 3), np.uint8)
        got = want.copy()
        cv2.fillPoly(want, [pts.astype(np.int32)], (10, 200, 30))
        draw.fill_poly(got, pts, (10, 200, 30))
        np.testing.assert_array_equal(got[:, 1:-1], want[:, 1:-1], err_msg=str(pts.tolist()))


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
def test_polylines_8_equal_cv2(thickness):
    for i, pts in enumerate(_polygons(thickness, 120)):
        closed = bool(i % 2)
        want = np.zeros((50, 60, 3), np.uint8)
        got = want.copy()
        cv2.polylines(want, [pts.astype(np.int32)], closed, (200, 100, 5), thickness)
        draw.polylines_8(got, pts, closed, (200, 100, 5), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{pts.tolist()} closed={closed}")


def test_one_pixel_lines_clip_as_cv2():
    for pts in _polygons(9, 200, -20, 80):
        want = np.zeros((50, 60, 3), np.uint8)
        got = want.copy()
        cv2.polylines(want, [pts.astype(np.int32)], False, (9, 9, 9), 1)
        draw.polylines_8(got, pts, False, (9, 9, 9), 1)
        np.testing.assert_array_equal(got, want)


def test_fill_rect_equals_cv2():
    rng = np.random.default_rng(3)
    for _ in range(100):
        a, b = (tuple(int(v) for v in rng.integers(-10, 70, 2)) for _ in range(2))
        want = np.zeros((50, 60, 3), np.uint8)
        got = want.copy()
        cv2.rectangle(want, a, b, (1, 2, 3), cv2.FILLED)
        draw.fill_rect(got, a, b, (1, 2, 3))
        np.testing.assert_array_equal(got, want)


TOOL_FONTS = [(f"ann{lw}", max(0.35, 0.18 * lw), max(1, lw // 2), cv2.LINE_AA)
              for lw in range(1, 9)] + [("seg", 0.6, 2, cv2.LINE_8)]


@pytest.mark.parametrize("key,scale,thickness,line_type", TOOL_FONTS)
def test_tool_fonts_equal_cv2(key, scale, thickness, line_type):
    for text in list(PRINTABLE) + LABELS + ["car", "1_2/1", "motorcycle"]:
        (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        assert draw.text_size(text, key) == (w, h), text
        assert draw.text_baseline(text, key) == base, text
    rng = np.random.default_rng(len(key))
    for text in LABELS + ["car", "1_2/1", "3_4/2"]:
        bg = rng.integers(0, 256, (60, 420, 3)).astype(np.uint8)
        want = bg.copy()
        cv2.putText(want, text, (5, 40), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255),
                    thickness, line_type)
        got = bg.copy()
        draw.put_text(got, text, (5, 40), key, (255, 255, 255))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, text
