"""Pillow's bicubic resize of 8-bit RGB images, in numpy.

The reference's training loader letterboxes with
``PIL.Image.fromarray(img).resize((w, h))``, whose default filter is
``BICUBIC``. This is a copy of Pillow's 8-bit resampler
(``libImaging/Resample.c``), so that the port's batches equal the
reference's bit for bit without Pillow:

- the filter's support is scaled by the reduction factor (antialiasing);
- each output pixel's weights are normalized in float64, then rounded to
  fixed point with ``PRECISION_BITS`` = 22 fractional bits;
- a horizontal pass rounds into uint8, then a vertical pass does the same;
- a resize to the same size is a copy.

The integer sums are exact in int32 (|sum| < 2^31 for 8-bit inputs), so
their order does not matter; the float64 weights follow Pillow's order of
operations.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
BICUBIC_SUPPORT = 2.0


def bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic convolution kernel (a = -0.5), elementwise float64."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def precompute_coeffs(in_size: int, out_size: int) -> tuple:
    """(xmin (out,), xmax (out,), int32 fixed-point weights (out, ksize)):
    output pixel i reads input pixels xmin[i] .. xmin[i] + xmax[i] - 1."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    used = taps[None, :] < xmax[:, None]
    w = np.where(used, bicubic_filter((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
                                      * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # Pillow's sequential sum
        ww = ww + w[:, j]
    w = np.where(used & (ww[:, None] != 0.0), w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + fixed, 0.5 + fixed)).astype(np.int32)
    return xmin, xmax, k


def _clip8(acc: np.ndarray) -> np.ndarray:
    out = np.right_shift(acc, PRECISION_BITS)
    out = np.where(acc >= (1 << PRECISION_BITS << 8), 255, out)
    return np.where(acc <= 0, 0, out).astype(np.uint8)


def _resample_rows(img: np.ndarray, xmin, k) -> np.ndarray:
    """One pass along axis 0 of (N, M, C) uint8 -> (len(xmin), M, C) uint8:
    each tap gathers whole contiguous rows."""
    acc = np.full((len(xmin),) + img.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    term = np.empty_like(acc)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, img.shape[0] - 1)  # taps past xmax weigh 0
        np.multiply(img[idx], k[:, j, None, None], out=term)
        acc += term
    return _clip8(acc)


def resize_bicubic(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) uint8, equal to
    ``np.asarray(PIL.Image.fromarray(img).resize((out_w, out_h)))``."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    ymin, ymax, ky = precompute_coeffs(h, out_h)
    out = img
    if out_w != w:
        xmin, _, kx = precompute_coeffs(w, out_w)
        # only the rows the vertical pass reads, as Pillow does; the
        # horizontal pass runs on the transposed image (contiguous gathers)
        first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
        cols = np.ascontiguousarray(img[first:last].transpose(1, 0, 2))
        out = np.ascontiguousarray(_resample_rows(cols, xmin, kx).transpose(1, 0, 2))
        ymin = ymin - first
    if out_h != h:
        out = _resample_rows(out, ymin, ky)
    return out
