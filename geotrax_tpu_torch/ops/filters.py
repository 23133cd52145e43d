"""1-D smoothing with scipy's semantics, in float64 numpy on the host.

The port's copy of the numpy path of ``geotrax_tpu/ops/filters.py`` that the
georeferencing stage runs on each track's speed:
  - gaussian: sigma = cfg kernel_size, mode='reflect', truncate=3.0
    (``scipy.ndimage.gaussian_filter1d``);
  - savgol: window = kernel|kernel+1 (odd), polyorder 2, mode='nearest'
    (``scipy.signal.savgol_filter``).
scipy's 'reflect' is symmetric with the edge repeated (d c b a | a b c d);
the index map tiles reflections for pads wider than the signal.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=64)
def _gaussian_weights(sigma: float, truncate: float = 3.0) -> np.ndarray:
    """scipy's kernel: exp(-0.5 x²/σ²) over [-r, r], r = int(truncate*σ+0.5),
    normalized to sum 1 (returned reversed-for-correlate like scipy does;
    symmetric so identical)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float64)


@lru_cache(maxsize=64)
def _savgol_weights(window_length: int, polyorder: int) -> np.ndarray:
    """Savitzky-Golay smoothing coefficients (derivative 0, centered):
    the center row of the least-squares polynomial projection."""
    half = window_length // 2
    pos = np.arange(-half, window_length - half, dtype=np.float64)
    a = pos[:, None] ** np.arange(polyorder + 1)[None, :]
    # value at 0 of the fitted polynomial = e0' (A'A)^-1 A' y
    proj = np.linalg.pinv(a)  # (polyorder+1, window)
    return proj[0][::-1].copy()  # reversed: correlate vs convolve convention


def gaussian_filter1d_np(x: np.ndarray, sigma: float, mode: str = "reflect",
                         truncate: float = 3.0) -> np.ndarray:
    """Float64 host variant (used by the georeferencing stage, where values
    feed fixed-decimal CSV rounding and f32 noise could flip a digit)."""
    return _correlate1d_np(np.asarray(x, np.float64), _gaussian_weights(float(sigma), float(truncate)), mode)


def savgol_filter_np(x: np.ndarray, window_length: int, polyorder: int = 2,
                     mode: str = "nearest") -> np.ndarray:
    if window_length % 2 == 0:
        window_length += 1
    return _correlate1d_np(np.asarray(x, np.float64), _savgol_weights(int(window_length), int(polyorder)), mode)


def _correlate1d_np(x: np.ndarray, weights: np.ndarray, mode: str) -> np.ndarray:
    n = x.shape[-1]
    k = weights.shape[0]
    radius = k // 2
    idx = np.arange(n)[:, None] + (np.arange(k) - radius)[None, :]
    if mode == "reflect":
        period = 2 * n
        j = np.mod(idx, period)
        idx = np.where(j < n, j, period - 1 - j)
    else:
        idx = np.clip(idx, 0, n - 1)
    return (x[..., idx] * weights).sum(-1)
