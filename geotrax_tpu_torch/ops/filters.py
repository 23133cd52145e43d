"""1-D smoothing with scipy's semantics: float64 numpy on the host, and the
same filters on tensors on any device.

The ``_np`` functions are the port's copy of the numpy path of
``geotrax_tpu/ops/filters.py`` that the georeferencing stage runs on each
track's speed:
  - gaussian: sigma = cfg kernel_size, mode='reflect', truncate=3.0
    (``scipy.ndimage.gaussian_filter1d``);
  - savgol: window = kernel|kernel+1 (odd), polyorder 2, mode='nearest'
    (``scipy.signal.savgol_filter``).
scipy's 'reflect' is symmetric with the edge repeated (d c b a | a b c d);
the index map tiles reflections for pads wider than the signal.

``correlate1d``, ``gaussian_filter1d``, ``savgol_filter`` and ``gradient``
are the reference's device functions: batched ``(..., n)`` tensors on the
tensor's own device, float32 unless the input is float64. They take their
weights from the same cached tables and add the taps in numpy's order, so a
float64 result equals the ``_np`` version's bit for bit. No stage calls
them, as in the reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# Device versions: the same filters on tensors of shape (..., n) on any device
# ---------------------------------------------------------------------------

def _float_dtype(x) -> torch.dtype:
    """float64 for a float64 input, else float32 (the reference's rule with
    x64 off)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _index_map(n: int, k: int, mode: str, device) -> torch.Tensor:
    """(n, k) source index of each output sample's k taps (centred)."""
    idx = (torch.arange(n, device=device)[:, None]
           + (torch.arange(k, device=device) - k // 2)[None, :])
    if mode == "reflect":
        period = 2 * n
        j = torch.remainder(idx, period)
        return torch.where(j < n, j, period - 1 - j)
    if mode == "nearest":
        return idx.clamp(0, n - 1)
    raise ValueError(f"mode must be 'reflect' or 'nearest', not {mode!r}")


def _pairwise_sum(term, lo: int, n: int):
    """sum(term(lo + i) for i < n) added in numpy's pairwise order (runs of
    fewer than 8 in sequence, else 8 interleaved partial sums, halves above
    128), so that a float64 result is the ``_np`` version's bit for bit."""
    if n < 8:
        acc = term(lo)
        for i in range(1, n):
            acc = acc + term(lo + i)
        return acc
    if n <= 128:
        r = [term(lo + j) for j in range(8)]
        i = 8
        while i < n - n % 8:
            for j in range(8):
                r[j] = r[j] + term(lo + i + j)
            i += 8
        acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for i in range(i, n):
            acc = acc + term(lo + i)
        return acc
    half = n // 2
    half -= half % 8
    return _pairwise_sum(term, lo, half) + _pairwise_sum(term, lo + half, n - half)


def correlate1d(x, weights, mode: str = "reflect"):
    """``scipy.ndimage.correlate1d`` over the last axis of a tensor with a
    centred origin; ``mode`` is 'reflect' (symmetric, tiled when the radius
    exceeds the length) or 'nearest'. One gather and one product per tap."""
    x = torch.as_tensor(x)
    x = x.to(_float_dtype(x))
    w = torch.as_tensor(np.asarray(weights), dtype=x.dtype, device=x.device)
    k = w.shape[0]
    idx = _index_map(x.shape[-1], k, mode, x.device)
    return _pairwise_sum(lambda j: x[..., idx[:, j]] * w[j], 0, k)


def gaussian_filter1d(x, sigma: float, mode: str = "reflect", truncate: float = 3.0):
    """Gaussian smoothing along the last axis
    (``scipy.ndimage.gaussian_filter1d``)."""
    return correlate1d(x, _gaussian_weights(float(sigma), float(truncate)), mode)


def savgol_filter(x, window_length: int, polyorder: int = 2, mode: str = "nearest"):
    """Savitzky-Golay smoothing along the last axis
    (``scipy.signal.savgol_filter``); an even window becomes the next odd."""
    if window_length % 2 == 0:
        window_length += 1
    return correlate1d(x, _savgol_weights(int(window_length), int(polyorder)), mode)


def gradient(x):
    """``np.gradient`` along the last axis: central differences inside,
    one-sided at the ends (length >= 2)."""
    x = torch.as_tensor(x)
    x = x.to(_float_dtype(x))
    interior = (x[..., 2:] - x[..., :-2]) / 2.0
    return torch.cat([x[..., 1:2] - x[..., 0:1], interior, x[..., -1:] - x[..., -2:-1]], -1)
