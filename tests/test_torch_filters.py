"""The port's device filters (geotrax_tpu_torch/ops/filters.py) against the
JAX package's (geotrax_tpu/ops/filters.py) on the CPU, and against the
port's own float64 ``_np`` versions.

- ``correlate1d`` in modes 'reflect' and 'nearest', ``gaussian_filter1d`` at
  sigma 1, 3.5 and 14 on lengths 2 to 300 (radius 42 > length included),
  ``savgol_filter`` with windows 5 to 31 and an even one, ``gradient``;
- float32 input: within F32_TOL of the JAX function (JAX runs float32 with
  x64 off; both add the same float32 products in different orders);
- float64 input: equal bit for bit to the ``_np`` version;
- a batched (4, 7, n) input equals its rows one by one.
"""

import numpy as np
import pytest
import torch

from geotrax_tpu.ops import filters as ref
from geotrax_tpu_torch.ops import filters as port

F32_TOL = 2e-6  # relative to the signal's largest magnitude
LENGTHS = (2, 3, 7, 30, 85, 300)


def _signal(n, seed, shape=()):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0.0, 1.0, (*shape, n)), -1) + 10.0


def _close_f32(got: torch.Tensor, want, scale):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL * max(scale, 1.0))


@pytest.mark.parametrize("mode", ["reflect", "nearest"])
@pytest.mark.parametrize("n", LENGTHS)
def test_correlate1d_against_jax(mode, n):
    x = _signal(n, n)
    w = np.random.default_rng(1).normal(size=9)
    got = port.correlate1d(torch.tensor(x, dtype=torch.float32), w, mode)
    want = ref.correlate1d(x.astype(np.float32), w.astype(np.float32), mode)
    _close_f32(got, want, np.abs(x).max() * np.abs(w).sum())
    got64 = port.correlate1d(torch.tensor(x), w, mode)
    assert np.array_equal(got64.numpy(), port._correlate1d_np(x, w, mode))


@pytest.mark.parametrize("sigma", [1.0, 3.5, 14.0])
@pytest.mark.parametrize("n", LENGTHS)
def test_gaussian_filter1d_against_jax(sigma, n):
    x = _signal(n, 7 * n)
    got = port.gaussian_filter1d(torch.tensor(x, dtype=torch.float32), sigma)
    _close_f32(got, ref.gaussian_filter1d(x, sigma), np.abs(x).max())
    got64 = port.gaussian_filter1d(torch.tensor(x), sigma)
    assert got64.dtype == torch.float64
    assert np.array_equal(got64.numpy(), port.gaussian_filter1d_np(x, sigma))
    assert np.array_equal(got64.numpy(), ref.gaussian_filter1d_np(x, sigma))


def test_gaussian_radius_exceeds_length():
    x = _signal(5, 3)
    radius = len(port._gaussian_weights(14.0)) // 2
    assert radius == 42 > len(x)
    from scipy.ndimage import gaussian_filter1d

    np.testing.assert_allclose(port.gaussian_filter1d(torch.tensor(x), 14.0).numpy(),
                               gaussian_filter1d(x, 14.0, mode="reflect", truncate=3.0),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("window", [5, 8, 15, 31])
@pytest.mark.parametrize("n", [3, 30, 300])
def test_savgol_filter_against_jax(window, n):
    x = _signal(n, window + n)
    got = port.savgol_filter(torch.tensor(x, dtype=torch.float32), window)
    _close_f32(got, ref.savgol_filter(x, window), np.abs(x).max() * 4)
    got64 = port.savgol_filter(torch.tensor(x), window)
    assert np.array_equal(got64.numpy(), port.savgol_filter_np(x, window))


@pytest.mark.parametrize("n", LENGTHS)
def test_gradient_against_jax(n):
    x = _signal(n, 11 * n)
    got = port.gradient(torch.tensor(x, dtype=torch.float32))
    _close_f32(got, ref.gradient(x.astype(np.float32)), np.abs(x).max())
    assert np.array_equal(port.gradient(torch.tensor(x)).numpy(), np.gradient(x))


def test_batched_rows_equal_one_by_one():
    x = _signal(60, 5, shape=(4, 7))
    for dtype in (torch.float32, torch.float64):
        xt = torch.tensor(x, dtype=dtype)
        outs = {"gauss": port.gaussian_filter1d(xt, 3.5),
                "savgol": port.savgol_filter(xt, 15),
                "grad": port.gradient(xt),
                "near": port.correlate1d(xt, np.ones(5) / 5, "nearest")}
        for i in range(4):
            for j in range(7):
                row = xt[i, j]
                assert torch.equal(outs["gauss"][i, j], port.gaussian_filter1d(row, 3.5))
                assert torch.equal(outs["savgol"][i, j], port.savgol_filter(row, 15))
                assert torch.equal(outs["grad"][i, j], port.gradient(row))
                assert torch.equal(outs["near"][i, j],
                                   port.correlate1d(row, np.ones(5) / 5, "nearest"))
    got = port.gaussian_filter1d(torch.tensor(x, dtype=torch.float32), 14.0)
    want = np.stack([[np.asarray(ref.gaussian_filter1d(r, 14.0)) for r in plane] for plane in x])
    _close_f32(got, want, np.abs(x).max())


def test_dtype_rule_and_bad_mode():
    assert port.gradient(torch.arange(5)).dtype == torch.float32
    assert port.gaussian_filter1d(torch.ones(4, dtype=torch.float16), 1.0).dtype == torch.float32
    with pytest.raises(ValueError):
        port.correlate1d(torch.ones(4), np.ones(3), "wrap")
