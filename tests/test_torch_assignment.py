"""The port's exact host assignment (ops/assignment.py:lapjv_exact and its
own io/native/lapjv.cpp, built with g++ at first use) against the JAX
package's ``lapjv_exact`` and scipy's ``linear_sum_assignment`` on seeded
random costs: square, wide, tall (solved transposed) and empty; equal
columns. A source that does not build raises instead of falling back."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from geotrax_tpu.ops.assignment import lapjv_exact as jax_lapjv
from geotrax_tpu_torch.io import native
from geotrax_tpu_torch.ops import assignment

torch.set_num_threads(1)


def scipy_columns(cost):
    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[0], -1, dtype=np.int64)
    out[rows] = cols
    return out


@pytest.mark.parametrize("shape", [(1, 1), (7, 7), (12, 30), (40, 41), (200, 400), (30, 12),
                                   (0, 5), (5, 0)])
@pytest.mark.parametrize("kind", ["uniform", "integer"])
def test_lapjv_exact_equals_the_reference_and_scipy(shape, kind):
    rng = np.random.default_rng(sum(shape) + len(kind))
    cost = (rng.uniform(0, 1, shape) if kind == "uniform"
            else rng.permutation(np.arange(np.prod(shape))).reshape(shape) * 0.5)
    ours = assignment.lapjv_exact(cost)
    assert ours.dtype == np.int64 and ours.shape == (shape[0],)
    np.testing.assert_array_equal(ours, scipy_columns(cost))
    if 0 < shape[0] <= shape[1]:  # the reference's native solver takes N <= M
        np.testing.assert_array_equal(ours, jax_lapjv(cost))
    assigned = ours[ours >= 0]
    assert len(np.unique(assigned)) == len(assigned) == min(shape)


def test_lapjv_exact_refuses_an_infinite_cost():
    cost = np.full((3, 3), np.inf)
    with pytest.raises(ValueError, match="no assignment"):
        assignment.lapjv_exact(cost)


def test_failing_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "lapjv.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(assignment, "LAPJV_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(assignment, "_lap_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for lapjv.cpp"):
        assignment.lapjv_exact(np.eye(3))
