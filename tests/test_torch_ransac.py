"""Homography fits and RANSAC of the port against the JAX package. RANSAC
gets the hypothesis indices JAX drew (``_sample_indices(fold_in(key, fid),
...)``); with them the homography agrees within 1e-4 relative and the
inlier masks are equal. The port's own draw from a key is held to JAX's in
tests/test_torch_prng.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.ops import homography as jh
from geotrax_tpu.ops import ransac as jr
from geotrax_tpu_torch.ops import homography as th
from geotrax_tpu_torch.ops import prng
from geotrax_tpu_torch.ops import ransac as tr

H_RTOL = 1e-4


def correspondences(seed, n=200, outliers=0.3, noise=0.3):
    rng = np.random.default_rng(seed)
    h = np.eye(3)
    ang = rng.uniform(-0.05, 0.05)
    h[:2, :2] = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]) * 1.01
    h[:2, 2] = rng.uniform(-8, 8, 2)
    h[2, :2] = rng.uniform(-2e-5, 2e-5, 2)
    src = rng.uniform(0, 400, (n, 2))
    p = np.c_[src, np.ones(n)] @ h.T
    dst = p[:, :2] / p[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    dst[bad] = rng.uniform(0, 400, (bad.sum(), 2))
    valid = rng.random(n) > 0.1
    return src.astype(np.float32), dst.astype(np.float32), valid, h


def h_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=H_RTOL, atol=H_RTOL * np.abs(ref).max())


def test_fits_match_jax():
    src, dst, _, _ = correspondences(0, n=40, outliers=0.0)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    w = np.random.default_rng(1).uniform(0, 1, 40).astype(np.float32)
    h_close(th.fit_homography(s, d).numpy(), jh.fit_homography(jnp.asarray(src), jnp.asarray(dst)))
    h_close(th.fit_homography_normal(s, d, torch.from_numpy(w)).numpy(),
            jh.fit_homography_normal(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    h_close(th.fit_affine(s, d, torch.from_numpy(w)).numpy(),
            jh.fit_affine(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    h_close(th.fit_homography_minimal(s[:4], d[:4]).numpy(),
            jh.fit_homography_minimal(jnp.asarray(src[:4]), jnp.asarray(dst[:4])))
    hm = np.array(jh.fit_homography(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(
        th.reprojection_error(torch.from_numpy(hm), s, d).numpy(),
        np.asarray(jh.reprojection_error(jnp.asarray(hm), jnp.asarray(src), jnp.asarray(dst))),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_array_equal(th.adjugate3(torch.from_numpy(hm)).numpy(),
                                  np.asarray(jh.adjugate3(jnp.asarray(hm))))


@pytest.mark.parametrize("transformation,seed", [("projective", 2), ("projective", 3), ("affine", 4)])
def test_ransac_with_injected_indices(transformation, seed):
    src, dst, valid, _ = correspondences(seed)
    n_hyps = 256
    sample_size = 4 if transformation == "projective" else 3
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    weights = jnp.asarray(valid, jnp.float32)
    weights = weights / weights.sum()
    idx = np.array(jr._sample_indices(key, n_hyps, sample_size, len(src), weights))
    ref = jr.ransac_fit(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), 2.0, key,
                        num_hypotheses=n_hyps, transformation=transformation)
    ours = tr.ransac_fit(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid), 2.0,
                         num_hypotheses=n_hyps, transformation=transformation,
                         sample_idx=torch.from_numpy(idx).long())
    h_close(ours.h_matrix.numpy(), ref.h_matrix)
    np.testing.assert_array_equal(ours.inliers.numpy(), np.asarray(ref.inliers))
    assert int(ours.num_inliers) == int(ref.num_inliers) > 50
    # the port's weights and inverse-CDF draw reproduce JAX's indices from
    # the same uniforms
    u = np.array(jax.random.uniform(key, (n_hyps, sample_size)))
    np.testing.assert_array_equal(
        tr.indices_from_uniform(torch.from_numpy(u), tr.sample_weights(torch.from_numpy(valid))).numpy(),
        idx,
    )


def test_ransac_batched_and_generator():
    data = [correspondences(s) for s in (5, 6)]
    src = torch.from_numpy(np.stack([d[0] for d in data]))
    dst = torch.from_numpy(np.stack([d[1] for d in data]))
    valid = torch.from_numpy(np.stack([d[2] for d in data]))
    keys = prng.fold_in(prng.PRNGKey(0), [5, 6])
    idx = tr.sample_indices(keys, 256, 4, tr.sample_weights(valid))
    batch = tr.ransac_fit(src, dst, valid, 2.0, num_hypotheses=256, sample_idx=idx)
    for i, (_, _, _, h_true) in enumerate(data):
        one = tr.ransac_fit(src[i], dst[i], valid[i], 2.0, num_hypotheses=256, sample_idx=idx[i])
        np.testing.assert_allclose(batch.h_matrix[i].numpy(), one.h_matrix.numpy(), rtol=1e-5, atol=1e-6)
        corners = np.array([[20, 20, 1], [380, 380, 1.0]])
        a = corners @ batch.h_matrix[i].numpy().astype(np.float64).T
        b = corners @ h_true.T
        assert np.abs(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).max() < 1.0
    # drawing from the keys gives what the drawn indices give
    drawn = tr.ransac_fit(src, dst, valid, 2.0, key=keys, num_hypotheses=256)
    torch.testing.assert_close(drawn.h_matrix, batch.h_matrix, rtol=0, atol=0)
    again = tr.ransac_fit(src[0], dst[0], valid[0], 2.0, key=prng.fold_in(prng.PRNGKey(0), 9),
                          num_hypotheses=256)
    twice = tr.ransac_fit(src[0], dst[0], valid[0], 2.0, key=prng.fold_in(prng.PRNGKey(0), 9),
                          num_hypotheses=256)
    torch.testing.assert_close(again.h_matrix, twice.h_matrix, rtol=0, atol=0)


def degenerate_case(name, n=60):
    """Correspondences on which the refinement's weighted system is
    underdetermined or NaN: (src, dst, valid, (64, 4) hypothesis indices).
    ``three soft inliers``: every hypothesis is the exact fit of points 0-3,
    of which 3 is not valid and the rest of dst is noise; ``every sample
    degenerate``: three valid points, so every draw repeats one; ``nan
    correspondence``: a valid point's src is NaN, half the points inliers."""
    src, dst, valid, _ = correspondences(11, n=n, outliers=0.0)
    rng = np.random.default_rng(12)
    idx = None
    if name == "three soft inliers":
        dst[4:] = rng.uniform(0, 400, (n - 4, 2))
        valid[:] = True
        valid[3] = False
        idx = np.tile(np.arange(4), (64, 1))
    elif name == "every sample degenerate":
        valid[:] = False
        valid[:3] = True
    else:
        valid[:] = True
        dst[30:] = rng.uniform(0, 400, (n - 30, 2))
        src[5] = np.nan
    if idx is None:
        idx = tr.sample_indices(np.asarray(prng.fold_in(prng.PRNGKey(0), 3))[None], 64, 4,
                                tr.sample_weights(torch.from_numpy(valid)[None]))[0].numpy()
    return src, dst, valid, idx


@pytest.mark.parametrize("name", ["three soft inliers", "every sample degenerate",
                                  "nan correspondence"])
def test_ransac_degenerate_refit_does_not_depend_on_rounding(name):
    """With fewer soft inliers than a minimal sample the refinement keeps
    the incumbent hypothesis (the weighted system's eigenvector is then any
    vector of its null space), so the result is the same on the
    correspondences in another order, whose sums round differently as
    another device's do; and a NaN correspondence raises nothing."""
    src, dst, valid, idx = degenerate_case(name)
    perm = np.random.default_rng(5).permutation(len(src))

    def fit(order):
        return tr.ransac_fit(torch.from_numpy(src[order]), torch.from_numpy(dst[order]),
                             torch.from_numpy(valid[order]), 2.0, num_hypotheses=64,
                             sample_idx=torch.from_numpy(np.argsort(order)[idx]).long())

    one, other = fit(np.arange(len(src))), fit(perm)
    h_close(other.h_matrix.numpy(), one.h_matrix.numpy())
    np.testing.assert_array_equal(other.inliers.numpy(), one.inliers.numpy()[perm])
    if name == "three soft inliers":
        assert int(one.num_inliers) == 3
        minimal = th.normalize_h(th.fit_homography_minimal(torch.from_numpy(src[:4]),
                                                           torch.from_numpy(dst[:4])))
        h_close(one.h_matrix.numpy(), minimal.numpy())
    elif name == "every sample degenerate":
        assert int(one.num_inliers) <= 3
    else:
        assert int(one.num_inliers) >= 15 and torch.isfinite(one.h_matrix).all()


def test_ransac_nan_correspondence_equals_the_reference():
    """A NaN correspondence (valid) makes every refit NaN, which the
    reference and the port both turn down: the same homography and inliers
    from JAX's draws."""
    src, dst, valid, _ = degenerate_case("nan correspondence")
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    weights = jnp.asarray(valid, jnp.float32) / valid.sum()
    idx = np.array(jr._sample_indices(key, 256, 4, len(src), weights))
    ref = jr.ransac_fit(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), 2.0, key,
                        num_hypotheses=256)
    ours = tr.ransac_fit(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                         2.0, num_hypotheses=256, sample_idx=torch.from_numpy(idx).long())
    h_close(ours.h_matrix.numpy(), ref.h_matrix)
    np.testing.assert_array_equal(ours.inliers.numpy(), np.asarray(ref.inliers))
    assert int(ours.num_inliers) == int(ref.num_inliers) >= 15
