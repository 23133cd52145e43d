"""Massively-parallel robust homography estimation (RANSAC / MAGSAC-style).

Counterpart of ``geotrax_tpu/ops/ransac.py:ransac_fit``: thousands of
minimal-sample hypotheses are fitted and scored at once (closed-form 4-point
fits + one reprojection-error matrix), the best by a soft (sigma-marginalized
flavor) score is polished by IRLS on its soft inliers. Takes one frame's
correspondences or a batch (leading axis).

Sampling draws what the reference draws: ``key`` is a JAX-format threefry
key (``ops/prng.py``, e.g. ``fold_in(PRNGKey(seed), frame_id)``), its
uniforms are made on the host and turned into indices by the reference's
inverse CDF, with the weights' prefix sum taken in the order XLA takes it
(``cumsum_xla``), so the indices equal the reference's bit for bit.
``ransac_fit`` also takes the hypothesis indices (``sample_idx``) directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from geotrax_tpu_torch._device import to_device
from geotrax_tpu_torch.ops import prng
from geotrax_tpu_torch.ops.homography import (
    fit_affine,
    fit_homography_minimal,
    fit_homography_normal,
    normalize_h,
    reprojection_error,
)


class RansacResult(NamedTuple):
    h_matrix: torch.Tensor     # (..., 3, 3)
    inliers: torch.Tensor      # (..., N) bool
    num_inliers: torch.Tensor  # (...,) int
    score: torch.Tensor        # (...,) soft inlier score


def sample_weights(valid: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> sampling weights summing to 1: uniform over the valid
    correspondences, or over all when none is valid (keeps the fit NaN-free;
    callers gate on the match count)."""
    weights = valid.to(torch.float32)
    total = weights.sum(dim=-1, keepdim=True)
    weights = torch.where(total > 0, weights, torch.ones_like(weights))
    return weights / torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1.0)


# XLA's CPU backend rewrites a cumulative sum into blocks of this many
# elements (see cumsum_xla).
_SCAN_BLOCK = 16


def _prefix_sequential(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, added strictly left to
    right from 0 (one elementwise add per column, exact on any device)."""
    acc = x[..., 0] + 0.0
    cols = [acc]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along the last axis in the order in which
    the reference's ``jnp.cumsum`` adds on the CPU: XLA pads the axis with
    zeros to whole blocks of 16 and sums each block left to right, takes
    the prefix sums of the blocks' totals the same way (recursively, down
    to one block), and adds to each block the total of the blocks before
    it. Sums taken in another order (``torch.cumsum``, on either device)
    differ in the last bits, enough to move an inverse-CDF boundary."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _prefix_sequential(x)
    m = -(-n // _SCAN_BLOCK)
    lead = x.shape[:-1]
    blocks = _prefix_sequential(F.pad(x, (0, m * _SCAN_BLOCK - n)).reshape(lead + (m, _SCAN_BLOCK)))
    before = F.pad(cumsum_xla(blocks[..., -1])[..., :-1], (1, 0))
    return (blocks + before[..., None]).reshape(lead + (m * _SCAN_BLOCK,))[..., :n]


def indices_from_uniform(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw WITH replacement: (..., H, S) uniforms in [0, 1) and
    (..., N) weights -> (..., H, S) indices (the reference's searchsorted)."""
    n = weights.shape[-1]
    cum = cumsum_xla(weights)
    lead = cum.shape[:-1]
    scaled = (u * cum[..., -1:, None]).reshape(lead + (-1,))
    idx = torch.searchsorted(cum.contiguous(), scaled.contiguous())
    return torch.clamp(idx, 0, n - 1).reshape(u.shape)


def sample_indices(keys, num_hypotheses: int, sample_size: int,
                   weights: torch.Tensor) -> torch.Tensor:
    """(B, H, S) random correspondence indices for (B, N) weights, frame
    ``b`` drawing ``uniform(keys[b], (H, S))`` (``ops/prng.py``) as the
    reference's ``_sample_indices`` does. The uniforms are made on the host
    and move to the weights' device in one copy, which does not wait for
    the card."""
    u = prng.uniform(np.asarray(keys, np.uint32), (num_hypotheses, sample_size))
    return indices_from_uniform(to_device(u, weights.device), weights)


def _gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) gathered at (B, H, S) -> (B, H, S, 2)."""
    b, h, s = idx.shape
    flat = idx.reshape(b, h * s, 1).expand(b, h * s, 2)
    return torch.gather(points, 1, flat).reshape(b, h, s, 2)


def ransac_fit(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
               threshold: float, key=None,
               num_hypotheses: int = 2048, transformation: str = "projective",
               refine_iters: int = 3, sample_idx: torch.Tensor | None = None) -> RansacResult:
    """Robust fit of dst ≈ H @ src over (..., N, 2) correspondences with a
    (..., N) mask. ``threshold`` is the inlier reprojection error [px], used
    as the soft score's scale. Hypothesis indices come from ``sample_idx``
    ((..., H, S)) when given, else they are drawn from ``key``: a (2,)
    threefry key (``ops/prng.py``) for one frame or for every frame of the
    batch, or one (B, 2) key per frame."""
    single = src.dim() == 2
    if single:
        src, dst, valid = src[None], dst[None], valid[None]
        if sample_idx is not None:
            sample_idx = sample_idx[None]
    b, n = valid.shape
    sample_size = 4 if transformation == "projective" else 3
    hyp_fit = fit_homography_minimal if transformation == "projective" else fit_affine
    fit_fn = fit_homography_normal if transformation == "projective" else fit_affine

    if sample_idx is None:
        if key is None:
            raise ValueError("ransac_fit needs a key or sample_idx")
        keys = np.broadcast_to(np.asarray(key, np.uint32), (b, 2))
        sample_idx = sample_indices(keys, num_hypotheses, sample_size, sample_weights(valid))
    hyps = hyp_fit(_gather_points(src, sample_idx), _gather_points(dst, sample_idx))  # (B,H,3,3)

    # Score every hypothesis against every correspondence; degenerate
    # minimal samples give NaN/Inf errors, scored as infinite error.
    inf = float("inf")
    errors = reprojection_error(hyps, src[:, None], dst[:, None])  # (B,H,N)
    errors = torch.where(torch.isfinite(errors), errors, inf)
    errors = torch.where(valid[:, None, :], errors, inf)
    soft = torch.clamp_min(1.0 - (errors / threshold) ** 2, 0.0)
    scores = soft.sum(dim=-1)
    best = torch.argmax(scores, dim=-1)
    h_best = hyps[torch.arange(b, device=hyps.device), best]

    def score_of(hm):
        e = torch.where(valid, reprojection_error(hm, src, dst), inf)
        e = torch.where(torch.isfinite(e), e, inf)
        return torch.clamp_min(1.0 - (e / threshold) ** 2, 0.0).sum(dim=-1)

    # Local optimization: IRLS refit on soft inliers of the incumbent model.
    # With fewer soft inliers than a minimal sample the weighted system has
    # no unique solution (the reference's refit is then whichever vector of
    # the null space rounding picks), so the incumbent stays.
    h = h_best
    for _ in range(refine_iters):
        err = reprojection_error(h, src, dst)
        err = torch.where(torch.isfinite(err), err, inf)
        w = torch.where(valid, torch.clamp_min(1.0 - (err / threshold) ** 2, 0.0), 0.0)
        h_new = fit_fn(src, dst, weights=w)
        posed = (w > 0).sum(dim=-1) >= sample_size
        better = posed & (score_of(h_new) >= score_of(h))
        h = torch.where(better[:, None, None], h_new, h)
    h_final = normalize_h(h)

    err_final = reprojection_error(h_final, src, dst)
    inliers = valid & (err_final < threshold)
    soft_final = torch.where(valid, torch.clamp_min(1.0 - (err_final / threshold) ** 2, 0.0), 0.0)
    result = RansacResult(h_final, inliers, inliers.sum(dim=-1), soft_final.sum(dim=-1))
    if single:
        return RansacResult(*(t[0] for t in result))
    return result
