"""Projective geometry: point transforms and homography estimation.

Counterpart of ``geotrax_tpu/ops/homography.py``: applying a 3x3 homography
is multiply-adds and a divide; fitting one is a normalized DLT, solved by an
SVD (N-point), the 9x9 normal equations (weighted refinement) or the
closed-form projective-basis method (4-point RANSAC hypotheses). The small
3x3 products stay unrolled elementwise, as in the reference, so their
float32 rounding is the same.
"""

from __future__ import annotations

import numpy as np
import torch

_SQRT2 = float(np.sqrt(np.float32(2.0)))


def apply_homography(h: torch.Tensor, points: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Transform (..., N, 2) points by (..., 3, 3) homographies."""
    x, y = points[..., 0], points[..., 1]
    hb = h[..., None, :, :]  # broadcast over the points axis
    mx = hb[..., 0, 0] * x + hb[..., 0, 1] * y + hb[..., 0, 2]
    my = hb[..., 1, 0] * x + hb[..., 1, 1] * y + hb[..., 1, 2]
    mw = hb[..., 2, 0] * x + hb[..., 2, 1] * y + hb[..., 2, 2]
    return torch.stack([mx, my], dim=-1) / (mw[..., None] + eps)


def invert_homography(h: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(h)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3) as unrolled elementwise math."""
    rows = []
    for i in range(3):
        cols = []
        for j in range(3):
            cols.append(a[..., i, 0] * b[..., 0, j]
                        + a[..., i, 1] * b[..., 1, j]
                        + a[..., i, 2] * b[..., 2, j])
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3) without a matrix product (see matmul3)."""
    return torch.stack([
        m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1] + m[..., i, 2] * v[..., 2]
        for i in range(3)
    ], dim=-1)


def compose(h_outer: torch.Tensor, h_inner: torch.Tensor) -> torch.Tensor:
    """Composition: apply h_inner first, then h_outer."""
    return h_outer @ h_inner


def normalize_h(h: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return h / (h[..., 2:3, 2:3] + eps)


def _normalization_transform(points: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Hartley normalization: translate centroid to origin, scale mean
    distance to sqrt(2). points: (..., N, 2) -> (..., 3, 3)."""
    centroid = points.mean(dim=-2, keepdim=True)
    dist = torch.linalg.vector_norm(points - centroid, dim=-1).mean(dim=-1)
    scale = torch.full_like(dist, _SQRT2) / (dist + eps)
    t = torch.zeros(points.shape[:-2] + (3, 3), dtype=points.dtype, device=points.device)
    t[..., 0, 0] = scale
    t[..., 1, 1] = scale
    t[..., 0, 2] = -scale * centroid[..., 0, 0]
    t[..., 1, 2] = -scale * centroid[..., 0, 1]
    t[..., 2, 2] = 1.0
    return t


def _dlt_rows(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(..., 2N, 9) DLT system of normalized correspondences."""
    x, y = s[..., 0], s[..., 1]
    u, v = d[..., 0], d[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    row2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    return torch.cat([row1, row2], dim=-2)


def fit_homography(src: torch.Tensor, dst: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized DLT homography fit from (..., N, 2) correspondences, N >= 4:
    the smallest right singular vector of A. Returns (..., 3, 3) with
    h[2,2] = 1."""
    t_src = _normalization_transform(src)
    t_dst = _normalization_transform(dst)
    a = _dlt_rows(apply_homography(t_src, src), apply_homography(t_dst, dst))
    if weights is not None:
        w = torch.cat([weights, weights], dim=-1)[..., None]
        a = a * torch.sqrt(torch.clamp_min(w, 0.0))
    # full_matrices only for the minimal 8x9 system, whose null vector is
    # absent from the thin V
    _, _, vt = torch.linalg.svd(a, full_matrices=a.shape[-2] < 9)
    h_norm = vt[..., -1, :].reshape(src.shape[:-2] + (3, 3))
    h = _sim_inverse(t_dst) @ h_norm @ t_src
    return normalize_h(h)


def adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate of (..., 3, 3): adj(M) @ M = det(M) I. For
    projective entities (defined up to scale) it is the inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)


def _sim_inverse(t: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a Hartley transform [[s,0,tx],[0,s,ty],[0,0,1]]."""
    s = t[..., 0, 0]
    inv_s = 1.0 / s
    out = torch.zeros_like(t)
    out[..., 0, 0] = inv_s
    out[..., 1, 1] = inv_s
    out[..., 0, 2] = -t[..., 0, 2] * inv_s
    out[..., 1, 2] = -t[..., 1, 2] * inv_s
    out[..., 2, 2] = 1.0
    return out


def _projective_basis(points4: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) -> (..., 3, 3) transform B mapping the canonical projective
    basis e1,e2,e3,(1,1,1) to the four points: B = [p1 p2 p3] diag(v) with
    v ∝ [p1 p2 p3]^-1 p4 (scale-free via the adjugate)."""
    p = torch.cat([points4, torch.ones_like(points4[..., :1])], -1)  # (...,4,3)
    m = torch.stack([p[..., 0, :], p[..., 1, :], p[..., 2, :]], -1)  # columns
    v = matvec3(adjugate3(m), p[..., 3, :])
    return m * v[..., None, :]


# Inverse iteration of smallest_eigenvector. Its shift, relative to the
# trace, is far below the second eigenvalue of AᵀWA (1.5e-6 of the trace and
# up on the refinement systems of a 256x160 synthetic clip, more on larger
# frames) and keeps the shifted matrix regular; a step shrinks the other
# directions by the ratio of the smallest eigenvalue's size (float32 rounding
# or the fit's residual) to the second, 7e-2 at worst on those systems.
EIG_SHIFT = 1e-10
EIG_STEPS = 10


def smallest_eigenvector(m: torch.Tensor) -> torch.Tensor:
    """(..., n, n) symmetric positive semi-definite matrices (their lower
    triangles, as eigh reads them) -> (..., n) unit eigenvectors of their
    smallest eigenvalues (sign arbitrary), by EIG_STEPS steps of inverse
    iteration on an LU factor of m scaled to unit trace plus EIG_SHIFT * I
    (LU, not Cholesky: float32 rounding can leave the smallest eigenvalue
    below -EIG_SHIFT). Unlike ``torch.linalg.eigh``, which reads its error
    flags back to the host (and raises on a NaN), nothing here waits for
    the card. It agrees with eigh to rounding where the second eigenvalue
    is well above the smallest; a NaN matrix gives a NaN vector, a zero
    matrix the start vector."""
    n = m.shape[-1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    m = torch.tril(m) + torch.tril(m, diagonal=-1).mT
    trace = torch.diagonal(m, dim1=-2, dim2=-1).sum(dim=-1)
    m = m / torch.clamp_min(trace, torch.finfo(m.dtype).tiny)[..., None, None]
    # unpacked: lu_solve checks its pivots on the host
    perm, lower, upper = torch.lu_unpack(*torch.linalg.lu_factor_ex(m + EIG_SHIFT * eye)[:2])
    v = torch.full(m.shape[:-1] + (1,), n ** -0.5, dtype=m.dtype, device=m.device)
    for _ in range(EIG_STEPS):
        y = torch.linalg.solve_triangular(lower, perm.mT @ v, upper=False, unitriangular=True)
        v = torch.linalg.solve_triangular(upper, y, upper=True)
        v = v / torch.linalg.vector_norm(v, dim=-2, keepdim=True)
    return v[..., 0]


def fit_homography_normal(src: torch.Tensor, dst: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted DLT via the 9x9 normal equations: h = the eigenvector of
    AᵀWA with the smallest eigenvalue (Hartley normalization keeps the
    squared condition number small).

    AᵀWA is formed in float32 as in the reference, and its 9x9 eigenproblem
    is solved in float64: a float32 solve's smallest eigenvector depends on
    the eigensolver to ~1e-2 px of translation on near-exact integer
    correspondences (two float32 LAPACK builds disagree by that much), and
    the float64 solve removes that dependence at a negligible cost. The
    eigenvector is ``smallest_eigenvector``'s on every device (the
    reference takes eigh's, which on the card reads back)."""
    t_src = _normalization_transform(src)
    t_dst = _normalization_transform(dst)
    a = _dlt_rows(apply_homography(t_src, src), apply_homography(t_dst, dst))
    if weights is not None:
        w = torch.cat([weights, weights], dim=-1)[..., None]
        a = a * torch.sqrt(torch.clamp_min(w, 0.0))
    ata = torch.matmul(a.transpose(-1, -2), a)
    h_norm = smallest_eigenvector(ata.double()).to(ata.dtype).reshape(src.shape[:-2] + (3, 3))
    h = _sim_inverse(t_dst) @ h_norm @ t_src
    return normalize_h(h)


def fit_homography_minimal(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact 4-point homography via the projective-basis method:
    H = B_dst adj(B_src), closed-form 3x3 algebra. Degenerate (collinear)
    samples give a wild H that scores as an outlier downstream."""
    t_src = _normalization_transform(src)
    t_dst = _normalization_transform(dst)
    s = apply_homography(t_src, src)
    d = apply_homography(t_dst, dst)
    b_src = _projective_basis(s)
    b_dst = _projective_basis(d)
    h_norm = matmul3(b_dst, adjugate3(b_src))
    h = matmul3(matmul3(_sim_inverse(t_dst), h_norm), t_src)
    return normalize_h(h)


def fit_affine(src: torch.Tensor, dst: torch.Tensor,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares affine fit from (..., N, 2) correspondences, N >= 3,
    returned as a 3x3 homography with last row [0, 0, 1]."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype, device=src.device)
    a = torch.cat([src, ones], dim=-1)  # (..., N, 3)
    aw = a if weights is None else a * torch.clamp_min(weights, 0.0)[..., None]
    ata = torch.matmul(aw.transpose(-1, -2), a)
    atb = torch.matmul(aw.transpose(-1, -2), dst)
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    # a degenerate sample gives a singular system: like the reference's
    # solve, return what the factorization gives (inf/NaN, scored as an
    # infinite error) instead of raising
    sol = torch.linalg.solve_ex(ata + 1e-9 * eye, atb, check_errors=False)[0]  # (..., 3, 2)
    h = torch.zeros(src.shape[:-2] + (3, 3), dtype=src.dtype, device=src.device)
    h[..., :2, :] = sol.transpose(-1, -2)
    h[..., 2, 2] = 1.0
    return h


def reprojection_error(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Per-point Euclidean reprojection error (..., N)."""
    return torch.linalg.vector_norm(apply_homography(h, src) - dst, dim=-1)
