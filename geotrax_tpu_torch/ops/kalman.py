"""Constant-velocity Kalman filters for multi-object tracking.

Counterpart of ``geotrax_tpu/ops/kalman.py``. Two state parameterizations:

- XYAH (ByteTrack lineage): state [cx, cy, a(=w/h), h, vx, vy, va, vh]
- XYWH (BoT-SORT lineage):  state [cx, cy, w, h, vx, vy, vw, vh]

The motion model advances each coordinate independently and the noises are
diagonal, so the 8x8 covariance stays four independent 2x2 (pos, vel)
blocks; the filter carries it as (..., 4, 3) = per-coordinate
[p_xx, p_xv, p_vv] and every step is closed-form elementwise math over all
track slots at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

STD_POS = 1.0 / 20.0
STD_VEL = 1.0 / 160.0

COV_DIM = 3  # [p_xx, p_xv, p_vv] per coordinate


class KFState(NamedTuple):
    mean: torch.Tensor  # (..., 8)
    cov: torch.Tensor   # (..., 4, 3) per-coordinate [p_xx, p_xv, p_vv]


def _noise_stds(mean: torch.Tensor, fmt: str) -> tuple:
    """Per-coordinate (position std, velocity std) base scales (..., 4)."""
    if fmt == "xyah":
        h = mean[..., 3]
        pos = torch.stack([h, h, torch.zeros_like(h), h], dim=-1)
        std_pos = STD_POS * pos
        std_pos[..., 2] = 1e-2
        std_vel = STD_VEL * pos
        std_vel[..., 2] = 1e-5
    else:
        w, h = mean[..., 2], mean[..., 3]
        scale = torch.stack([w, h, w, h], dim=-1)
        std_pos = STD_POS * scale
        std_vel = STD_VEL * scale
    return std_pos, std_vel


def _measurement_std(mean: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "xyah":
        h = mean[..., 3]
        std = STD_POS * torch.stack([h, h, torch.zeros_like(h), h], dim=-1)
        std[..., 2] = 1e-1
        return std
    w, h = mean[..., 2], mean[..., 3]
    return STD_POS * torch.stack([w, h, w, h], dim=-1)


def initiate(measurement: torch.Tensor, fmt: str = "xyah") -> KFState:
    """New-track state from a first measurement (..., 4). Velocities start at
    0 with inflated uncertainty (2x position / 10x velocity std)."""
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    std_pos, std_vel = _noise_stds(mean, fmt)
    p_xx = (2 * std_pos) ** 2
    p_vv = (10 * std_vel) ** 2
    if fmt == "xyah":
        # the aspect channel's init stds are the fixed constants 1e-2 / 1e-5
        p_xx[..., 2] = 1e-4
        p_vv[..., 2] = 1e-10
    cov = torch.stack([p_xx, torch.zeros_like(std_pos), p_vv], dim=-1)
    return KFState(mean, cov)


def predict(state: KFState, fmt: str = "xyah", dt: float = 1.0) -> KFState:
    """Time update x <- F x, P <- F P F' + Q, in per-coordinate closed form:
    x += dt*v;  p_xx += dt*(2 p_xv + dt*p_vv) + q_x;  p_xv += dt*p_vv;
    p_vv += q_v."""
    x, v = state.mean[..., :4], state.mean[..., 4:]
    mean = torch.cat([x + dt * v, v], dim=-1)
    std_pos, std_vel = _noise_stds(state.mean, fmt)
    p_xx = state.cov[..., 0]
    p_xv = state.cov[..., 1]
    p_vv = state.cov[..., 2]
    cov = torch.stack([
        p_xx + dt * (2.0 * p_xv + dt * p_vv) + std_pos ** 2,
        p_xv + dt * p_vv,
        p_vv + std_vel ** 2,
    ], dim=-1)
    return KFState(mean, cov)


def update(state: KFState, measurement: torch.Tensor, fmt: str = "xyah") -> KFState:
    """Measurement update with H = [I4 0] in per-coordinate closed form:
    s = p_xx + r;  K = [p_xx, p_xv]/s;  standard covariance downdate."""
    r = _measurement_std(state.mean, fmt) ** 2
    p_xx = state.cov[..., 0]
    p_xv = state.cov[..., 1]
    p_vv = state.cov[..., 2]
    s = p_xx + r
    k_x = p_xx / s
    k_v = p_xv / s
    innov = measurement - state.mean[..., :4]
    x = state.mean[..., :4] + k_x * innov
    v = state.mean[..., 4:] + k_v * innov
    cov = torch.stack([
        (1.0 - k_x) * p_xx,
        (1.0 - k_x) * p_xv,
        p_vv - k_v * p_xv,
    ], dim=-1)
    return KFState(torch.cat([x, v], dim=-1), cov)


def gating_distance(state: KFState, measurements: torch.Tensor,
                    fmt: str = "xyah") -> torch.Tensor:
    """Squared Mahalanobis distance of (..., M, 4) measurements to the
    predicted measurement distribution (diagonal innovation covariance)."""
    r = _measurement_std(state.mean, fmt) ** 2
    s = state.cov[..., 0] + r                       # (..., 4)
    d = measurements - state.mean[..., None, :4]    # (..., M, 4)
    return torch.sum(d * d / s[..., None, :], dim=-1)


def measurement_from_xywh(boxes_xywh: torch.Tensor, fmt: str = "xyah") -> torch.Tensor:
    """Convert pipeline boxes (cx,cy,w,h) to the filter's measurement space."""
    if fmt == "xyah":
        cx, cy, w, h = boxes_xywh.unbind(-1)
        return torch.stack([cx, cy, w / torch.clamp_min(h, 1e-6), h], dim=-1)
    return boxes_xywh


def xywh_from_state(mean: torch.Tensor, fmt: str = "xyah") -> torch.Tensor:
    """Filter state -> pipeline boxes (cx,cy,w,h)."""
    if fmt == "xyah":
        cx, cy, a, h = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
        return torch.stack([cx, cy, a * h, h], dim=-1)
    return mean[..., :4]
