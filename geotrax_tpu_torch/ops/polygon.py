"""Point-in-polygon tests on tensors: the port of ``geotrax_tpu/ops/polygon.py``.

Lane assignment tests N points against M four-corner lane polygons with a
crossing-number (even-odd) ray cast to +x, in float32 with the reference's
operations, so that the hits are the reference's. ``assign_first_polygon``
runs over chunks of points: at Songdo scale (1.8M rows) N x M x 4 edges do
not fit as one broadcast.
"""

from __future__ import annotations

import torch

CHUNK_POINTS = 1 << 16


def points_in_polygons(points: torch.Tensor, polygons: torch.Tensor,
                       eps: float = 1e-12) -> torch.Tensor:
    """(N,2) points x (M,K,2) closed polygons -> (N,M) bool containment."""
    px = points[:, None, None, 0]
    py = points[:, None, None, 1]
    x1 = polygons[None, :, :, 0]
    y1 = polygons[None, :, :, 1]
    x2 = torch.roll(polygons[..., 0], -1, dims=-1)[None]
    y2 = torch.roll(polygons[..., 1], -1, dims=-1)[None]

    straddles = (y1 > py) != (y2 > py)
    dy = y2 - y1
    x_at_y = x1 + (py - y1) * (x2 - x1) / torch.where(torch.abs(dy) < eps, eps, dy)
    crossings = torch.sum(straddles & (px < x_at_y), dim=-1)
    return (crossings % 2) == 1


def assign_first_polygon(points: torch.Tensor, polygons: torch.Tensor,
                         chunk: int = CHUNK_POINTS) -> torch.Tensor:
    """(N,) int64 index of the first polygon (in polygon order) containing
    each point, -1 where none does."""
    out = []
    for start in range(0, points.shape[0], chunk):
        inside = points_in_polygons(points[start:start + chunk], polygons)  # (n,M)
        first = torch.argmax(inside.to(torch.uint8), dim=1)
        out.append(torch.where(inside.any(dim=1), first, -1))
    if not out:
        return torch.empty((0,), dtype=torch.int64, device=points.device)
    return torch.cat(out)
