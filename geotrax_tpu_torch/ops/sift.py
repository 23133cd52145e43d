"""L2 descriptor matching: the port of ``geotrax_tpu/ops/sift.py:match_l2``.

The rest of the JAX module (the RootSIFT scale space that georeferencing
uses) waits for a later slice of the port (ROADMAP A12).
"""

from __future__ import annotations

import torch

from geotrax_tpu_torch.ops.features import Matches


def match_l2(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
             valid_b: torch.Tensor, ratio: float = 0.55, block: int = 4096) -> Matches:
    """L2 matching with Lowe ratio + mutual cross-check.

    ``desc_a`` (..., Ka, T) against ``desc_b`` (..., Kb, T) (leading axes
    broadcast). Distances are squared: sqrt is monotonic, so the argmins, the
    mutual check and the ratio test (against ratio² · second²) decide as on
    distances. Invalid rows and columns get +1e9 on their squared norms, so
    every one of their distances passes the sentinel. A rows are processed
    ``block`` at a time to bound the (block, Kb) distance tile; ties in the
    column minimum go to the earlier row, as in the reference's running best.
    The product is plain float32 (``torch.matmul``; the port turns TF32
    off on the card)."""
    ka = desc_a.shape[-2]
    big = 1e9
    nb2 = torch.sum(desc_b * desc_b, dim=-1) + torch.where(valid_b, 0.0, big)
    na2_all = torch.sum(desc_a * desc_a, dim=-1) + torch.where(valid_a, 0.0, big)
    lead = torch.broadcast_shapes(desc_a.shape[:-2], desc_b.shape[:-2])
    kb = desc_b.shape[-2]
    dev = desc_a.device

    best_parts, second_parts, idx_parts = [], [], []
    b_best = torch.full(lead + (kb,), big, device=dev)
    b_row = torch.full(lead + (kb,), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(kb, device=dev)
    for start in range(0, ka, block):
        a = desc_a[..., start:start + block, :]
        na2 = na2_all[..., start:start + block]
        dots = torch.matmul(a, desc_b.transpose(-1, -2))
        d2 = torch.clamp_min(na2[..., :, None] + nb2[..., None, :] - 2.0 * dots, 0.0)

        best = d2.amin(dim=-1)
        best_idx = torch.argmin(d2, dim=-1)
        second = torch.where(cols == best_idx[..., None], big, d2).amin(dim=-1)

        col_best = d2.amin(dim=-2)
        col_row = torch.argmin(d2, dim=-2) + start
        better = col_best < b_best
        b_best = torch.where(better, col_best, b_best)
        b_row = torch.where(better, col_row, b_row)
        best_parts.append(best)
        second_parts.append(second)
        idx_parts.append(best_idx)

    best = torch.cat(best_parts, dim=-1)
    second = torch.cat(second_parts, dim=-1)
    best_idx = torch.cat(idx_parts, dim=-1)
    rows = torch.arange(ka, device=dev)
    ratio_ok = best < (ratio * ratio) * second
    mutual = torch.gather(b_row, -1, best_idx) == rows
    valid = valid_a & ratio_ok & mutual & (best < big / 2)
    return Matches(idx_a=rows.expand(best_idx.shape), idx_b=best_idx, valid=valid)
