"""Contrast-Limited Adaptive Histogram Equalization.

Counterpart of ``geotrax_tpu/ops/clahe.py`` (``stabilo.clahe``, on in the
``stable`` preset), in plain tensor operations over a batch of grays: the
image is padded symmetrically to whole tiles of a ``tiles`` x ``tiles``
grid, each tile's 256-bin histogram is clipped at ``clip_limit`` times the
mean bin count with the excess spread evenly over the bins, its CDF becomes
the tile's mapping, and each pixel blends the mappings of its four
surrounding tile centres bilinearly. The histograms count exactly; the CDF
is summed in the reference's order (``ransac.cumsum_xla``); the blend is
float32 as in the reference.
"""

from __future__ import annotations

import torch

from geotrax_tpu_torch.ops.ransac import cumsum_xla


def _pad_symmetric(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad the last two axes at their ends by mirroring, edge included
    (numpy's "symmetric")."""
    if pad_h:
        x = torch.cat([x, x.flip(-2)[..., :pad_h, :]], dim=-2)
    if pad_w:
        x = torch.cat([x, x.flip(-1)[..., :pad_w]], dim=-1)
    return x


def clahe(gray: torch.Tensor, tiles: int = 8, clip_limit: float = 2.0,
          n_bins: int = 256) -> torch.Tensor:
    """(..., H, W) float or uint8 gray in [0, 255] -> equalized float32 of
    the same shape."""
    lead, (h, w) = gray.shape[:-2], gray.shape[-2:]
    g = gray.to(torch.float32).reshape((-1, h, w))
    b, dev = g.shape[0], g.device
    tile_h, tile_w = -(-h // tiles), -(-w // tiles)
    padded = _pad_symmetric(g, tile_h * tiles - h, tile_w * tiles - w)
    ph, pw = padded.shape[-2:]
    bins = torch.clamp(padded.to(torch.int32), 0, n_bins - 1).long()

    # per-tile histograms: one bincount over (image, tile, bin) ids
    rows = torch.arange(ph, device=dev) // tile_h
    cols = torch.arange(pw, device=dev) // tile_w
    tile_id = rows[:, None] * tiles + cols[None, :]
    image_id = torch.arange(b, device=dev)[:, None, None] * (tiles * tiles)
    ids = ((image_id + tile_id) * n_bins + bins).reshape(-1)
    hist = torch.bincount(ids, minlength=b * tiles * tiles * n_bins).to(torch.float32)
    hist = hist.reshape(b, tiles * tiles, n_bins)
    del ids

    # clip + uniform redistribution of the excess
    limit = clip_limit * (tile_h * tile_w) / n_bins
    excess = torch.sum(torch.clamp_min(hist - limit, 0.0), dim=-1, keepdim=True)
    hist = torch.clamp_max(hist, limit) + excess / n_bins

    cdf = cumsum_xla(hist)
    cdf = cdf / cdf[..., -1:]
    mapping = (cdf * (n_bins - 1)).reshape(-1)

    # bilinear blend of the 4 surrounding tile mappings
    ty = (torch.arange(ph, dtype=torch.float32, device=dev) - tile_h / 2.0) / tile_h
    tx = (torch.arange(pw, dtype=torch.float32, device=dev) - tile_w / 2.0) / tile_w
    y0 = torch.clamp(torch.floor(ty), 0, tiles - 1).long()
    x0 = torch.clamp(torch.floor(tx), 0, tiles - 1).long()
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    fy = torch.clamp(ty - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(tx - x0, 0.0, 1.0)[None, :]

    def m(yy, xx):
        return mapping[((image_id + yy[:, None] * tiles + xx[None, :]) * n_bins + bins)]

    out = (m(y0, x0) * (1 - fy) * (1 - fx) + m(y0, x1) * (1 - fy) * fx
           + m(y1, x0) * fy * (1 - fx) + m(y1, x1) * fy * fx)
    return out[:, :h, :w].reshape(lead + (h, w))
