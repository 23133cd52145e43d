"""Top-k selection with ``jax.lax.top_k``'s order.

Counterpart of ``geotrax_tpu/ops/topk.py`` as it behaves off the TPU, where
both helpers are the exact ``lax.top_k``: values in descending order, and
among equal values the lower index first. FAST scores and thresholded
detection scores tie often (every non-corner scores 0), and ``torch.topk``
leaves the order of ties unspecified, so both helpers take the first k of a
stable descending sort.
"""

from __future__ import annotations

import torch


def exact_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis; ties broken
    by lower index, as ``lax.top_k``."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def approx_top_k(x: torch.Tensor, k: int, recall_target: float = 0.95):
    """The JAX package's approximate top-k is approximate on the TPU only;
    everywhere else, and here, it is ``exact_top_k``."""
    del recall_target
    return exact_top_k(x, k)
