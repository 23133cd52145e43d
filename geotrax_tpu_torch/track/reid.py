"""Learned ReID embedding head (cfg ``tracker.<name>.model: <path>.npz``).

Counterpart of ``geotrax_tpu/track/reid.py``. The default appearance
signature is the fixed patch projection of
``pipeline/device_pipeline.py:embed_boxes``; when the tracker block names an
``.npz`` weights file, this small convolutional head replaces it.

Head: 32x32 RGB patch -> conv3x3(16)/2 SiLU -> conv3x3(32)/2 SiLU ->
conv3x3(64)/2 SiLU -> global mean pool -> linear(emb_dim) -> L2 norm.

Checkpoints are the reference's own format: ``save_head`` writes, and
``load_head`` reads, HWIO conv weights (``conv{i}_w`` of shape
(3,3,cin,cout)), so a head saved by either package gives the same
embeddings in both. In memory the port keeps OIHW weights, PyTorch's
layout. The reference's ``padding="SAME"`` with stride 2 on an even input
pads (0,1) in each spatial dimension; ``embed_patches`` pads exactly that
and convolves with no padding of its own.
"""

from __future__ import annotations

import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from geotrax_tpu_torch.track.base import EMB_DIM

PATCH = 32
CHANNELS = (16, 32, 64)


def _required_shapes(emb_dim: int) -> dict:
    """The reference's (HWIO) shape of every parameter of the head."""
    shapes = {}
    cin = 3
    for i, cout in enumerate(CHANNELS):
        shapes[f"conv{i}_w"] = (3, 3, cin, cout)
        shapes[f"conv{i}_b"] = (cout,)
        cin = cout
    shapes["proj_w"] = (cin, emb_dim)
    shapes["proj_b"] = (emb_dim,)
    return shapes


def _from_reference(arrays: dict) -> dict:
    """Reference-layout numpy arrays -> the port's float32 tensors (conv
    weights HWIO -> OIHW)."""
    params = {}
    for key, value in arrays.items():
        t = torch.as_tensor(np.asarray(value, np.float32))
        if key.startswith("conv") and key.endswith("_w"):
            t = t.permute(3, 2, 0, 1).contiguous()
        params[key] = t
    return params


def _to_reference(params: dict) -> dict:
    """The port's tensors -> reference-layout numpy arrays (OIHW -> HWIO)."""
    out = {}
    for key, value in params.items():
        t = value.detach().cpu()
        if key.startswith("conv") and key.endswith("_w"):
            t = t.permute(2, 3, 1, 0)
        out[key] = t.contiguous().numpy()
    return out


def init_head(generator: torch.Generator, emb_dim: int = EMB_DIM) -> dict:
    """He-initialized random head drawn from ``generator`` (a CPU
    ``torch.Generator``); CPU float32 tensors. The draws are not the
    reference's (``jax.random``); the scales and shapes are."""
    arrays = {}
    cin = 3
    for i, cout in enumerate(CHANNELS):
        scale = float(np.sqrt(2.0 / (9 * cin)))
        arrays[f"conv{i}_w"] = torch.randn((3, 3, cin, cout), generator=generator).numpy() * scale
        arrays[f"conv{i}_b"] = np.zeros((cout,), np.float32)
        cin = cout
    arrays["proj_w"] = torch.randn((cin, emb_dim), generator=generator).numpy() * float(
        np.sqrt(1.0 / cin))
    arrays["proj_b"] = np.zeros((emb_dim,), np.float32)
    return _from_reference(arrays)


def save_head(path, params: dict) -> None:
    """Write ``params`` in the reference's ``.npz`` format (HWIO)."""
    np.savez(path, **_to_reference(params))


def load_head(path) -> dict | None:
    """Load a head checkpoint in the reference's format; ``None`` when the
    file is missing or malformed or its shapes are not the head's with
    ``EMB_DIM`` outputs (callers then embed by projection)."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path) as data:
            arrays = {k: np.asarray(data[k]) for k in data.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):  # not a readable .npz
        return None
    shapes = _required_shapes(EMB_DIM)
    if not set(shapes) <= set(arrays):
        return None
    if any(tuple(arrays[k].shape) != shape for k, shape in shapes.items()):
        return None
    return _from_reference({k: arrays[k] for k in shapes})


def _embed_nchw(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(M,3,32,32) float32 patches (0..255) -> (M,emb_dim) L2-normed."""
    x = x / 255.0
    for i in range(len(CHANNELS)):
        # SAME with stride 2 on an even size: pad 0 before, 1 after
        x = F.conv2d(F.pad(x, (0, 1, 0, 1)), params[f"conv{i}_w"], params[f"conv{i}_b"],
                     stride=2)
        x = x * torch.sigmoid(x)  # SiLU
    x = x.mean(dim=(2, 3))
    emb = x @ params["proj_w"] + params["proj_b"]
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)


def embed_patches(params: dict, patches: torch.Tensor) -> torch.Tensor:
    """(M,32,32,3) float32 patches (the reference's NHWC layout) ->
    (M,emb_dim) L2-normalized embeddings."""
    return _embed_nchw(params, patches.permute(0, 3, 1, 2))


def resolve_head(tracker_params: dict, logger=None) -> dict | None:
    """The cfg hook: ``tracker.<active>.model`` naming an ``.npz`` file loads
    the conv head; ``auto``/None/missing or malformed files keep the
    projection path, with a warning for the last two (the reference's
    ``model: auto`` semantics)."""
    ref = (tracker_params or {}).get("model")
    if not ref or str(ref) in ("auto", "None"):
        return None
    if not str(ref).endswith(".npz"):
        if logger:
            logger.warning(
                f"tracker model '{ref}': only .npz ReID heads are supported; "
                "using the projection embedding."
            )
        return None
    params = load_head(ref)
    if logger:
        if params is None:
            logger.warning(
                f"ReID head '{ref}' missing or malformed; using the projection embedding."
            )
        else:
            logger.info(f"Loaded learned ReID head from '{ref}'.")
    return params
