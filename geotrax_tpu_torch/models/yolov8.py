"""YOLOv8 detection family in PyTorch.

Counterpart of ``geotrax_tpu/models/yolov8.py``. Inference-mode batch norm is
folded into each convolution (weight + bias), so a Conv block is conv + bias
+ SiLU. The network is an ``nn.Module`` (``YOLOv8``) whose submodules mirror
the JAX params tree: ``layers[str(i)]`` follows the ultralytics layer
indexing (0..8 backbone, 9 SPPF, 12/15/18/21 neck C2f, 16/19 downsamples,
22 detect), so ``params_from_jax`` is a direct name mapping.

Layouts: ``forward`` and ``forward_features`` keep the JAX package's NHWC
images and features at their boundary; inside, activations are NCHW
(PyTorch's convolution layout) and the block functions take NCHW. Weights
are OIHW (the JAX tree's HWIO, transposed on load). Convolutions go through
``torch.nn.functional.conv2d``, a plain product outside any hand-written
kernel. A model cast to bfloat16 (``half``) runs bfloat16 activations with
float32 biases, head outputs and box decoding.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.ops.resize import resize_u8_linear

# variant -> (depth_multiple, width_multiple, max_channels)
SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}


class ModelSpec(NamedTuple):
    variant: str = "s"
    nc: int = 4          # classes (geo-trax taxonomy: car/bus/truck/motorcycle)
    reg_max: int = 16    # DFL bins per box side
    p2: bool = False     # high-resolution P2 head variant (small objects)

    @property
    def strides(self):
        return (4, 8, 16, 32) if self.p2 else (8, 16, 32)

    @property
    def head_index(self) -> int:
        """Detect layer index: 22 in yolov8.yaml, 28 in yolov8-p2.yaml."""
        return 28 if self.p2 else 22

    @property
    def head_channels(self):
        w = self.width
        if self.p2:
            return (w(128), w(256), w(512), w(1024))
        return (w(256), w(512), w(1024))

    def width(self, c: int) -> int:
        d, w, maxc = SCALES[self.variant]
        return int(math.ceil(min(c, maxc) * w / 8) * 8) if c != 3 else 3

    def depth(self, n: int) -> int:
        d, _, _ = SCALES[self.variant]
        return max(1, round(n * d))


# ---------------------------------------------------------------------------
# Modules (weights only; the block functions below run them)
# ---------------------------------------------------------------------------

class ConvBN(nn.Module):
    """A convolution with folded batch norm: OIHW weight + bias."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)


class Bottleneck(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.cv1 = ConvBN(c, c, 3)
        self.cv2 = ConvBN(c, c, 3)


class C2f(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        hidden = cout // 2
        self.cv1 = ConvBN(cin, 2 * hidden, 1)
        self.cv2 = ConvBN((2 + n) * hidden, cout, 1)
        self.m = nn.ModuleList([Bottleneck(hidden) for _ in range(n)])


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        half = cout // 2
        self.cv1 = ConvBN(cin, half, 1)
        self.cv2 = ConvBN(half * 4, cout, 1)


class Detect(nn.Module):
    def __init__(self, spec: "ModelSpec"):
        super().__init__()
        ch = list(spec.head_channels)
        c2 = max(16, ch[0] // 4, 4 * spec.reg_max)
        c3 = max(ch[0], min(spec.nc, 100))
        self.cv2 = nn.ModuleList([
            nn.ModuleList([ConvBN(c, c2, 3), ConvBN(c2, c2, 3), ConvBN(c2, 4 * spec.reg_max, 1)])
            for c in ch
        ])
        self.cv3 = nn.ModuleList([
            nn.ModuleList([ConvBN(c, c3, 3), ConvBN(c3, c3, 3), ConvBN(c3, spec.nc, 1)])
            for c in ch
        ])


class YOLOv8(nn.Module):
    """The whole network; ``model(images)`` is ``forward(model, images, spec)``."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        w = spec.width
        cin_map = {
            0: 3, 1: w(64), 2: w(128), 3: w(128), 4: w(256), 5: w(256), 6: w(512),
            7: w(512), 8: w(1024), 9: w(1024),
            12: w(1024) + w(512), 15: w(512) + w(256),
        }
        if spec.p2:
            cin_map.update({
                18: w(256) + w(128), 19: w(128), 21: w(128) + w(256),
                22: w(256), 24: w(256) + w(512), 25: w(512),
                27: w(512) + w(1024),
            })
        else:
            cin_map.update({16: w(256), 18: w(256) + w(512), 19: w(512), 21: w(512) + w(1024)})
        layers = {}
        for i, (kind, args) in sorted(backbone_plan(spec).items()):
            cin = cin_map[i]
            if kind == "conv":
                layers[str(i)] = ConvBN(cin, args["cout"], 3)
            elif kind == "c2f":
                layers[str(i)] = C2f(cin, args["cout"], args["n"])
            else:
                layers[str(i)] = SPPF(cin, args["cout"])
        layers[str(spec.head_index)] = Detect(spec)
        self.layers = nn.ModuleDict(layers)

    def forward(self, images: torch.Tensor):
        return forward(self, images, self.spec)


# ---------------------------------------------------------------------------
# Blocks (NCHW activations)
# ---------------------------------------------------------------------------

def conv(p: ConvBN, x: torch.Tensor, weight=None, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The convolution plus bias, in float32. A bfloat16 ``x`` (``half``)
    convolves in bfloat16 and adds the bias in float32, as the reference's
    bf16 convolutions with float32 results do."""
    w = p.weight if weight is None else weight
    if x.dtype == torch.float32:
        return F.conv2d(x, w, p.bias, stride=stride, padding=padding)
    return F.conv2d(x, w, None, stride=stride, padding=padding).float() + p.bias.float()[:, None, None]


def conv_block(p: ConvBN, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Conv(k x k, stride) + folded-BN bias + SiLU, in ``x``'s dtype."""
    k = p.weight.shape[-1]
    return F.silu(conv(p, x, stride=stride, padding=k // 2)).to(x.dtype)


def bottleneck(p: Bottleneck, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
    y = conv_block(p.cv2, conv_block(p.cv1, x))
    return x + y if shortcut else y


def c2f_block(p: C2f, x: torch.Tensor, n: int, shortcut: bool) -> torch.Tensor:
    """Cross-stage partial with n bottlenecks; concat of all intermediates."""
    y = conv_block(p.cv1, x)
    half = y.shape[1] // 2
    parts = [y[:, :half], y[:, half:]]
    for i in range(n):
        parts.append(bottleneck(p.m[i], parts[-1], shortcut))
    return conv_block(p.cv2, torch.cat(parts, dim=1))


def sppf_block(p: SPPF, x: torch.Tensor) -> torch.Tensor:
    """Spatial pyramid pooling (fast): 3 chained 5x5 max-pools (-inf pad)."""
    y = conv_block(p.cv1, x)
    pools = [y]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
    return conv_block(p.cv2, torch.cat(pools, dim=1))


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(N,C,H,W) -> (N,4C,H/2,W/2); channel = c*4 + sub_row*2 + sub_col
    (the JAX package's channel order)."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(n, 4 * c, h // 2, w // 2)


def _stem_s2d_weights(w3: torch.Tensor) -> torch.Tensor:
    """Rearrange a k3 s2 (pad 1) OIHW kernel into the equivalent k2 s1 kernel
    over space-to-depth(2) input. Original tap ky reads row 2i-1+ky = block
    (i-1+di) sub-row si with (di,si) = (0,1),(1,0),(1,1) for ky=0,1,2; the
    (0,0) position never contributes and stays zero."""
    cout, cin = w3.shape[0], w3.shape[1]
    w2 = torch.zeros((cout, 4 * cin, 2, 2), dtype=w3.dtype, device=w3.device)
    taps = {0: (0, 1), 1: (1, 0), 2: (1, 1)}
    c_idx = torch.arange(cin, device=w3.device)
    for ky in range(3):
        for kx in range(3):
            di, si = taps[ky]
            dj, sj = taps[kx]
            w2[:, c_idx * 4 + si * 2 + sj, di, dj] = w3[:, :, ky, kx]
    return w2


def stem_conv_s2d(p: ConvBN, x: torch.Tensor) -> torch.Tensor:
    """k3/s2 conv via space-to-depth: the same function as
    ``conv_block(p, x, stride=2)`` (equal up to float32 rounding), the form
    the JAX package runs for layers 0 and 1."""
    xs = F.pad(space_to_depth2(x), (1, 0, 1, 0))
    return F.silu(conv(p, xs, weight=_stem_s2d_weights(p.weight))).to(x.dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def detect_head(p: Detect, features, spec: ModelSpec) -> torch.Tensor:
    """Per-scale box (4*reg_max) + class (nc) branches over NHWC features ->
    (B, total_anchors, 4*reg_max + nc) raw output."""
    outs = []
    for k, feat in enumerate(features):
        x = feat.permute(0, 3, 1, 2)
        box = conv_block(p.cv2[k][1], conv_block(p.cv2[k][0], x))
        box = conv(p.cv2[k][2], box)
        cls = conv_block(p.cv3[k][1], conv_block(p.cv3[k][0], x))
        cls = conv(p.cv3[k][2], cls)
        b, _, h, w = box.shape
        outs.append(torch.cat([box, cls], dim=1).permute(0, 2, 3, 1).reshape(b, h * w, -1))
    return torch.cat(outs, dim=1)


def make_anchors(feat_shapes, strides, offset: float = 0.5, device="cpu"):
    """Anchor centers (in stride units) and per-anchor strides (cached per
    shape and device: they are constants of the input size)."""
    return _anchors(tuple(map(tuple, feat_shapes)), tuple(strides), offset, str(device))


@lru_cache(maxsize=8)
def _anchors(feat_shapes, strides, offset, device):
    points, stride_list = [], []
    for (h, w), s in zip(feat_shapes, strides):
        ys, xs = np.mgrid[0:h, 0:w]
        points.append(np.stack([xs + offset, ys + offset], axis=-1).reshape(-1, 2))
        stride_list.append(np.full((h * w,), s, dtype=np.float32))
    return (
        torch.as_tensor(np.concatenate(points).astype(np.float32), device=device),
        torch.as_tensor(np.concatenate(stride_list), device=device),
    )


def decode_boxes(raw, anchors, strides_per_anchor, spec: ModelSpec):
    """Raw head output -> (boxes_xywh in input px, class_probs)."""
    reg = raw[..., : 4 * spec.reg_max]
    cls = raw[..., 4 * spec.reg_max:]
    b, n = raw.shape[0], raw.shape[1]
    # DFL: softmax expectation over reg_max bins per side (l, t, r, b)
    reg = reg.reshape(b, n, 4, spec.reg_max)
    bins = torch.arange(spec.reg_max, dtype=torch.float32, device=raw.device)
    dist = torch.sum(torch.softmax(reg, dim=-1) * bins, dim=-1)  # (B,N,4)
    lt, rb = dist[..., :2], dist[..., 2:]
    x1y1 = anchors[None] - lt
    x2y2 = anchors[None] + rb
    cxy = (x1y1 + x2y2) / 2 * strides_per_anchor[None, :, None]
    wh = (x2y2 - x1y1) * strides_per_anchor[None, :, None]
    return torch.cat([cxy, wh], dim=-1), torch.sigmoid(cls)


# ---------------------------------------------------------------------------
# Full network
# ---------------------------------------------------------------------------

def backbone_plan(spec: ModelSpec):
    """(layer_index -> (kind, args)) for backbone+neck; mirrors ultralytics
    yolov8.yaml (and yolov8-p2.yaml when spec.p2) layer numbering."""
    w = spec.width
    d = spec.depth
    plan = {
        0: ("conv", dict(cout=w(64), stride=2)),
        1: ("conv", dict(cout=w(128), stride=2)),
        2: ("c2f", dict(cout=w(128), n=d(3), shortcut=True)),
        3: ("conv", dict(cout=w(256), stride=2)),
        4: ("c2f", dict(cout=w(256), n=d(6), shortcut=True)),
        5: ("conv", dict(cout=w(512), stride=2)),
        6: ("c2f", dict(cout=w(512), n=d(6), shortcut=True)),
        7: ("conv", dict(cout=w(1024), stride=2)),
        8: ("c2f", dict(cout=w(1024), n=d(3), shortcut=True)),
        9: ("sppf", dict(cout=w(1024))),
        12: ("c2f", dict(cout=w(512), n=d(3), shortcut=False)),
        15: ("c2f", dict(cout=w(256), n=d(3), shortcut=False)),
    }
    if spec.p2:
        plan.update({
            18: ("c2f", dict(cout=w(128), n=d(3), shortcut=False)),
            19: ("conv", dict(cout=w(128), stride=2)),
            21: ("c2f", dict(cout=w(256), n=d(3), shortcut=False)),
            22: ("conv", dict(cout=w(256), stride=2)),
            24: ("c2f", dict(cout=w(512), n=d(3), shortcut=False)),
            25: ("conv", dict(cout=w(512), stride=2)),
            27: ("c2f", dict(cout=w(1024), n=d(3), shortcut=False)),
        })
    else:
        plan.update({
            16: ("conv", dict(cout=w(256), stride=2)),
            18: ("c2f", dict(cout=w(512), n=d(3), shortcut=False)),
            19: ("conv", dict(cout=w(512), stride=2)),
            21: ("c2f", dict(cout=w(1024), n=d(3), shortcut=False)),
        })
    return plan


def forward_features(model: YOLOv8, x: torch.Tensor, spec: ModelSpec):
    """Backbone + PAN neck: (B,H,W,3) NHWC images -> multi-scale NHWC feature
    maps [P3, P4, P5] (or [P2..P5] for the P2 variant)."""
    plan = backbone_plan(spec)
    L = model.layers

    def run(i, x):
        kind, args = plan[i]
        if kind == "conv":
            return conv_block(L[str(i)], x, stride=args["stride"])
        if kind == "c2f":
            return c2f_block(L[str(i)], x, n=args["n"], shortcut=args["shortcut"])
        return sppf_block(L[str(i)], x)

    x = x.permute(0, 3, 1, 2).contiguous()
    # layers 0-1 in space-to-depth form when the input halves evenly (as the
    # JAX package runs them); plain strided conv for odd test shapes
    x = stem_conv_s2d(L["0"], x) if x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0 else run(0, x)
    x = stem_conv_s2d(L["1"], x) if x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0 else run(1, x)
    p2 = run(2, x)
    x = run(3, p2)
    p3 = run(4, x)
    x = run(5, p3)
    p4 = run(6, x)
    x = run(7, p4)
    x = run(8, x)
    p5 = run(9, x)

    # top-down
    n12 = run(12, torch.cat([upsample2x(p5), p4], dim=1))
    n15 = run(15, torch.cat([upsample2x(n12), p3], dim=1))
    if spec.p2:
        n18 = run(18, torch.cat([upsample2x(n15), p2], dim=1))
        n21 = run(21, torch.cat([run(19, n18), n15], dim=1))
        n24 = run(24, torch.cat([run(22, n21), n12], dim=1))
        n27 = run(27, torch.cat([run(25, n24), p5], dim=1))
        feats = [n18, n21, n24, n27]
    else:
        # bottom-up
        n18 = run(18, torch.cat([run(16, n15), n12], dim=1))
        n21 = run(21, torch.cat([run(19, n18), p5], dim=1))
        feats = [n15, n18, n21]
    return [f.permute(0, 2, 3, 1) for f in feats]


def forward(model: YOLOv8, images: torch.Tensor, spec: ModelSpec):
    """(B,H,W,3) float images (already letterboxed, 0..1; bfloat16 with a
    bfloat16 model) -> (boxes_xywh (B,N,4) in input px, class_probs (B,N,nc)),
    float32."""
    feats = forward_features(model, images, spec)
    raw = detect_head(model.layers[str(spec.head_index)], feats, spec)
    feat_shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchors, stride_arr = make_anchors(feat_shapes, spec.strides, device=images.device)
    return decode_boxes(raw, anchors, stride_arr, spec)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, spec: ModelSpec, device="cuda") -> YOLOv8:
    """A YOLOv8 with random He-normal weights and zero biases, drawn from
    ``generator`` (a CPU generator gives the same weights on every device)."""
    dev = resolve_device(device)
    model = YOLOv8(spec)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvBN):
                cout, cin, k, _ = mod.weight.shape
                w = torch.randn(mod.weight.shape, generator=generator, device=generator.device)
                mod.weight.copy_(w * (2.0 / (cin * k * k)) ** 0.5)
    return model.to(dev).eval()


def _load_tree(module: nn.Module, tree) -> None:
    if isinstance(module, ConvBN):
        w = torch.from_numpy(np.array(tree["w"], dtype=np.float32)).permute(3, 2, 0, 1)
        module.weight.copy_(w)
        module.bias.copy_(torch.from_numpy(np.array(tree["b"], dtype=np.float32)))
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"params list of {len(tree)} for {len(module)} modules")
        for sub, t in zip(module, tree):
            _load_tree(sub, t)
    else:
        for key, t in tree.items():
            sub = module[key] if isinstance(module, nn.ModuleDict) else getattr(module, key)
            _load_tree(sub, t)


def params_from_jax(tree: dict, spec: ModelSpec, device="cuda") -> YOLOv8:
    """Load the nested numpy dict that ``geotrax_tpu.models.yolov8.init_params``
    (or its weight converter) returns into a ``YOLOv8``: HWIO -> OIHW."""
    dev = resolve_device(device)
    model = YOLOv8(spec)
    with torch.no_grad():
        _load_tree(model, tree)
    return model.to(dev).eval()


# ---------------------------------------------------------------------------
# Preprocessing (letterbox, ultralytics-compatible)
# ---------------------------------------------------------------------------

_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def letterbox_shape(src_h: int, src_w: int, imgsz: int, stride: int = 32,
                    auto: bool = True) -> tuple:
    """Target (h, w, scale, pad_top, pad_left) for ultralytics LetterBox:
    aspect-preserving resize to fit imgsz, padded to a stride multiple (auto)
    or to the full square (auto=False)."""
    r = min(imgsz / src_h, imgsz / src_w)
    new_h, new_w = round(src_h * r), round(src_w * r)
    if auto:
        pad_h = (-new_h) % stride
        pad_w = (-new_w) % stride
    else:
        pad_h, pad_w = imgsz - new_h, imgsz - new_w
    top, left = pad_h // 2, pad_w // 2
    return new_h + pad_h, new_w + pad_w, r, top, left


def letterbox_pad(resized_u8: torch.Tensor, out_h: int, out_w: int, top: int, left: int) -> torch.Tensor:
    """Pad ALREADY-RESIZED (..., new_h, new_w, 3) uint8 images onto the gray
    (114) letterbox canvas -> (..., out_h, out_w, 3) float32 in [0,1]."""
    nh, nw = resized_u8.shape[-3], resized_u8.shape[-2]
    canvas = torch.full(resized_u8.shape[:-3] + (out_h, out_w, 3), 114.0,
                        dtype=torch.float32, device=resized_u8.device)
    canvas[..., top:top + nh, left:left + nw, :] = resized_u8.to(torch.float32)
    # XLA compiles the reference's "/ 255" into a product with the float32
    # reciprocal; the same product keeps the inputs bit-equal
    return canvas * _INV_255


def letterbox(image_u8: torch.Tensor, out_h: int, out_w: int, new_h: int, new_w: int,
              top: int, left: int) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., out_h, out_w, 3) float32 in [0,1]: the
    cv2-exact resize (ops/resize.py), then the gray padding."""
    if tuple(image_u8.shape[-3:-1]) != (new_h, new_w):
        image_u8 = resize_u8_linear(image_u8, new_h, new_w)
    return letterbox_pad(image_u8, out_h, out_w, top, left)


def unletterbox_boxes(boxes_xywh: torch.Tensor, scale: float, top: int, left: int) -> torch.Tensor:
    """Map letterboxed-space boxes back to original pixel coordinates."""
    cx = (boxes_xywh[..., 0] - left) / scale
    cy = (boxes_xywh[..., 1] - top) / scale
    w = boxes_xywh[..., 2] / scale
    h = boxes_xywh[..., 3] / scale
    return torch.stack([cx, cy, w, h], dim=-1)
