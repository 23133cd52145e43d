"""RT-DETR-L with ultralytics' graph and weights, in PyTorch.

Counterpart of ``geotrax_tpu/models/rtdetr_ul.py``: the HGNetv2-L backbone,
the hybrid encoder (AIFI self-attention on P5, then the CCFM top-down and
bottom-up RepC3 fusion) and the deformable-attention decoder with its
query selection, as ultralytics' ``rtdetr-l`` defines them, so that weights
converted from an ``rtdetr-l.pt`` (``models/convert.py``) give the same
detections as the reference. Batch norm is folded into each convolution and
each RepConv's two branches are merged into one 3x3 convolution by the
converter.

The weights live in a ``ParamTree``: nested modules whose names are the JAX
parameter tree's keys (``backbone/stem/stem1/w`` ...), so
``params_from_jax`` is a direct name mapping. Convolution weights are OIHW
(the tree's HWIO, transposed on load); linear weights stay (in, out) for
``x @ w``. The public stages (``backbone``, ``hybrid_encoder``, ``decoder``,
``forward``) take and return the reference's NHWC layout; inside,
activations are NCHW. Everything runs in float32: ``_linear`` and the
attention products are full float32 products (``resolve_device`` turns
TF32 off on the card), as the reference's ``"highest"`` precision.

The deformable sampling gathers the four bilinear taps of every sampling
point by index from the flattened (H*W) value map of each head and adds
them in the reference's order (``_bilinear_nhwc``), with zero padding
outside the map (``grid_sample(align_corners=False)``).
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
from geotrax_tpu_torch.ops.topk import exact_top_k


class ULSpec(NamedTuple):
    nc: int = 80
    hd: int = 256           # hidden dim
    nq: int = 300           # queries
    ndl: int = 6            # decoder layers
    nh: int = 8             # heads
    ndp: int = 4            # sampling points
    d_ffn: int = 1024
    # HGNetv2-L stage parameters: (cm, c2, k, light, shortcut, n)
    stages: tuple = (
        (48, 128, 3, False, False, 6),
        (96, 512, 3, False, False, 6),
        (192, 1024, 5, True, False, 6),
        (192, 1024, 5, True, True, 6),
        (192, 1024, 5, True, True, 6),
        (384, 2048, 5, True, False, 6),
    )
    stem_cm: int = 32
    stem_c2: int = 48


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested parameter tree as a module: a dict becomes a module whose
    children are its keys, a list an ``nn.ModuleList``, an array a frozen
    parameter (4-D arrays, HWIO convolution kernels, transposed to OIHW)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.register_parameter(key, nn.Parameter(_tensor(value), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)


def _tensor(value) -> torch.Tensor:
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


class RTDETRL(nn.Module):
    """The whole network: ``model(images)`` is ``forward(model, images, spec)``."""

    def __init__(self, tree: dict, spec: ULSpec):
        super().__init__()
        self.spec = spec
        self.p = ParamTree(tree)

    def forward(self, images: torch.Tensor):
        return forward(self, images, self.spec)


def _conv_shape(k: int, cin: int, cout: int) -> tuple:
    return (k, k, cin, cout)


def _hgblock_shapes(c1: int, cm: int, c2: int, k: int, light: bool, n: int) -> dict:
    out = {}
    for i in range(n):
        cin = c1 if i == 0 else cm
        out[f"m{i}"] = ({"conv1": _conv_shape(1, cin, cm), "conv2": _conv_shape(k, 1, cm)}
                        if light else _conv_shape(k, cin, cm))
    out["sc"] = _conv_shape(1, c1 + n * cm, c2 // 2)
    out["ec"] = _conv_shape(1, c2 // 2, c2)
    return out


def _repc3_shapes(cin: int, c: int, n: int = 3) -> dict:
    out = {"cv1": _conv_shape(1, cin, c), "cv2": _conv_shape(1, cin, c)}
    out.update({f"m{i}": _conv_shape(3, c, c) for i in range(n)})
    return out


def _mlp_shapes(dims: list) -> dict:
    return {f"l{i}": ("linear", a, b) for i, (a, b) in enumerate(zip(dims, dims[1:]))}


def tree_shapes(spec: ULSpec) -> dict:
    """The parameter tree's structure: a conv's HWIO shape, ("linear", in,
    out), ("ln", dim) or ("mha", dim) at each leaf of the converter's tree."""
    st = spec.stages
    hd = spec.hd
    backbone = {
        "stem": {"stem1": _conv_shape(3, 3, spec.stem_cm),
                 "stem2a": _conv_shape(2, spec.stem_cm, spec.stem_cm // 2),
                 "stem2b": _conv_shape(2, spec.stem_cm // 2, spec.stem_cm),
                 "stem3": _conv_shape(3, 2 * spec.stem_cm, spec.stem_cm),
                 "stem4": _conv_shape(1, spec.stem_cm, spec.stem_c2)},
    }
    cin = spec.stem_c2
    names = (("s1", None), ("s2", "dw2"), ("s3a", "dw3"), ("s3b", None), ("s3c", None),
             ("s4", "dw4"))
    for (name, dw), (cm, c2, k, light, _shortcut, n) in zip(names, st):
        if dw is not None:
            backbone[dw] = _conv_shape(3, 1, cin)
        backbone[name] = _hgblock_shapes(cin, cm, c2, k, light, n)
        cin = c2
    encoder = {
        "proj5": _conv_shape(1, st[5][1], hd),
        "aifi": {"ma": ("mha", hd), "fc1": ("linear", hd, spec.d_ffn),
                 "fc2": ("linear", spec.d_ffn, hd), "norm1": ("ln", hd), "norm2": ("ln", hd)},
        "lat0": _conv_shape(1, hd, hd), "proj4": _conv_shape(1, st[4][1], hd),
        "fpn0": _repc3_shapes(2 * hd, hd), "lat1": _conv_shape(1, hd, hd),
        "proj3": _conv_shape(1, st[1][1], hd), "fpn1": _repc3_shapes(2 * hd, hd),
        "down0": _conv_shape(3, hd, hd), "pan0": _repc3_shapes(2 * hd, hd),
        "down1": _conv_shape(3, hd, hd), "pan1": _repc3_shapes(2 * hd, hd),
    }
    n_samp = spec.nh * 3 * spec.ndp
    decoder = {f"input_proj{i}": _conv_shape(1, hd, hd) for i in range(3)}
    decoder.update({
        "enc_output_l": ("linear", hd, hd), "enc_output_ln": ("ln", hd),
        "enc_score_head": ("linear", hd, spec.nc),
        "enc_bbox_head": _mlp_shapes([hd, hd, hd, 4]),
        "query_pos_head": _mlp_shapes([4, 2 * hd, hd]),
    })
    for i in range(spec.ndl):
        decoder[f"dec_layer{i}"] = {
            "self_attn": ("mha", hd),
            "cross_attn": {"sampling_offsets": ("linear", hd, 2 * n_samp),
                           "attention_weights": ("linear", hd, n_samp),
                           "value_proj": ("linear", hd, hd), "output_proj": ("linear", hd, hd)},
            "norm1": ("ln", hd), "norm2": ("ln", hd), "norm3": ("ln", hd),
            "linear1": ("linear", hd, spec.d_ffn), "linear2": ("linear", spec.d_ffn, hd),
        }
        decoder[f"dec_bbox_head{i}"] = _mlp_shapes([hd, hd, hd, 4])
        decoder[f"dec_score_head{i}"] = ("linear", hd, spec.nc)
    return {"backbone": backbone, "encoder": encoder, "decoder": decoder}


def random_tree(shapes, generator: torch.Generator):
    """A numpy parameter tree of ``shapes`` (``tree_shapes``) drawn from
    ``generator``: He-normal convolutions, Glorot-uniform linear maps, zero
    biases, unit layer-norm scales."""
    def draw(shape):
        return torch.randn(shape, generator=generator).numpy()

    def linear(din, dout):
        lim = (6.0 / (din + dout)) ** 0.5
        w = (torch.rand((din, dout), generator=generator) * 2 - 1) * lim
        return {"w": w.numpy(), "b": np.zeros(dout, np.float32)}

    def leaf(node):
        if isinstance(node, dict):
            return {k: leaf(v) for k, v in node.items()}
        if node[0] == "linear":
            return linear(node[1], node[2])
        if node[0] == "ln":
            return {"scale": np.ones(node[1], np.float32), "bias": np.zeros(node[1], np.float32)}
        if node[0] == "mha":
            d = node[1]
            inp, out = linear(d, 3 * d), linear(d, d)
            return {"in_w": inp["w"], "in_b": inp["b"], "out_w": out["w"], "out_b": out["b"]}
        kh, kw, cin, cout = node
        return {"w": draw(node) * (2.0 / (kh * kw * cin)) ** 0.5, "b": np.zeros(cout, np.float32)}

    return leaf(shapes)


def init_params(generator: torch.Generator, spec: ULSpec = ULSpec(), device="cuda") -> RTDETRL:
    """An RT-DETR-L of ``spec`` with random weights from ``generator`` (a CPU
    generator gives the same weights on every device)."""
    return params_from_jax(random_tree(tree_shapes(spec), generator), spec, device=device)


def params_from_jax(tree: dict, spec: ULSpec, device="cuda") -> RTDETRL:
    """The nested numpy tree of the JAX converter
    (``convert_rtdetr_ultralytics``) or of ``random_tree`` as an
    ``RTDETRL`` on ``device``."""
    dev = resolve_device(device)
    return RTDETRL(tree, spec).to(dev).eval()


# ---------------------------------------------------------------------------
# primitives (NCHW activations)
# ---------------------------------------------------------------------------

def _act(y: torch.Tensor, act):
    if act == "relu":
        return F.relu(y)
    if act == "silu":
        return F.silu(y)
    return y


def _conv(p, x: torch.Tensor, stride: int = 1, padding=None, groups: int = 1, act="relu"):
    w = p["w"]
    if padding is None:
        padding = w.shape[-1] // 2  # torch autopad
    return _act(F.conv2d(x, w, p["b"], stride=stride, padding=padding, groups=groups), act)


def _linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _ln(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _mha(p, q, k, v, num_heads: int) -> torch.Tensor:
    """torch nn.MultiheadAttention with a packed in-projection, batch first."""
    b, nq, d = q.shape
    dh = d // num_heads
    wq, wk, wv = p["in_w"].split(d, dim=1)   # stored (d, 3d)
    bq, bk, bv = p["in_b"].split(d)

    def split(x):
        return x.reshape(b, -1, num_heads, dh).transpose(1, 2)

    qh, kh, vh = split(q @ wq + bq), split(k @ wk + bk), split(v @ wv + bv)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    out = (attn @ vh).transpose(1, 2).reshape(b, nq, d)
    return out @ p["out_w"] + p["out_b"]


def _mlp(p, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        x = _linear(p[f"l{i}"], x)
        if i < n_layers - 1:
            x = F.relu(x)
    return x


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------

def _hgstem(p, x):
    x = _conv(p["stem1"], x, stride=2)
    x = F.pad(x, (0, 1, 0, 1))
    x2 = _conv(p["stem2a"], x, padding=0)
    x2 = F.pad(x2, (0, 1, 0, 1))
    x2 = _conv(p["stem2b"], x2, padding=0)
    # ultralytics' 2x2 stride-1 ceil-mode max pool on the padded map
    x1 = F.max_pool2d(x, 2, stride=1)
    x = torch.cat([x1, x2], dim=1)
    x = _conv(p["stem3"], x, stride=2)
    return _conv(p["stem4"], x)


def _hgblock(p, x, light: bool, shortcut: bool, n: int):
    ys = [x]
    for i in range(n):
        m = p[f"m{i}"]
        if light:
            y = _conv(m["conv1"], ys[-1], act=None)
            ys.append(_conv(m["conv2"], y, groups=y.shape[1]))
        else:
            ys.append(_conv(m, ys[-1]))
    y = _conv(p["ec"], _conv(p["sc"], torch.cat(ys, dim=1)))
    return y + x if shortcut else y


def _dwconv(p, x, stride: int):
    return _conv(p, x, stride=stride, groups=x.shape[1], act=None)


def _backbone(p, x, spec: ULSpec):
    st = spec.stages
    x = _hgstem(p["stem"], x)
    x = _hgblock(p["s1"], x, st[0][3], st[0][4], st[0][5])
    x = _dwconv(p["dw2"], x, 2)
    p3 = _hgblock(p["s2"], x, st[1][3], st[1][4], st[1][5])
    x = _dwconv(p["dw3"], p3, 2)
    x = _hgblock(p["s3a"], x, st[2][3], st[2][4], st[2][5])
    x = _hgblock(p["s3b"], x, st[3][3], st[3][4], st[3][5])
    p4 = _hgblock(p["s3c"], x, st[4][3], st[4][4], st[4][5])
    x = _dwconv(p["dw4"], p4, 2)
    p5 = _hgblock(p["s4"], x, st[5][3], st[5][4], st[5][5])
    return p3, p4, p5


# ---------------------------------------------------------------------------
# hybrid encoder
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _sincos_pos_np(w: int, h: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """ultralytics' AIFI position grid, with its x-major flatten, in numpy."""
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)[None]


def _aifi(p, x, num_heads: int):
    """(B,C,H,W) -> same: one post-norm transformer encoder layer with an
    exact-GELU feed-forward over the row-major tokens."""
    b, c, h, w = x.shape
    tokens = x.flatten(2).transpose(1, 2)
    pos = torch.from_numpy(_sincos_pos_np(w, h, c)).to(x.device)
    q = tokens + pos
    tokens = _ln(p["norm1"], tokens + _mha(p["ma"], q, q, tokens, num_heads))
    y = _linear(p["fc2"], F.gelu(_linear(p["fc1"], tokens), approximate="none"))
    tokens = _ln(p["norm2"], tokens + y)
    return tokens.transpose(1, 2).reshape(b, c, h, w)


def _repc3(p, x, n: int = 3):
    y = _conv(p["cv1"], x, act="silu")
    for i in range(n):
        y = F.silu(_conv(p[f"m{i}"], y, act=None))  # the merged RepConv
    out = y + _conv(p["cv2"], x, act="silu")
    if "cv3" in p:
        out = _conv(p["cv3"], out, act="silu")
    return out


def _upsample2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _hybrid_encoder(p, p3, p4, p5, spec: ULSpec):
    f5 = _aifi(p["aifi"], _conv(p["proj5"], p5, act=None), spec.nh)   # layers 10, 11
    y5 = _conv(p["lat0"], f5, act="silu")                               # 12
    x = torch.cat([_upsample2(y5), _conv(p["proj4"], p4, act=None)], dim=1)
    x = _repc3(p["fpn0"], x)                                            # 16
    y4 = _conv(p["lat1"], x, act="silu")                                # 17
    x = torch.cat([_upsample2(y4), _conv(p["proj3"], p3, act=None)], dim=1)
    out3 = _repc3(p["fpn1"], x)                                         # 21
    x = torch.cat([_conv(p["down0"], out3, stride=2, act="silu"), y4], dim=1)
    out4 = _repc3(p["pan0"], x)                                         # 24
    x = torch.cat([_conv(p["down1"], out4, stride=2, act="silu"), y5], dim=1)
    out5 = _repc3(p["pan1"], x)                                         # 27
    return out3, out4, out5


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _gather_taps(value: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Bilinear samples of ``value`` (B*nh, H*W, dh) at continuous pixel
    coordinates ``x``, ``y`` (B*nh, P) with zero padding, the four taps
    added in the reference's order -> (B*nh, P, dh)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    dh = value.shape[-1]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(value, 1, idx[..., None].expand(-1, -1, dh))
        return v * inb[..., None]

    return (tap(x0i, y0i) * (1 - fx) * (1 - fy)
            + tap(x0i + 1, y0i) * fx * (1 - fy)
            + tap(x0i, y0i + 1) * (1 - fx) * fy
            + tap(x0i + 1, y0i + 1) * fx * fy)


def _msdeform_attn(p, query, refer_bbox, level_feats, spec: ULSpec):
    """query (B,Q,C); refer_bbox (B,Q,4) in sigmoid space; level_feats
    (B,C,H,W) maps. MSDeformAttn with ultralytics' sampling locations."""
    b, nq, c = query.shape
    nl = len(level_feats)
    nh, ndp = spec.nh, spec.ndp
    dh = c // nh
    offsets = _linear(p["sampling_offsets"], query).reshape(b, nq, nh, nl, ndp, 2)
    weights = torch.softmax(
        _linear(p["attention_weights"], query).reshape(b, nq, nh, nl * ndp), dim=-1
    ).reshape(b, nq, nh, nl, ndp)
    add = offsets / ndp * refer_bbox[:, :, None, None, None, 2:] * 0.5
    loc = refer_bbox[:, :, None, None, None, :2] + add       # (B,Q,nh,nl,ndp,2)

    out = torch.zeros((b, nq, nh, dh), dtype=query.dtype, device=query.device)
    for li, feat in enumerate(level_feats):
        h, w = feat.shape[2], feat.shape[3]
        value = _linear(p["value_proj"], feat.flatten(2).transpose(1, 2))   # (B,HW,C)
        value = value.reshape(b, h * w, nh, dh).transpose(1, 2).reshape(b * nh, h * w, dh)
        # grid_sample(align_corners=False): px = loc * W - 0.5
        lx = loc[:, :, :, li, :, 0] * w - 0.5                             # (B,Q,nh,ndp)
        ly = loc[:, :, :, li, :, 1] * h - 0.5
        lx = lx.permute(0, 2, 1, 3).reshape(b * nh, nq * ndp)
        ly = ly.permute(0, 2, 1, 3).reshape(b * nh, nq * ndp)
        sampled = _gather_taps(value, lx, ly, h, w).reshape(b, nh, nq, ndp, dh).permute(0, 2, 1, 3, 4)
        out = out + torch.sum(sampled * weights[:, :, :, li, :, None], dim=3)
    return _linear(p["output_proj"], out.reshape(b, nq, c))


def _inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


@lru_cache(maxsize=8)
def _anchors_np(shapes: tuple, grid_size: float = 0.05, eps: float = 1e-2) -> tuple:
    """ultralytics' anchors in logit space, ``inf`` where invalid, and the
    valid mask, in numpy float32 as the reference builds them."""
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                             indexing="ij")
        gxy = (np.stack([gx, gy], -1) + 0.5) / np.array([w, h], np.float32)
        wh = np.ones_like(gxy) * grid_size * (2.0 ** i)
        anchors.append(np.concatenate([gxy, wh], -1).reshape(-1, 4))
    anchors = np.concatenate(anchors, 0)[None]
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        anchors = np.log(anchors / (1 - anchors))
    anchors = np.where(valid, anchors, np.inf).astype(np.float32)
    return anchors, valid.astype(np.float32)


def _decoder(p, enc_feats, spec: ULSpec):
    b = enc_feats[0].shape[0]
    dev = enc_feats[0].device
    projected = [_conv(p[f"input_proj{i}"], f, act=None) for i, f in enumerate(enc_feats)]
    shapes = tuple((f.shape[2], f.shape[3]) for f in projected)
    feats = torch.cat([f.flatten(2).transpose(1, 2) for f in projected], dim=1)   # (B,A,hd)
    anchors_np, valid_np = _anchors_np(shapes)
    anchors = torch.from_numpy(anchors_np).to(dev)
    features = _linear(p["enc_output_l"], torch.from_numpy(valid_np).to(dev) * feats)
    features = _ln(p["enc_output_ln"], features)
    enc_scores = _linear(p["enc_score_head"], features)                            # (B,A,nc)
    _, top_idx = exact_top_k(enc_scores.amax(dim=-1), spec.nq)
    top_feats = torch.gather(features, 1, top_idx[..., None].expand(-1, -1, features.shape[-1]))
    top_anchors = anchors[0][top_idx]
    embed = top_feats
    refer_bbox = torch.sigmoid(_mlp(p["enc_bbox_head"], top_feats, 3) + top_anchors)
    for i in range(spec.ndl):
        lp = p[f"dec_layer{i}"]
        qpos = _mlp(p["query_pos_head"], refer_bbox, 2)
        q = embed + qpos
        embed = _ln(lp["norm1"], embed + _mha(lp["self_attn"], q, q, embed, spec.nh))
        cross = _msdeform_attn(lp["cross_attn"], embed + qpos, refer_bbox, projected, spec)
        embed = _ln(lp["norm2"], embed + cross)
        y = _linear(lp["linear2"], F.relu(_linear(lp["linear1"], embed)))
        embed = _ln(lp["norm3"], embed + y)
        bbox = _mlp(p[f"dec_bbox_head{i}"], embed, 3)
        refer_bbox = torch.sigmoid(bbox + _inverse_sigmoid(refer_bbox))
    scores = torch.sigmoid(_linear(p[f"dec_score_head{spec.ndl - 1}"], embed))
    return refer_bbox, scores


# ---------------------------------------------------------------------------
# the reference's stages (NHWC at the boundary)
# ---------------------------------------------------------------------------

def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def backbone(model: RTDETRL, x: torch.Tensor, spec: ULSpec):
    """(B,H,W,3) -> (P3, P4, P5) NHWC feature maps (strides 8/16/32)."""
    return tuple(_nhwc(f) for f in _backbone(model.p["backbone"], _nchw(x), spec))


def hybrid_encoder(model: RTDETRL, p3, p4, p5, spec: ULSpec):
    """NHWC (P3, P4, P5) -> three NHWC hd-channel maps."""
    outs = _hybrid_encoder(model.p["encoder"], _nchw(p3), _nchw(p4), _nchw(p5), spec)
    return tuple(_nhwc(f) for f in outs)


def decoder(model: RTDETRL, enc_feats, spec: ULSpec):
    """Three NHWC maps -> (boxes in sigmoid space (B,nq,4), scores (B,nq,nc))."""
    return _decoder(model.p["decoder"], [_nchw(f) for f in enc_feats], spec)


def forward(model: RTDETRL, images: torch.Tensor, spec: ULSpec):
    """(B,H,W,3) float32 in [0,1] -> (boxes_xywh px (B,nq,4), probs (B,nq,nc))."""
    p = model.p
    p3, p4, p5 = _backbone(p["backbone"], _nchw(images), spec)
    feats = _hybrid_encoder(p["encoder"], p3, p4, p5, spec)
    boxes, probs = _decoder(p["decoder"], list(feats), spec)
    img_h, img_w = images.shape[1], images.shape[2]
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=images.device)
    return boxes * scale, probs

