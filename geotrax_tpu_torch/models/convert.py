"""Detector checkpoints: ultralytics ``.pt`` state dicts and ``.npz``
parameter files, loaded into the port's ``YOLOv8`` and RT-DETR models.

The port's copy of ``geotrax_tpu/models/convert.py``:

- ``.pt``: a flat ultralytics ``DetectionModel`` state dict (``model.<i>.``
  keys, Conv2d + BatchNorm2d per block), as a raw dict, under ``model`` or
  under ``state_dict`` (the reference's own export), optionally with
  ``class_names``. Batch norm is folded into each convolution with
  ultralytics' eps 1e-3; the folded OIHW weights go straight into the
  port's modules, which keep torch's OIHW layout.
- ``.npz``: the reference's ``save_npz`` layout: ``param:<path>`` arrays of
  the JAX parameter tree (HWIO weights, ``layers/<i>/...``, list indices as
  path parts), ``meta:<key>`` scalars (variant, nc, reg_max, p2) and a
  pickled ``class_names`` dict. A file written by either package loads in
  the other.

- RT-DETR ``.pt``: an ultralytics ``RTDETRDetectionModel`` state dict of
  the ``rtdetr-l`` graph (``convert_rtdetr_ultralytics``): batch norm
  folded, each RepConv's 3x3 and 1x1 branches merged into one 3x3 kernel,
  into the JAX converter's parameter tree and from it into the port's
  ``rtdetr_ul.RTDETRL``.

A real ultralytics checkpoint pickles ultralytics' own classes, which
``torch.load`` cannot rebuild without that package; such a file loads once
its ``state_dict`` has been saved as a plain dict of tensors.

CLI (the options of ``tools/export_model.py``; ``train/export.sh`` runs it
on every ``.pt`` under a folder)::

    python -m geotrax_tpu_torch.models.convert weights.pt -o weights.npz [--bf16] [--check 1920]
    python -m geotrax_tpu_torch.models.convert trained.npz -o weights.pt --format pt

``--bf16`` stores the weights as bfloat16 in the bytes the reference's
export writes (two-byte void records, which is how numpy saves ml_dtypes'
bfloat16); ``load_npz`` reads them back as float32 (ROADMAP C9).
``--check`` runs one forward at that imgsz on ``--device`` (the card unless
``--device cpu``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import argparse

import numpy as np
import torch
import torch.nn as nn

from geotrax_tpu_torch.models import yolov8

_BN_EPS = 1e-3  # ultralytics BatchNorm2d(eps=0.001)


def _torch_load(model_path: Path):
    return torch.load(Path(model_path), map_location="cpu", weights_only=False)


def read_class_names(model_path: Path) -> Optional[dict]:
    """{class_id: name} stored in a checkpoint file, or None."""
    model_path = Path(model_path)
    if not model_path.is_file():
        return None
    if model_path.suffix == ".npz":
        with np.load(model_path, allow_pickle=True) as data:
            if "class_names" in data:
                raw = data["class_names"].item()
                return {int(k): str(v) for k, v in raw.items()}
        return None
    if model_path.suffix == ".pt":
        ckpt = _torch_load(model_path)
        if isinstance(ckpt, dict) and isinstance(ckpt.get("class_names"), dict):
            return {int(k): str(v) for k, v in ckpt["class_names"].items()}
        model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
        names = getattr(model, "names", None)
        if isinstance(names, dict):
            return {int(k): str(v) for k, v in names.items()}
        if isinstance(names, (list, tuple)):
            return {i: str(v) for i, v in enumerate(names)}
    return None


def torch_state_dict(model_path: Path) -> dict:
    """Flat {name: float32-or-int numpy array} state dict of a ``.pt``."""
    ckpt = _torch_load(model_path)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(model, "float"):
        model = model.float()
    state = model.state_dict() if hasattr(model, "state_dict") else model
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _fold_conv_bn(sd: dict, prefix: str) -> tuple:
    """Conv2d + BatchNorm2d -> (OIHW weight, bias) with BN folded."""
    w = sd[f"{prefix}.conv.weight"]
    scale = sd[f"{prefix}.bn.weight"] / np.sqrt(sd[f"{prefix}.bn.running_var"] + _BN_EPS)
    b = sd[f"{prefix}.bn.bias"] - sd[f"{prefix}.bn.running_mean"] * scale
    return (w * scale[:, None, None, None]).astype(np.float32), b.astype(np.float32)


def _plain_conv(sd: dict, prefix: str) -> tuple:
    """Conv2d with bias (the detect head's final 1x1) -> (OIHW weight, bias)."""
    w = sd[f"{prefix}.weight"]
    b = sd.get(f"{prefix}.bias", np.zeros(w.shape[0], np.float32))
    return np.asarray(w, np.float32), np.asarray(b, np.float32)


def infer_spec(sd: dict) -> yolov8.ModelSpec:
    """Variant, nc, reg_max and P2-ness of a YOLOv8 state dict."""
    p2 = "model.28.cv3.0.2.weight" in sd
    head = 28 if p2 else 22
    stem_out = sd["model.0.conv.weight"].shape[0]
    nc = sd[f"model.{head}.cv3.0.2.weight"].shape[0]
    reg_max = sd[f"model.{head}.cv2.0.2.weight"].shape[0] // 4
    for variant, (_, w, _) in yolov8.SCALES.items():
        if int(np.ceil(64 * w / 8) * 8) == stem_out:
            return yolov8.ModelSpec(variant=variant, nc=int(nc), reg_max=int(reg_max), p2=p2)
    raise ValueError(f"Cannot infer YOLOv8 variant from stem width {stem_out}")


def _set(conv: yolov8.ConvBN, wb: tuple) -> None:
    w, b = wb
    if tuple(conv.weight.shape) != w.shape:
        raise ValueError(f"checkpoint weight {w.shape} for a layer of {tuple(conv.weight.shape)}")
    conv.weight.copy_(torch.as_tensor(np.array(w, np.float32)))
    conv.bias.copy_(torch.as_tensor(np.array(b, np.float32)))


def convert_ultralytics(sd: dict, spec: Optional[yolov8.ModelSpec] = None) -> tuple:
    """Flat ultralytics state dict -> (``YOLOv8`` on the CPU, spec); layer
    indices follow yolov8.yaml (``yolov8.backbone_plan``)."""
    spec = spec or infer_spec(sd)
    model = yolov8.YOLOv8(spec)
    layers = model.layers
    with torch.no_grad():
        for i, (kind, _args) in yolov8.backbone_plan(spec).items():
            prefix, layer = f"model.{i}", layers[str(i)]
            if kind == "conv":
                _set(layer, _fold_conv_bn(sd, prefix))
                continue
            _set(layer.cv1, _fold_conv_bn(sd, f"{prefix}.cv1"))
            _set(layer.cv2, _fold_conv_bn(sd, f"{prefix}.cv2"))
            if kind == "c2f":
                for j, m in enumerate(layer.m):
                    _set(m.cv1, _fold_conv_bn(sd, f"{prefix}.m.{j}.cv1"))
                    _set(m.cv2, _fold_conv_bn(sd, f"{prefix}.m.{j}.cv2"))
        head = spec.head_index
        for branch in ("cv2", "cv3"):
            for k, stack in enumerate(getattr(layers[str(head)], branch)):
                _set(stack[0], _fold_conv_bn(sd, f"model.{head}.{branch}.{k}.0"))
                _set(stack[1], _fold_conv_bn(sd, f"model.{head}.{branch}.{k}.1"))
                _set(stack[2], _plain_conv(sd, f"model.{head}.{branch}.{k}.2"))
    return model.eval(), spec


def load_model(model_path: Path, device="cpu") -> tuple:
    """A detector checkpoint (.pt or .npz) -> (``YOLOv8`` on ``device``,
    spec, class names or None)."""
    model_path = Path(model_path)
    if model_path.suffix == ".pt":
        model, spec = convert_ultralytics(torch_state_dict(model_path))
        names = read_class_names(model_path)
    elif model_path.suffix == ".npz":
        tree, meta = load_npz(model_path)
        spec = yolov8.ModelSpec(
            variant=str(meta.get("variant", "s")),
            nc=int(meta.get("nc", 4)),
            reg_max=int(meta.get("reg_max", 16)),
            p2=bool(int(meta.get("p2", 0))),
        )
        model = yolov8.params_from_jax(_restore_lists(tree), spec, device="cpu")
        names = meta.get("class_names")
    else:
        raise ValueError(f"Unsupported model format: {model_path}")
    return model.to(device).eval(), spec, names


def _restore_lists(node):
    """{'0': ..., '1': ...} dicts (from the npz flattening) back to lists,
    where the digit keys form exactly 0..n-1 (the 'layers' dict has gaps
    and stays a dict)."""
    if isinstance(node, dict):
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys) and sorted(int(k) for k in keys) == list(
                range(len(keys))):
            return [_restore_lists(node[str(i)]) for i in range(len(keys))]
        return {k: _restore_lists(v) for k, v in node.items()}
    return node


def _hwio(weight: torch.Tensor) -> np.ndarray:
    return weight.detach().cpu().permute(2, 3, 1, 0).contiguous().numpy()


def _tree(module: nn.Module, conv=lambda m: {"b": m.bias.detach().cpu().numpy(),
                                             "w": _hwio(m.weight)}):
    """The JAX parameter tree of a module: ``conv(c)`` per conv (by default
    {'w': HWIO, 'b'} arrays), lists for module lists, dicts of children
    otherwise."""
    if isinstance(module, yolov8.ConvBN):
        return conv(module)
    if isinstance(module, nn.ModuleList):
        return [_tree(m, conv) for m in module]
    return {name: _tree(child, conv) for name, child in module.named_children()}


def tree_leaves(node) -> list:
    """The leaves of a nested dict/list tree in JAX's flattening order
    (dict keys sorted, list items in order)."""
    if isinstance(node, dict):
        return [leaf for key in sorted(node) for leaf in tree_leaves(node[key])]
    if isinstance(node, list):
        return [leaf for item in node for leaf in tree_leaves(item)]
    return [node]


def param_leaves(model: yolov8.YOLOv8) -> list:
    """The model's parameters in the order of the reference's params tree
    flattened by JAX (``jax.tree_util.tree_leaves``): per conv its bias,
    then its (OIHW) weight."""
    return tree_leaves({"layers": _tree(model.layers, lambda m: {"b": m.bias, "w": m.weight})})


def _flatten(node, path: str, out: dict) -> None:
    """``param:<path>`` entries in the order of JAX's tree flattening
    (dict keys sorted, list items in order)."""
    if isinstance(node, dict):
        for key in sorted(node):
            _flatten(node[key], f"{path}/{key}" if path else key, out)
    elif isinstance(node, list):
        for i, item in enumerate(node):
            _flatten(item, f"{path}/{i}", out)
    else:
        out[f"param:{path}"] = np.asarray(node)


_BF16_RECORD = np.dtype("V2")


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even) as two-byte records."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(_BF16_RECORD)


def _from_bf16_bits(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).float().numpy()


def save_npz(path: Path, model: yolov8.YOLOv8, class_names: Optional[dict] = None,
             bf16: bool = False, **meta) -> None:
    """Save ``model`` as the reference's ``save_npz`` does, with the spec's
    variant, nc, reg_max and p2 as metadata unless ``meta`` sets them;
    ``bf16`` stores the weights as bfloat16 records."""
    flat: dict = {}
    _flatten({"layers": _tree(model.layers)}, "", flat)
    if bf16:
        flat = {k: _bf16_bits(v) for k, v in flat.items()}
    if class_names is not None:
        flat["class_names"] = np.array(class_names, dtype=object)
    spec = model.spec
    meta = {"variant": spec.variant, "nc": spec.nc, "reg_max": spec.reg_max,
            "p2": int(spec.p2), **meta}
    for key, value in meta.items():
        flat[f"meta:{key}"] = np.array(value)
    np.savez(Path(path), **flat)


def load_npz(path: Path) -> tuple[dict, dict]:
    """(nested params, metadata) from a .npz written by ``save_npz``."""
    params: dict = {}
    meta: dict = {}
    with np.load(Path(path), allow_pickle=True) as data:
        for key in data.files:
            if key.startswith("param:"):
                node = params
                parts = key[len("param:"):].split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                value = data[key]
                node[parts[-1]] = _from_bf16_bits(value) if value.dtype == _BF16_RECORD else value
            elif key == "class_names":
                meta["class_names"] = {int(k): str(v) for k, v in data[key].item().items()}
            elif key.startswith("meta:"):
                meta[key[len("meta:"):]] = data[key].item()
    return params, meta


def _unfold(conv: yolov8.ConvBN, prefix: str, out: dict) -> None:
    """A folded conv -> ultralytics Conv keys in the identity-BN form
    (mean 0, var 1 - eps, gamma 1, beta = bias), which folds back exactly."""
    w = conv.weight.detach().cpu().numpy().astype(np.float32)
    cout = w.shape[0]
    out[f"{prefix}.conv.weight"] = w
    out[f"{prefix}.bn.weight"] = np.ones(cout, np.float32)
    out[f"{prefix}.bn.bias"] = conv.bias.detach().cpu().numpy().astype(np.float32)
    out[f"{prefix}.bn.running_mean"] = np.zeros(cout, np.float32)
    out[f"{prefix}.bn.running_var"] = np.full(cout, 1.0 - _BN_EPS, np.float32)
    out[f"{prefix}.bn.num_batches_tracked"] = np.asarray(0, np.int64)


def export_ultralytics_state_dict(model: yolov8.YOLOv8) -> dict:
    """Inverse of ``convert_ultralytics``: the flat ultralytics-layout
    {name: numpy array} state dict of ``model`` (identity BN), with the DFL
    expectation conv's frozen arange weights."""
    spec = model.spec
    layers = model.layers
    out: dict = {}
    for i, (kind, _args) in yolov8.backbone_plan(spec).items():
        prefix, layer = f"model.{i}", layers[str(i)]
        if kind == "conv":
            _unfold(layer, prefix, out)
            continue
        _unfold(layer.cv1, f"{prefix}.cv1", out)
        _unfold(layer.cv2, f"{prefix}.cv2", out)
        if kind == "c2f":
            for j, m in enumerate(layer.m):
                _unfold(m.cv1, f"{prefix}.m.{j}.cv1", out)
                _unfold(m.cv2, f"{prefix}.m.{j}.cv2", out)
    head = spec.head_index
    for branch in ("cv2", "cv3"):
        for k, stack in enumerate(getattr(layers[str(head)], branch)):
            _unfold(stack[0], f"model.{head}.{branch}.{k}.0", out)
            _unfold(stack[1], f"model.{head}.{branch}.{k}.1", out)
            out[f"model.{head}.{branch}.{k}.2.weight"] = stack[2].weight.detach().cpu().numpy()
            out[f"model.{head}.{branch}.{k}.2.bias"] = stack[2].bias.detach().cpu().numpy()
    out[f"model.{head}.dfl.conv.weight"] = np.arange(
        spec.reg_max, dtype=np.float32).reshape(1, spec.reg_max, 1, 1)
    return out


def save_pt(path: Path, model: yolov8.YOLOv8, class_names: Optional[dict] = None) -> None:
    """Save ``model`` as a ``.pt`` that both packages load: its ultralytics
    state dict as tensors under ``state_dict``, and ``class_names``."""
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in export_ultralytics_state_dict(model).items()}
    ckpt = {"state_dict": sd}
    if class_names is not None:
        ckpt["class_names"] = dict(class_names)
    torch.save(ckpt, Path(path))


# ---------------------------------------------------------------------------
# RT-DETR (ultralytics RTDETRDetectionModel, rtdetr-l graph)
# ---------------------------------------------------------------------------

def _conv_t(sd: dict, prefix: str) -> dict:
    """Conv2d + BatchNorm2d -> {'w': HWIO, 'b'} with BN folded."""
    w, b = _fold_conv_bn(sd, prefix)
    return {"w": np.transpose(w, (2, 3, 1, 0)), "b": b}


def _lin_t(sd: dict, prefix: str) -> dict:
    """torch nn.Linear -> {'w' (in,out), 'b'} (transposed for x @ w)."""
    return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T).astype(np.float32),
            "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _ln_t(sd: dict, prefix: str) -> dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _mha_t(sd: dict, prefix: str) -> dict:
    """torch nn.MultiheadAttention (packed qkv in_proj)."""
    return {
        "in_w": np.ascontiguousarray(sd[f"{prefix}.in_proj_weight"].T).astype(np.float32),
        "in_b": np.asarray(sd[f"{prefix}.in_proj_bias"], np.float32),
        "out_w": np.ascontiguousarray(sd[f"{prefix}.out_proj.weight"].T).astype(np.float32),
        "out_b": np.asarray(sd[f"{prefix}.out_proj.bias"], np.float32),
    }


def _repconv_merged(sd: dict, prefix: str) -> dict:
    """RepConv (3x3 + 1x1 branches, each Conv+BN) as ONE 3x3 conv: BN folded
    per branch, the 1x1 kernel added at the 3x3 kernel's centre."""
    b3 = _conv_t(sd, f"{prefix}.conv1")
    b1 = _conv_t(sd, f"{prefix}.conv2")
    w = b3["w"].copy()
    w[1:2, 1:2] += b1["w"]
    return {"w": w, "b": b3["b"] + b1["b"]}


def _hgblock_t(sd: dict, prefix: str, light: bool, n: int = 6) -> dict:
    out = {}
    for i in range(n):
        if light:
            out[f"m{i}"] = {"conv1": _conv_t(sd, f"{prefix}.m.{i}.conv1"),
                            "conv2": _conv_t(sd, f"{prefix}.m.{i}.conv2")}
        else:
            out[f"m{i}"] = _conv_t(sd, f"{prefix}.m.{i}")
    out["sc"] = _conv_t(sd, f"{prefix}.sc")
    out["ec"] = _conv_t(sd, f"{prefix}.ec")
    return out


def _repc3_t(sd: dict, prefix: str, n: int = 3) -> dict:
    out = {"cv1": _conv_t(sd, f"{prefix}.cv1"), "cv2": _conv_t(sd, f"{prefix}.cv2")}
    for i in range(n):
        out[f"m{i}"] = _repconv_merged(sd, f"{prefix}.m.{i}")
    if f"{prefix}.cv3.conv.weight" in sd:
        out["cv3"] = _conv_t(sd, f"{prefix}.cv3")
    return out


def _input_proj_t(sd: dict, prefix: str) -> dict:
    """The decoder's input_proj: Conv2d(bias=False) + a plain BatchNorm2d
    (eps 1e-5)."""
    w = sd[f"{prefix}.0.weight"]
    mean, var = sd[f"{prefix}.1.running_mean"], sd[f"{prefix}.1.running_var"]
    scale = sd[f"{prefix}.1.weight"] / np.sqrt(var + 1e-5)
    return {"w": np.transpose(w * scale[:, None, None, None], (2, 3, 1, 0)).astype(np.float32),
            "b": (sd[f"{prefix}.1.bias"] - mean * scale).astype(np.float32)}


def _mlp_t(sd: dict, prefix: str, n_layers: int) -> dict:
    return {f"l{i}": _lin_t(sd, f"{prefix}.layers.{i}") for i in range(n_layers)}


def infer_rtdetr_spec(sd: dict):
    """ULSpec of an ultralytics RT-DETR state dict (rtdetr-l family)."""
    from geotrax_tpu_torch.models.rtdetr_ul import ULSpec

    stem = sd["model.0.stem1.conv.weight"].shape[0]
    if stem != 32:
        raise NotImplementedError(
            f"Only the rtdetr-l (HGNetv2-L, stem 32) graph is supported; "
            f"this checkpoint has stem width {stem} (rtdetr-x is unsupported).")
    ndl = 0
    while f"model.28.dec_score_head.{ndl}.weight" in sd:
        ndl += 1
    return ULSpec(nc=int(sd["model.28.dec_score_head.0.weight"].shape[0]),
                  hd=int(sd["model.28.enc_output.0.weight"].shape[0]), ndl=ndl,
                  d_ffn=int(sd["model.28.decoder.layers.0.linear1.weight"].shape[0]))


def rtdetr_ultralytics_tree(sd: dict, spec) -> dict:
    """Flat ultralytics RT-DETR state dict -> the JAX converter's parameter
    tree (numpy, HWIO convolutions)."""
    m = "model"
    backbone = {
        "stem": {k: _conv_t(sd, f"{m}.0.{k}") for k in ("stem1", "stem2a", "stem2b", "stem3", "stem4")},
        "s1": _hgblock_t(sd, f"{m}.1", light=False),
        "dw2": _conv_t(sd, f"{m}.2"),
        "s2": _hgblock_t(sd, f"{m}.3", light=False),
        "dw3": _conv_t(sd, f"{m}.4"),
        "s3a": _hgblock_t(sd, f"{m}.5", light=True),
        "s3b": _hgblock_t(sd, f"{m}.6", light=True),
        "s3c": _hgblock_t(sd, f"{m}.7", light=True),
        "dw4": _conv_t(sd, f"{m}.8"),
        "s4": _hgblock_t(sd, f"{m}.9", light=True),
    }
    encoder = {
        "proj5": _conv_t(sd, f"{m}.10"),
        "aifi": {"ma": _mha_t(sd, f"{m}.11.ma"), "fc1": _lin_t(sd, f"{m}.11.fc1"),
                 "fc2": _lin_t(sd, f"{m}.11.fc2"), "norm1": _ln_t(sd, f"{m}.11.norm1"),
                 "norm2": _ln_t(sd, f"{m}.11.norm2")},
        "lat0": _conv_t(sd, f"{m}.12"), "proj4": _conv_t(sd, f"{m}.14"),
        "fpn0": _repc3_t(sd, f"{m}.16"), "lat1": _conv_t(sd, f"{m}.17"),
        "proj3": _conv_t(sd, f"{m}.19"), "fpn1": _repc3_t(sd, f"{m}.21"),
        "down0": _conv_t(sd, f"{m}.22"), "pan0": _repc3_t(sd, f"{m}.24"),
        "down1": _conv_t(sd, f"{m}.25"), "pan1": _repc3_t(sd, f"{m}.27"),
    }
    dec = f"{m}.28"
    decoder = {
        "enc_output_l": _lin_t(sd, f"{dec}.enc_output.0"),
        "enc_output_ln": _ln_t(sd, f"{dec}.enc_output.1"),
        "enc_score_head": _lin_t(sd, f"{dec}.enc_score_head"),
        "enc_bbox_head": _mlp_t(sd, f"{dec}.enc_bbox_head", 3),
        "query_pos_head": _mlp_t(sd, f"{dec}.query_pos_head", 2),
    }
    for i in range(3):
        decoder[f"input_proj{i}"] = _input_proj_t(sd, f"{dec}.input_proj.{i}")
    for i in range(spec.ndl):
        lp = f"{dec}.decoder.layers.{i}"
        decoder[f"dec_layer{i}"] = {
            "self_attn": _mha_t(sd, f"{lp}.self_attn"),
            "cross_attn": {name: _lin_t(sd, f"{lp}.cross_attn.{name}") for name in (
                "sampling_offsets", "attention_weights", "value_proj", "output_proj")},
            "norm1": _ln_t(sd, f"{lp}.norm1"),
            "norm2": _ln_t(sd, f"{lp}.norm2"),
            "norm3": _ln_t(sd, f"{lp}.norm3"),
            "linear1": _lin_t(sd, f"{lp}.linear1"),
            "linear2": _lin_t(sd, f"{lp}.linear2"),
        }
        decoder[f"dec_bbox_head{i}"] = _mlp_t(sd, f"{dec}.dec_bbox_head.{i}", 3)
        decoder[f"dec_score_head{i}"] = _lin_t(sd, f"{dec}.dec_score_head.{i}")
    return {"backbone": backbone, "encoder": encoder, "decoder": decoder}


def convert_rtdetr_ultralytics(sd: dict, spec=None) -> tuple:
    """Flat ultralytics RT-DETR state dict (rtdetr-l graph) -> (``RTDETRL``
    on the CPU, ULSpec)."""
    from geotrax_tpu_torch.models import rtdetr_ul

    spec = spec or infer_rtdetr_spec(sd)
    return rtdetr_ul.params_from_jax(rtdetr_ultralytics_tree(sd, spec), spec, device="cpu"), spec


def load_rtdetr(model_path: Path) -> tuple:
    """An RT-DETR checkpoint -> (model on the CPU, spec, class names or
    None): a ``.pt`` is the ultralytics rtdetr-l graph (``RTDETRL``), a
    ``.npz`` the native family (``rtdetr.RTDETR``, spec from its metadata)."""
    from geotrax_tpu_torch.models import rtdetr

    model_path = Path(model_path)
    if model_path.suffix == ".pt":
        model, spec = convert_rtdetr_ultralytics(torch_state_dict(model_path))
        return model, spec, read_class_names(model_path)
    if model_path.suffix != ".npz":
        raise ValueError(f"Unsupported model format: {model_path}")
    raw, meta = load_npz(model_path)
    spec = rtdetr.RTDETRSpec(
        variant=str(meta.get("variant", "s")),
        nc=int(meta.get("nc", 4)),
        hidden=int(meta.get("hidden", 256)),
        num_queries=int(meta.get("num_queries", 300)),
        num_decoder_layers=int(meta.get("num_decoder_layers", 4)),
        num_heads=int(meta.get("num_heads", 8)),
        num_points=int(meta.get("num_points", 4)),
    )
    return rtdetr.params_from_jax(_restore_lists(raw), spec, device="cpu"), spec, meta.get("class_names")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m geotrax_tpu_torch.models.convert",
        description="Convert a YOLOv8 detector checkpoint (.pt or .npz) to .npz or .pt")
    parser.add_argument("checkpoint", type=Path, help=".pt (torch) or .npz input")
    parser.add_argument("--out", "-o", type=Path, required=True)
    parser.add_argument("--bf16", action="store_true", help="Store weights as bfloat16")
    parser.add_argument("--check", type=int, default=None,
                        help="Run one forward of the written file at this imgsz")
    parser.add_argument("--format", choices=("npz", "pt"), default=None,
                        help="Output format (default: from --out suffix)")
    parser.add_argument("--device", default="cuda",
                        help="Device of --check (default: the card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    if args.check:  # before writing: no card, no file
        from geotrax_tpu_torch._device import resolve_device

        device = resolve_device(args.device)
    model, spec, names = load_model(args.checkpoint)
    fmt = args.format or ("pt" if args.out.suffix == ".pt" else "npz")
    if fmt == "pt":
        save_pt(args.out, model, names)
        print(f"yolov8{spec.variant} nc={spec.nc} -> ultralytics-layout state-dict {args.out} "
              f"({len(export_ultralytics_state_dict(model))} tensors)")
        return 0
    save_npz(args.out, model, class_names=names, bf16=args.bf16)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"yolov8{spec.variant} nc={spec.nc} ({n_params / 1e6:.2f}M params) -> {args.out}")
    if args.check:
        written, spec, _ = load_model(args.out, device=device)
        size = -(-args.check // 32) * 32
        with torch.no_grad():
            boxes, probs = yolov8.forward(written, torch.zeros((1, size, size, 3), device=device),
                                          spec)
        if not (torch.isfinite(boxes).all() and torch.isfinite(probs).all()):
            raise SystemExit(f"check @ {size}: the forward of {args.out} is not finite")
        print(f"check @ {size} on {device}: boxes {tuple(boxes.shape)}, probs "
              f"{tuple(probs.shape)} OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
