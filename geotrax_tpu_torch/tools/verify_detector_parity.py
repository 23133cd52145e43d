"""Detector-parity check: a ``.pt`` checkpoint through the port's converter
against a torch oracle, box by box: the port of
``tools/verify_detector_parity.py``.

The real ``geotrax_hbb_yolov8s_1920_v1.pt`` weights are not in the
repository; this is the recipe for the day they are:

  python -m geotrax_tpu_torch.tools.verify_detector_parity /path/to/geotrax_hbb_yolov8s_1920_v1.pt \
      --image /path/to/4k_frame.png --imgsz 1920

1. loads the state dict (``models/convert.torch_state_dict``) and converts it
   into the port's ``YOLOv8`` (``convert_ultralytics``, batch norm folded
   into each convolution): the path ``extract`` takes for a ``.pt``;
2. rebuilds the same network in torch from the state dict with its batch
   norms unfolded (Conv+BN+SiLU, C2f, SPPF, the PAN neck, the decoupled DFL
   head), an oracle independent of the folding;
3. runs both on the letterboxed image, the converted model on ``--device``
   (default cuda) and the oracle on the CPU, and reports the largest raw
   head deviation (before NMS), the largest per-box deviation of the final
   detections, and PASS or FAIL against ``--tol-raw`` / ``--tol-box``.

Without ``--image`` a seeded synthetic frame is used; without weights
``--selftest`` builds a small random state dict in ultralytics' layout and
checks the converter itself.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn


def build_torch_oracle(sd: dict, spec):
    """Rebuild the ultralytics DetectionModel forward from a flat state dict
    with its batch norms unfolded (eval mode), independent of the
    converter's folding, so a folding error cannot cancel out."""

    class Conv(nn.Module):
        def __init__(self, prefix, cin, cout, k, s):
            super().__init__()
            self.conv = nn.Conv2d(cin, cout, k, s, k // 2, bias=False)
            # ultralytics sets every batch norm's eps to 1e-3 (initialize_weights)
            self.bn = nn.BatchNorm2d(cout, eps=1e-3)
            self.act = nn.SiLU()
            self._prefix = prefix

        def load(self, sd):
            self.conv.weight.data = sd[f"{self._prefix}.conv.weight"]
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(self.bn, name).data = sd[f"{self._prefix}.bn.{name}"]
            return self

        def forward(self, x):
            return self.act(self.bn(self.conv(x)))

    def conv_from_sd(prefix, stride=1):
        w = sd[f"{prefix}.conv.weight"]
        return Conv(prefix, w.shape[1], w.shape[0], w.shape[2], stride).load(sd)

    class Bottleneck(nn.Module):
        def __init__(self, prefix, shortcut):
            super().__init__()
            self.cv1 = conv_from_sd(f"{prefix}.cv1")
            self.cv2 = conv_from_sd(f"{prefix}.cv2")
            self.add = shortcut

        def forward(self, x):
            y = self.cv2(self.cv1(x))
            return x + y if self.add else y

    class C2f(nn.Module):
        def __init__(self, prefix, shortcut):
            super().__init__()
            self.cv1 = conv_from_sd(f"{prefix}.cv1")
            n = 0
            while f"{prefix}.m.{n}.cv1.conv.weight" in sd:
                n += 1
            self.m = nn.ModuleList(
                Bottleneck(f"{prefix}.m.{i}", shortcut) for i in range(n)
            )
            self.cv2 = conv_from_sd(f"{prefix}.cv2")

        def forward(self, x):
            y = list(self.cv1(x).chunk(2, 1))
            for m in self.m:
                y.append(m(y[-1]))
            return self.cv2(torch.cat(y, 1))

    class SPPF(nn.Module):
        def __init__(self, prefix):
            super().__init__()
            self.cv1 = conv_from_sd(f"{prefix}.cv1")
            self.cv2 = conv_from_sd(f"{prefix}.cv2")
            self.pool = nn.MaxPool2d(5, 1, 2)

        def forward(self, x):
            y = [self.cv1(x)]
            for _ in range(3):
                y.append(self.pool(y[-1]))
            return self.cv2(torch.cat(y, 1))

    class Oracle(nn.Module):
        def __init__(self):
            super().__init__()
            L = "model."
            self.l0 = conv_from_sd(L + "0", 2)
            self.l1 = conv_from_sd(L + "1", 2)
            self.l2 = C2f(L + "2", True)
            self.l3 = conv_from_sd(L + "3", 2)
            self.l4 = C2f(L + "4", True)
            self.l5 = conv_from_sd(L + "5", 2)
            self.l6 = C2f(L + "6", True)
            self.l7 = conv_from_sd(L + "7", 2)
            self.l8 = C2f(L + "8", True)
            self.l9 = SPPF(L + "9")
            self.l12 = C2f(L + "12", False)
            self.l15 = C2f(L + "15", False)
            self.l16 = conv_from_sd(L + "16", 2)
            self.l18 = C2f(L + "18", False)
            self.l19 = conv_from_sd(L + "19", 2)
            self.l21 = C2f(L + "21", False)
            self.head_cv2 = nn.ModuleList()
            self.head_cv3 = nn.ModuleList()
            for k in range(3):
                p2 = f"model.22.cv2.{k}"
                p3 = f"model.22.cv3.{k}"
                box_final = nn.Conv2d(
                    sd[f"{p2}.2.weight"].shape[1], sd[f"{p2}.2.weight"].shape[0], 1
                )
                box_final.weight.data = sd[f"{p2}.2.weight"]
                box_final.bias.data = sd[f"{p2}.2.bias"]
                cls_final = nn.Conv2d(
                    sd[f"{p3}.2.weight"].shape[1], sd[f"{p3}.2.weight"].shape[0], 1
                )
                cls_final.weight.data = sd[f"{p3}.2.weight"]
                cls_final.bias.data = sd[f"{p3}.2.bias"]
                self.head_cv2.append(nn.Sequential(
                    conv_from_sd(f"{p2}.0"), conv_from_sd(f"{p2}.1"), box_final))
                self.head_cv3.append(nn.Sequential(
                    conv_from_sd(f"{p3}.0"), conv_from_sd(f"{p3}.1"), cls_final))
            self.up = nn.Upsample(scale_factor=2, mode="nearest")

        def forward(self, x):
            x = self.l1(self.l0(x))
            p3_in = self.l4(self.l3(self.l2(x)))
            p4_in = self.l6(self.l5(p3_in))
            p5_in = self.l9(self.l8(self.l7(p4_in)))
            t = self.l12(torch.cat([self.up(p5_in), p4_in], 1))
            p3 = self.l15(torch.cat([self.up(t), p3_in], 1))
            p4 = self.l18(torch.cat([self.l16(p3), t], 1))
            p5 = self.l21(torch.cat([self.l19(p4), p5_in], 1))
            outs = []
            for k, f in enumerate((p3, p4, p5)):
                raw = torch.cat([self.head_cv2[k](f), self.head_cv3[k](f)], 1)
                outs.append(raw.flatten(2).permute(0, 2, 1))  # (B, HW, C)
            return torch.cat(outs, 1)

    model = Oracle().eval()
    return model


def make_selftest_state_dict():
    """Small random YOLOv8n state dict in ultralytics' layout (nc=4). Its
    heads are shaped so that the box comparison means something: the class
    logits spread (x30, shifted by -2.6) so that a few percent of the anchors
    pass ``--conf`` with scores that do not tie within float32 noise, and
    the boxes are about one stride wide (two DFL bins at logit 20 per side),
    so that NMS keeps them apart."""

    from geotrax_tpu_torch.models import yolov8

    spec = yolov8.ModelSpec(variant="n", nc=4)
    torch.manual_seed(0)
    sd = {}

    def add_conv(prefix, cin, cout, k):
        sd[f"{prefix}.conv.weight"] = torch.randn(cout, cin, k, k) * 0.05
        sd[f"{prefix}.bn.weight"] = torch.rand(cout) + 0.5
        sd[f"{prefix}.bn.bias"] = torch.randn(cout) * 0.1
        sd[f"{prefix}.bn.running_mean"] = torch.randn(cout) * 0.1
        sd[f"{prefix}.bn.running_var"] = torch.rand(cout) + 0.5
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)

    def add_c2f(prefix, cin, cout, n):
        half = cout // 2
        add_conv(f"{prefix}.cv1", cin, cout, 1)
        for i in range(n):
            add_conv(f"{prefix}.m.{i}.cv1", half, half, 3)
            add_conv(f"{prefix}.m.{i}.cv2", half, half, 3)
        add_conv(f"{prefix}.cv2", half * (2 + n), cout, 1)

    w, d = spec.width, spec.depth
    add_conv("model.0", 3, w(64), 3)
    add_conv("model.1", w(64), w(128), 3)
    add_c2f("model.2", w(128), w(128), d(3))
    add_conv("model.3", w(128), w(256), 3)
    add_c2f("model.4", w(256), w(256), d(6))
    add_conv("model.5", w(256), w(512), 3)
    add_c2f("model.6", w(512), w(512), d(6))
    add_conv("model.7", w(512), w(1024), 3)
    add_c2f("model.8", w(1024), w(1024), d(3))
    add_conv("model.9.cv1", w(1024), w(1024) // 2, 1)
    add_conv("model.9.cv2", w(1024) * 2, w(1024), 1)
    add_c2f("model.12", w(1024) + w(512), w(512), d(3))
    add_c2f("model.15", w(512) + w(256), w(256), d(3))
    add_conv("model.16", w(256), w(256), 3)
    add_c2f("model.18", w(256) + w(512), w(512), d(3))
    add_conv("model.19", w(512), w(512), 3)
    add_c2f("model.21", w(512) + w(1024), w(1024), d(3))
    # ultralytics Detect: c2 = max(16, ch[0] // 4, 4 * reg_max)
    c_box = max(16, w(256) // 4, 4 * spec.reg_max)
    c_cls = max(w(256), min(spec.nc, 100))
    for k, ch in enumerate((w(256), w(512), w(1024))):
        add_conv(f"model.22.cv2.{k}.0", ch, c_box, 3)
        add_conv(f"model.22.cv2.{k}.1", c_box, c_box, 3)
        sd[f"model.22.cv2.{k}.2.weight"] = torch.randn(64, c_box, 1, 1) * 0.05
        sd[f"model.22.cv2.{k}.2.bias"] = torch.randn(64) * 0.1
        add_conv(f"model.22.cv3.{k}.0", ch, c_cls, 3)
        add_conv(f"model.22.cv3.{k}.1", c_cls, c_cls, 3)
        sd[f"model.22.cv3.{k}.2.weight"] = torch.randn(spec.nc, c_cls, 1, 1) * 0.05
        sd[f"model.22.cv3.{k}.2.bias"] = torch.randn(spec.nc) * 0.1
    sd["model.22.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    box_bias = torch.zeros(64)
    box_bias[0::spec.reg_max] = box_bias[1::spec.reg_max] = 20.0
    for k in range(3):
        sd[f"model.22.cv3.{k}.2.weight"] *= 30.0
        sd[f"model.22.cv3.{k}.2.bias"] -= 2.6
        sd[f"model.22.cv2.{k}.2.weight"] *= 0.05
        sd[f"model.22.cv2.{k}.2.bias"] = box_bias.clone()
    return sd


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Gate the .pt->port detector conversion per-box against a torch oracle.")
    parser.add_argument("model", type=Path, nargs="?", default=None,
                        help="Ultralytics YOLOv8 .pt checkpoint")
    parser.add_argument("--image", type=Path, default=None,
                        help="Frame to run parity on (default: synthetic)")
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--iou", type=float, default=0.7)
    parser.add_argument("--tol-raw", type=float, default=5e-3,
                        help="Max |raw head output| deviation (f32)")
    parser.add_argument("--tol-box", type=float, default=0.1,
                        help="Max per-box center/extent deviation [px]")
    parser.add_argument("--selftest", action="store_true",
                        help="Gate the converter on a random in-process checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the converted model (default cuda; 'cpu' runs "
                             "the plain PyTorch path; the oracle runs on the CPU)")
    return parser.parse_args(argv)


def match_boxes(bj: np.ndarray, bt: np.ndarray) -> tuple:
    """(largest per-box deviation, unmatched count): NMS order is not stable
    under float32 score ties, so boxes pair greedily by centre distance."""
    box_dev, unmatched = 0.0, abs(len(bj) - len(bt))
    if len(bj) and len(bt):
        d = np.linalg.norm(bj[:, None, :2] - bt[None, :, :2], axis=-1)
        used = np.zeros(len(bt), bool)
        for i in np.argsort(d.min(axis=1)):
            order = np.argsort(d[i])
            hit = next((j for j in order if not used[j]), None)
            if hit is None or d[i, hit] > max(bj[i, 2], bj[i, 3]):
                unmatched += 1
                continue
            used[hit] = True
            box_dev = max(box_dev, float(np.abs(bj[i] - bt[hit]).max()))
    return box_dev, unmatched


def check(args) -> dict:
    """The comparison's numbers and verdict."""
    from geotrax_tpu_torch._device import resolve_device
    from geotrax_tpu_torch.models import yolov8
    from geotrax_tpu_torch.models.convert import convert_ultralytics, torch_state_dict
    from geotrax_tpu_torch.ops.nms import postprocess_detections

    device = resolve_device(args.device)
    if args.selftest or args.model is None:
        if args.model is None and not args.selftest:
            print("No checkpoint given — running --selftest on a random "
                  "in-process state dict.")
        sd = make_selftest_state_dict()
    else:
        sd = {k: torch.as_tensor(np.asarray(v)) for k, v in torch_state_dict(args.model).items()}
    # the converter takes numpy; the oracle loads the tensors directly
    model, spec = convert_ultralytics({k: v.numpy() for k, v in sd.items()})
    model = model.to(device)
    oracle = build_torch_oracle(sd, spec)

    # the input frame, letterboxed to imgsz as extraction letterboxes it
    if args.image is not None:
        from geotrax_tpu_torch.train.data import load_image

        frame = load_image(args.image)
    else:
        rng = np.random.default_rng(42)
        frame = np.kron(rng.integers(0, 255, (args.imgsz // 8, args.imgsz // 8, 3)),
                        np.ones((8, 8, 1))).astype(np.uint8)
    src_h, src_w = frame.shape[:2]
    out_h, out_w, r, top, left = yolov8.letterbox_shape(src_h, src_w, args.imgsz)
    new_h, new_w = round(src_h * r), round(src_w * r)
    img = yolov8.letterbox(torch.as_tensor(frame), out_h, out_w, new_h, new_w, top, left)

    with torch.no_grad():
        # the oracle's raw head output (B, N, 4*reg_max + nc), on the CPU
        raw_t = oracle(img[None].permute(0, 3, 1, 2)).numpy()
        feats = yolov8.forward_features(model, img[None].to(device), spec)
        raw_j = yolov8.detect_head(model.layers[str(spec.head_index)], feats, spec).cpu().numpy()
    raw_dev = float(np.abs(raw_j - raw_t).max())

    # the final boxes through the same decode and NMS both ways
    anchors, strides = yolov8.make_anchors([(f.shape[1], f.shape[2]) for f in feats],
                                           spec.strides)

    def final_boxes(raw):
        boxes, probs = yolov8.decode_boxes(torch.as_tensor(raw), anchors, strides, spec)
        det = postprocess_detections(boxes[0], probs[0], args.conf, args.iou, 300, agnostic=True)
        valid = det["valid"].numpy()
        return det["boxes_xywh"].numpy()[valid], det["scores"].numpy()[valid]

    bj, _ = final_boxes(raw_j)
    bt, _ = final_boxes(raw_t)
    box_dev, unmatched = match_boxes(bj, bt)
    ok = raw_dev <= args.tol_raw and box_dev <= args.tol_box and unmatched == 0
    return {"spec": spec, "anchors": raw_j.shape[1], "raw_dev": raw_dev, "port": len(bj),
            "torch": len(bt), "unmatched": unmatched, "box_dev": box_dev, "ok": ok}


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    res = check(args)
    spec = res["spec"]
    print(f"checkpoint       : {args.model or '<selftest random>'}")
    print(f"spec             : variant={spec.variant} nc={spec.nc} imgsz={args.imgsz}")
    print(f"anchors          : {res['anchors']}")
    print(f"raw head max dev : {res['raw_dev']:.3e} (tol {args.tol_raw})")
    print(f"detections       : port={res['port']} torch={res['torch']} "
          f"unmatched={res['unmatched']}")
    print(f"box max dev [px] : {res['box_dev']:.4f} (tol {args.tol_box})")
    print("PARITY:", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
