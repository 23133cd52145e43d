"""Detector training loop (fine-tuning and from scratch), data-parallel
over one or several ranks.

CLI:  python -m geotrax_tpu_torch.train --data <dataset_dir> [--model m.pt|.npz]
                                        [--cfg default] [--epochs N] [--device cpu]
                                        [--devices N] [--slices S] [--multihost] ...

The port of ``geotrax_tpu/train/train.py``: hyperparameters from the
config's ultralytics section (lr0, lrf, momentum, weight_decay,
warmup_epochs, box/cls/dfl gains, epochs, batch, imgsz, patience, seed,
fraction, cos_lr), the reference's loss and gradients
(``models/loss.py``), its Nesterov SGD and schedule (``train/optim.py``),
checkpoints as .npz (last.npz / best.npz, by val mAP@50) that either
package loads, ``trainer_state.npz`` with the reference's leaves for
``--resume`` (either package's file resumes in the other), and the same
run files. The step runs on ``--device`` (the card unless ``--device cpu``
is passed; there is no fallback).

Several ranks (``parallel/mesh.py``): ``--devices N`` starts N processes,
rank r on ``cuda:r`` (NCCL) or, with ``--device cpu``, on the CPU (gloo);
under torchrun's environment (``--multihost``, ``train/launch.sh``) each
process joins the group that it describes, and ``--slices S`` lays the
ranks out as S slices. ``--batch`` is the global batch: each rank decodes
and steps on its own B/N rows, the gradients are averaged over the ranks,
and the logged losses are the global batch's. Every rank evaluates; rank
0's mAP and early-stop decision hold for all, and only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from geotrax_tpu_torch.models import yolov8
from geotrax_tpu_torch.models.convert import load_model, param_leaves, save_npz
from geotrax_tpu_torch.ops.nms import postprocess_detections
from geotrax_tpu_torch.parallel.mesh import (
    batch_rows, broadcast_object, make_hybrid_mesh, make_mesh, make_train_step, shard_params,
    spawn,
)
from geotrax_tpu_torch.train.data import Loader
from geotrax_tpu_torch.train.metrics import evaluate_detections
from geotrax_tpu_torch.train.optim import SGD, SGDState, build_lr_schedule
from geotrax_tpu_torch.train.runlog import RunLogger
from geotrax_tpu_torch.utils.config_utils import load_config
from geotrax_tpu_torch.utils.logging_utils import setup_logger


def evaluate(model: yolov8.YOLOv8, spec, loader: Loader, conf=0.001, iou=0.7, max_det=300,
             single_cls: bool = False) -> dict:
    """Run validation and compute the detection metrics.

    ``single_cls=True`` re-scores the same predictions class-agnostically
    (every prediction and GT mapped to class 0): the reference's separate
    single-class val pass."""
    device = next(model.parameters()).device
    predictions, ground_truths = [], []
    with torch.no_grad():
        for batch in loader.epoch(0):
            boxes, probs = yolov8.forward(model, torch.from_numpy(batch["images"]).to(device), spec)
            det = postprocess_detections(boxes, probs, conf, iou, max_det, agnostic=False)
            det = {k: v.cpu().numpy() for k, v in det.items()}
            # padded tail rows (validation ceil-batching) carry no real image
            for i in range(int(batch.get("n_valid", len(batch["images"])))):
                valid = det["valid"][i]
                classes = det["classes"][i][valid]
                gt_mask = batch["gt_mask"][i]
                gt_cls = batch["gt_cls"][i][gt_mask]
                if single_cls:
                    classes = np.zeros_like(classes)
                    gt_cls = np.zeros_like(gt_cls)
                predictions.append({
                    "boxes_xywh": det["boxes_xywh"][i][valid],
                    "scores": det["scores"][i][valid],
                    "classes": classes,
                })
                ground_truths.append({
                    "boxes_xywh": batch["gt_boxes"][i][gt_mask],
                    "classes": gt_cls,
                })
    return evaluate_detections(predictions, ground_truths, 1 if single_cls else spec.nc)


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def save_trainer_state(path, opt_state: SGDState, epoch: int, best_map: float,
                       bad_epochs: int) -> None:
    """Checkpoint the optimizer state + loop counters for --resume, as the
    reference writes it: ``_meta`` and ``leaf_<i>`` for optax's state
    leaves (the momentum trace in the params tree's order, HWIO conv
    kernels, then the int32 update count)."""
    leaves = [_to_jax_layout(t) for t in opt_state.trace]
    leaves.append(np.asarray(opt_state.count, np.int32))
    np.savez(
        path,
        _meta=np.asarray([float(epoch), float(best_map), float(bad_epochs)]),
        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
    )


def load_trainer_state(path, template: SGDState):
    """-> (opt_state, next_epoch, best_map, bad_epochs); ``template`` (the
    optimizer's ``init``) gives each trace leaf's shape and device."""
    with np.load(path) as z:
        meta = z["_meta"]
        leaves = [z[f"leaf_{i}"] for i in range(len(template.trace) + 1)]
    trace = []
    for i, (leaf, t) in enumerate(zip(leaves, template.trace)):
        arr = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{path}: leaf_{i} has shape {leaf.shape}, the model's "
                             f"parameter {tuple(t.shape)}")
        trace.append(torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(t.device))
    opt_state = SGDState(trace, int(leaves[-1]))
    return opt_state, int(meta[0]) + 1, float(meta[1]), int(meta[2])


def _save_checkpoint(path: Path, model: yolov8.YOLOv8, spec) -> None:
    save_npz(path, model, class_names={i: str(i) for i in range(spec.nc)},
             variant=spec.variant, nc=spec.nc, reg_max=spec.reg_max, p2=int(spec.p2))


def _global_batch(args, hp: dict) -> int:
    return int(args.batch or hp.get("batch", 8))


def _check_batch(batch: int, world: int) -> None:
    if batch % world:
        raise SystemExit(f"geotrax_tpu_torch.train: --batch {batch} (the global batch) does "
                         f"not split over {world} ranks")


def train(args, logger=None) -> dict:
    slices = getattr(args, "slices", None) or 1
    device_arg = getattr(args, "device", "cuda")
    mesh = (make_hybrid_mesh(slices, getattr(args, "devices", None), device=device_arg)
            if slices > 1 else make_mesh(getattr(args, "devices", None), device=device_arg))
    writer = mesh.rank == 0
    if logger is None:  # the other ranks log warnings only, and to no file
        logger = setup_logger("geotrax.train" if writer else f"geotrax.train.rank{mesh.rank}",
                              args.verbose, dry_run=not writer)
        if not writer:
            logger.setLevel("WARNING")
    hp = load_config(args.cfg, logger).get("ultralytics", {})

    imgsz = int(args.imgsz or hp.get("imgsz", 640))
    batch = _global_batch(args, hp)
    _check_batch(batch, mesh.world_size)
    epochs = int(args.epochs or hp.get("epochs", 100))
    lr0 = float(hp.get("lr0", 0.01))
    lrf = float(hp.get("lrf", 0.01))
    momentum = float(hp.get("momentum", 0.937))
    weight_decay = float(hp.get("weight_decay", 5e-4))
    warmup_epochs = float(hp.get("warmup_epochs", 3.0))
    patience = int(hp.get("patience", 50))

    device = mesh.device
    if mesh.world_size > 1:
        logger.info(f"Data-parallel over {mesh.world_size} ranks {mesh.shape}, global batch "
                    f"{batch}.")

    resume = bool(getattr(args, "resume", False))
    out_dir = Path(args.out)
    # model: resumed, pretrained (converted), or fresh
    if resume:
        last = out_dir / "last.npz"
        state_path = out_dir / "trainer_state.npz"
        if not last.exists() or not state_path.exists():
            raise SystemExit(
                f"--resume needs {last} and {state_path} from a previous run")
        model, spec, _names = load_model(last, device=device)
        logger.info(f"Resuming from '{last}' (yolov8{spec.variant}, nc={spec.nc}).")
    elif args.model:
        model, spec, _names = load_model(Path(args.model), device=device)
        logger.info(f"Fine-tuning from '{args.model}' (yolov8{spec.variant}, nc={spec.nc}).")
    else:
        # the reference's model matrix accepts yolov8{n,s,m,l,x}[-p2]
        v = args.variant
        p2 = v.endswith("-p2")
        spec = yolov8.ModelSpec(variant=v[:-3] if p2 else v, nc=args.nc, p2=p2)
        generator = torch.Generator().manual_seed(int(hp.get("seed", 0) or 0))
        model = yolov8.init_params(generator, spec, device=device)
        logger.info(f"Training yolov8{spec.variant} (nc={spec.nc}) from scratch.")
    model.requires_grad_(True)
    shard_params(model, mesh)

    train_loader = Loader(args.data, "train", imgsz=imgsz, batch_size=batch,
                          max_gt=args.max_gt, training=True,
                          fraction=float(hp.get("fraction", 1.0)),
                          rows=batch_rows(batch, mesh))
    val_loader = Loader(args.data, "val", imgsz=imgsz, batch_size=batch,
                        max_gt=args.max_gt, training=False)

    steps_per_epoch = len(train_loader)
    total_steps = steps_per_epoch * epochs
    schedule = build_lr_schedule(
        lr0, lrf, int(warmup_epochs * steps_per_epoch), total_steps,
        bool(hp.get("cos_lr", False)),
    )
    optimizer = SGD(schedule, momentum=momentum, weight_decay=weight_decay)
    step = make_train_step(spec, optimizer, mesh, float(hp.get("box", 7.5)),
                           float(hp.get("cls", 0.5)), float(hp.get("dfl", 1.5)))

    if writer:
        out_dir.mkdir(parents=True, exist_ok=True)
    best_map = -1.0
    bad_epochs = 0
    start_epoch = 0
    history = []
    if resume and (out_dir / "metrics.jsonl").exists():
        # rebuild the in-memory history from the per-epoch JSONL (written
        # incrementally, so it survives the kill that made resume necessary)
        history = [json.loads(ln)
                   for ln in (out_dir / "metrics.jsonl").read_text().splitlines()
                   if ln.strip()]
    # persisted metrics: results.csv + metrics.jsonl + TensorBoard events,
    # flushed per epoch
    runlog = (RunLogger(out_dir, enable_tensorboard=not getattr(args, "no_tb", False))
              if writer else None)

    opt_state = optimizer.init(param_leaves(model))
    if resume:
        opt_state, start_epoch, best_map, bad_epochs = load_trainer_state(
            out_dir / "trainer_state.npz", opt_state)
        logger.info(f"Resumed at epoch {start_epoch} "
                    f"(best mAP@50 {best_map:.4f}, {bad_epochs} stagnant).")
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        for batch_np in train_loader.epoch(epoch):
            batch_np.pop("n_valid", None)  # loader bookkeeping, not data
            b = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
            opt_state, metrics = step(model, opt_state, b)
            losses.append(float(metrics["loss"]))
        mean_loss = float(np.mean(losses)) if losses else float("nan")

        # every rank evaluates; rank 0's numbers (and so its best/patience
        # decision) hold for all: a rank that stopped on its own would hang
        # the others in the next all-reduce
        val = broadcast_object(evaluate(model, spec, val_loader), mesh)
        # the reference logs the schedule called eagerly on a Python int
        lr_now = float(schedule(min((epoch + 1) * steps_per_epoch, total_steps), fused=False))
        history.append({"epoch": epoch, "loss": mean_loss, **val})
        # per-class P/R/mAP ride along as flat scalar columns
        flat_pc = {
            f"{m}_{c}": v[m]
            for c, v in val.get("per_class", {}).items()
            for m in ("precision", "recall", "ap50", "ap50_95")
        }
        if writer:
            runlog.log_epoch(epoch, {
                "loss": mean_loss,
                **{k: v for k, v in val.items()
                   if k not in ("per_class", "per_class_ap50")},
                **flat_pc, "lr": lr_now,
                "epoch_s": round(time.time() - t0, 2),
            })
        logger.info(
            f"epoch {epoch + 1}/{epochs}: loss {mean_loss:.4f} "
            f"mAP50 {val['map50']:.4f} mAP50-95 {val['map50_95']:.4f} "
            f"({time.time() - t0:.1f}s)"
        )

        if writer:
            _save_checkpoint(out_dir / "last.npz", model, spec)
        if val["map50"] > best_map:
            best_map = val["map50"]
            bad_epochs = 0
            if writer:
                _save_checkpoint(out_dir / "best.npz", model, spec)
        else:
            bad_epochs += 1
        # optimizer-state + loop-counter checkpoint: a killed run resumes
        # from here with --resume instead of starting over
        if writer:
            save_trainer_state(out_dir / "trainer_state.npz", opt_state, epoch, best_map,
                               bad_epochs)
        if bad_epochs >= patience:
            logger.notice(f"Early stop after {patience} stagnant epochs.")
            break

    # final single-class validation pass: class-agnostic P/R/mAP of the last
    # checkpoint (the reference's separate single_cls val run)
    val_single = broadcast_object(evaluate(model, spec, val_loader, single_cls=True), mesh)
    logger.info(
        f"single-class val: P {val_single['precision']:.4f} "
        f"R {val_single['recall']:.4f} mAP50 {val_single['map50']:.4f} "
        f"mAP50-95 {val_single['map50_95']:.4f}"
    )

    if writer:
        runlog.close()
        summary = {
            "history": history,
            "single_cls_val": {k: v for k, v in val_single.items()
                               if k not in ("per_class", "per_class_ap50")},
        }
        (out_dir / "history.json").write_text(json.dumps(history, indent=2))
        (out_dir / "val_summary.json").write_text(json.dumps(summary, indent=2))
    logger.notice(f"Training done: best mAP@50 {best_map:.4f}; checkpoints in '{out_dir}'.")
    return {"best_map50": best_map, "history": history,
            "single_cls_val": val_single}


def parse_cli_args(argv=None):
    parser = argparse.ArgumentParser(description="Train/fine-tune the YOLOv8 detector (PyTorch)")
    parser.add_argument("--data", type=Path, required=True,
                        help="Dataset root (images/{train,val} + labels/{train,val})")
    parser.add_argument("--model", type=str, default=None,
                        help="Pretrained checkpoint (.pt or .npz); omit to train from scratch")
    parser.add_argument("--variant", type=str, default="s",
                        choices=[v + sfx for v in "nsmlx" for sfx in ("", "-p2")])
    parser.add_argument("--nc", type=int, default=4, help="Number of classes")
    parser.add_argument("--cfg", "-c", type=str, default="default")
    parser.add_argument("--imgsz", type=int, default=None)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--max-gt", type=int, default=64, dest="max_gt")
    parser.add_argument("--devices", type=int, default=None,
                        help="Ranks of the data-parallel run: N processes on cuda:0..N-1 "
                             "(or on the CPU with --device cpu); under torchrun, the world "
                             "size it must equal")
    parser.add_argument("--slices", type=int, default=None,
                        help="Lay the ranks out as S slices (nodes) of N/S")
    parser.add_argument("--multihost", action="store_true",
                        help="Join the process group that torchrun's environment describes "
                             "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; "
                             "train/launch.sh starts one torchrun per node)")
    parser.add_argument("--out", type=Path, default=Path("runs/train"))
    parser.add_argument("--resume", action="store_true",
                        help="Resume a killed/preempted run from <out>/last.npz "
                             "+ <out>/trainer_state.npz (optimizer state, epoch, "
                             "best-mAP and patience counters all restored)")
    parser.add_argument("--no-tb", action="store_true", dest="no_tb",
                        help="Disable TensorBoard event files (results.csv/metrics.jsonl "
                             "always written)")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the step (default: the card; 'cpu' for the "
                             "plain CPU path)")
    return parser.parse_args(argv)


def _world_size(args) -> int:
    """The run's rank count, checked before any process starts: torchrun's
    WORLD_SIZE (which ``--devices`` must equal), else ``--devices``, which
    needs as many cards (unless ``--device cpu``); the global batch and
    ``--slices`` must split over it. Nothing falls back to fewer ranks."""
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.multihost and not torchrun:
        raise SystemExit("geotrax_tpu_torch.train: --multihost needs torchrun's environment "
                         "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); start it "
                         "through torchrun or train/launch.sh")
    if torchrun:
        world = int(os.environ["WORLD_SIZE"])
        if args.devices and args.devices != world:
            raise SystemExit(f"geotrax_tpu_torch.train: --devices {args.devices} disagrees "
                             f"with torchrun's WORLD_SIZE={world}")
    else:
        world = args.devices or 1
        cards = torch.cuda.device_count()
        if world > 1 and torch.device(args.device).type == "cuda" and cards < world:
            raise SystemExit(f"geotrax_tpu_torch.train: --devices {world} needs {world} cards; "
                             f"this machine has {cards}")
    slices = args.slices or 1
    if world % slices:
        raise SystemExit(f"geotrax_tpu_torch.train: {world} ranks do not split into "
                         f"--slices {slices}")
    hp = load_config(args.cfg, logging.getLogger("geotrax.train")).get("ultralytics", {})
    _check_batch(_global_batch(args, hp), world)
    return world


def main(argv=None):
    args = parse_cli_args(argv)
    if os.environ.get("GEOTRAX_MULTIHOST"):
        args.multihost = True
    world = _world_size(args)
    if world > 1 and "RANK" not in os.environ:
        try:
            spawn(train, world, args)
        except torch.multiprocessing.ProcessException as exc:
            raise SystemExit(f"geotrax_tpu_torch.train: rank {exc.error_index} of {world} "
                             f"failed; the run is stopped:\n{exc}") from None
        return
    try:
        train(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
