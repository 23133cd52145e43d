"""Ranks of the port's data-parallel step for tests/test_torch_mesh.py,
without JAX: ``python tests/torch_mesh_worker.py MODEL.npz BATCHES.npz OUT
--world N [--slices S] [--device cuda:0 --backend gloo]`` spawns N ranks
(gloo on the CPU by default; the card test shares one card between gloo
ranks) through ``parallel/mesh.py:spawn``; each joins the group (``make_mesh`` or
``make_hybrid_mesh``), takes rank 0's weights (``shard_params``), runs the
step (``make_train_step``, the trainer's SGD and schedule) on its rows
(``shard_batch``) of each global batch in BATCHES.npz (``images_<i>``,
``gt_boxes_<i>``, ...) and writes OUT/rank<r>.npz: the metrics of every
step, then the parameters and momentum trace in ``param_leaves`` order."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from geotrax_tpu_torch.models.convert import load_model, param_leaves  # noqa: E402
from geotrax_tpu_torch.parallel.mesh import (  # noqa: E402
    make_hybrid_mesh, make_mesh, make_train_step, shard_batch, shard_params, spawn,
)
from geotrax_tpu_torch.train.optim import SGD, build_lr_schedule  # noqa: E402

# the optimizer of the comparison: warmup over one step, so that the second
# step moves the weights; the trainer's momentum and weight decay
SCHEDULE = (0.01, 0.01, 1, 10, False)
MOMENTUM, WEIGHT_DECAY = 0.937, 5e-4
KEYS = ("images", "gt_boxes", "gt_cls", "gt_mask")


def rank_main(model_path: str, batches_path: str, out: str, slices: int, device: str,
              backend) -> None:
    torch.set_num_threads(1)
    mesh = (make_hybrid_mesh(slices, device=device, backend=backend) if slices > 1
            else make_mesh(device=device, backend=backend))
    model, spec, _ = load_model(Path(model_path), device=mesh.device)
    model.requires_grad_(True)
    shard_params(model, mesh)
    optimizer = SGD(build_lr_schedule(*SCHEDULE), MOMENTUM, WEIGHT_DECAY)
    step = make_train_step(spec, optimizer, mesh)
    state = optimizer.init(param_leaves(model))
    saved = {}
    with np.load(batches_path) as z:
        n_steps = sum(1 for k in z.files if k.startswith("images_"))
        for i in range(n_steps):
            batch = shard_batch({k: z[f"{k}_{i}"] for k in KEYS}, mesh)
            saved[f"rows_{i}"] = batch["images"].cpu().numpy()
            state, metrics = step(model, state, batch)
            for k, v in metrics.items():
                saved[f"{k}_{i}"] = v.cpu().numpy()
    for i, p in enumerate(param_leaves(model)):
        saved[f"param_{i}"] = p.detach().cpu().numpy()
        saved[f"trace_{i}"] = state.trace[i].cpu().numpy()
    saved["count"] = np.asarray(state.count)
    saved["shape"] = np.asarray([mesh.shape.get("slice", 1), mesh.shape["data"]])
    np.savez(Path(out) / f"rank{mesh.rank}.npz", **saved)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("model")
    parser.add_argument("batches")
    parser.add_argument("out")
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--slices", type=int, default=1)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--backend", default=None)
    args = parser.parse_args()
    spawn(rank_main, args.world, args.model, args.batches, args.out, args.slices, args.device,
          args.backend)


if __name__ == "__main__":
    main()
