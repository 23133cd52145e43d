"""The process layout of a training run, its data-parallel step, and
detection over several devices.

Counterpart of ``geotrax_tpu/parallel/mesh.py``. The reference lays its TPU
cores out as a ('data', 'model') mesh and lets GSPMD insert the
collectives. The port runs one process per rank in a ``torch.distributed``
process group (NCCL between cards; gloo on the CPU, or for ranks that
share one card):

- ``make_mesh`` / ``make_hybrid_mesh``: the layout of the process group
  (world size, rank, local rank, this rank's device, axis sizes); without
  a group, one rank. Under torchrun's environment (or ``spawn``'s) they
  join the group first.
- ``batch_spec`` / ``batch_rows`` / ``shard_batch``: rank r takes rows
  [r*B/n, (r+1)*B/n) of each global batch of B, the rows that the
  reference's ``NamedSharding(mesh, P("data"))`` places on data shard r.
- ``shard_params``: rank 0's weights, broadcast to every rank.
- ``make_train_step``: loss, backward, one all-reduce of the gradients
  flattened in ``param_leaves`` order (the step's metrics ride in the same
  buffer), divided by the world size, then the SGD update. The loss is a
  mean of per-image terms and YOLOv8's batch norm is folded, so the mean
  over ranks of each rank's mean is the global batch's: the reference's
  psum over 'data'. With one rank it runs no collective.
- ``make_inference_step``: (B,H,W,3) frames split in order over a list of
  devices in one process, one replica of the weights per device.

Tensor parallelism over conv output channels (the reference's
``_param_spec``) is not carried over (ROADMAP C8): every rank holds the
whole model (YOLOv8x is 68M parameters, 0.27 GB in float32), so a (dp, tp)
mesh of the reference becomes dp*tp data-parallel ranks with the same
update.
"""

from __future__ import annotations

import copy
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.models import yolov8
from geotrax_tpu_torch.models.convert import param_leaves
from geotrax_tpu_torch.models.loss import detection_loss
from geotrax_tpu_torch.ops.nms import postprocess_detections

# How long a rank waits to join the group or in a collective before it
# raises: a rank that died must not hold the others forever.
DIST_TIMEOUT = timedelta(minutes=15)
# the step's metrics: averaged over ranks, except fg (anchors assigned), summed
_MEAN_METRICS = ("loss", "box", "cls", "dfl")


@dataclass(frozen=True)
class Mesh:
    """The layout of the ranks of one run. ``shape`` holds the axis sizes:
    {'data': n}, or {'slice': S, 'data': n // S} from ``make_hybrid_mesh``;
    ranks are numbered slice-major."""

    shape: dict
    world_size: int
    rank: int
    local_rank: int
    device: torch.device


def _torchrun_env() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_device(device, local_rank: int) -> torch.device:
    """``device`` for this rank: a bare 'cuda' means the card of the local
    rank; an indexed one ('cuda:0') is taken as given (ranks sharing it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def init_process_group(device="cuda", backend: Optional[str] = None) -> None:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). The backend is NCCL
    on cards and gloo on the CPU unless ``backend`` names one (gloo for
    ranks that share a card, where NCCL refuses)."""
    if dist.is_initialized():
        return
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method="env://", timeout=DIST_TIMEOUT)


def _layout(n: int, device, backend: Optional[str]) -> tuple:
    """(rank, local rank, device) of this process in a layout of ``n``
    ranks, joining torchrun's group when its environment is set."""
    if not dist.is_initialized() and _torchrun_env():
        init_process_group(device, backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a layout of {n} devices needs a process group of {n} ranks; this "
                         f"process is in one of {world} (run through torchrun, launch.sh or "
                         f"`--devices {n}`)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return rank, local_rank, _rank_device(device, local_rank)


def _world(n_devices: Optional[int]) -> int:
    if n_devices:
        return int(n_devices)
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if _torchrun_env() else 1


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device="cuda", backend: Optional[str] = None) -> Mesh:
    """The layout of ``n_devices`` ranks (default: the process group's
    size, 1 without a group) as one 'data' axis. ``dp`` and ``tp`` keep the
    reference's check that dp * tp == n; both fold into 'data' (C8)."""
    n = _world(n_devices)
    tp = tp or 1
    dp = dp or n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    rank, local_rank, dev = _layout(n, device, backend)
    return Mesh({"data": n}, n, rank, local_rank, dev)


def make_hybrid_mesh(n_slices: int, n_devices: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None) -> Mesh:
    """The layout of ``n_devices`` ranks as ``n_slices`` slices of n/S: the
    reference's multi-slice pod (DCN between slices), here S nodes of
    torchrun's LOCAL_WORLD_SIZE ranks. The gradient's all-reduce is one
    collective over every rank, so NCCL crosses the network once per
    gradient, which is what the hybrid mesh buys on a pod."""
    n = _world(n_devices)
    if n % n_slices:
        raise ValueError(f"{n} devices do not split into {n_slices} slices")
    rank, local_rank, dev = _layout(n, device, backend)
    return Mesh({"slice": n_slices, "data": n // n_slices}, n, rank, local_rank, dev)


def batch_spec(mesh: Mesh) -> tuple:
    """The axes that a batch's first dimension is split over: ('slice',
    'data') on a hybrid layout, ('data',) otherwise."""
    return ("slice", "data") if "slice" in mesh.shape else ("data",)


def batch_rows(batch_size: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``batch_size``."""
    n = mesh.world_size
    if batch_size % n:
        raise ValueError(f"a global batch of {batch_size} does not split over {n} ranks")
    per = batch_size // n
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of each array of a global batch, as tensors on its
    device."""
    out = {}
    for key, value in batch.items():
        rows = value[batch_rows(len(value), mesh)]
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.ascontiguousarray(rows))
        out[key] = rows.to(mesh.device)
    return out


def _flat(tensors: list) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: list) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def shard_params(model: yolov8.YOLOv8, mesh: Mesh) -> yolov8.YOLOv8:
    """Broadcast rank 0's parameters (in ``param_leaves`` order, one
    buffer) so that every rank starts from one set of weights."""
    if mesh.world_size > 1:
        params = param_leaves(model)
        with torch.no_grad():
            flat = _flat(params)
            dist.broadcast(flat, src=0)
            _unflat(flat, params)
    return model


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if mesh.world_size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_mean(grads: list, metrics: dict, world_size: int) -> dict:
    """Average ``grads`` over the ranks in place, and the step's metrics
    (fg summed), in one all-reduce of one buffer."""
    stats = torch.stack([metrics[k].detach().float() for k in _MEAN_METRICS + ("fg",)])
    flat = torch.cat([_flat(grads), stats.to(grads[0].device)])
    dist.all_reduce(flat)
    n = flat.numel() - stats.numel()
    with torch.no_grad():
        _unflat(flat[:n] / world_size, grads)
    stats = flat[n:]
    out = {k: stats[i] / world_size for i, k in enumerate(_MEAN_METRICS)}
    out["fg"] = stats[-1].round().to(metrics["fg"].dtype)
    return out


def make_train_step(spec, optimizer, mesh: Optional[Mesh] = None, box_gain: float = 7.5,
                    cls_gain: float = 0.5, dfl_gain: float = 1.5):
    """Build ``step(model, opt_state, batch, mark=None) -> (opt_state,
    metrics)``: loss, backward, the gradients' all-reduce over ``mesh``'s
    ranks (none with one rank) and the optimizer update
    (``train/optim.py``) of the model's parameters in place. ``batch``
    holds this rank's rows of the global batch as tensors on its device;
    the metrics are the global batch's. ``mark(name)``, when given, is
    called after the forward with the loss, after the backward, after the
    all-reduce (several ranks only) and after the update (the smoke records
    CUDA events there). The gain knobs mirror cfg ultralytics box/cls/dfl."""
    world = mesh.world_size if mesh is not None else 1

    def step(model, opt_state, batch, mark=None):
        params = param_leaves(model)
        for p in params:
            p.grad = None
        loss, metrics = detection_loss(model, batch["images"], batch["gt_boxes"],
                                       batch["gt_cls"], batch["gt_mask"], spec,
                                       box_gain, cls_gain, dfl_gain)
        if mark:
            mark("forward")
        loss.backward()
        if mark:
            mark("backward")
        grads = [p.grad for p in params]
        if world > 1:
            metrics = all_reduce_mean(grads, metrics, world)
            if mark:
                mark("all_reduce")
        opt_state = optimizer.update(params, grads, opt_state)
        if mark:
            mark("update")
        return opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


def replica(model: torch.nn.Module, device: torch.device, copies: dict) -> torch.nn.Module:
    """``model`` itself on its own device, else its copy on ``device`` (kept
    in ``copies``) with the weights refreshed from ``model``."""
    own = next(model.parameters()).device
    if own == device:
        return model
    held = copies.get(device)
    if held is None or held[0] is not model:
        copies[device] = (model, copy.deepcopy(model).to(device))
    else:
        with torch.no_grad():
            for a, b in zip(held[1].parameters(), model.parameters()):
                a.copy_(b)
    return copies[device][1]


def make_inference_step(spec, devices, conf: float = 0.25, iou: float = 0.7,
                        max_det: int = 300):
    """Batched detection over several devices of one process: ``run(model,
    frames)`` splits (B,H,W,3) images in order over ``devices`` (a list of
    torch devices; one may repeat), runs ``yolov8.forward`` and the batched
    ``postprocess_detections`` on each device's part with a replica of the
    weights there, and returns the fixed-slot detections concatenated in
    frame order on the first device."""
    devices = [torch.device(d) for d in devices]
    copies: dict = {}

    def run(model, frames):
        outs = []
        with torch.no_grad():
            for dev, part in zip(devices, torch.tensor_split(frames, len(devices))):
                if len(part):
                    m = replica(model, dev, copies)
                    boxes, probs = yolov8.forward(m, part.to(dev), spec)
                    outs.append(postprocess_detections(boxes, probs, conf, iou, max_det))
        return {k: torch.cat([o[k].to(devices[0]) for o in outs]) for k in outs[0]}

    return run


def free_port() -> int:
    """A free TCP port on this host (for MASTER_PORT)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank: int, fn, world_size: int, port: int, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args) -> None:
    """Run ``fn(*args)`` in ``world_size`` new processes on this host, each
    with torchrun's environment for its rank, so that ``make_mesh`` there
    joins one group of ``world_size``. ``fn`` must be importable (it is
    pickled by name). A rank that fails ends the others, and this raises
    ``torch.multiprocessing.ProcessException`` naming it."""
    torch.multiprocessing.start_processes(_spawned, args=(fn, world_size, free_port(), args),
                                          nprocs=world_size, start_method="spawn")
