"""The training step on one device.

Counterpart of ``geotrax_tpu/parallel/mesh.py``'s ``make_mesh`` and
``make_train_step``. The reference shards the step over a ('data',
'model') mesh of TPU cores; the port runs it on one card. Data-parallel
training over several cards (``--devices N > 1``, ``--slices``,
``--multihost``; DDP in the port) and the sharded ``make_inference_step``
wait for ROADMAP A15b.
"""

from __future__ import annotations

from typing import Optional

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.models.convert import param_leaves
from geotrax_tpu_torch.models.loss import detection_loss

A15B_MESSAGE = ("data-parallel training over several cards (--devices N > 1, --slices, "
                "--multihost) is not ported yet: see ROADMAP A15b")


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> list:
    """The device list of a training run: one device. More than one exits
    with a message naming ROADMAP A15b."""
    if (n_devices or 1) > 1:
        raise SystemExit(f"geotrax_tpu_torch.train: {A15B_MESSAGE}")
    return [resolve_device(device)]


def make_train_step(spec, optimizer, box_gain: float = 7.5, cls_gain: float = 0.5,
                    dfl_gain: float = 1.5):
    """Build ``step(model, opt_state, batch, mark=None) -> (opt_state,
    metrics)``: loss, backward and the optimizer update (``train/optim.py``)
    of the model's parameters in place. ``batch`` holds the loader's arrays
    as tensors on the model's device; ``mark(name)``, when given, is called
    after the forward with the loss, after the backward and after the
    update (the smoke records CUDA events there). The gain knobs mirror cfg
    ultralytics box/cls/dfl."""

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
        opt_state = optimizer.update(params, [p.grad for p in params], opt_state)
        if mark:
            mark("update")
        return opt_state, {k: v.detach() for k, v in metrics.items()}

    return step
