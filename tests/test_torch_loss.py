"""The training losses of the port against the JAX package, values and
gradients: ``ciou``, ``task_aligned_assign`` and ``detection_loss``
(``models/loss.py``), and RT-DETR's ``detr_loss``. Weights are carried over
with ``params_from_jax``; the gradients are ``jax.value_and_grad``'s against
``backward()``'s, for every parameter.

Tolerances (float32; the convolutions sum in other orders on the two
backends): the loss and its parts within rel 1e-5, each parameter's
gradient within a relative L2 error of 1e-4 (of its norm, or of 1e-6 of
the whole gradient's norm where that is larger), CIoU within 1e-6 (values) and
1e-5 (gradients), the assignment's integer and boolean outputs equal and
its ``align``/``ious`` within 1e-6."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.models import loss as jloss
from geotrax_tpu.models import rtdetr as jrt
from geotrax_tpu.models import yolov8 as jy
from geotrax_tpu_torch.models import loss as tloss
from geotrax_tpu_torch.models import rtdetr as trt
from geotrax_tpu_torch.models import yolov8 as ty
from geotrax_tpu_torch.models.convert import _restore_lists

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for torch: the models are tiny, and the suite
    runs a worker on every core, where a thread pool per worker makes every
    one wait (autouse, so it is set before the module's other fixtures)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grad(p: torch.nn.Parameter) -> np.ndarray:
    """A parameter's gradient; zeros where the loss does not reach it, as
    JAX's gradient is there."""
    g = (torch.zeros_like(p) if p.grad is None else p.grad).detach().numpy()
    return g.transpose(2, 3, 1, 0) if g.ndim == 4 else g


def grad_tree(module):
    """The port's gradients as the JAX params tree (HWIO conv kernels)."""
    if isinstance(module, ty.ConvBN):
        return {"b": _grad(module.bias), "w": _grad(module.weight)}
    if isinstance(module, torch.nn.ModuleList):
        return [grad_tree(m) for m in module]
    if isinstance(module, torch.nn.Parameter):
        return _grad(module)
    children = dict(module.named_children())
    params = {k: v for k, v in module.named_parameters(recurse=False)}
    return {**{k: grad_tree(v) for k, v in children.items()},
            **{k: grad_tree(v) for k, v in params.items()}}


def assert_grads_close(jax_grads, port_grads, tol=GRAD_REL_L2):
    """Every leaf of the JAX gradient tree against the port's: the L2 error
    relative to the leaf's norm, or to 1e-6 of the whole gradient's norm
    where that is larger (a leaf whose gradient is zero in exact arithmetic,
    as attention's key biases under the softmax, holds rounding noise on
    both sides)."""
    leaves = jax.tree_util.tree_flatten_with_path(jax_grads)[0]
    assert leaves
    floor = 1e-6 * np.sqrt(sum(float(np.sum(np.square(np.asarray(x)))) for _, x in leaves))
    worst = 0.0
    for path, want in leaves:
        got = port_grads
        for key in path:
            got = got[key.key if hasattr(key, "key") else key.idx]
        want = np.asarray(want)
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), floor)
        assert err <= tol, (jax.tree_util.keystr(path), err)
        worst = max(worst, err)
    return worst, len(leaves)


def random_boxes(rng, n, lo=0.0, hi=60.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(1.0, 30.0, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_ciou_values_and_gradients():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 64), random_boxes(rng, 64)
    # ties: shared edges (max/min at equality), touching and disjoint boxes
    b[:8, :2] = a[:8, :2]
    b[8:16, 0] = a[8:16, 2]
    b[16:24] = a[16:24]
    w = rng.standard_normal(64).astype(np.float32)

    def jfn(x, y):
        return jnp.sum(jloss.ciou(x, y) * w)

    jv = jloss.ciou(jnp.asarray(a), jnp.asarray(b))
    jga, jgb = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tv = tloss.ciou(ta, tb)
    (tv * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jga), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=1e-5, atol=1e-5)


def assignment_inputs(seed=1, b=2, g=5, nc=3):
    """Predictions over a 64x64 input's anchors; GT with a duplicate row
    (IoUs tied across GTs) and padded rows."""
    rng = np.random.default_rng(seed)
    anchors, strides = jy.make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    anchors_px = np.asarray(anchors) * np.asarray(strides)[:, None]
    a = anchors_px.shape[0]
    centers = anchors_px[None] + rng.uniform(-3, 3, (b, a, 2))
    wh = rng.uniform(8, 40, (b, a, 2))
    pred = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.01, 0.99, (b, a, nc)).astype(np.float32)
    gt = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), bool)
    gt[0, :3] = [[20, 30, 24, 16], [20, 30, 24, 16], [45, 35, 30, 20]]
    cls[0, :3] = [0, 1, 2]
    mask[0, :3] = True
    gt[1, :4] = [[32, 32, 40, 30], [10, 8, 14, 12], [50, 50, 20, 20], [5, 60, 8, 6]]
    cls[1, :4] = [1, 0, 2, 5]    # class 5 is out of range: clipped, as the reference
    mask[1, :4] = True
    return scores, pred, anchors_px.astype(np.float32), gt, cls, mask


def test_task_aligned_assign_matches():
    scores, pred, anchors_px, gt, cls, mask = assignment_inputs()
    got = tloss.task_aligned_assign(*(torch.from_numpy(x) for x in (
        scores, pred, anchors_px, gt, cls, mask)))
    names = ("best_gt", "fg", "align", "ious", "pos_mask")
    fg_total = 0
    for i in range(scores.shape[0]):
        want = jloss.task_aligned_assign(jnp.asarray(scores[i]), jnp.asarray(pred[i]),
                                         jnp.asarray(anchors_px), jnp.asarray(gt[i]),
                                         jnp.asarray(cls[i]), jnp.asarray(mask[i]))
        for name, w, t in zip(names, want, got):
            w, t = np.asarray(w), t[i].numpy()
            if name in ("align", "ious"):
                np.testing.assert_allclose(t, w, rtol=0, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(t, w, err_msg=name)
        fg_total += int(np.asarray(want[1]).sum())
    assert fg_total > 0
    # the duplicated GT row never wins an anchor: argmax's lowest index
    assert not got[4][0, :, 1].any() and got[4][0, :, 0].any()


@pytest.fixture(scope="module")
def yolo_case():
    """yolov8n, nc=2, imgsz 64, batch 2: letterboxed images (a 114 border
    above and below), padded GT rows, a duplicated GT (tied IoUs) and a GT
    inside the border."""
    spec = jy.ModelSpec(variant="n", nc=2)
    params = jy.init_params(jax.random.PRNGKey(0), spec)
    rng = np.random.default_rng(0)
    img = np.full((2, 64, 64, 3), 114, np.uint8)
    img[:, 12:52] = rng.integers(0, 256, (2, 40, 64, 3))
    images = img.astype(np.float32) * np.float32(1 / 255)
    gt = np.zeros((2, 6, 4), np.float32)
    cls = np.zeros((2, 6), np.int32)
    mask = np.zeros((2, 6), bool)
    gt[0, :4] = [[20, 30, 24, 16], [20, 30, 24, 16], [45, 35, 30, 20], [30, 6, 20, 10]]
    cls[0, :4] = [0, 1, 1, 0]
    mask[0, :4] = True
    gt[1, :2] = [[32, 32, 40, 30], [10, 8, 14, 12]]
    cls[1, :2] = [1, 0]
    mask[1, :2] = True
    return spec, params, images, gt, cls, mask


def test_detection_loss_and_every_gradient(yolo_case):
    spec, params, images, gt, cls, mask = yolo_case
    (jv, jm), jg = jax.value_and_grad(
        lambda p: jloss.detection_loss(p, jnp.asarray(images), jnp.asarray(gt), jnp.asarray(cls),
                                       jnp.asarray(mask), spec), has_aux=True)(params)
    model = ty.params_from_jax(jax.tree.map(np.asarray, params), ty.ModelSpec(*spec), device="cpu")
    model.requires_grad_(True)
    tv, tm = tloss.detection_loss(model, *(torch.from_numpy(x) for x in (images, gt, cls, mask)),
                                  ty.ModelSpec(*spec))
    tv.backward()
    assert int(tm["fg"]) == int(jm["fg"]) > 0
    for key in ("loss", "box", "cls", "dfl"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    worst, n = assert_grads_close(jg, {"layers": grad_tree(model.layers)})
    assert n == 2 * sum(1 for m in model.modules() if isinstance(m, ty.ConvBN))


def test_trainable_only_when_asked(yolo_case):
    spec, params, *_ = yolo_case
    model = ty.params_from_jax(jax.tree.map(np.asarray, params), ty.ModelSpec(*spec), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    assert all(p.requires_grad for p in model.parameters())


DETR_SPEC = jrt.RTDETRSpec(variant="n", nc=4, hidden=64, num_queries=30,
                           num_decoder_layers=2, num_heads=4, num_points=2)


def test_detr_loss_and_gradients():
    params = jrt.init_params(jax.random.PRNGKey(0), DETR_SPEC)
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    gt = rng.uniform(15, 50, (2, 5, 4)).astype(np.float32)
    cls = rng.integers(0, 4, (2, 5)).astype(np.int32)
    mask = np.array([[True] * 3 + [False] * 2, [True] * 5])
    (jv, jm), jg = jax.value_and_grad(
        lambda p: jrt.detr_loss(p, jnp.asarray(images), jnp.asarray(gt), jnp.asarray(cls),
                                jnp.asarray(mask), DETR_SPEC), has_aux=True)(params)
    tree = _restore_lists(jax.tree.map(np.asarray, params))
    model = trt.params_from_jax(tree, trt.RTDETRSpec(*DETR_SPEC), device="cpu")
    model.requires_grad_(True)
    tv, tm = trt.detr_loss(model, *(torch.from_numpy(x) for x in (images, gt, cls, mask)),
                           trt.RTDETRSpec(*DETR_SPEC))
    tv.backward()
    for key in ("loss", "cls", "l1", "giou"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    port = {"backbone": grad_tree(model.backbone.layers), **grad_tree(model.p)}
    assert_grads_close(jg, port)
