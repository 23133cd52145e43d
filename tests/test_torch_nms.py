"""The detector's NMS and post-processing against the JAX package's, on the
CPU, compared exactly: ``nms_torch`` (the plain version, the CPU route of
``nms`` and the oracle of csrc/nms.cu) and ``postprocess_detections`` on a
suppression chain deeper than NMS_ROUNDS_PER_CHECK, equal scores,
per-class suppression, fewer candidates than slots, no alive candidate,
every candidate alive and batches (``jax.vmap`` on the JAX side); the
routing of ``nms`` on the CPU; the RANSAC refinement's eigensolver (the
same on every device) against ``torch.linalg.eigh``; and a steady chunk
step of the fused extractor, which reads back to the host only inside the
plain versions and copies nothing from the host but through
``_device.to_device``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile, record_function

from geotrax_tpu.ops import nms as jnms
from geotrax_tpu_torch import _cuda, _device
from geotrax_tpu_torch.ops import assignment
from geotrax_tpu_torch.ops import homography as th
from geotrax_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)

IOU = 0.7


def clustered(n, seed, objects=None, alive=None, ties=False, classes=3):
    """(boxes (n, 4) xyxy, scores (n,), classes (n,)) float32 / int32:
    clusters of jittered duplicates (deep suppression chains) of
    ``objects`` vehicles; the first ``alive`` candidates (all by default)
    score in (0.05, 1), the rest 0; ``ties`` draws scores from five values."""
    rng = np.random.default_rng(seed)
    objects = objects or max(n // 6, 1)
    alive = n if alive is None else alive
    centre = rng.uniform(20, 300, (objects, 2))[rng.integers(0, objects, n)]
    xy = centre + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(10, 30, (n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    if ties:
        scores = rng.choice(np.float32([0.3, 0.5, 0.6, 0.8, 0.9]), n).astype(np.float32)
    else:
        scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    scores[alive:] = 0.0
    return boxes, scores, rng.integers(0, classes, n).astype(np.int32)


def chain(n, step=12.0, width=100.0, height=40.0):
    """A row of ``n`` boxes in score order, each over IOU with the next and
    under it with the one after: greedy keeps every other box, and the
    fixed point needs about n rounds."""
    x = np.arange(n, dtype=np.float32) * np.float32(step)
    boxes = np.stack([x, np.zeros_like(x), x + np.float32(width), np.full_like(x, height)], -1)
    return boxes, np.linspace(1.0, 0.5, n, dtype=np.float32), np.zeros(n, np.int32)


CASES = {
    # name: (boxes, scores, classes, max_det, agnostic)
    "chain of 40": (*chain(40), 30, True),
    "equal scores": (*clustered(120, 1, ties=True), 100, True),
    "per class": (*clustered(150, 2, classes=4), 100, False),
    "fewer candidates than slots": (*clustered(30, 3), 50, True),
    "fewer than slots, per class": (*clustered(30, 4), 50, False),
    "no alive candidate": (*clustered(64, 5, alive=0), 20, True),
    "every candidate alive": (*clustered(256, 6, objects=200), 300, True),
    "max_det cuts the kept": (*clustered(200, 7, objects=150), 10, True),
    "absent candidates between": (*clustered(90, 8, alive=60), 40, False),
}


def jax_nms(boxes, scores, classes, max_det, agnostic):
    keep, valid = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), IOU, max_det,
                           class_ids=jnp.asarray(classes), agnostic=agnostic)
    return np.asarray(keep), np.asarray(valid)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_nms_equals_the_reference(name):
    boxes, scores, classes, max_det, agnostic = CASES[name]
    keep, valid = tnms.nms_torch(torch.from_numpy(boxes), torch.from_numpy(scores), IOU, max_det,
                                 class_ids=torch.from_numpy(classes), agnostic=agnostic)
    rk, rv = jax_nms(boxes, scores, classes, max_det, agnostic)
    np.testing.assert_array_equal(valid.numpy(), rv)
    np.testing.assert_array_equal(keep.numpy(), rk)
    if name == "chain of 40":  # every other box, deeper than a block of rounds
        assert 40 > 4 * tnms.NMS_ROUNDS_PER_CHECK
        np.testing.assert_array_equal(keep.numpy()[:20], np.arange(0, 40, 2))
    if name == "no alive candidate":
        assert not valid.any() and not keep.any()


@pytest.mark.parametrize("agnostic", [True, False])
@pytest.mark.parametrize("names", [("per class", "equal scores"),
                                   ("every candidate alive", "max_det cuts the kept",
                                    "no alive candidate")])
def test_plain_nms_batch_equals_the_reference_vmapped(agnostic, names):
    """One call over a batch (the chunk step's form) equals the reference
    vmapped over the same images, and each image's call alone."""
    n = min(len(CASES[k][1]) for k in names)
    boxes = np.stack([CASES[k][0][:n] for k in names])
    scores = np.stack([CASES[k][1][:n] for k in names])
    classes = np.stack([CASES[k][2][:n] for k in names])
    max_det = 25
    keep, valid = tnms.nms_torch(torch.from_numpy(boxes), torch.from_numpy(scores), IOU, max_det,
                                 class_ids=torch.from_numpy(classes), agnostic=agnostic)
    rk, rv = jax.vmap(lambda b, s, c: jnms.nms(b, s, IOU, max_det, class_ids=c,
                                               agnostic=agnostic))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rk))
    for i in range(len(names)):
        ki, vi = tnms.nms_torch(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]), IOU,
                                max_det, class_ids=torch.from_numpy(classes[i]),
                                agnostic=agnostic)
        torch.testing.assert_close(ki, keep[i], rtol=0, atol=0)
        torch.testing.assert_close(vi, valid[i], rtol=0, atol=0)


def head(b, n, nc, seed, conf_share=0.3):
    """Seeded head outputs: (b, n, 4) xywh boxes in clusters and (b, n, nc)
    class probabilities, about ``conf_share`` of the anchors over 0.25."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([clustered(n, seed + i)[0] for i in range(b)])
    xywh = np.concatenate([(boxes[..., :2] + boxes[..., 2:]) / 2, boxes[..., 2:] - boxes[..., :2]],
                          -1).astype(np.float32)
    probs = (rng.uniform(0, 1, (b, n, nc)) ** (1 / conf_share - 1)).astype(np.float32)
    probs[:, ::9] = 0.0  # anchors under every threshold
    return xywh, probs


@pytest.mark.parametrize("agnostic", [True, False])
@pytest.mark.parametrize("conf,max_det,masked", [(0.25, 1000, False), (0.001, 300, False),
                                                 (0.25, 40, True)])
def test_postprocess_equals_the_reference(agnostic, conf, max_det, masked):
    """postprocess_detections over a batch (top-k preselection, per-class
    offset, NMS, gathers) equals the reference vmapped: the default preset,
    training's evaluate (conf 0.001, max_det 300) and a class filter."""
    xywh, probs = head(3, 1500, 4, 11)
    mask = np.array([True, False, True, True]) if masked else None
    ours = tnms.postprocess_detections(torch.from_numpy(xywh), torch.from_numpy(probs), conf, IOU,
                                       max_det, None if mask is None else torch.from_numpy(mask),
                                       agnostic=agnostic)
    ref = jax.vmap(lambda b, p: jnms.postprocess_detections(
        b, p, conf, IOU, max_det, None if mask is None else jnp.asarray(mask),
        agnostic=agnostic))(jnp.asarray(xywh), jnp.asarray(probs))
    assert 0 < int(np.asarray(ref["valid"]).sum())
    for key in ("boxes_xywh", "scores", "classes", "valid"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_cpu_route_is_the_plain_version_and_loads_no_library(monkeypatch):
    """On CPU tensors ``nms`` is ``nms_torch`` (its count moves, the
    kernel's does not) and builds or loads no library; the kernel's call
    refuses CPU tensors and ``nms`` another device type, naming them."""
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    boxes, scores, classes, max_det, agnostic = CASES["per class"]
    before_calls, before_launches = tnms.nms_torch.calls, tnms.nms_sorted.launches
    keep, valid = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), IOU, max_det,
                           class_ids=torch.from_numpy(classes), agnostic=agnostic)
    assert tnms.nms_torch.calls == before_calls + 1 and tnms.nms_sorted.launches == before_launches
    rk, rv = jax_nms(boxes, scores, classes, max_det, agnostic)
    np.testing.assert_array_equal(keep.numpy(), rk)
    order, sorted_boxes, sorted_scores = tnms.sorted_candidates(
        torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
        torch.from_numpy(classes)[None], agnostic)
    with pytest.raises(ValueError, match="CUDA device"):
        tnms.nms_sorted(sorted_boxes, sorted_scores, order, IOU, max_det)
    meta = torch.empty((2, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tnms.nms(torch.empty((2, 5, 4), device="meta"), meta, IOU, max_det)
    assert tnms.nms_torch.calls == before_calls + 1


def reference_top_k(xywh, probs, conf, max_det, mask=None):
    """The reference's own candidates before its NMS (geotrax_tpu's
    postprocess_detections up to its exact_top_k, vmapped): (classes int32,
    top scores, top indices) as numpy."""
    from geotrax_tpu.ops.topk import exact_top_k as jax_top_k

    probs = jnp.asarray(probs)
    if mask is not None:
        probs = jnp.where(jnp.asarray(mask)[None, None, :], probs, 0.0)
    scores = probs.max(axis=-1)
    classes = probs.argmax(axis=-1)
    scores = jnp.where(scores >= conf, scores, 0.0)
    k = min(max(2 * max_det, 1024), scores.shape[-1])
    top_scores, top_idx = jax.vmap(lambda s: jax_top_k(s, k))(scores)
    return (np.array(classes, np.int32), np.array(top_scores), np.array(top_idx, np.int64))


def topk_case(name):
    """(xywh, probs, conf, max_det, mask) of a post-processing case."""
    xywh, probs = head(2, 1500, 4, 21)
    conf, max_det, mask = 0.25, 1000, None
    if name == "max_det under the kept":
        conf, max_det = 0.001, 20
    elif name == "K under max_det":
        xywh, probs = xywh[:, :300], probs[:, :300]
    elif name == "class mask":
        mask = np.array([True, False, True, True])
    elif name == "tied scores":
        rng = np.random.default_rng(3)
        probs = rng.choice(np.float32([0.0, 0.3, 0.5, 0.5, 0.9]), probs.shape).astype(np.float32)
    elif name == "nan and inf boxes":
        xywh = xywh.copy()
        top = np.argsort(-probs.max(-1), axis=-1, kind="stable")
        xywh[0, top[0, 3], 0] = np.nan  # a kept candidate's centre
        xywh[0, top[0, 10], 2] = np.inf  # another's width
        xywh[1, top[1, 5], 1] = -np.inf
    return xywh, probs, conf, max_det, mask


TOPK_CASES = ["default", "max_det under the kept", "K under max_det", "class mask",
              "tied scores", "nan and inf boxes"]


@pytest.mark.parametrize("agnostic", [True, False])
@pytest.mark.parametrize("name", TOPK_CASES)
def test_plain_topk_postprocessing_equals_the_reference(name, agnostic):
    """postprocess_topk_torch (the fused kernel's oracle and its CPU route),
    fed the reference's own top-K candidates, gives the reference's
    postprocess_detections exactly: max_det above and under the kept count,
    fewer candidates than slots, a class mask, tied scores, NaN and infinite
    box coordinates (the per-class span turns NaN)."""
    xywh, probs, conf, max_det, mask = topk_case(name)
    classes, top_scores, top_idx = reference_top_k(xywh, probs, conf, max_det, mask)
    ours = tnms.postprocess_topk_torch(torch.from_numpy(xywh), torch.from_numpy(classes),
                                       torch.from_numpy(top_scores), torch.from_numpy(top_idx),
                                       IOU, max_det, agnostic)
    ref = jax.vmap(lambda b, p: jnms.postprocess_detections(
        b, p, conf, IOU, max_det, None if mask is None else jnp.asarray(mask),
        agnostic=agnostic))(jnp.asarray(xywh), jnp.asarray(probs))
    kept = np.asarray(ref["valid"]).sum(axis=-1)
    assert kept.min() > 0
    if name == "max_det under the kept":
        assert (kept == max_det).all()
    if name == "K under max_det":
        assert top_scores.shape[-1] < max_det
    for key in ("boxes_xywh", "scores", "classes", "valid"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
    if name == "nan and inf boxes":
        assert np.isnan(ours["boxes_xywh"].numpy()).any()


@pytest.mark.parametrize("k", [1024, 3000])
def test_exact_top_k_order_is_the_stable_argsort(k):
    """The fused kernel skips the reference's stable argsort of the top-K
    scores: on scores thresholded as postprocess_detections thresholds them
    (ties, zeros, and NaN in the class probabilities, which the threshold
    maps to 0), exact_top_k's order is the stable descending argsort's, so
    that argsort is the identity; and its indices are the reference's."""
    from geotrax_tpu_torch.ops.topk import exact_top_k

    rng = np.random.default_rng(k)
    probs = np.zeros((3, 3000, 4), np.float32)
    best = rng.choice(np.float32([0.0, 0.1, 0.3, 0.3, 0.6, 0.6, 0.9]), (3, 3000))
    np.put_along_axis(probs, rng.integers(0, 4, (3, 3000, 1)), best[..., None], axis=-1)
    probs[rng.uniform(size=probs.shape) < 0.05] = np.nan
    p = torch.from_numpy(probs)
    scores = p.amax(dim=-1)
    scores = torch.where(scores >= 0.25, scores, 0.0)
    assert torch.isnan(p).any() and not torch.isnan(scores).any()
    top_scores, top_idx = exact_top_k(scores, k)
    identity = torch.arange(k).expand(3, k)
    assert torch.equal(torch.argsort(-top_scores, dim=-1, stable=True), identity)
    assert (top_scores[:, 1:] == top_scores[:, :-1]).any()
    assert bool((top_scores == 0).any()) == (k == 3000)
    _, ref_scores, ref_idx = reference_top_k(np.zeros((3, 3000, 4), np.float32), probs, 0.25,
                                             k // 2)
    np.testing.assert_array_equal(top_idx.numpy(), ref_idx)
    np.testing.assert_array_equal(top_scores.numpy(), ref_scores)


# clusters of each size an H100 (132 SMs) holds at once, as csrc/nms.cu's
# nms_max_clusters reports them for 2000 candidates
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
H100_SHARED = 227248


@pytest.mark.parametrize("b,n,want", [(1, 2000, 16), (4, 2000, 16), (8, 1024, 8),
                                      (32, 2000, 2), (132, 2000, 1), (200, 2000, 1),
                                      (1, 131072, 16), (32, 131072, 16), (1, 37, 1),
                                      (4, 100, 2), (1, 192, 4)])
def test_cluster_size_choices(b, n, want):
    """The largest cluster whose b copies the card holds at once (the batch
    in one wave), among those whose blocks' shared memory holds the image
    and that have a tile for each block (up to the next power of two):
    B = 1, 4 and 8 take 16, 16 and 8 blocks an image, 32 takes 2 (the card
    holds 30 clusters of 4), 132 one; a batch no size fits in one wave
    takes the smallest that launches; the image's candidates can force a
    larger cluster, and a one-tile image takes one block."""
    asked = []

    def clusters(c, shared):
        asked.append((c, shared))
        return H100_CLUSTERS[c]

    assert tnms.cluster_size(b, n, H100_SHARED, clusters) == want
    assert all(shared == tnms.shared_bytes(n, c) <= H100_SHARED for c, shared in asked)
    assert tnms.shared_bytes(2000, 2) == 16 * tnms.TILE_BYTES


def test_cluster_size_refuses_what_no_cluster_holds():
    with pytest.raises(ValueError, match="no cluster"):
        tnms.cluster_size(1, 131072, 100_000, lambda c, s: 7)
    with pytest.raises(ValueError, match="no cluster"):
        tnms.cluster_size(1, 2000, H100_SHARED, lambda c, s: 0)


def test_topk_cpu_route_is_the_plain_version_and_loads_no_library(monkeypatch):
    """On CPU tensors postprocess_topk and postprocess_detections run
    postprocess_topk_torch (its count moves, the kernel's does not) and
    build or load no library; another device type is refused by name."""
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    xywh, probs, conf, max_det, _ = topk_case("default")
    classes, top_scores, top_idx = reference_top_k(xywh, probs, conf, max_det)
    calls, launches = tnms.postprocess_topk_torch.calls, tnms.postprocess_topk.launches
    args = (torch.from_numpy(xywh), torch.from_numpy(classes), torch.from_numpy(top_scores),
            torch.from_numpy(top_idx), IOU, max_det)
    out = tnms.postprocess_topk(*args, False)
    assert tnms.postprocess_topk_torch.calls == calls + 1
    for key, value in tnms.postprocess_topk_torch(*args, False).items():
        torch.testing.assert_close(out[key], value, rtol=0, atol=0, equal_nan=True)
    det = tnms.postprocess_detections(torch.from_numpy(xywh), torch.from_numpy(probs), conf, IOU,
                                      max_det, agnostic=False)
    assert tnms.postprocess_topk_torch.calls == calls + 3
    assert tnms.postprocess_topk.launches == launches
    torch.testing.assert_close(det["valid"], out["valid"], rtol=0, atol=0)
    meta = torch.empty((2, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tnms.postprocess_topk(torch.empty((2, 5, 4), device="meta"), meta.int(), meta,
                              meta.long(), IOU, max_det)


def refinement_system(n, noise, seed, zero_share=0.3):
    """The 9x9 float64 normal-equation matrix fit_homography_normal builds
    for ``n`` noisy correspondences of a near-identity homography with soft
    inlier weights (``zero_share`` of them zero)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, [1920, 1080], (n, 2)).astype(np.float32)
    h = np.array([[1.01, 0.02, 5.0], [-0.01, 0.99, -3.0], [1e-6, 2e-6, 1.0]])
    p = np.c_[src, np.ones(n)] @ h.T
    dst = (p[:, :2] / p[:, 2:]).astype(np.float32) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    w[rng.uniform(size=n) < zero_share] = 0.0
    s, d, w = torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w)
    a = th._dlt_rows(th.apply_homography(th._normalization_transform(s), s),
                     th.apply_homography(th._normalization_transform(d), d))
    a = a * torch.sqrt(torch.clamp_min(torch.cat([w, w])[:, None], 0.0))
    return torch.matmul(a.T, a).double()


@pytest.mark.parametrize("n,noise", [(2000, 0.1), (500, 0.5), (50, 0.5), (8, 1.0), (12, 2.0)])
def test_smallest_eigenvector_equals_eigh(n, noise):
    """The refinement's inverse iteration gives eigh's smallest eigenvector
    (up to its sign) on refinement systems, a batch at once, with no read
    back to the host (no item, no error check)."""
    m = torch.stack([refinement_system(n, noise, seed) for seed in range(4)])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        v = th.smallest_eigenvector(m)
    names = {e.key for e in prof.key_averages()}
    assert not names & {"aten::item", "aten::_local_scalar_dense", "aten::_linalg_check_errors"}
    e = torch.linalg.eigh(m)[1][..., :, 0]
    sign = torch.sign((e * v).sum(dim=-1, keepdim=True))
    torch.testing.assert_close(v * sign, e, rtol=0, atol=1e-12)


def clustered_system(far, spread, seed):
    """The 9x9 float64 normal-equation matrix of 60 exact correspondences of
    a near-identity homography: ``far`` of them spread over a 256x256 frame,
    the rest in a ``spread``-pixel square. Its second eigenvalue is 1e-7 to
    1e-5 of the trace, its smallest float32 rounding (1e-11 to 1e-9, of
    either sign)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(100, 100 + spread, (60, 2))
    src[:far] = rng.uniform(0, 256, (far, 2))
    h = np.array([[1.01, 0.02, 5.0], [-0.01, 0.99, -3.0], [1e-6, 2e-6, 1.0]])
    p = np.c_[src, np.ones(60)] @ h.T
    s = torch.from_numpy(src.astype(np.float32))
    d = torch.from_numpy((p[:, :2] / p[:, 2:]).astype(np.float32))
    a = th._dlt_rows(th.apply_homography(th._normalization_transform(s), s),
                     th.apply_homography(th._normalization_transform(d), d))
    return torch.matmul(a.T, a).double()


@pytest.mark.parametrize("far,spread", [(2, 5.0), (3, 5.0), (3, 1.0)])
def test_smallest_eigenvector_equals_eigh_on_clustered_points(far, spread):
    """Where the second eigenvalue is near the float32 rounding of the
    smallest (a few points away from a tight cluster), the inverse
    iteration still gives eigh's eigenvector, to eigh's own accuracy
    (1e-16 of the trace over the gap between the two)."""
    m = torch.stack([clustered_system(far, spread, seed) for seed in range(4)])
    ev, vecs = torch.linalg.eigh(m)
    v, e = th.smallest_eigenvector(m), vecs[..., :, 0]
    sign = torch.sign((e * v).sum(dim=-1, keepdim=True))
    gap = float(((ev[:, 1] - ev[:, 0]) / ev.sum(dim=-1)).min())
    assert gap < 2e-5
    torch.testing.assert_close(v * sign, e, rtol=0, atol=1e-16 / gap)


def test_smallest_eigenvector_on_degenerate_matrices():
    """A zero matrix gives the start vector and a NaN one NaN, where eigh
    raises on the NaN; neither reads back to the host."""
    m = torch.zeros((3, 9, 9), dtype=torch.float64)
    m[1] = float("nan")  # what one NaN correspondence makes of the system
    m[2] = clustered_system(3, 5.0, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        v = th.smallest_eigenvector(m)
    names = {e.key for e in prof.key_averages()}
    assert not names & {"aten::item", "aten::_local_scalar_dense", "aten::_linalg_check_errors"}
    torch.testing.assert_close(v[0], torch.full((9,), 1 / 3, dtype=torch.float64))
    assert torch.isnan(v[1]).all() and torch.isfinite(v[2]).all()
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.eigh(m[1])


def test_cpu_refinement_keeps_eigh(monkeypatch):
    """On the CPU fit_homography_normal gives the fit that eigh's smallest
    eigenvector gives (the reference's solver), through the inverse
    iteration that the card runs too."""
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.uniform(0, 100, (2, 30, 2)).astype(np.float32))
    dst = src + 1.5 + torch.from_numpy(rng.normal(0, 0.2, (2, 30, 2)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 1, (2, 30)).astype(np.float32))
    h = th.fit_homography_normal(src, dst, weights=w)
    monkeypatch.setattr(th, "smallest_eigenvector", lambda m: torch.linalg.eigh(m)[1][..., :, 0])
    torch.testing.assert_close(h, th.fit_homography_normal(src, dst, weights=w), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(h[:, :2, 2], torch.full((2, 2), 1.5), rtol=0, atol=0.2)


def test_to_device_on_the_cpu_is_as_tensor():
    """``to_device`` leaves a CPU target to torch.as_tensor (no pinned
    memory, which needs a card)."""
    u = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = _device.to_device(u, torch.device("cpu"))
    assert t.dtype == torch.float32 and not t.is_pinned()
    np.testing.assert_array_equal(t.numpy(), u)
    ids = _device.to_device([3, 4, 5], "cpu")
    assert ids.dtype == torch.int64 and ids.tolist() == [3, 4, 5]


class HostData(TorchFunctionMode):
    """Records tensors made from host data (``torch.as_tensor``/``tensor``/
    ``asarray`` of a non-tensor, ``from_numpy``): on the card each is a
    copy the host waits for, unless it goes through ``_device.to_device``."""

    def __init__(self):
        super().__init__()
        self.made, self.through_to_device = [], 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("as_tensor", "tensor", "asarray", "from_numpy") and args \
                and not isinstance(args[0], torch.Tensor):
            import traceback

            frames = [f for f in traceback.extract_stack()[:-1] if "geotrax_tpu_torch" in f.filename]
            if frames and frames[-1].filename.endswith("_device.py"):
                self.through_to_device += 1
            else:
                self.made.append(f"{name} at {frames[-1].filename}:{frames[-1].lineno}"
                                 if frames else name)
        return func(*args, **(kwargs or {}))


class Ranged:
    """Runs a plain version inside a profiler range named ``label``; its
    ``calls`` count (which the plain version raises by its module name)
    stays the plain version's."""

    def __init__(self, fn, label):
        self.fn, self.label = fn, label

    @property
    def calls(self):
        return self.fn.calls

    @calls.setter
    def calls(self, value):
        self.fn.calls = value

    def __call__(self, *a, **kw):
        with record_function(self.label):
            return self.fn(*a, **kw)


def test_steady_chunk_step_reads_back_only_in_plain_versions(monkeypatch):
    """A steady chunk step of the default extract path (YOLOv8n at imgsz
    256 on 512x288 frames, stabilization, botsort) on the CPU: every read
    back to the host (item, nonzero) sits in the plain NMS or the plain
    auction, which the card replaces by csrc/nms.cu and csrc/auction.cu
    (the RANSAC refinement reads nothing back); and every tensor made from
    host data goes through ``_device.to_device`` (the frame ids and RANSAC's
    uniforms), so the card's step never waits for a copy."""
    import chip_smoke

    monkeypatch.setattr(tnms, "nms_torch", Ranged(tnms.nms_torch, "plain.nms_torch"))
    monkeypatch.setattr(assignment, "auction_assignment_torch",
                        Ranged(assignment.auction_assignment_torch,
                               "plain.auction_assignment_torch"))
    run = chip_smoke.phase_main("cpu", width=512, height=288, n_frames=6, chunk=4, variant="n",
                                imgsz=256, horizon=14, tol_px=10.0)
    assert run["sync_checked_steps"] == 1 and run["sync_checked_chunks"] == 2
    fx, step = run["fx"], run["fx"]._chunk_impl
    seen = {}

    def watched(frames, fids, n_valid, first):
        assert not first
        mode = HostData()
        with profile(activities=[ProfilerActivity.CPU]) as prof, mode:
            out = step(frames, fids, n_valid, first)
        seen.update(prof=prof, mode=mode)
        return out

    fx._chunk_impl = watched
    chip_smoke.phase_steady(fx, 512, 288, 0, 14, 6, chunk=4, n_chunks=1, tol_px=10.0)
    reads, allowed = 0, ("plain.nms_torch", "plain.auction_assignment_torch")
    for e in seen["prof"].events():
        if e.name in ("aten::_local_scalar_dense", "aten::nonzero"):
            chain, q = [], e.cpu_parent
            while q is not None:
                chain.append(q.name)
                q = q.cpu_parent
            assert any(a in chain for a in allowed), chain
            reads += 1
    assert reads > 0  # the plain versions did run
    assert seen["mode"].made == [] and seen["mode"].through_to_device == 2
