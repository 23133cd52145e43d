"""Fixed-shape NMS and detection post-processing.

Counterpart of ``geotrax_tpu/ops/nms.py``. Static shapes throughout: the
caller supplies a fixed candidate count and ``max_det`` output slots; empty
slots carry index 0 and ``valid=False``. Both functions take one image's
arrays or a batch of them (a leading axis), which is how the fused chunk
step runs them: one call for all frames of a chunk.

``csrc/nms.cu`` runs the reference's greedy loop (a ``lax.while_loop`` on
the device) for every image of the batch on the card, one thread-block
cluster an image, computing each IoU as it needs it, and reads nothing
back. On a CUDA tensor ``postprocess_detections`` takes the top-K with
torch and hands the rest to one launch of it (``postprocess_topk``: the
gathers, the corners, the per-class offset, NMS, the detections), and
``nms`` sorts its candidates with torch and launches it on them
(``nms_sorted``). On a CPU tensor each runs its plain version
(``postprocess_topk_torch``, ``nms_torch``), which the kernel equals bit
for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache

import torch

from geotrax_tpu_torch import _cuda
from geotrax_tpu_torch.ops.boxes import iou_matrix, xywh_to_xyxy
from geotrax_tpu_torch.ops.topk import exact_top_k

KERNEL = "nms"

# Greedy rounds run between two host reads of the convergence flag in the
# plain version: the JAX reference tests it on the device every round
# (lax.while_loop), as the kernel does; here each test is a device->host
# sync, so it is taken once per block of rounds. Rounds past the fixed point
# change nothing, so the result is the same.
NMS_ROUNDS_PER_CHECK = 4

# The kernel's launch (csrc/nms.cu): a cluster of up to MAX_CLUSTER blocks
# an image (the card's non-portable cluster size) holds the image's
# candidates in its shared memory, TILE_BYTES for each tile of TILE that a
# block owns (boxes, areas, an alive and a suppression word); at most
# MAX_CANDIDATES an image, 128 tiles a block at MAX_CLUSTER.
MAX_CLUSTER = 16
TILE = 64
TILE_BYTES = TILE * 20 + 16
MAX_CANDIDATES = 1 << 17


def sorted_candidates(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
                      class_ids: torch.Tensor | None, agnostic: bool) -> tuple:
    """(B, N) candidates in descending score order (stable): returns (order
    (B, N) int64, the boxes in that order with the per-class coordinate
    offset where ``agnostic`` is False (B, N, 4), the scores in that order)."""
    b, n = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_sorted = torch.gather(boxes_xyxy, 1, order[..., None].expand(b, n, 4))
    scores_sorted = torch.gather(scores, 1, order)
    if not agnostic and class_ids is not None:
        # per-class coordinate offset: boxes of different classes never overlap
        span = (boxes_sorted.amax(dim=(1, 2)) - boxes_sorted.amin(dim=(1, 2))) + 1.0
        cls_sorted = torch.gather(class_ids, 1, order).to(boxes_sorted.dtype)
        boxes_sorted = boxes_sorted + (cls_sorted * span[:, None])[..., None]
    return order, boxes_sorted, scores_sorted


def _batched(boxes_xyxy, scores, class_ids):
    """One image's arrays as a batch of one; (single, boxes, scores, class_ids)."""
    if scores.dim() == 1:
        return (True, boxes_xyxy[None], scores[None],
                None if class_ids is None else class_ids[None])
    return False, boxes_xyxy, scores, class_ids


def nms_torch(boxes_xyxy: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              max_det: int, class_ids: torch.Tensor | None = None, agnostic: bool = True):
    """Plain PyTorch greedy NMS (the CPU route and the kernel's oracle), with
    ``nms``'s arguments and results. The fixed point runs as (B, N, N)
    tensor rounds over the IoU matrix, its convergence flag read by the
    host every NMS_ROUNDS_PER_CHECK rounds. ``nms_torch.calls`` counts its
    calls."""
    nms_torch.calls += 1
    single, boxes_xyxy, scores, class_ids = _batched(boxes_xyxy, scores, class_ids)
    dev = scores.device
    b, n = scores.shape
    order, offset_boxes, scores_sorted = sorted_candidates(boxes_xyxy, scores, class_ids, agnostic)

    iou = iou_matrix(offset_boxes, offset_boxes)
    positions = torch.arange(n, device=dev)

    # Fixed-point form of greedy NMS: keep_i = ~exists j<i kept with
    # iou(i,j) > t. Iterating from all-kept converges to the exact greedy
    # solution in as many rounds as the deepest suppression chain (<= n).
    alive = scores_sorted > 0.0
    suppress_mask = (iou > iou_threshold) & (positions[:, None] < positions[None, :])
    suppress_mask = suppress_mask & alive[:, :, None]
    del iou

    keep = alive
    rounds = 0
    while rounds < n:
        for _ in range(min(NMS_ROUNDS_PER_CHECK, n - rounds)):
            prev = keep
            suppressed = (suppress_mask & keep[:, :, None]).any(dim=1)
            keep = alive & ~suppressed
            rounds += 1
        if not bool((keep != prev).any()):
            break

    # Compact kept indices into max_det slots, preserving score order.
    kept_rank = torch.cumsum(keep, dim=1) - 1
    sort_key = torch.where(keep, kept_rank, n + positions[None, :])
    compact = torch.argsort(sort_key, dim=1)[:, : min(max_det, n)]
    if n < max_det:
        # fewer candidates than output slots: pad with index 0, masked
        # invalid below since sum(kept) <= n
        compact = torch.nn.functional.pad(compact, (0, max_det - n))
    valid = torch.arange(max_det, device=dev)[None, :] < keep.sum(dim=1, keepdim=True)
    keep_indices = torch.where(valid, torch.gather(order, 1, compact), 0)
    if single:
        return keep_indices[0], valid[0]
    return keep_indices, valid


nms_torch.calls = 0


def shared_bytes(n: int, cluster: int) -> int:
    """Dynamic shared memory of one block when ``cluster`` blocks hold an
    image of ``n`` candidates (tile t in block t % cluster)."""
    tiles = -(-n // TILE)
    return -(-tiles // cluster) * TILE_BYTES


def cluster_size(b: int, n: int, shared_limit: int, clusters) -> int:
    """Blocks an image for a batch of ``b`` images of ``n`` candidates on a
    card whose blocks may take ``shared_limit`` bytes of dynamic shared
    memory and that holds ``clusters(size, shared_bytes)`` clusters of a
    size at once: the largest power of two up to MAX_CLUSTER, and up to the
    image's tiles (a block without one would only take barriers), whose
    ``b`` clusters the card holds at once (the batch in one wave, each image
    over as many SMs as that leaves), else the smallest that launches; in
    either case one whose blocks' shared memory holds the image."""
    tiles = max(1, -(-n // TILE))
    sizes = [c for c in (1 << k for k in range(MAX_CLUSTER.bit_length()))
             if (c == 1 or c < 2 * tiles) and shared_bytes(n, c) <= shared_limit]
    held = {c: clusters(c, shared_bytes(n, c)) for c in sizes}
    one_wave = [c for c in sizes if held[c] >= b]
    if one_wave:
        return max(one_wave)
    launches = [c for c in sizes if held[c] > 0]
    if not launches:
        raise ValueError(f"nms kernel: no cluster of up to {MAX_CLUSTER} blocks holds {n} "
                         f"candidates")
    return min(launches)


@lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """``csrc/nms.cu``'s library (built and loaded once), its entry points typed."""
    lib = _cuda.load(KERNEL)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nms.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32, i32, ptr, ptr, ptr]
    lib.nms.restype = i32
    lib.nms_topk.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, i64, i32, i32, ctypes.c_float,
                             i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.nms_topk.restype = i32
    lib.nms_shared_limit.argtypes = [i32]
    lib.nms_shared_limit.restype = i32
    lib.nms_max_clusters.argtypes = [i32, i32]
    lib.nms_max_clusters.restype = i32
    return lib


def build(verbose: bool = False) -> tuple:
    """Compile the kernel (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(KERNEL, verbose=verbose)


@lru_cache(maxsize=None)
def _shared_limit(index: int) -> int:
    """The dynamic shared memory a block may take on cuda:``index``."""
    with torch.cuda.device(index):
        limit = _library().nms_shared_limit(index)
    if limit < 0:
        raise RuntimeError(f"nms kernel: cannot prepare cuda:{index}")
    return limit


@lru_cache(maxsize=1024)
def _cluster(index: int, b: int, n: int) -> int:
    """``cluster_size``'s choice on cuda:``index``, kept per (device, b, n)."""
    lib = _library()

    def clusters(size: int, shared: int) -> int:
        with torch.cuda.device(index):
            count = lib.nms_max_clusters(size, shared)
        if count < 0:
            raise RuntimeError(f"nms kernel: cluster occupancy query failed with CUDA error "
                               f"{-count}")
        return count

    return cluster_size(b, n, _shared_limit(index), clusters)


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version's), False for a CUDA one
    (the kernel's); raises on any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


@contextlib.contextmanager
def _current_stream(device: torch.device):
    """``device`` made current for the block; yields its current stream's
    handle."""
    index = device.index
    with (contextlib.nullcontext() if torch.cuda.current_device() == index
          else torch.cuda.device(index)):
        yield torch.cuda.current_stream(index).cuda_stream


def nms_sorted(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor, order: torch.Tensor,
               iou_threshold: float, max_det: int) -> tuple:
    """The kernel's call: greedy NMS of (B, N) CUDA candidates already in
    descending score order (``sorted_candidates``' outputs: contiguous
    float32 (B, N, 4) corner boxes and (B, N) scores, (B, N) int64
    ``order``); a candidate with score <= 0 neither survives nor
    suppresses. Returns (keep_indices (B, max_det) int64: ``order`` at the
    first ``max_det`` kept positions in score order, 0 after them; valid
    (B, max_det) bool). One launch on the current stream for the whole batch
    (``cluster_size``'s blocks an image), nothing read back, so it can be
    captured in a CUDA graph; it counts on ``nms_sorted.launches``."""
    if _on_cpu(boxes_sorted, "nms kernel"):
        raise ValueError(f"nms kernel: the candidates must be on a CUDA device, got "
                         f"{boxes_sorted.device}")
    if boxes_sorted.dtype != torch.float32 or scores_sorted.dtype != torch.float32:
        raise ValueError(f"nms kernel: takes float32 boxes and scores, got {boxes_sorted.dtype} "
                         f"and {scores_sorted.dtype}")
    if order.dtype != torch.int64:
        raise ValueError(f"nms kernel: takes an int64 order, got {order.dtype}")
    if scores_sorted.dim() != 2 or tuple(boxes_sorted.shape) != tuple(scores_sorted.shape) + (4,) \
            or order.shape != scores_sorted.shape:
        raise ValueError(f"nms kernel: takes (B, N, 4) boxes with (B, N) scores and order, got "
                         f"{tuple(boxes_sorted.shape)}, {tuple(scores_sorted.shape)} and "
                         f"{tuple(order.shape)}")
    if any(t.device != boxes_sorted.device for t in (scores_sorted, order)):
        raise ValueError("nms kernel: boxes, scores and order must be on one device")
    if not (boxes_sorted.is_contiguous() and scores_sorted.is_contiguous()
            and order.is_contiguous()):
        raise ValueError("nms kernel: takes contiguous tensors")
    if boxes_sorted.data_ptr() % 16:
        raise ValueError("nms kernel: takes boxes that start on a 16-byte boundary")
    b, n = scores_sorted.shape
    if n > MAX_CANDIDATES:
        raise ValueError(f"nms kernel: takes at most {MAX_CANDIDATES} candidates, got {n}")
    if max_det < 0 or b > 2 ** 31 - 1:
        raise ValueError(f"nms kernel: max_det {max_det} and batch {b} out of range")
    dev = boxes_sorted.device
    keep = torch.empty((b, max_det), dtype=torch.int64, device=dev)
    valid = torch.empty((b, max_det), dtype=torch.bool, device=dev)
    if b == 0 or max_det == 0:
        return keep, valid
    if n == 0:
        return keep.zero_(), valid.zero_()
    cluster = _cluster(dev.index, b, n)
    with _current_stream(dev) as stream:
        rc = _library().nms(boxes_sorted.data_ptr(), scores_sorted.data_ptr(), order.data_ptr(),
                            b, n, iou_threshold, max_det, cluster, keep.data_ptr(),
                            valid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed with CUDA error {rc} (B={b}, N={n}, "
                           f"cluster {cluster})")
    nms_sorted.launches += 1
    return keep, valid


nms_sorted.launches = 0


def nms(boxes_xyxy: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_det: int, class_ids: torch.Tensor | None = None, agnostic: bool = True):
    """Greedy NMS over (N,4) boxes and (N,) scores, or a batch (B,N,4)/(B,N).

    Returns (keep_indices (...,max_det), valid_mask (...,max_det)); invalid
    slots hold index 0 with valid=False. Scores <= 0 are absent candidates.
    A CPU tensor runs ``nms_torch``; a CUDA tensor sorts the candidates
    with torch operations and runs the kernel (``nms_sorted``), which takes
    float32 boxes and scores and raises on anything else."""
    if _on_cpu(scores, "nms"):
        return nms_torch(boxes_xyxy, scores, iou_threshold, max_det, class_ids=class_ids,
                         agnostic=agnostic)
    single, boxes_xyxy, scores, class_ids = _batched(boxes_xyxy, scores, class_ids)
    if scores.dim() != 2 or tuple(boxes_xyxy.shape) != tuple(scores.shape) + (4,):
        raise ValueError(f"nms kernel: takes (B, N, 4) boxes with (B, N) scores, got "
                         f"{tuple(boxes_xyxy.shape)} and {tuple(scores.shape)}")
    order, boxes_sorted, scores_sorted = sorted_candidates(boxes_xyxy, scores, class_ids,
                                                           agnostic)
    # the sort and the gathers keep their inputs' strides
    keep_indices, valid = nms_sorted(boxes_sorted.contiguous(), scores_sorted.contiguous(),
                                     order.contiguous(), iou_threshold, max_det)
    if single:
        return keep_indices[0], valid[0]
    return keep_indices, valid


def postprocess_topk_torch(boxes_xywh: torch.Tensor, classes: torch.Tensor,
                           top_scores: torch.Tensor, top_idx: torch.Tensor,
                           iou_threshold: float, max_det: int, agnostic: bool = True) -> dict:
    """Plain PyTorch post-processing after the top-K (the CPU route of
    ``postprocess_topk`` and its kernel's oracle), with its arguments and
    results: the candidates' boxes and classes gathered, ``nms_torch`` on
    their corners, the detections gathered. ``postprocess_topk_torch.calls``
    counts its calls."""
    postprocess_topk_torch.calls += 1
    b, k = top_scores.shape
    cand_boxes = torch.gather(boxes_xywh, 1, top_idx[..., None].expand(b, k, 4))
    cand_classes = torch.gather(classes, 1, top_idx)
    keep, valid = nms_torch(xywh_to_xyxy(cand_boxes), top_scores, iou_threshold, max_det,
                            class_ids=cand_classes, agnostic=agnostic)
    boxes = torch.gather(cand_boxes, 1, keep[..., None].expand(b, max_det, 4))
    return {
        "boxes_xywh": torch.where(valid[..., None], boxes, 0.0),
        "scores": torch.where(valid, torch.gather(top_scores, 1, keep), 0.0),
        "classes": torch.where(valid, torch.gather(cand_classes, 1, keep), -1),
        "valid": valid,
    }


postprocess_topk_torch.calls = 0


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the fused kernel reads it, copied where it is not: each
    image's row contiguous, the images any stride apart (for (B, N, 4)
    boxes a multiple of 4 elements, from a 16-byte boundary)."""
    if x.dim() == 3:
        ok = x.stride()[1:] == (4, 1) and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0
    else:
        ok = x.stride(1) == 1
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def postprocess_topk(boxes_xywh: torch.Tensor, classes: torch.Tensor, top_scores: torch.Tensor,
                     top_idx: torch.Tensor, iou_threshold: float, max_det: int,
                     agnostic: bool = True) -> dict:
    """Everything ``postprocess_detections`` does after its top-K: (B, A, 4)
    xywh boxes and (B, A) int32 classes of the anchors, the (B, K) scores
    and int64 anchor indices of ``exact_top_k`` -> dict of (B, max_det, ...)
    detections: boxes_xywh, scores, classes (int32, -1 when empty), valid.

    Precondition: scores in ``exact_top_k``'s order, no NaN (thresholded
    scores have none), so the reference's stable argsort of them is the
    identity and is skipped; it is not checked, since a check would read
    back. A CPU tensor runs ``postprocess_topk_torch``. A CUDA tensor takes
    float32 boxes and scores only (raises on anything else) and runs one
    launch of csrc/nms.cu on the current stream for the whole batch
    (``cluster_size``'s blocks an image): the gathers, the corners, the
    per-class offset where ``agnostic`` is False, greedy NMS and the
    detections, nothing read back, so it can be captured in a CUDA graph; it
    counts on ``postprocess_topk.launches``."""
    if _on_cpu(top_scores, "postprocess_topk"):
        return postprocess_topk_torch(boxes_xywh, classes, top_scores, top_idx, iou_threshold,
                                      max_det, agnostic)
    what = "postprocess_topk kernel"
    if boxes_xywh.dtype != torch.float32 or top_scores.dtype != torch.float32:
        raise ValueError(f"{what}: takes float32 boxes and scores, got {boxes_xywh.dtype} and "
                         f"{top_scores.dtype}")
    if classes.dtype != torch.int32 or top_idx.dtype != torch.int64:
        raise ValueError(f"{what}: takes int32 classes and int64 indices, got {classes.dtype} "
                         f"and {top_idx.dtype}")
    if boxes_xywh.dim() != 3 or boxes_xywh.shape[2] != 4 or classes.shape != boxes_xywh.shape[:2] \
            or top_scores.dim() != 2 or top_idx.shape != top_scores.shape \
            or top_scores.shape[0] != boxes_xywh.shape[0]:
        raise ValueError(f"{what}: takes (B, A, 4) boxes, (B, A) classes, (B, K) scores and "
                         f"indices, got {tuple(boxes_xywh.shape)}, {tuple(classes.shape)}, "
                         f"{tuple(top_scores.shape)} and {tuple(top_idx.shape)}")
    dev = top_scores.device
    if any(t.device != dev for t in (boxes_xywh, classes, top_idx)):
        raise ValueError(f"{what}: boxes, classes, scores and indices must be on one device")
    b, k = top_scores.shape
    if k > MAX_CANDIDATES:
        raise ValueError(f"{what}: takes at most {MAX_CANDIDATES} candidates, got {k}")
    if max_det < 0 or b > 2 ** 31 - 1:
        raise ValueError(f"{what}: max_det {max_det} and batch {b} out of range")
    out = {"boxes_xywh": torch.empty((b, max_det, 4), dtype=torch.float32, device=dev),
           "scores": torch.empty((b, max_det), dtype=torch.float32, device=dev),
           "classes": torch.empty((b, max_det), dtype=torch.int32, device=dev),
           "valid": torch.empty((b, max_det), dtype=torch.bool, device=dev)}
    if b == 0 or max_det == 0:
        return out
    if k == 0:
        out["classes"].fill_(-1)
        for key in ("boxes_xywh", "scores", "valid"):
            out[key].zero_()
        return out
    boxes_xywh, classes, top_scores, top_idx = map(_rows, (boxes_xywh, classes, top_scores,
                                                           top_idx))
    cluster = _cluster(dev.index, b, k)
    with _current_stream(dev) as stream:
        rc = _library().nms_topk(
            boxes_xywh.data_ptr(), boxes_xywh.stride(0), classes.data_ptr(), classes.stride(0),
            top_scores.data_ptr(), top_scores.stride(0), top_idx.data_ptr(), top_idx.stride(0),
            b, k, iou_threshold, max_det, int(bool(agnostic)), cluster,
            out["boxes_xywh"].data_ptr(), out["scores"].data_ptr(), out["classes"].data_ptr(),
            out["valid"].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc} (B={b}, K={k}, "
                           f"cluster {cluster})")
    postprocess_topk.launches += 1
    return out


postprocess_topk.launches = 0


def postprocess_detections(boxes_xywh: torch.Tensor, class_scores: torch.Tensor,
                           conf_threshold: float, iou_threshold: float, max_det: int,
                           class_mask: torch.Tensor | None = None,
                           agnostic: bool = True) -> dict:
    """Detector-head output -> final detections (ultralytics-compatible).

    boxes_xywh: (N,4) or (B,N,4); class_scores: (N,C) or (B,N,C)
    post-sigmoid. Per anchor the best class is taken; anchors below
    ``conf_threshold`` or outside ``class_mask`` are dropped; NMS keeps at
    most ``max_det``. Returns a dict of fixed-shape tensors: boxes_xywh
    (...,max_det,4), scores, classes (int32, -1 when empty), valid. After
    the top-K, ``postprocess_topk`` does the rest: one kernel launch on a
    CUDA tensor, the plain version on a CPU one.
    """
    single = boxes_xywh.dim() == 2
    if single:
        boxes_xywh, class_scores = boxes_xywh[None], class_scores[None]
    if class_mask is not None:
        class_scores = torch.where(class_mask[None, None, :], class_scores, 0.0)
    scores = class_scores.amax(dim=-1)
    classes = torch.argmax(class_scores, dim=-1).to(torch.int32)
    # a NaN score becomes 0 here, so the top-K below holds none
    scores = torch.where(scores >= conf_threshold, scores, 0.0)

    # Candidate pre-selection: NMS is O(K^2) in candidates, so top-K first
    # (floored at 1024 so a small max_det still sees enough candidates).
    n = scores.shape[1]
    k = min(max(2 * max_det, 1024), n)
    top_scores, top_idx = exact_top_k(scores, k)
    out = postprocess_topk(boxes_xywh, classes, top_scores, top_idx, iou_threshold, max_det,
                           agnostic)
    if single:
        return {key: v[0] for key, v in out.items()}
    return out
