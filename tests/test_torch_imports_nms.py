"""The smoke's NMS phase (chip_smoke.phase_nms, and path_nms on what a
chunk's detector hands its post-processing after the top-K) rehearsed on the CPU at a small
size in a subprocess with one intra-op thread, under the import guard of
tests/test_torch_imports.py; the phase's bound, candidates and whole-step
read check in process; and the kernels' wrappers up to their launch, with a
stand-in for the library."""

import contextlib
import subprocess
import sys

import pytest
import torch

from geotrax_tpu_torch.ops import nms as nms_ops
from test_torch_imports import EPILOGUE, PRELUDE, ROOT

NMS_GUARD = PRELUDE + r'''
nm = chip_smoke.phase_nms("cpu", b=3, n=200, lock_b=2, objects=30, evaluate=(2, 128, 40),
                          chain=60, odd=(1, 3, 37))
names = [c["name"] for c in nm["cases"]]
assert names == ["chunk", "lockstep", "frame", "evaluate", "chain 60", "odd 1", "odd 3",
                 "odd 37"], names
assert nm["max_abs_err"] == 0.0 and nm["path"] is None, nm
shapes = {c["name"]: c["shape"] for c in nm["cases"]}
assert shapes["chunk"] == (3, 200) and shapes["evaluate"] == (2, 128), shapes
ev = next(c for c in nm["cases"] if c["name"] == "evaluate")
assert ev["alive"] == 2 * 128 and not ev["agnostic"] and ev["max_det"] == 40, ev
assert next(c for c in nm["cases"] if c["name"] == "chain 60")["kept"] == 30
assert "ms" not in nm["cases"][0]
line = chip_smoke.nms_line(nm, 1.0, "cpu")
assert line.startswith("nms ok") and "chain 60 1x60 max_det 30" in line, line
# the path's own candidates: what a chunk's post-processing hands NMS
from geotrax_tpu_torch.ops import nms as nms_ops
kept = []
xywh = torch.rand(2, 300, 4) * 100
with chip_smoke.TopkSwap(nms_ops.postprocess_topk, kept):
    nms_ops.postprocess_detections(xywh, torch.rand(2, 300, 4), 0.25, 0.7, 50)
    nms_ops.postprocess_detections(xywh, torch.rand(2, 300, 4), 0.25, 0.7, 50)
assert not isinstance(nms_ops.postprocess_topk, chip_smoke.TopkSwap) and len(kept) == 1
p = chip_smoke.path_nms(kept)
assert p["shape"] == (2, 300) and p["max_det"] == 50 and p["max_abs_err"] == 0.0, p
assert chip_smoke.nms_text(p).startswith("path 2x300 max_det 50"), chip_smoke.nms_text(p)
''' + EPILOGUE


def test_smoke_nms_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", NMS_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout


def test_nms_bound_counts_alive_pairs_and_bytes():
    """The bound counts what greedy NMS needs of this answer: the pairs of
    kept candidates and one IoU for each suppressed alive one (up to the
    last kept one where the slots fill), a box area for each; the sorted
    scores up to the first absent one, those boxes and the kept order read
    once, the slots written once (9 B each)."""
    import chip_smoke

    pair, box = chip_smoke.NMS_PAIR_FLOPS, chip_smoke.NMS_BOX_FLOPS
    scores = torch.tensor([[0.9, 0.5, 0.0, 0.3], [0.0, 0.0, 0.0, 0.0]])
    order = torch.argsort(-scores, dim=-1, stable=True)
    keep = torch.tensor([[0, 3, 0, 0, 0, 0], [0] * 6])  # candidate 1 suppressed by 0
    valid = torch.tensor([[True, True] + [False] * 4, [False] * 6])
    ms, by, moved, ops = chip_smoke.nms_bound_ms(scores, order, keep, valid)
    assert ops == (1 + 1) * pair + 3 * box
    assert moved == (4 * 4 + 16 * 3 + 8 * 2) + 4 * 1 + 2 * 9 * 6
    assert by == "bytes" and ms == moved / chip_smoke.HBM_BYTES_PER_S * 1e3
    # one slot, filled by the first candidate: nothing after it is needed
    ms, by, moved, ops = chip_smoke.nms_bound_ms(scores, order, keep[:, :1], valid[:, :1])
    assert ops == box and moved == (4 + 16 + 8) + 4 + 2 * 9
    # 1000 disjoint candidates of 2000 kept in 1000 slots
    dense = torch.ones((32, 2000))
    order = torch.arange(2000).expand(32, 2000)
    keep = torch.arange(1000).expand(32, 1000)
    ms, by, _, ops = chip_smoke.nms_bound_ms(dense, order, keep, torch.ones((32, 1000), dtype=bool))
    assert ops == 32 * (1000 * 999 / 2 * pair + 1000 * box)
    assert by == "operations" and ms == ops / chip_smoke.FP32_FLOP_PER_S * 1e3


@pytest.mark.parametrize("agnostic", [True, False])
def test_topk_bound_charges_classes_only_where_nms_compares(agnostic):
    """The fused call's bound adds to NMS's scores read the slots written
    (25 B each) and, for each needed candidate, its anchor index and xywh
    box (24 B) with its corners, and its class (4 B, agnostic: the kept
    ones'); per class, every candidate's index and box for the span with
    its corners and max / min, but the class and offset of the needed ones
    only."""
    import chip_smoke

    pair, box = chip_smoke.NMS_PAIR_FLOPS, chip_smoke.NMS_BOX_FLOPS
    scores = torch.tensor([[0.9, 0.5, 0.0, 0.3], [0.0, 0.0, 0.0, 0.0]])
    order = torch.argsort(-scores, dim=-1, stable=True)
    keep = torch.tensor([[0, 3, 0, 0, 0, 0], [0] * 6])  # 3 needed, 2 kept in image 0
    valid = torch.tensor([[True, True] + [False] * 4, [False] * 6])
    ms, by, moved, ops = chip_smoke.topk_bound_ms(scores, order, keep, valid, agnostic)
    nms_ops_count, base = (1 + 1) * pair + 3 * box, 4 * (4 + 1) + 2 * 6 * 25
    if agnostic:
        assert ops == nms_ops_count + 3 * chip_smoke.TOPK_BOX_FLOPS
        assert moved == base + 24 * 3 + 4 * 2
    else:
        assert ops == nms_ops_count + 8 * (chip_smoke.TOPK_BOX_FLOPS + chip_smoke.TOPK_SPAN_FLOPS) \
            + 3 * chip_smoke.TOPK_OFFSET_FLOPS
        assert moved == base + 24 * 8 + 4 * 3
    assert by == "bytes" and ms == moved / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_nms_candidates_and_chain():
    """The seeded candidates: contiguous, the asked alive count scoring
    from ``conf``, classes where asked; the chain keeps every other box."""
    import chip_smoke

    boxes, scores, cls = chip_smoke.nms_candidates(3, 100, 10, 4, 0, "cpu", classes=4, conf=0.25)
    assert boxes.shape == (3, 100, 4) and boxes.is_contiguous() and scores.is_contiguous()
    assert (scores > 0).sum(dim=-1).tolist() == [40, 40, 40]
    assert float(scores[scores > 0].min()) >= 0.25 and cls.dtype == torch.int32
    assert int(cls.max()) <= 3 and bool((boxes[..., 2:] > boxes[..., :2]).all())
    boxes, scores, none = chip_smoke.nms_chain(11, "cpu")
    keep, valid = nms_ops.nms_torch(boxes, scores, chip_smoke.NMS_IOU, 8)
    assert none is None and keep[0, :6].tolist() == [0, 2, 4, 6, 8, 10]
    assert valid.sum() == 6


def test_whole_step_check_restores_the_extractor():
    """tracker_reads_checked with whole_step wraps the chunk step of every
    chunk after the first (counting it) and the tracker of every chunk,
    and gives the extractor its own methods back."""
    import chip_smoke

    class Fx:
        def _run_tracker(self):
            return "tracked"

        def _chunk_impl(self, frames, fids, n_valid, first):
            return self._run_tracker()

    fx = Fx()
    with chip_smoke.tracker_reads_checked(fx, "cpu", whole_step=True) as seen:
        assert [fx._chunk_impl(None, [], 1, first) for first in (True, False, False)] == \
            ["tracked"] * 3
    assert seen == {"chunks": 3, "steps": 2}
    assert "_chunk_impl" not in vars(fx) and "_run_tracker" not in vars(fx)
    with chip_smoke.tracker_reads_checked(fx, "cpu") as seen:
        fx._chunk_impl(None, [], 1, False)
    assert seen == {"chunks": 1, "steps": 0}


class StubLibrary:
    """Stands in for csrc/nms.cu's library: records each launch's arguments
    and returns ``rc``; reports an H100's shared memory and the clusters of
    each size it holds at once."""

    def __init__(self, rc=0):
        self.rc, self.topk, self.sorted = rc, [], []

    def nms_topk(self, *args):
        self.topk.append(args)
        return self.rc

    def nms(self, *args):
        self.sorted.append(args)
        return self.rc

    def nms_shared_limit(self, device):
        return 227248

    def nms_max_clusters(self, cluster, shared):
        return {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}[cluster]


@pytest.fixture
def stub_card(monkeypatch):
    """CPU tensors reach the kernels' launches: the device checks pass, the
    stream is a stand-in handle and the library is a StubLibrary."""
    lib = StubLibrary()
    monkeypatch.setattr(nms_ops, "_library", lambda: lib)
    monkeypatch.setattr(nms_ops, "_on_cpu", lambda t, what: False)
    monkeypatch.setattr(nms_ops, "_current_stream",
                        lambda device: contextlib.nullcontext(4242))
    monkeypatch.setattr(nms_ops, "_shared_limit", lambda index: lib.nms_shared_limit(index))
    monkeypatch.setattr(nms_ops, "_cluster", lambda index, b, n: nms_ops.cluster_size(
        b, n, lib.nms_shared_limit(index), lib.nms_max_clusters))
    return lib


def topk_arguments(b=4, anchors=300, k=200, seed=0):
    """postprocess_topk's arguments as postprocess_detections makes them:
    the top-K a slice of a longer sort (rows ``anchors`` apart)."""
    from geotrax_tpu_torch.ops.topk import exact_top_k

    g = torch.Generator().manual_seed(seed)
    xywh = torch.rand((b, anchors, 4), generator=g) * 100
    classes = torch.randint(0, 4, (b, anchors), generator=g, dtype=torch.int32)
    top_scores, top_idx = exact_top_k(torch.rand((b, anchors), generator=g), k)
    return xywh, classes, top_scores, top_idx


def test_postprocess_topk_passes_its_launch_arguments(stub_card):
    """One launch with the inputs' pointers and image strides (the top-K
    read in place, with its stride), B and K, the threshold, max_det, the
    agnostic flag, the cluster size chosen for B and K (16 at B = 4 and K =
    1024, 2 at B = 32) and the outputs' pointers and the stream; the
    detections' shapes and types; nothing read back or copied where the
    layout is the kernel's."""
    xywh, classes, top_scores, top_idx = topk_arguments(anchors=2000, k=1024)
    assert not top_scores.is_contiguous()
    launches = nms_ops.postprocess_topk.launches
    out = nms_ops.postprocess_topk(xywh, classes, top_scores, top_idx, 0.7, 50, False)
    assert nms_ops.postprocess_topk.launches == launches + 1 and len(stub_card.topk) == 1
    args = stub_card.topk[0]
    assert args[:8] == (xywh.data_ptr(), 8000, classes.data_ptr(), 2000, top_scores.data_ptr(),
                        2000, top_idx.data_ptr(), 2000)
    assert args[8:10] == (4, 1024) and args[10] == pytest.approx(0.7)
    assert args[11:14] == (50, 0, 16)
    assert args[14:] == (out["boxes_xywh"].data_ptr(), out["scores"].data_ptr(),
                         out["classes"].data_ptr(), out["valid"].data_ptr(), 4242)
    assert out["boxes_xywh"].shape == (4, 50, 4) and out["classes"].dtype == torch.int32
    assert out["valid"].dtype == torch.bool and out["scores"].dtype == torch.float32
    big = topk_arguments(b=32)
    nms_ops.postprocess_topk(*big, 0.5, 7, True)
    assert stub_card.topk[1][8:14] == (32, 200, pytest.approx(0.5), 7, 1, 2)


def test_postprocess_topk_copies_what_the_kernel_cannot_read(stub_card):
    """Boxes whose rows are not contiguous, or not on a 16-byte boundary,
    and class rows with a stride reach the kernel as contiguous copies."""
    xywh, classes, top_scores, top_idx = topk_arguments()
    column_major = xywh.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    shifted = torch.empty(4 * 300 * 4 + 1)[1:].view(4, 300, 4).copy_(xywh)
    cls_t = classes.t().contiguous().t()
    for boxes in (column_major, shifted):
        nms_ops.postprocess_topk(boxes, cls_t, top_scores, top_idx, 0.7, 50, True)
        args = stub_card.topk[-1]
        assert args[0] != boxes.data_ptr() and args[0] % 16 == 0 and args[1] == 1200
        assert args[2] != cls_t.data_ptr() and args[3] == 300


def test_postprocess_topk_refuses_before_any_launch(stub_card):
    """float64 or bfloat16 boxes or scores, other class and index types and
    mismatched shapes raise a ValueError that names them; a non-zero return
    code raises with the CUDA error; the launch count moves only on a
    launch that returned 0."""
    xywh, classes, top_scores, top_idx = topk_arguments()
    launches = nms_ops.postprocess_topk.launches
    bad = [((xywh.double(), classes, top_scores, top_idx), "float32"),
           ((xywh.to(torch.bfloat16), classes, top_scores, top_idx), "float32"),
           ((xywh, classes, top_scores.double(), top_idx), "float32"),
           ((xywh, classes, top_scores.to(torch.bfloat16), top_idx), "float32"),
           ((xywh, classes.long(), top_scores, top_idx), "int32 classes"),
           ((xywh, classes, top_scores, top_idx.int()), "int64 indices"),
           ((xywh[..., :3], classes, top_scores, top_idx), r"\(B, A, 4\)"),
           ((xywh, classes[:, :10], top_scores, top_idx), r"\(B, A, 4\)"),
           ((xywh, classes, top_scores[:2], top_idx[:2]), r"\(B, A, 4\)"),
           ((xywh, classes, top_scores, top_idx[:, :5]), r"\(B, A, 4\)")]
    for tensors, match in bad:
        with pytest.raises(ValueError, match=match):
            nms_ops.postprocess_topk(*tensors, 0.7, 50, True)
    assert stub_card.topk == [] and nms_ops.postprocess_topk.launches == launches
    stub_card.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        nms_ops.postprocess_topk(xywh, classes, top_scores, top_idx, 0.7, 50, True)
    assert nms_ops.postprocess_topk.launches == launches and len(stub_card.topk) == 1


def test_nms_sorted_passes_the_cluster_size(stub_card):
    """The kernel's call on sorted candidates passes the cluster chosen for
    its batch (``_cluster``'s choice, which the smoke's sweep forces) and
    raises on a non-zero return code, such as the library's refusal of a
    cluster whose shared memory cannot hold the candidates."""
    import chip_smoke

    scores = torch.rand((32, 2000))
    order, boxes, sorted_scores = nms_ops.sorted_candidates(torch.rand((32, 2000, 4)), scores,
                                                            None, True)
    keep, valid = nms_ops.nms_sorted(boxes.contiguous(), sorted_scores.contiguous(),
                                     order.contiguous(), 0.7, 1000)
    args = stub_card.sorted[-1]
    assert args[3:5] == (32, 2000) and args[6:8] == (1000, 2) and args[-1] == 4242
    assert args[8:10] == (keep.data_ptr(), valid.data_ptr())
    with chip_smoke.cluster_forced(8):
        nms_ops.nms_sorted(boxes.contiguous(), sorted_scores.contiguous(), order.contiguous(),
                           0.7, 1000)
    assert stub_card.sorted[-1][7] == 8
    stub_card.rc = 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        nms_ops.nms_sorted(boxes.contiguous(), sorted_scores.contiguous(), order.contiguous(),
                           0.7, 1000)
