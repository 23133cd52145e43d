"""The smoke's NMS phase (chip_smoke.phase_nms, and path_nms on the
candidates a chunk's detector hands NMS) rehearsed on the CPU at a small
size in a subprocess with one intra-op thread, under the import guard of
tests/test_torch_imports.py; and the phase's bound, candidates and
whole-step read check in process."""

import subprocess
import sys

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
with chip_smoke.nms_swapped(nms_ops.nms, kept):
    nms_ops.postprocess_detections(xywh, torch.rand(2, 300, 4), 0.25, 0.7, 50)
    nms_ops.postprocess_detections(xywh, torch.rand(2, 300, 4), 0.25, 0.7, 50)
assert nms_ops.nms is chip_smoke.NMS_KERNEL and len(kept) == 1
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
