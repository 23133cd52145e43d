"""The smoke's auction phase (chip_smoke.phase_auction, and path_auctions on
the auctions of a chunk) rehearsed on the CPU at a small size in a
subprocess with one intra-op thread, under the import guard of
tests/test_torch_imports.py; and the phase's bound and recorder checked in
process."""

import subprocess
import sys

import torch

from geotrax_tpu_torch.ops import assignment
from test_torch_imports import EPILOGUE, PRELUDE, ROOT

AUCTION_GUARD = PRELUDE + r'''
au = chip_smoke.phase_auction("cpu", slots=40, dets=40, big_slots=24, big_dets=60,
                              huge_dets=90, detr=(2, 5, 30))
names = [c["name"] for c in au["cases"]]
assert names[:2] == ["default", "lockstep"], names
assert len(names) == 10 and au["max_abs_err"] == 0.0 and au["path"] is None, au
shapes = {c["name"]: c["shape"] for c in au["cases"]}
assert shapes["default"] == (40, 80) and shapes["lockstep"] == (4, 40, 80), shapes
assert shapes["max_det 60"] == (24, 84) and shapes["max_det 90"] == (24, 114), shapes
assert shapes["RT-DETR matcher"] == (2, 5, 35), shapes
assert next(c for c in au["cases"] if c["name"] == "cap hit")["unassigned"] > 0
assert "ms" not in au["cases"][0]
line = chip_smoke.auction_line(au, 1.0, "cpu")
assert line.startswith("auction ok") and "RT-DETR matcher 2x5x35" in line, line
# the path's own auctions: the costs a chunk's BYTE steps hand the auction
from geotrax_tpu_torch.ops import assignment
kept = []
cost, rows, cols = chip_smoke.tracker_inputs((), 16, 12, 10, 9, 4, "cpu")
with chip_smoke.AuctionRecorder(kept, 3):
    for thr in (0.8, 0.5, 0.7):
        assignment.masked_assignment(cost, rows, cols, thr)
p = chip_smoke.path_auctions(kept)
assert p["auctions"] == 3 and p["shape"] == (16, 28) and p["max_abs_err"] == 0.0, p
assert 0 < p["matched"] <= 3 * 9 and "ms" not in p, p
assert chip_smoke.path_text(p).startswith("3 auctions of 16x28"), chip_smoke.path_text(p)
''' + EPILOGUE


def test_smoke_auction_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", AUCTION_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout


def test_auction_bound_reads_each_bidder_row_once_per_round():
    """The bound counts, per problem, every bidder's row of M float32 costs
    once in each round it bids and the N int64 columns written once."""
    import chip_smoke

    stats = torch.tensor([[3, 1200], [1, 1000]], dtype=torch.int64)
    ms, by, moved = chip_smoke.auction_bound_ms(stats, 1000, 2000)
    assert by == "bytes" and moved == 4 * 2000 * 2200 + 8 * 1000 * 2
    assert ms == moved / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_auction_recorder_keeps_the_wrapper_count():
    """While the smoke's recorder stands in for the wrapper, the wrapper's
    launch count is still the one the smoke reads, and the name is restored."""
    import chip_smoke

    cost = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 12
    ones = torch.ones(4, dtype=torch.bool)
    original = assignment.auction_assignment
    kept = []
    with chip_smoke.AuctionRecorder(kept, 1) as rec:
        assert assignment.auction_assignment is rec
        rec.launches = 5
        assert original.launches == 5 and chip_smoke.auction_launches() == 5
        for _ in range(2):
            assignment.masked_assignment(cost, ones[:3], ones, 0.8)
    assert assignment.auction_assignment is original and len(kept) == 1
    assert tuple(kept[0][0].shape) == (3, 7) and chip_smoke.auction_launches() == 5
    original.launches = 0
