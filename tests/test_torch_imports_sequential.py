"""The smoke's sequential phase (chip_smoke.phase_sequential) rehearsed on
the CPU at a tiny size in a subprocess that refuses the imports
tests/test_torch_imports.py refuses, with one intra-op thread: fused ==
sequential on the oracle, YOLOv8n with the rsift stabilizer and RT-DETR-L
at its published widths through run_extraction, the card-against-CPU check
and the kernels on the path's own inputs (their plain versions here). Its
own file, so that the suite's workers run it beside the other rehearsals."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

SEQUENTIAL_GUARD = PRELUDE + r'''
# at 512x288 the random detector's box masks half of the rsift stabilizer's
# small gray; at 768x432 its homographies hold to the camera's
sq = chip_smoke.phase_sequential("cpu", width=768, height=432, n_frames=6, imgsz=384,
                                 check_imgsz=128, variant="n", rsift_features=600, tol_px=10.0)
# on the CPU the fused chunk step and the sequential loop are bit-equal
assert sq["a"]["chunk1"]["equal"] and sq["a"]["chunk"]["equal"] and sq["a"]["rows"] > 0, sq["a"]
assert sq["a"]["chunk"]["box_diff_px"] == sq["a"]["chunk"]["h_diff"] == 0.0, sq["a"]
assert sq["b"]["stats"]["frames"] == 6 and sq["b"]["checks"]["camera_err_px"] < 10.0, sq["b"]
assert sq["c"]["stats"]["frames"] == 6 and sq["c_detections_frame0"] == sq["vehicles"] == 1, sq
assert sq["c_launches"] == {"fast_score": 0, "patch_gather": 0}, sq["c_launches"]
assert sq["c_card_vs_cpu"]["score_err"] == 0.0 and sq["c_flops"] > 1e10, sq
assert sq["kernels"]["gray_shape"] == (1, 216, 384), sq["kernels"]
g = sq["kernels"]["gather"]
assert g["shape"] == (1, 432, 768, 3) and g["corners"] == 1000 and g["pool2"] and g["mean4"], g
assert "sequential ok" in chip_smoke.sequential_line(sq, 1.0, "cpu")
''' + EPILOGUE


def test_smoke_sequential_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", SEQUENTIAL_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
