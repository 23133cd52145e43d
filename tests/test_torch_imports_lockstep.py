"""The smoke's lockstep phase (chip_smoke.phase_lockstep) rehearsed on the
CPU at a tiny size in a subprocess that refuses the imports
tests/test_torch_imports.py refuses, with one intra-op thread: (a) the
lockstep files against run_extraction of each video alone on the oracle,
(b) a random YOLOv8n with ReID through extract_videos_batch and the videos
one after another through run_extraction, (c) the kernels on the phase's
own inputs (their plain versions here), (d) ``batch --parallel-videos 4``
twice. Its own file, so that the suite's workers run it beside the other
rehearsals."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

LOCKSTEP_GUARD = PRELUDE + r'''
# at 768x432 the random detector's boxes leave the stabilizer enough of the
# gray for the camera check (as in the sequential rehearsal)
lk = chip_smoke.phase_lockstep(None, "cpu", width=768, height=432, lengths=(4, 4, 4, 3),
                               imgsz=320, variant="n", tol_px=10.0, max_det=64,
                               max_features=300, rounds=1, reps=2)
# on the CPU the lockstep and the sequential loop write the same files
assert all(r["equal"] and r["rows"] > 0 for r in lk["a"].values()), lk["a"]
b = lk["b"]
assert b["steps"] == 4 and len(b["step_ms"]) == 4 and b["camera_err_px"] < 10.0, b["step_ms"]
assert b["launches"] == {"fast_score": 0, "patch_gather": 0}, b["launches"]
assert len(b["runs"]["lockstep"]) == len(b["runs"]["serial"]) == 1
assert lk["emb_norm_err"] < 1e-5 and lk["emb_rows"] == 4 * 4 * 64 - 64, lk["emb_rows"]
assert lk["kernels"]["gray_shape"] == (4, 216, 384), lk["kernels"]
g = lk["kernels"]["gather"]
assert g["shape"] == (4, 432, 768, 3) and g["corners"] == 64 and g["pool2"] and g["mean4"], g
assert lk["d_calls_0"] == {"lockstep": 1, "per_file": 0}, lk["d_calls_0"]
assert lk["d_calls_1"] == {"lockstep": 0, "per_file": 0}, lk["d_calls_1"]
assert "lockstep ok" in chip_smoke.lockstep_line(lk, 1.0, "cpu")
# the profiled group runs on the card only (torch.profiler reaches for
# optional packages the guard refuses); its report's layout here
assert "b_profile" not in lk
prof = {"steps": 4, "wall_ms": 9.0, "device_busy_ms": 5.0, "top": [("gemm", 1.0, 8)],
        "stages": [(f"lock.{s}", 8.0, 4.0, 4.0) for s in ("detect", "tracker")]}
assert chip_smoke.lockstep_profile_lines(prof)[1].split()[:2] == ["stage", "lock.detect"]
''' + EPILOGUE


def test_smoke_lockstep_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", LOCKSTEP_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
