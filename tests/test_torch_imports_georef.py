"""The smoke's georef phase (chip_smoke.phase_georef) rehearsed on the CPU
at a tiny size in a subprocess that refuses the imports
tests/test_torch_imports.py refuses (PIL and pandas among them), with one
intra-op thread: the synthetic ortho and frames, the assets written as
files, ``run_georeferencing`` with the master path and again from the
cache, the CSV's checks, the device steps timed alone with the level
breakdown, and the orb-path Stabilizer pair. Its own file, so that the
suite's workers run it beside the other rehearsals."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

GEOREF_GUARD = PRELUDE + r'''
geo = chip_smoke.phase_georef("cpu", size=640, fw=320, fh=180, n_frames=300, vehicles=4,
                              rects=200, max_features=4000, tol_px=3.0, min_inliers=50,
                              min_share=0.5)
assert geo["inliers"] >= 50 and geo["master_err_px"] < 3.0 and geo["ref_err_px"] < 3.0, geo
assert geo["ortho_slots"] == chip_smoke.feature_slots(640, 640, 4000) == 3997, geo
assert geo["csv"]["rows"] == geo["tracked_rows"] == 1200 and geo["csv"]["assigned"] > 0, geo
assert [len(r["seconds"]) for r in geo["runs"]] == [10, 10], geo["runs"]
assert geo["orb_launches"] == 0 and geo["orb_err_px"] < 2.0, geo
brk = geo["ortho_breakdown"]
assert len(brk["levels"]) == 7 and set(brk["pieces"]) == {
    "blur 1.6", "blur 2.56", "planes blur 2.4", "planes tent 4", "top-k"}, brk
assert "PIL" in REFUSED and "pandas" in REFUSED
''' + EPILOGUE


def test_smoke_georef_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", GEOREF_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
