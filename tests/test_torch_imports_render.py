"""The smoke's render phase (chip_smoke.phase_render) rehearsed on the CPU
at a small size in a subprocess that refuses the imports
tests/test_torch_imports.py refuses and, as on a machine without them,
matplotlib and seaborn too, with one intra-op thread: (a) the five modes of
``visualize`` through the port's encoder and decoder (this machine has
FFmpeg's libraries), (b) the warp's timing, (c) ``plot``'s data half alone,
said so in the phase's line, (d) ``batch`` under its default gates. The port's
visualize and plot import no ``geotrax_tpu`` and need no cv2, matplotlib or
seaborn at import or on this path."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

RENDER_GUARD = PRELUDE.replace(
    "sys.meta_path.insert(0, Refuse())",
    "REFUSED = tuple(REFUSED) + ('matplotlib', 'seaborn')\nsys.meta_path.insert(0, Refuse())"
) + r'''
edits = {"  max_det: 1000\n": "  max_det: 64\n",
         "  max_features: 2000\n  ref_multiplier": "  max_features: 300\n  ref_multiplier"}
chip_smoke.reset_launches()
rd = chip_smoke.phase_render("cpu", width=768, height=432, n_frames=6, lengths=(4, 4, 4, 3),
                             plot_frames=400, edits=edits, reps=2)
assert rd["decode"] and sorted(rd["modes"]) == [0, 1, 2, 3, 4], rd["modes"]
for mode, m in rd["modes"].items():
    assert m["frames"] == 6 and m["decoded"] == 6 and m["max_diff"] == 0, (mode, m)
    assert m["warped"] == (5 if mode in (1, 4) else 0), (mode, m)
assert rd["warp"]["bound_by"] == "bytes" and rd["warp"]["bytes"] == 2 * 768 * 432 * 3
assert rd["plot"]["figures"] is None and "matplotlib" in rd["plot"]["missing"], rd["plot"]
assert rd["plot"]["rows"] == rd["plot_rows"] == 400, rd["plot"]
d = rd["d"]
assert d["calls"]["visualize"] == ["V0.mp4", "V1.mp4", "V2.mp4", "V3.mp4"], d
assert d["calls"]["plot"] == ["campaign"] and d["pdfs"] == 0, d
assert d["frames_written"] == {"V0_mode_0.mp4": 4, "V1_mode_0.mp4": 4, "V2_mode_0.mp4": 4,
                               "V3_mode_0.mp4": 3}, d
assert chip_smoke.launches() == {"fast_score": 0, "patch_gather": 0}
line = chip_smoke.render_line(rd, 1.0, "cpu")
assert line.startswith("render ok") and "figures NOT drawn" in line, line
''' + EPILOGUE


def test_smoke_render_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", RENDER_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
