"""The smoke's host-tools phase (chip_smoke.phase_host_tools, phase 18)
rehearsed on the CPU at a small size in a subprocess with one intra-op
thread, under the import guard of tests/test_torch_imports.py (no JAX, no
JAX package, no pandas, cv2, PIL or yaml, and no matplotlib: the card's
machine has none, so the tools' figures are skipped): the filters on an
(8, 200) batch, subset_orthophoto on a 600^2 tiled GeoTIFF (a 100^2 window
of its cutout against the CPU's), and the other fifteen host tools once
each with exit 0 and their files."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

HOST_GUARD = PRELUDE.replace("'geotrax_tpu')", "'geotrax_tpu', 'matplotlib')") + r'''
ht = chip_smoke.phase_host_tools("cpu", filter_shape=(8, 200), mosaic_px=600, window=100)
a = ht["a"]
for name in ("gaussian", "savgol", "gradient"):
    assert a[name]["max_abs_err"] == 0.0 and a[name]["ms"] is None, a[name]
assert a["gaussian"]["taps"] == 85 and a["gaussian"]["bound_by"] == "operations", a
b = ht["b"]
assert b["out"] == (320, 320) and b["window_differ"] == 0 and b["bound_by"] == "bytes", b
assert abs(b["bound_ms"] - (600 * 600 * 3 + 320 * 320 * 3) / 3.35e12 * 1e3) < 1e-12, b
assert len(ht["c"]) == 15, sorted(ht["c"])
line = chip_smoke.host_tools_line(ht, 1.0, "cpu")
assert line.startswith("host-tools ok") and "15 tools exit 0" in line, line
assert "matplotlib" not in sys.modules
''' + EPILOGUE


def test_smoke_host_tools_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", HOST_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
