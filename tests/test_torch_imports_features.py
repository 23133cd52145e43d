"""The smoke's features phase (chip_smoke.phase_features) rehearsed on the
CPU at a tiny size in a subprocess with one intra-op thread, under the
import guard of tests/test_torch_imports.py with one opening: Pillow may be
imported from inside ``io/tiff.py:_read_jpeg`` alone (the JPEG-compressed
TIFF fixture), and nowhere else. The feature library on a drifting frame
and its 1.6x zoom, ``lapjv_exact`` against scipy, the TIFF fixtures, and
the GeoTIFF leg: the georef assets written, ``georeference`` with the
master path and from the cache on a text-file folder, then on a folder
holding only ``<loc>.tif``."""

import subprocess
import sys

from test_torch_imports import PRELUDE, ROOT

FEATURES_GUARD = PRELUDE + r'''
class RefuseButJpegTiff(Refuse):
    """Pillow only with io/tiff.py's _read_jpeg on the stack."""
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            frame = sys._getframe(1)
            while frame is not None:
                code = frame.f_code
                if code.co_name == "_read_jpeg" and code.co_filename.endswith("io/tiff.py"):
                    return None
                frame = frame.f_back
        return super().find_spec(name, path, target)

sys.meta_path = [RefuseButJpegTiff() if isinstance(f, Refuse) else f for f in sys.meta_path]
assert "PIL" not in sys.modules
ft = chip_smoke.phase_features("cpu", width=640, height=360, k=300, lap_shape=(60, 110),
                               size=640, fw=320, fh=180, n_frames=300, vehicles=4, rects=200,
                               max_features=4000)
a, b, c = ft["a"], ft["b"], ft["c"]
assert a["shape"] == (180, 320) and a["launches"] == {"fast_score": 0, "patch_gather": 0}, a
assert a["matches"] > 20 and a["h_err_px"] < 4.0 and a["angle_err"] == 0.0, a
assert set(a["ms"]) == {"fast_oriented", "describe_patches", "describe_planes",
                        "describe_oriented", "pyramid_a", "pyramid_b", "match", "ransac"}, a
assert all(v == 0.0 for v in a["bits"].values()) and a["overlap"] == [1.0, 1.0], a
assert a["kernel_err"] == {"fast_score": 0.0, "patch_gather": 0.0}, a
assert b["shape"] == (60, 110) and b["s"] > 0, b
assert len(ft["fixtures"]["files"]) == 5, ft["fixtures"]
assert c["rows"] == 1200 and c["cache_s"] is not None and c["convert_s"] > 0, c
assert len(c["params"]) == 6 and c["params"][4:] == (0.0, 0.0), c
line = chip_smoke.features_line(ft, 1.0, "cpu")
assert line.startswith("features ok") and "CSV byte-equal" in line, line
# the JPEG fixture went through Pillow, inside _read_jpeg
assert "PIL" in sys.modules
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED and m.split(".")[0] != "PIL")
assert not leaked, leaked
print("GUARD-OK", len(names))
'''


def test_smoke_features_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", FEATURES_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
