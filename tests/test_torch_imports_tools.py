"""The smoke's tools phase (chip_smoke.phase_tools) rehearsed on the CPU at
a tiny size in a subprocess with one intra-op thread, under the import
guard of tests/test_torch_imports.py (no JAX, no JAX package, no pandas,
cv2, PIL or yaml): annotate_frames on two 640x360 PNGs with a calibrated
YOLOv8n at imgsz 256, without and with --augment (the "card" run is a
second CPU run, so the labels agree exactly); benchmark_ortho_matching
--synthetic-ortho on a 1024^2 ortho with a 640x360 view and 2000 features
with rsift and orb, FAST's plain version on the orb path's grays; and,
since this machine has FFmpeg, merge_videos_and_logs and
recut_video_and_log on two small clips (the cut snapped to keyframes
12..30)."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

TOOLS_GUARD = PRELUDE + r'''
tl = chip_smoke.phase_tools("cpu", width=640, height=360, n_images=2, variant="n", imgsz=256,
                            ortho_px=1024, max_features=2000, frame_size=(640, 360))
for key in ("plain", "augment"):
    r = tl[key]
    assert r["lines"] == r["cpu_lines"] > 0 and r["box_px"] == 0.0 and r["score"] == 0.0, r
    assert r["at_threshold"] == 0 and r["ms_per_image"] > 0, r
assert tl["calibrated"] > 0, tl
b = tl["b"]
assert [r["detector"] for r in b["rows"]] == ["rsift", "orb"], b["rows"]
assert b["rows"][0]["err"] < 3.0 and b["rows"][0]["peak_gib"] is None, b["rows"]
assert b["launches"] == {"fast_score": 0, "patch_gather": 0}, b
assert (360, 640) in b["grays"] and (1024, 1024) in b["grays"], b["grays"]
assert tl["c"]["ran"] and tl["c"]["merged"] == 50 and tl["c"]["cut"] == 19, tl["c"]
line = chip_smoke.tools_line(tl, 1.0, "cpu")
assert line.startswith("tools ok") and "merge_videos_and_logs" in line, line
''' + EPILOGUE


def test_smoke_tools_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", TOOLS_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
