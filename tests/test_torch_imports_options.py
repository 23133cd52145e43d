"""The smoke's options phase (chip_smoke.phase_options) rehearsed on the CPU
at a tiny size in a subprocess that refuses the imports
tests/test_torch_imports.py refuses, with one intra-op thread: the stable
preset, tiles, half and stabilization off with botsort and with bytetrack,
each through a fresh detector and extractor, on two chunks of two 512x288
frames of the guard's video. Its own file, so that the suite's workers run
it beside the other two rehearsals."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

OPTIONS_GUARD = PRELUDE + r'''
reader = chip_smoke.smoke_reader(512, 288, 0, 14, stop=4)  # the guard's video
frames = chip_smoke.make_frames(reader)
_, fx, _ = chip_smoke.build_extractor("cpu", 512, 288, "n", 256, 0, 2, frames[0][1])
opts = chip_smoke.phase_options(fx.detector, frames, reader, "cpu", imgsz=256, chunk=2,
                                tol_px=10.0)
assert [k for k in opts] == [k for k, _ in chip_smoke.OPTIONS], opts
assert all(v["launches"] == 0 and len(v["ms"]) == 2 for v in opts.values()), opts
assert "gmc_err_px" in opts["stabilize off, botsort"] and "camera_err_px" in opts["stable"], opts
''' + EPILOGUE


def test_smoke_options_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", OPTIONS_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
