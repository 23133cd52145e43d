"""The smoke's decode phase, part (f), rehearsed: chip_smoke.decode_workers
(GEOTRAX_DECODE_WORKERS through cv2) on the CPU at a small size, in a
subprocess under the import guard of tests/test_torch_imports.py with cv2
let through, as the card's machine has it: tests/data/video/h264_gop.mp4
read by the GOP-parallel reader on cv2 captures with 2, 3 and 4 workers,
every frame equal to the reference's; a clip of the seeded scene written
as mp4v by cv2's writer and read with 1, 2 and 4 workers (two segments of
two GOPs at most), frames equal at every count; one capture's split; and
``python -m geotrax_tpu_torch extract`` of it with 1 and the fastest count
of workers, files byte-equal."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

WORKERS_GUARD = PRELUDE.replace("'cv2', ", "") + r'''
import tempfile
from pathlib import Path
reader = chip_smoke.smoke_reader(512, 288, 0, 14, stop=6)
frames = chip_smoke.make_frames(reader)
_, fx, _ = chip_smoke.build_extractor("cpu", 512, 288, "n", 256, 0, 4, frames[0][1])
tmp = Path(tempfile.mkdtemp())
ckpt, cfg = chip_smoke.cli_checkpoint(fx.detector, tmp)
# 48 frames of cv2's default 12-frame GOPs: two segments of two GOPs at most
wk = chip_smoke.decode_workers(tmp, ckpt, cfg, "cpu", chip_smoke.GOP_CLIP,
                               chip_smoke.smoke_reader(320, 192, 0, 48), 48, counts=[1, 2, 4])
assert [(c, r["workers"], r["frames_equal"]) for c, r in wk["gop"].items()] == [
    (2, 2, 96), (3, 3, 96), (4, 4, 96)], wk["gop"]
assert wk["gop"][4]["segments"] == [(0, 24), (24, 48), (48, 72), (72, 96)], wk["gop"]
reads = wk["reads"]
assert [(c, r["reader"], r["workers"]) for c, r in reads.items()] == [
    (1, "VideoReader", 1), (2, "ParallelVideoReader", 2), (4, "ParallelVideoReader", 2)], reads
assert wk["split"]["frames"] == 48 and wk["best"] in (2, 4), wk
ex = wk["extract"]
assert list(ex) == [1, wk["best"]] and ex[1]["reader"].startswith("VideoReader (cv2"), ex
assert ex[wk["best"]]["reader"].startswith("ParallelVideoReader (cv2 backend, 2 workers"), ex
line = chip_smoke.workers_text(wk)
assert line.startswith("(f) host: ") and line.endswith("files byte-equal"), line
''' + EPILOGUE


def test_smoke_decode_workers_imports_nothing_else_refused():
    proc = subprocess.run([sys.executable, "-c", WORKERS_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
