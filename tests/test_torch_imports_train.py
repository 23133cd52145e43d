"""The smoke's train phase (chip_smoke.phase_train) rehearsed on the CPU at
a tiny size in a subprocess that refuses the imports
tests/test_torch_imports.py refuses (PIL among them: the port reads PNG
with its own codec and resizes with its own copy of Pillow's resampler),
with one intra-op thread: the dataset written, ``train`` fine-tuned from
the seeded checkpoint for 2 epochs and resumed, one step on two devices
(here both the CPU), the instrumented loop; neither hand kernel launches."""

import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

TRAIN_GUARD = PRELUDE + r'''
tr = chip_smoke.phase_train("cpu", width=160, height=96, counts=(4, 3), imgsz=64, batch=2,
                            check_imgsz=64, check_batch=2, timed_steps=3, vehicles=3)
assert tr["launches"] == {"fast_score": 0, "patch_gather": 0}, tr["launches"]
assert tr["labels"] == 7 * 3
full, resumed = tr["full"], tr["resumed"]
assert len(full["losses"]) == 2 and full["count"] == 2 * 2, full
assert full["lr"] == resumed["lr"] and resumed["losses"] == full["losses"], (full, resumed)
assert tr["resume"]["weight_max_abs"] == 0.0, tr["resume"]
cc = tr["card_vs_cpu"]
assert cc["fg"][0] > 0 and cc["loss_rel"] == 0.0 and cc["card_cpu_max"] == 0.0, cc
assert cc["card_f64_max"] < 1e-4, cc
tm = tr["timed"]
assert len(tm["steps"]) == 3 and tm["val_images"] == 3 and len(tm["load_ms"]) == 2, tm
assert tm["bound_by"] in ("bytes", "operations") and tm["flops"] > 2 * tm["forward_flops"]
line = chip_smoke.train_line(tr, 1.0, "cpu")
assert line.startswith("train ok") and "resumed to 2" in line, line
''' + EPILOGUE


def test_smoke_train_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", TRAIN_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
