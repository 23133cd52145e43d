"""The smoke's multi phase (chip_smoke.phase_multi) rehearsed on the CPU at
a tiny size in a subprocess that refuses the imports
tests/test_torch_imports.py refuses, with one intra-op thread: (a) one
rank in a gloo group of one bit-equal to no group; (b) two gloo ranks
spawned, bit-equal to each other and within MULTI_REL_TOL of (a); (c) the
CLI's refusal and its one-rank run; (d) detection over two stand-in
devices bit-equal to one; (e) run on two stand-in "cards" (NCCL's part
through gloo on the CPU, the lockstep with --devices 2)."""

import os
import subprocess
import sys

from test_torch_imports import EPILOGUE, PRELUDE, ROOT

MULTI_GUARD = PRELUDE + r'''
mu = chip_smoke.phase_multi("cpu", width=160, height=96, counts=(4, 3), imgsz=64, batch=2,
                            n_frames=4, vehicles=3, cards=2, lock_frames=3, variant="n")
assert mu["a"]["group_equal"] and mu["a"]["repeat_equal"] and mu["a"]["backend"] == "gloo", mu["a"]
assert mu["labels"] == 7 * 3 and mu["a"]["rows"] == 2, mu
for rk in (mu["b"], mu["e"]["ranks"]):
    assert rk["world"] == 2 and rk["backend"] == "gloo" and rk["rows"] == 1, rk
    assert rk["trace_all"] <= chip_smoke.MULTI_REL_TOL and rk["trace_all"] > 0, rk
    assert [len(r["load_ms"]) for r in rk["ranks"]] == [2, 2], rk
assert "--batch 2" in mu["c_refused"] and "3 ranks" in mu["c_refused"], mu["c_refused"]
assert len(mu["c_run"]["losses"]) == 1 and mu["c_run"]["count"] == 2, mu["c_run"]
for d in (mu["d"], mu["e"]["d"]):
    assert d["step_diff"] == d["tiled_diff"] == 0.0 and d["frames"] == 4, d
assert mu["d"]["launches"] == {"fast_score": 0, "patch_gather": 0}, mu["d"]
assert sum(mu["e"]["lockstep"]["rows"]) > 0, mu["e"]
line = chip_smoke.multi_line(mu, 1.0, "cpu")
assert line.startswith("multi ok") and "(e) 2 ranks over gloo" in line, line
entry = chip_smoke.multi_entry(mu)
assert entry["b"]["world"] == 2 and entry["e"]["lockstep_rows"] == mu["e"]["lockstep"]["rows"]
mu["e"], mu["cards"] = None, 1
assert "(e) did not run for want of cards" in chip_smoke.multi_line(mu, 1.0, "cpu")
''' + EPILOGUE


def test_smoke_multi_phase_imports_nothing_refused():
    # the spawned ranks inherit one intra-op thread from the environment
    proc = subprocess.run([sys.executable, "-c", MULTI_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
