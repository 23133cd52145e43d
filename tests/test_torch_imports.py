"""The port stands alone: nothing of JAX, of the JAX package, or of the
packages the card's machine lacks or the port does without (yaml, cv2,
pandas, tqdm, flax, optax, PIL) is imported by geotrax_tpu_torch or
chip_smoke.py, at import time or on the smoke's path. A subprocess refuses
those imports, imports every module, and rehearses the smoke's phases on
the CPU at a tiny size: one subprocess the kernel, main, steady and ReID
phases, another the reference phase's six trackers and the cli phase (its
decode branch included, since this machine has FFmpeg's headers) (two, each
with one intra-op thread, so that each stays well inside its time limit
when the suite runs on every core; tests/test_torch_imports_options.py,
tests/test_torch_imports_georef.py and the other test_torch_imports_*.py
files rehearse the later phases in their own, on other workers); an AST
walk checks the sources."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "geotrax_tpu_torch"
REFUSED = ("jax", "jaxlib", "flax", "optax", "yaml", "cv2", "pandas", "tqdm", "PIL", "geotrax_tpu")

PRELUDE = r'''
import importlib, importlib.abc, pkgutil, sys
REFUSED = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import torch
# one intra-op thread: the rehearsal's tensors are tiny, and the suite runs its
# workers on every core, where a pool per process makes every one wait
torch.set_num_threads(1)
import geotrax_tpu_torch
names = [m.name for m in pkgutil.walk_packages(geotrax_tpu_torch.__path__, "geotrax_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
''' % (REFUSED,)

EPILOGUE = r'''
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("GUARD-OK", len(names))
'''

GUARD = PRELUDE + r'''
kern = chip_smoke.phase_kernel("cpu", check_shape=(2, 40, 60), odd_shape=(2, 37, 53),
                               time_shape=(32, 1080, 1920))
assert kern["max_abs_err"] == 0.0 and kern["bound_by"] == "bytes", kern
assert abs(kern["bound_ms"] - 2 * 4 * 32 * 1080 * 1920 / 3.35e12 * 1e3) < 1e-9
pg = chip_smoke.phase_patches("cpu", shapes=(((1, 40, 70), 30), ((6, 40, 70), 20)))
assert pg["max_abs_err"] == 0.0 and [r["shape"] for r in pg["shapes"]] == [(1, 40, 70),
                                                                          (6, 40, 70)], pg
last = pg["shapes"][-1]
assert last["bound_by"] == "bytes" and "ms" not in last, last
# every patch written once; the corner patches overlap, so fewer pixels are read
assert 4 * 6 * 20 * (1024 + 2) < last["bytes"] < 4 * 6 * 20 * (2 * 1024 + 2), last
# at this size the random detector's one box masks about half of the frame,
# so few features remain and the camera check gets a wide limit
run = chip_smoke.phase_main("cpu", width=512, height=288, n_frames=6, chunk=4, variant="n",
                            imgsz=256, horizon=14, tol_px=10.0)
assert run["checks"]["rows"] > 0, run["checks"]
assert run["checks"]["metadata_keys"] == chip_smoke.METADATA_KEYS, run["checks"]
assert chip_smoke.phase_kernel_on_path(run["frames"][:4], device="cpu") == {}
assert run["stats"]["chunks"] == 2 and run["fx"]._resize_geom == (144, 256)
steady = chip_smoke.phase_steady(run["fx"], 512, 288, 0, 14, 6, chunk=4, n_chunks=2, tol_px=10.0)
assert len(steady["chunk_ms"]) == 2 and steady["camera_err_px"] < 10.0, steady
assert len(run["frames"]) == 6 and [i for i, _ in steady["frames"]] == [6, 7, 8, 9]
rd = chip_smoke.phase_reid(run["fx"].detector, run["frames"], steady["frames"], run["reader"],
                           "cpu", imgsz=256, chunk=4, tol_px=10.0)
assert rd["stats"]["chunks"] == 2 and rd["checks"]["rows"] > 0, rd["checks"]
assert rd["launches"] == {"fast_score": 0, "patch_gather": 0}, rd["launches"]
assert rd["emb"]["valid"] > 0 and rd["emb"]["plain_err"] == 0.0, rd["emb"]
assert rd["head_emb"]["plain_err"] == 0.0 and rd["head_vs_projection"] > 0.1, rd
# the chunk's own HWC gathers: the shared resize's uint8 image, means for the
# projection and patches for the head
g, gh = rd["emb"]["gather"], rd["head_emb"]["gather"]
assert g["shape"] == gh["shape"] == (4, 144, 256, 3) and g["corners"] == gh["corners"], g
assert (g["pool2"], g["mean4"], gh["mean4"]) == (False, True, False) and "ms" not in g, (g, gh)
assert rd["timed_camera_err_px"] < 10.0 and rd["head_checks"]["rows"] > 0, rd
assert len(rd["turns"]["plain"]) == len(rd["turns"]["reid"]) == 2, rd["turns"]
''' + EPILOGUE

REFERENCE_GUARD = PRELUDE + r'''
ref = chip_smoke.phase_reference("cpu", n_frames=6, chunk=4)
assert list(ref) == ["botsort", "botsort+reid", "deepocsort+reid", "tracktrack+reid", "ocsort",
                     "fasttrack"], ref
assert all(r["box_err"] == 0.0 and r["h_err"] == 0.0 and r["rows"] > 0 for r in ref.values()), ref
# the cli phase on the first guard's frames and detector (the same seed and calibration)
reader = chip_smoke.smoke_reader(512, 288, 0, 14, stop=6)
frames = chip_smoke.make_frames(reader)
_, fx, _ = chip_smoke.build_extractor("cpu", 512, 288, "n", 256, 0, 4, frames[0][1])
cli = chip_smoke.phase_cli(fx.detector, frames, reader, "cpu", chunk=4, tol_px=10.0, turn_rounds=1)
assert cli["npz_vs_memory"] == 0.0 and cli["pt_vs_npz"] <= 1e-3 and cli["launches"] == 0, cli
assert cli["checks"]["rows"] > 0 and cli["checks"]["metadata_keys"] == chip_smoke.METADATA_KEYS
assert cli["probe"]["ok"] and cli["subprocess_checks"]["camera_err_px"] < 10.0, cli
assert len(cli["turns"]["ms"]["pipelined"]) == len(cli["turns"]["ms"]["serial"]) == 1, cli
''' + EPILOGUE


def test_port_and_smoke_import_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout


def test_smoke_reference_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", REFERENCE_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout


def _imports(path: Path):
    """(module, name of the function the import is in or None) per import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    owner = {}
    for f in ast.walk(tree):
        if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(f):
                owner.setdefault(id(node), f.name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, owner.get(id(node))) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, owner.get(id(node))


# The two Pillow imports of the port, each inside the one function that
# meets a file the port has no decoder for: the training loader's JPEG or
# BMP image, as the reference reads every image (PNG goes through
# io/png.py), and a JPEG-compressed TIFF orthophoto (every other TIFF goes
# through io/tiff.py's own decoders). The subprocess guards refuse PIL on
# every smoke path; tests/test_torch_imports_features.py lets that one
# function import it.
PIL_ALLOWED = (("geotrax_tpu_torch/train/data.py", "load_image"),
               ("geotrax_tpu_torch/io/tiff.py", "_read_jpeg"))


def test_sources_import_no_jax_and_no_reference_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    found = [(str(f.relative_to(ROOT)), m, fn) for f in files for m, fn in _imports(f)
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "geotrax_tpu", "PIL",
                                    "pandas", "tqdm")]
    bad = [x for x in found if not (x[1].split(".")[0] == "PIL" and (x[0], x[2]) in PIL_ALLOWED)]
    assert not bad, bad


def test_smoke_refuses_to_run_without_a_card():
    """No result line without CUDA: the smoke exits non-zero (checked where
    there is no card; on a machine with one the check is moot)."""
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_smoke_patch_bound_reads_each_covered_pixel_once():
    """The gather's bound counts every patch written and every plane pixel
    that some patch covers, once, whatever the overlap."""
    import numpy as np
    import torch

    import chip_smoke

    planes = torch.zeros((2, 64, 80))
    x0 = torch.tensor([[0, 0, 10, -5], [48, 70, 48, 30]], dtype=torch.int32)
    y0 = torch.tensor([[0, 0, 5, -9], [32, 40, 0, 16]], dtype=torch.int32)
    covered = 0
    for b in range(2):
        mask = np.zeros((64, 80), bool)
        for x, y in zip(x0[b].tolist(), y0[b].tolist()):
            x, y = min(max(x, 0), 80 - 32), min(max(y, 0), 64 - 32)
            mask[y:y + 32, x:x + 32] = True
        covered += int(mask.sum())
    ms, bound_by, moved = chip_smoke.patch_bound_ms(planes, x0, y0)
    assert bound_by == "bytes"
    assert moved == 4 * (8 * 1024 + covered + 2 * 8)
    assert ms == moved / chip_smoke.HBM_BYTES_PER_S * 1e3


@pytest.mark.parametrize("pool2", [False, True])
@pytest.mark.parametrize("mean4", [False, True])
def test_smoke_hwc_bound_reads_each_covered_byte_once(pool2, mean4):
    """The HWC gather's bound counts every patch (or its means) written and
    every uint8 byte under some patch, once: with ``pool2`` the 2x2 image
    pixels of each covered pooled pixel."""
    import numpy as np
    import torch

    import chip_smoke

    f = 2 if pool2 else 1
    # with pool2 the odd row and column are trimmed away
    image = torch.zeros((2, 64 * f + f - 1, 80 * f + f - 1, 3), dtype=torch.uint8)
    x0 = torch.tensor([[0, 0, 10, -5], [48, 70, 48, 30]], dtype=torch.int32)
    y0 = torch.tensor([[0, 0, 5, -9], [32, 40, 0, 16]], dtype=torch.int32)
    covered = 0
    for b in range(2):
        mask = np.zeros((64, 80), bool)
        for x, y in zip(x0[b].tolist(), y0[b].tolist()):
            x, y = min(max(x, 0), 80 - 32), min(max(y, 0), 64 - 32)
            mask[y:y + 32, x:x + 32] = True
        covered += int(mask.sum())
    ms, bound_by, moved = chip_smoke.hwc_bound_ms(image, x0, y0, pool2, mean4)
    assert bound_by == "bytes"
    assert moved == 3 * f * f * covered + 4 * 8 * 3 * (64 if mean4 else 1024) + 8 * 8
    assert ms == moved / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_cv2_only_inside_the_cv2_backend_and_no_yaml():
    """``yaml`` is imported nowhere in the port or the smoke; ``cv2`` only
    inside the functions of the cv2 decode backend (io/video.py)."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        functions = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef,
                                                                  ast.AsyncFunctionDef))]
        inside = {id(m) for f in functions for m in ast.walk(f)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for name in names:
                if name.split(".")[0] in ("yaml", "cv2"):
                    found.append((str(path.relative_to(ROOT)), name, id(node) in inside))
    assert found and all(f == "geotrax_tpu_torch/io/video.py" and n == "cv2" and inside
                         for f, n, inside in found), found
