"""The port's shell wrappers (``geotrax_tpu_torch/train/{train,export,
launch}.sh``) and its converter's CLI (``python -m
geotrax_tpu_torch.models.convert``), on the CPU.

- ``train.sh``: the reference's getopts and variant rule, the trainer's own
  flags after ``--``; a 1-epoch run writes the run files.
- ``export.sh``: every ``*.pt`` under a folder becomes a ``.npz`` that the
  port and the JAX package load; the port's forward and detections from it
  equal those from the ``.pt`` exactly, the reference's forward within
  tests/test_torch_yolov8.py's rtol 1e-4 / atol 1e-3; ``--bf16`` stores
  the reference's bytes (bfloat16 records), read back as float32.
- ``launch.sh``: without SLURM it runs its command unchanged; inside a
  multi-node allocation (``srun`` and ``scontrol`` replaced by stubs on
  PATH) it starts one torchrun per node with GEOTRAX_MULTIHOST=1.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.models import convert as jconvert
from geotrax_tpu.models import yolov8 as jy
from geotrax_tpu_torch.models import convert as tconvert
from geotrax_tpu_torch.models import yolov8 as ty
from geotrax_tpu_torch.ops.nms import postprocess_detections

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_train import RUN_FILES, write_synth_dataset  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "geotrax_tpu_torch" / "train"
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHON": sys.executable}


def run(argv, env=None, timeout=180, cwd=None):
    return subprocess.run([str(a) for a in argv], capture_output=True, text=True,
                          timeout=timeout, env=env or ENV, cwd=cwd or ROOT)


def test_train_sh_runs_the_trainer(tmp_path):
    data = write_synth_dataset(tmp_path / "data", counts=(("train", 8), ("val", 2)))
    proc = run([SCRIPTS / "train.sh", "-d", data, "-m", "yolov8n", "-e", "1", "-b", "8",
                "-i", "64", "-o", tmp_path / "run", "--", "--nc", "2", "--device", "cpu",
                "--no-tb"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == RUN_FILES
    assert "Training yolov8n (nc=2) from scratch" in proc.stderr
    proc = run([SCRIPTS / "train.sh", "-e", "1"])
    assert proc.returncode == 2 and "-d DATASET_DIR is required" in proc.stdout


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    spec = ty.ModelSpec(variant="n", nc=2)
    model = ty.init_params(torch.Generator().manual_seed(3), spec, device="cpu")
    (root / "a" / "b").mkdir(parents=True)
    tconvert.save_pt(root / "a" / "b" / "w.pt", model, {0: "car", 1: "bus"})
    tconvert.save_pt(root / "a" / "v.pt", model, {0: "car", 1: "bus"})
    proc = run([SCRIPTS / "export.sh", root / "a", "--check", "64", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, proc.stdout


def detections(model, spec, images):
    with torch.no_grad():
        boxes, probs = ty.forward(model, torch.from_numpy(images), spec)
        return boxes, probs, postprocess_detections(boxes, probs, 0.05, 0.7, 100)


def test_export_sh_npz_loads_in_both_packages(exported):
    root, stdout = exported
    assert stdout.count("exporting ") == 2 and stdout.count("check @ 64 on cpu") == 2
    images = np.random.default_rng(0).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    pt_model, spec, names = tconvert.load_model(root / "a" / "b" / "w.pt")
    npz_model, npz_spec, npz_names = tconvert.load_model(root / "a" / "b" / "w.npz")
    assert (npz_spec, npz_names) == (spec, names) == (spec, {0: "car", 1: "bus"})
    want, got = detections(pt_model, spec, images), detections(npz_model, spec, images)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    for k in want[2]:
        torch.testing.assert_close(got[2][k], want[2][k], rtol=0, atol=0, msg=k)
    assert int(want[2]["valid"].sum()) > 0
    params, jspec, jnames = jconvert.load_model(root / "a" / "b" / "w.npz")
    assert (jspec.variant, jspec.nc, jnames) == ("n", 2, names)
    jb, jp = jy.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(images), jspec)
    np.testing.assert_allclose(np.asarray(jb), want[0].numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(jp), want[1].numpy(), rtol=1e-4, atol=1e-3)


def test_convert_cli_bf16_and_pt(exported, tmp_path):
    root, _ = exported
    src = root / "a" / "v.npz"
    proc = run([sys.executable, "-m", "geotrax_tpu_torch.models.convert", src, "-o",
                tmp_path / "h.npz", "--bf16"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp_path / "h.npz", allow_pickle=True) as z:
        kinds = {z[k].dtype for k in z.files if k.startswith("param:")}
    assert kinds == {np.dtype("V2")}  # the reference's --bf16 bytes
    full, _, _ = tconvert.load_model(src)
    half, _, _ = tconvert.load_model(tmp_path / "h.npz")
    for a, b in zip(full.parameters(), half.parameters()):
        assert b.dtype == torch.float32
        torch.testing.assert_close(b, a.to(torch.bfloat16).float(), rtol=0, atol=0)
    proc = run([sys.executable, "-m", "geotrax_tpu_torch.models.convert", src, "-o",
                tmp_path / "back.pt"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    back, _, _ = tconvert.load_model(tmp_path / "back.pt")
    for a, b in zip(full.parameters(), back.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    if not torch.cuda.is_available():  # --check runs on the card unless told otherwise
        proc = run([sys.executable, "-m", "geotrax_tpu_torch.models.convert", src, "-o",
                    tmp_path / "c.npz", "--check", "64"])
        assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
        assert not (tmp_path / "c.npz").exists()


def test_launch_sh_without_slurm_runs_the_command_unchanged():
    env = {k: v for k, v in ENV.items() if not k.startswith("SLURM_")}
    argv = ["a", "b c", "", "--flag=x y"]
    proc = run([SCRIPTS / "launch.sh", sys.executable, "-c",
                "import json, os, sys; print(json.dumps([sys.argv[1:], "
                "os.environ.get('GEOTRAX_MULTIHOST')]))", *argv], env=env)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == [argv, None]


def test_launch_sh_starts_one_torchrun_per_node(tmp_path):
    stubs = tmp_path / "bin"
    stubs.mkdir()
    (stubs / "srun").write_text(
        f"#!{sys.executable}\nimport json, os, sys\n"
        "print(json.dumps([sys.argv[1:], os.environ.get('GEOTRAX_MULTIHOST')]))\n")
    (stubs / "scontrol").write_text("#!/bin/sh\nprintf 'gpu-node-3\\ngpu-node-4\\n'\n")
    for stub in stubs.iterdir():
        stub.chmod(0o755)
    env = {**ENV, "PATH": f"{stubs}{os.pathsep}{ENV['PATH']}", "SLURM_JOB_ID": "4242",
           "SLURM_JOB_NUM_NODES": "2", "SLURM_JOB_NODELIST": "gpu-node-[3-4]",
           "SLURM_GPUS_ON_NODE": "4"}
    proc = run([SCRIPTS / "launch.sh", "train.sh", "-d", "data set"], env=env)
    assert proc.returncode == 0, proc.stderr
    argv, multihost = json.loads(proc.stdout)
    assert multihost == "1"
    assert argv == ["--nodes", "2", "--ntasks-per-node", "1", sys.executable, "-m",
                    "torch.distributed.run", "--nnodes", "2", "--nproc-per-node", "4",
                    "--rdzv-backend", "c10d", "--rdzv-endpoint", "gpu-node-3:29500",
                    "--rdzv-id", "4242", "--no-python", "train.sh", "-d", "data set"]
