"""The port's trainer (``geotrax_tpu_torch/train``) against the JAX
package's: the schedule and one optimizer update against optax,
``trainer_state.npz`` across the packages, the loader's batches and the
letterbox resize bit for bit (Pillow imported here, never by the port),
``evaluate_detections`` and the run log equal, a 2-epoch ``train()`` of
each package from the same JAX-initialised ``.npz``, kill-and-resume
within a package and across the two, and the data-parallel CLI: ``--devices
2``, ``--slices 2`` and ``--multihost`` under torchrun's environment against
the 1-process run, and its exits.

Tolerances: the linear schedule (the default preset's) and the SGD update
bit-equal; the cosine schedule within 1e-6 x lr0 (libm's cosine against
XLA's, a few float32 ulps where 1 + cos cancels); per-epoch losses of
the two packages within rel 1e-4 and their final weights within rel L2
1e-4 (float32 convolutions summed in another order, over 4 steps); the
port's resumed run equal to its uninterrupted one (rtol 1e-5, atol 1e-7,
the reference's own bar); a run over 2 ranks against the 1-process run:
losses within rel 1e-4 and weights within rel L2 1e-4 (the gradients' mean
over ranks sums in another order), one rank under torchrun bit-equal."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from geotrax_tpu.models import yolov8 as jy
from geotrax_tpu.models.convert import save_npz as jax_save_npz
from geotrax_tpu.train import data as jdata
from geotrax_tpu.train import metrics as jmetrics
from geotrax_tpu.train import runlog as jrunlog
from geotrax_tpu.train import train as jtrain
from geotrax_tpu_torch.models import yolov8 as ty
from geotrax_tpu_torch.models.convert import param_leaves
from geotrax_tpu_torch.train import data as tdata
from geotrax_tpu_torch.train import metrics as tmetrics
from geotrax_tpu_torch.train import optim as toptim
from geotrax_tpu_torch.train import runlog as trunlog
from geotrax_tpu_torch.train import train as ttrain
from geotrax_tpu_torch.train.resample import resize_bicubic

ROOT = Path(__file__).resolve().parent.parent
RUN_FILES = ["best.npz", "history.json", "last.npz", "metrics.jsonl", "results.csv",
             "trainer_state.npz", "val_summary.json"]
LOSS_RTOL = 1e-4
WEIGHT_REL_L2 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for torch: the models are tiny, and the suite
    runs a worker on every core, where a thread pool per worker makes every
    one wait (autouse, so it is set before the module's other fixtures)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- optimizer
SCHEDULES = {
    "warmup_linear": (0.01, 0.01, 7, 40, False),
    "no_warmup_linear": (0.02, 0.1, 0, 13, False),
    "preset_linear": (0.01, 0.01, 600, 3200, False),
    "warmup_cosine": (0.01, 0.01, 7, 40, True),
    "cosine": (0.02, 0.1, 3, 500, True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_optax(name):
    """Inside the reference's jitted step (``fused``) and called eagerly on
    a Python int as it logs ``lr`` (not fused), at every step."""
    lr0, lrf, warm, total, cos = SCHEDULES[name]
    ref = jtrain.build_lr_schedule(lr0, lrf, warm, total, cos)
    port = toptim.build_lr_schedule(lr0, lrf, warm, total, cos)
    jitted = jax.jit(ref)
    counts = range(total + 3)
    fused = np.array([port(c) for c in counts], np.float32)
    eager = np.array([port(c, fused=False) for c in counts], np.float32)
    want_fused = np.array([jitted(jnp.int32(c)) for c in counts], np.float32)
    want_eager = np.array([ref(c) for c in counts], np.float32)
    if cos:  # libm's cosine against XLA's; 1 + cos cancels late in the decay
        np.testing.assert_allclose(fused, want_fused, rtol=0, atol=1e-6 * lr0)
        np.testing.assert_allclose(eager, want_eager, rtol=0, atol=1e-6 * lr0)
    else:
        np.testing.assert_array_equal(fused, want_fused)
        np.testing.assert_array_equal(eager, want_eager)


def test_sgd_update_equals_optax():
    """Six updates of the reference's optax chain in its jitted form
    against the port's SGD: parameters, trace and count bit-equal."""
    schedule = jtrain.build_lr_schedule(0.01, 0.01, 3, 20, False)
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.sgd(schedule, momentum=0.937, nesterov=True))
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 3, 8, 16), "b": (500,), "c": (1, 1, 16, 7)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]

    @jax.jit
    def step(p, state, g):
        updates, state = tx.update(g, state, p)
        return jax.tree.map(lambda a, b: a + b, p, updates), state

    sgd = toptim.SGD(toptim.build_lr_schedule(0.01, 0.01, 3, 20, False))
    keys = sorted(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    tstate = sgd.init(tp)
    jp, jstate = jax.tree.map(jnp.asarray, params), tx.init(params)
    for g in grads:
        jp, jstate = step(jp, jstate, g)
        tstate = sgd.update(tp, [torch.from_numpy(g[k]) for k in keys], tstate)
        trace = jax.tree_util.tree_leaves(jstate)[:-1]
        for i, k in enumerate(keys):
            np.testing.assert_array_equal(tp[i].numpy(), np.asarray(jp[k]), err_msg=k)
            np.testing.assert_array_equal(tstate.trace[i].numpy(), np.asarray(trace[i]))
        assert tstate.count == int(jax.tree_util.tree_leaves(jstate)[-1])


# ---------------------------------------------------------------- data
def write_synth_dataset(root: Path, counts=(("train", 16), ("val", 6)), size=96):
    """tests/test_train.py's recipe: bright elongated boxes on dark texture,
    written by Pillow."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in counts:
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(20, 60, (size, size, 3)).astype(np.uint8)
            labels = []
            for _ in range(rng.integers(1, 3)):
                cx, cy = rng.uniform(0.25, 0.75, 2)
                w, h = 0.3, 0.15
                x0, y0 = int((cx - w / 2) * size), int((cy - h / 2) * size)
                img[y0:y0 + int(h * size), x0:x0 + int(w * size)] = (250, 240, 90)
                labels.append(f"0 {cx:.4f} {cy:.4f} {w:.4f} {h:.4f}")
            Image.fromarray(img).save(root / "images" / split / f"{i}.png")
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(labels))
    return root


@pytest.fixture(scope="module")
def mixed_dataset(tmp_path_factory):
    """Odd sizes and every kind of file the loader meets: RGB, gray,
    palette and RGBA PNGs, a JPEG, a BMP, and an image without labels."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(3)
    sizes = [(71, 103), (96, 64), (50, 50), (33, 129), (120, 90), (64, 80), (45, 77)]
    kinds = ["RGB", "L", "P", "RGBA", "jpg", "bmp", "RGB"]
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i, ((h, w), kind) in enumerate(zip(sizes, kinds)):
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
            name = f"{split}{i}"
            if kind == "jpg":
                img.save(root / "images" / split / f"{name}.jpg", quality=90)
            elif kind == "bmp":
                img.save(root / "images" / split / f"{name}.bmp")
            else:
                (img.quantize(64) if kind == "P" else img.convert(kind)).save(
                    root / "images" / split / f"{name}.png")
            if i != 6:
                lines = [f"{rng.integers(0, 3)} {rng.uniform(0.2, 0.8):.4f} "
                         f"{rng.uniform(0.2, 0.8):.4f} {rng.uniform(0.05, 0.3):.4f} "
                         f"{rng.uniform(0.05, 0.3):.4f}" for _ in range(rng.integers(1, 12))]
                (root / "labels" / split / f"{name}.txt").write_text("\n".join(lines))
    return root


@pytest.mark.parametrize("case", [
    ("train", 4, True, 0), ("train", 4, True, 3), ("train", 9, True, 1),   # 9 > 7: replacement
    ("val", 3, False, 0),                                                  # padded tail
])
def test_loader_batches_bit_equal(mixed_dataset, case):
    split, batch, training, epoch = case
    kwargs = dict(imgsz=96, batch_size=batch, max_gt=8, training=training)
    ref = jdata.Loader(mixed_dataset, split, **kwargs)
    port = tdata.Loader(mixed_dataset, split, **kwargs)
    assert len(ref) == len(port)
    ref_batches, port_batches = list(ref.epoch(epoch)), list(port.epoch(epoch))
    assert len(ref_batches) == len(port_batches) > 0
    for a, b in zip(ref_batches, port_batches):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]), err_msg=key)
    if split == "val":
        assert ref_batches[-1]["n_valid"] == 7 % batch


@pytest.mark.parametrize("shape,size", [
    ((96, 128, 3), (64, 48)),      # down 0.5
    ((37, 53, 3), (90, 63)),       # up 1.7
    ((71, 103, 3), (97, 67)),      # odd, both axes
    ((50, 81, 3), (81, 31)),       # width kept, height down
    ((64, 64, 3), (64, 64)),       # same size: a copy
])
def test_letterbox_resize_bit_equal_to_pillow(shape, size):
    from PIL import Image

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    got = resize_bicubic(img, *size)
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(img).resize(size)))
    boxes = np.array([[1, 0.5, 0.4, 0.2, 0.3]], np.float32)
    for imgsz in (64, 97):
        a, ab = jdata.letterbox_sample(img, boxes, imgsz)
        b, bb = tdata.letterbox_sample(img, boxes, imgsz)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(bb, ab)


def test_evaluate_detections_equal():
    rng = np.random.default_rng(7)
    preds, gts = [], []
    for _ in range(5):
        g = rng.integers(0, 6)
        gt_boxes = np.concatenate([rng.uniform(20, 200, (g, 2)), rng.uniform(5, 40, (g, 2))], 1)
        gts.append({"boxes_xywh": gt_boxes, "classes": rng.integers(0, 3, g)})
        n = rng.integers(0, 12)
        jitter = rng.normal(0, 3, (n, 4))
        base = gt_boxes[rng.integers(0, max(g, 1), n)] if g else rng.uniform(20, 200, (n, 4))
        preds.append({"boxes_xywh": base + jitter, "scores": rng.uniform(0, 1, n),
                      "classes": rng.integers(0, 3, n)})
    for nc in (3, 1):
        p = [{**x, "classes": x["classes"] % nc} for x in preds]
        g = [{**x, "classes": x["classes"] % nc} for x in gts]
        assert tmetrics.evaluate_detections(p, g, nc) == jmetrics.evaluate_detections(p, g, nc)


def test_runlogger_files_equal(tmp_path):
    rows = [{"loss": 2.0, "map50": 0.1, "lr": 0.003, "n": 3},
            {"loss": 1.5, "map50": 0.2, "lr": 0.0066, "extra": "x"}]
    for mod, name in ((jrunlog, "ref"), (trunlog, "port")):
        log = mod.RunLogger(tmp_path / name, enable_tensorboard=False)
        for epoch, row in enumerate(rows):
            log.log_epoch(epoch, row)
        log.close()
        log = mod.RunLogger(tmp_path / name, enable_tensorboard=False)   # resume: appends
        log.log_epoch(2, rows[0])
        log.close()
    for f in ("results.csv", "metrics.jsonl"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()


# ---------------------------------------------------------------- train()
def run_args(data, model, out, epochs, **kw):
    args = dict(data=data, model=str(model) if model else None, variant="n", nc=2, cfg="default",
                imgsz=64, batch=8, epochs=epochs, max_gt=8, devices=None, out=out,
                verbose=False, resume=False, no_tb=True)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """From one JAX-initialised yolov8n .npz: the reference's 2-epoch run
    and its 1-epoch run; the port's 2-epoch run and the port resuming the
    reference's 1-epoch run to 2 epochs. (The reverse direction, the
    reference loading the port's ``trainer_state.npz``, is
    ``test_trainer_state_leaves_round_trip``.)"""
    root = tmp_path_factory.mktemp("train")
    data = write_synth_dataset(root / "data")
    spec = jy.ModelSpec(variant="n", nc=2)
    params = jax.tree.map(np.asarray, jy.init_params(jax.random.PRNGKey(0), spec))
    init = root / "init.npz"
    jax_save_npz(init, params, class_names={0: "0", 1: "1"}, variant="n", nc=2, reg_max=16, p2=0)
    out = {}
    out["ref"] = jtrain.train(run_args(data, init, root / "ref", 2))
    out["port"] = ttrain.train(run_args(data, init, root / "port", 2, device="cpu"))
    jtrain.train(run_args(data, init, root / "ref_then_port", 1))
    out["ref_then_port"] = ttrain.train(run_args(data, init, root / "ref_then_port", 2,
                                                 resume=True, device="cpu"))
    return root, out


def jsonl(path: Path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def npz_params(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("param:")}


def assert_same_run(root: Path, a: str, b: str, out: dict):
    """``b``'s run against ``a``'s; a resumed run's history starts with the
    rows read back from metrics.jsonl (the reference's own behaviour), so
    only the last row's keys are compared then."""
    ha, hb = out[a]["history"], out[b]["history"]
    assert [h["epoch"] for h in ha] == [h["epoch"] for h in hb] == [0, 1]
    assert ha[-1].keys() == hb[-1].keys()
    for x, y in zip(ha, hb):
        assert y["loss"] == pytest.approx(x["loss"], rel=LOSS_RTOL)
        for key in ("map50", "map50_95", "precision", "recall"):
            assert y[key] == pytest.approx(x[key], abs=1e-6), key
    ja, jb = jsonl(root / a / "metrics.jsonl"), jsonl(root / b / "metrics.jsonl")
    assert [r.keys() for r in ja] == [r.keys() for r in jb]
    assert [r["lr"] for r in ja] == [r["lr"] for r in jb]
    assert (root / a / "results.csv").read_text().splitlines()[0] == \
        (root / b / "results.csv").read_text().splitlines()[0]
    pa, pb = npz_params(root / a / "last.npz"), npz_params(root / b / "last.npz")
    assert pa.keys() == pb.keys()
    for key in pa:
        assert pa[key].shape == pb[key].shape and pa[key].dtype == pb[key].dtype
        err = np.linalg.norm(pb[key] - pa[key]) / max(np.linalg.norm(pa[key]), 1e-30)
        assert err <= WEIGHT_REL_L2, (key, err)


def test_two_epoch_train_matches_jax(runs):
    root, out = runs
    assert sorted(p.name for p in (root / "port").iterdir()) == RUN_FILES
    assert sorted(p.name for p in (root / "ref").iterdir()) == RUN_FILES
    assert_same_run(root, "ref", "port", out)
    assert json.loads((root / "port" / "val_summary.json").read_text()).keys() == \
        json.loads((root / "ref" / "val_summary.json").read_text()).keys()
    with np.load(root / "ref" / "trainer_state.npz") as za, \
            np.load(root / "port" / "trainer_state.npz") as zb:
        assert za.files == zb.files
        for key in za.files:
            assert za[key].shape == zb[key].shape and za[key].dtype == zb[key].dtype, key
        np.testing.assert_array_equal(zb["_meta"], za["_meta"])


def test_reference_run_resumes_in_the_port(runs):
    root, out = runs
    assert_same_run(root, "ref", "ref_then_port", out)


def test_trainer_state_leaves_round_trip(tmp_path):
    """The port's load and save of the reference's file: the same leaves,
    order, shapes and dtypes, OIHW in memory."""
    spec = jy.ModelSpec(variant="n", nc=2)
    params = jax.tree.map(np.asarray, jy.init_params(jax.random.PRNGKey(1), spec))
    rng = np.random.default_rng(0)
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.sgd(jtrain.build_lr_schedule(0.01, 0.01, 2, 10, False), momentum=0.9,
                               nesterov=True))
    state = tx.init(params)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    _, state = tx.update(grads, state, params)
    jtrain.save_trainer_state(tmp_path / "ref.npz", state, 4, 0.25, 2)

    model = ty.params_from_jax(params, ty.ModelSpec(*spec), device="cpu")
    leaves = param_leaves(model)
    template = toptim.SGD(toptim.build_lr_schedule(0.01, 0.01, 1, 2, False)).init(leaves)
    loaded, next_epoch, best, bad = ttrain.load_trainer_state(tmp_path / "ref.npz", template)
    assert (next_epoch, best, bad, loaded.count) == (5, 0.25, 2, 1)
    jleaves = jax.tree_util.tree_leaves(state)
    assert len(loaded.trace) == len(jleaves) - 1 == len(leaves)
    for t, p, j in zip(loaded.trace, leaves, jleaves):
        assert t.shape == p.shape
        want = np.asarray(j)
        np.testing.assert_array_equal(t.numpy(), want.transpose(3, 2, 0, 1) if want.ndim == 4
                                      else want)
    ttrain.save_trainer_state(tmp_path / "port.npz", loaded, 4, 0.25, 2)
    with np.load(tmp_path / "ref.npz") as za, np.load(tmp_path / "port.npz") as zb:
        assert za.files == zb.files
        for key in za.files:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(zb[key], za[key], err_msg=key)
    restored, *_ = jtrain.load_trainer_state(tmp_path / "port.npz", state)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    """The port's run interrupted after epoch 2 and resumed with --resume
    equals its uninterrupted 4-epoch run (tests/test_train.py's bar)."""
    data = write_synth_dataset(tmp_path / "data")

    def args(out, epochs, resume=False):
        return run_args(data, None, out, epochs, resume=resume, device="cpu")

    full = ttrain.train(args(tmp_path / "full", 4))
    ttrain.train(args(tmp_path / "resumed", 2))
    resumed = ttrain.train(args(tmp_path / "resumed", 4, resume=True))
    assert [h["epoch"] for h in resumed["history"]] == [0, 1, 2, 3]
    for a, b in zip(full["history"], resumed["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["map50"] == pytest.approx(b["map50"], abs=1e-6)
    ja = jsonl(tmp_path / "full" / "metrics.jsonl")
    jb = jsonl(tmp_path / "resumed" / "metrics.jsonl")
    assert len(ja) == len(jb) == 4
    for a, b in zip(ja, jb):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-9)
    pa = npz_params(tmp_path / "full" / "last.npz")
    pb = npz_params(tmp_path / "resumed" / "last.npz")
    for key in pa:
        np.testing.assert_allclose(pa[key], pb[key], rtol=1e-5, atol=1e-7, err_msg=key)
    assert "map50" in full["single_cls_val"]


def cli_run(data: Path, out: Path, *flags, env=None, timeout=240):
    """``python -m geotrax_tpu_torch.train`` on the CPU, 2 epochs of yolov8n
    at imgsz 64 and global batch 8."""
    base = [sys.executable, "-m", "geotrax_tpu_torch.train", "--data", str(data), "--variant",
            "n", "--nc", "2", "--imgsz", "64", "--batch", "8", "--epochs", "2", "--no-tb",
            "--out", str(out), *flags]
    return subprocess.run(base, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env={**__import__("os").environ, "OMP_NUM_THREADS": "1", **(env or {})})


@pytest.fixture(scope="module")
def dp_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    data = write_synth_dataset(root / "data")
    proc = cli_run(data, root / "one", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, data


def torchrun_env(world: int = 1, rank: int = 0) -> dict:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def csv_losses(path: Path) -> list:
    rows = [ln.split(",") for ln in path.read_text().splitlines()]
    col = rows[0].index("loss")
    return [float(r[col]) for r in rows[1:]]


@pytest.mark.parametrize("case", ["devices2", "slices2x1", "multihost_world1"])
def test_multi_rank_run_matches_one_process(dp_data, case):
    """``--devices 2`` and ``--slices 2 --devices 2`` spawn two gloo ranks
    on the CPU; ``--multihost`` under torchrun's environment of world size 1
    joins that group. Each writes the run files once (rank 0) with the
    global batch's losses."""
    root, data = dp_data
    flags, env = {"devices2": (["--devices", "2"], None),
                  "slices2x1": (["--slices", "2", "--devices", "2"], None),
                  "multihost_world1": (["--multihost"], torchrun_env())}[case]
    proc = cli_run(data, root / case, "--device", "cpu", *flags, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in (root / case).iterdir()) == RUN_FILES
    one, got = root / "one", root / case
    want, losses = csv_losses(one / "results.csv"), csv_losses(got / "results.csv")
    assert len(losses) == len(want) == 2
    assert (one / "results.csv").read_text().splitlines()[0] == \
        (got / "results.csv").read_text().splitlines()[0]
    pa, pb = npz_params(one / "last.npz"), npz_params(got / "last.npz")
    if case == "multihost_world1":  # one rank: no collective, the same step
        assert losses == want
        for key in pa:
            np.testing.assert_array_equal(pb[key], pa[key], err_msg=key)
        return
    assert "Data-parallel over 2 ranks" in proc.stderr
    assert losses == pytest.approx(want, rel=LOSS_RTOL)
    assert [r["lr"] for r in jsonl(got / "metrics.jsonl")] == \
        [r["lr"] for r in jsonl(one / "metrics.jsonl")]
    for key in pa:
        err = np.linalg.norm(pb[key] - pa[key]) / max(np.linalg.norm(pa[key]), 1e-30)
        assert err <= WEIGHT_REL_L2, (key, err)


@pytest.mark.parametrize("case", ["batch_not_divisible", "too_few_cards", "multihost_no_env"])
def test_multi_rank_exits_naming_both_numbers(dp_data, case):
    """Nothing falls back to fewer ranks: a global batch that does not split,
    more ranks than cards, or --multihost outside torchrun exits before a
    rank starts."""
    root, data = dp_data
    flags, words = {"batch_not_divisible": (["--devices", "3", "--device", "cpu"],
                                            ["--batch 8", "3 ranks"]),
                    "too_few_cards": (["--devices", "2"], ["--devices 2 needs 2 cards",
                                                           "this machine has"]),
                    "multihost_no_env": (["--multihost", "--device", "cpu"],
                                         ["torchrun's environment"])}[case]
    if case == "too_few_cards" and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    proc = cli_run(data, root / case, *flags, timeout=60)
    assert proc.returncode != 0
    for word in words:
        assert word in proc.stderr, proc.stderr[-2000:]
    assert not (root / case).exists()


def test_cli_on_the_cpu_and_no_fallback(tmp_path):
    """``python -m geotrax_tpu_torch.train`` writes the run's files with
    ``--device cpu``; without it, on a machine with no card, it raises."""
    data = write_synth_dataset(tmp_path / "data", counts=(("train", 4), ("val", 2)))
    base = [sys.executable, "-m", "geotrax_tpu_torch.train", "--data", str(data), "--variant",
            "n", "--nc", "2", "--imgsz", "64", "--epochs", "2", "--no-tb"]
    env = {**__import__("os").environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(base + ["--out", str(tmp_path / "cpu"), "--device", "cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in (tmp_path / "cpu").iterdir()) == RUN_FILES
    if torch.cuda.is_available():
        return
    proc = subprocess.run(base + ["--out", str(tmp_path / "card")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "card" / "last.npz").exists()
