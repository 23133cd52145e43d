"""The port's process layout, data-parallel step and detection over several
devices (``geotrax_tpu_torch/parallel/mesh.py``, ``tiling.py``) against the
JAX package's mesh (8 forced host devices, tests/conftest.py).

- Layouts: ``make_mesh`` / ``make_hybrid_mesh`` of n = 1, 2, 4, 8 ranks
  (each rank in torch's in-process fake group) against the reference's
  ``mesh.shape``, with 'model' folded into 'data' (ROADMAP C8), and the
  reference's errors.
- Batch rows: each rank's ``shard_batch`` rows equal the addressable shards
  of the reference's ``shard_batch``.
- The step: 2 and 4 gloo ranks, and 2 slices x 2, spawned on the CPU
  (tests/torch_mesh_worker.py) for two steps of yolov8n at imgsz 64 on
  global batches of 4, against the reference's ``make_train_step`` on
  ``make_mesh(4)`` (dp 2 x tp 2) from the same weights: losses within rel
  1e-4, weights and momentum within rel L2 1e-4 (tests/test_torch_train.py's
  bar: float32 convolutions and the gradients' mean summed in another
  order); the ranks
  bit-equal to each other, and the hybrid layout bit-equal to the flat one.
- Detection: ``make_inference_step`` over 2 stand-in CPU devices against
  the reference's on a 2-device mesh, and ``make_tiled_detector`` with 4
  tiles over 4 stand-ins against the reference's with and without its mesh,
  at tests/test_tiling.py's rtol 1e-5 / atol 1e-4; each equal to the port's
  one-device call exactly.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh

from geotrax_tpu.models import yolov8 as jy
from geotrax_tpu.models.convert import save_npz as jax_save_npz
from geotrax_tpu.parallel import mesh as jmesh
from geotrax_tpu.parallel import tiling as jtiling
from geotrax_tpu.train import train as jtrain
from geotrax_tpu_torch.models import yolov8 as ty
from geotrax_tpu_torch.parallel import mesh as tmesh
from geotrax_tpu_torch.parallel import tiling as ttiling

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_worker as worker  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-4
SPAWN_TIMEOUT_S = 120
SPEC_J = jy.ModelSpec(variant="n", nc=2)
SPEC_T = ty.ModelSpec(variant="n", nc=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def in_fake_group(world: int, rank: int, fn):
    """``fn()`` as rank ``rank`` of a group of ``world`` (torch's fake
    backend: no peers, no collectives run)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        return fn()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- layouts
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_layouts_match_reference_shapes(n):
    ref = dict(jmesh.make_mesh(n).shape)
    for rank in sorted({0, n - 1}):
        mesh = in_fake_group(n, rank, lambda: tmesh.make_mesh(device="cpu"))
        assert mesh.shape == {"data": ref["data"] * ref["model"]}
        assert (mesh.world_size, mesh.rank, mesh.device) == (n, rank, torch.device("cpu"))
        assert tmesh.batch_spec(mesh) == ("data",)
    if n > 1:
        ref = dict(jmesh.make_hybrid_mesh(2, n).shape)
        mesh = in_fake_group(n, n - 1, lambda: tmesh.make_hybrid_mesh(2, device="cpu"))
        assert mesh.shape == {"slice": ref["slice"], "data": ref["data"] * ref["model"]}
        assert tmesh.batch_spec(mesh) == ("slice", "data")
    # without a group: one rank, no collective
    assert tmesh.make_mesh(device="cpu").shape == {"data": 1}


def test_layout_errors_match_reference():
    with pytest.raises(ValueError, match="8 devices do not split into 3 slices"):
        jmesh.make_hybrid_mesh(3, 8)
    with pytest.raises(ValueError, match="8 devices do not split into 3 slices"):
        tmesh.make_hybrid_mesh(3, 8, device="cpu")
    with pytest.raises(AssertionError):
        jmesh.make_mesh(8, dp=3, tp=2)
    with pytest.raises(ValueError, match=r"dp\(3\) \* tp\(2\) != devices\(8\)"):
        tmesh.make_mesh(8, dp=3, tp=2, device="cpu")
    # a layout of 4 needs a group of 4
    with pytest.raises(ValueError, match="needs a process group of 4 ranks"):
        tmesh.make_mesh(4, device="cpu")
    assert in_fake_group(4, 1, lambda: tmesh.make_mesh(4, dp=2, tp=2, device="cpu")).shape == \
        {"data": 4}


# ---------------------------------------------------------------- batch rows
def global_batch(rng, b: int, size: int = 64, g: int = 4) -> dict:
    return {"images": rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32),
            "gt_boxes": np.concatenate([rng.uniform(12, 52, (b, g, 2)),
                                        rng.uniform(6, 20, (b, g, 2))], -1).astype(np.float32),
            "gt_cls": rng.integers(0, 2, (b, g)).astype(np.int32),
            "gt_mask": rng.uniform(0, 1, (b, g)) < 0.8}


def reference_shards(arr) -> list:
    """The distinct row blocks of a sharded array, in row order."""
    blocks = {}
    for shard in arr.addressable_shards:
        blocks[shard.index[0].start or 0] = np.asarray(shard.data)
    return [blocks[k] for k in sorted(blocks)]


@pytest.mark.parametrize("layout", ["flat8", "slices2x4", "dp4tp2"])
def test_shard_batch_rows_equal_reference_shards(layout):
    batch = global_batch(np.random.default_rng(0), 16)
    if layout == "flat8":
        ref_mesh, slices, world = jmesh.make_mesh(8, dp=8, tp=1), 1, 8
    elif layout == "slices2x4":
        ref_mesh, slices, world = jmesh.make_hybrid_mesh(2, 8, tp=1), 2, 8
    else:  # tp folded into data: ranks 2d and 2d+1 hold the reference's shard d
        ref_mesh, slices, world = jmesh.make_mesh(8), 1, 8
    with ref_mesh:
        ref = jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, ref_mesh)
    for key in batch:
        blocks = reference_shards(ref[key])
        rows = []
        for rank in range(world):
            def shard():
                mesh = (tmesh.make_hybrid_mesh(slices, device="cpu") if slices > 1
                        else tmesh.make_mesh(device="cpu"))
                return tmesh.shard_batch(batch, mesh)[key].numpy()
            rows.append(in_fake_group(world, rank, shard))
        per = world // len(blocks)
        for d, block in enumerate(blocks):
            np.testing.assert_array_equal(np.concatenate(rows[d * per:(d + 1) * per]), block)
    with pytest.raises(ValueError, match="a global batch of 6 does not split over 4 ranks"):
        in_fake_group(4, 0, lambda: tmesh.batch_rows(6, tmesh.make_mesh(device="cpu")))


# ---------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """The reference's two sharded steps on make_mesh(4) (dp 2 x tp 2) from
    a JAX-initialised yolov8n, with the files the port's ranks read."""
    root = tmp_path_factory.mktemp("mesh_step")
    params = jax.tree.map(np.asarray, jy.init_params(jax.random.PRNGKey(0), SPEC_J))
    jax_save_npz(root / "init.npz", params, class_names={0: "0", 1: "1"}, variant="n", nc=2,
                 reg_max=16, p2=0)
    rng = np.random.default_rng(1)
    batches = [global_batch(rng, 4) for _ in range(2)]
    np.savez(root / "batches.npz", **{f"{k}_{i}": v for i, b in enumerate(batches)
                                      for k, v in b.items()})
    tx = optax.chain(optax.add_decayed_weights(worker.WEIGHT_DECAY),
                     optax.sgd(jtrain.build_lr_schedule(*worker.SCHEDULE),
                               momentum=worker.MOMENTUM, nesterov=True))
    mesh = jmesh.make_mesh(4)
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    metrics = []
    with mesh:
        p = jmesh.shard_params(jax.tree.map(jnp.asarray, params), mesh)
        state = tx.init(p)
        step = jmesh.make_train_step(SPEC_J, tx, mesh)
        for b in batches:
            p, state, m = step(p, state, jmesh.shard_batch(
                {k: jnp.asarray(v) for k, v in b.items()}, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
    leaves = jax.tree_util.tree_leaves(state)
    return {"root": root, "metrics": metrics,
            "params": [np.asarray(x) for x in jax.tree_util.tree_leaves(p)],
            "trace": [np.asarray(x) for x in leaves[:-1]], "count": int(leaves[-1]), "runs": {}}


def run_ranks(case: dict, world: int, slices: int = 1) -> list:
    """Each rank's file from the worker's run (once per layout)."""
    if (world, slices) in case["runs"]:
        return case["runs"][world, slices]
    out = case["root"] / f"w{world}s{slices}"
    out.mkdir()
    proc = subprocess.run(
        [sys.executable, str(Path(worker.__file__)), str(case["root"] / "init.npz"),
         str(case["root"] / "batches.npz"), str(out), "--world", str(world),
         "--slices", str(slices)],
        cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    case["runs"][world, slices] = ranks
    return ranks


def oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("world,slices", [(2, 1), (4, 1), (4, 2)])
def test_step_on_ranks_equals_reference_mesh_step(step_case, world, slices):
    ranks = run_ranks(step_case, world, slices)
    assert [tuple(r["shape"]) for r in ranks] == [(slices, world // slices)] * world
    first = ranks[0]
    for other in ranks[1:]:  # every rank applied the same all-reduced gradient
        assert other.keys() == first.keys()
        for k in first:
            if not k.startswith("rows_"):
                np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    per = 4 // world  # rank r's rows of each global batch
    for r, rank in enumerate(ranks):
        with np.load(step_case["root"] / "batches.npz") as z:
            np.testing.assert_array_equal(rank["rows_0"], z["images_0"][r * per:(r + 1) * per])
    for i, m in enumerate(step_case["metrics"]):
        for k in ("loss", "box", "cls", "dfl"):
            assert float(first[f"{k}_{i}"]) == pytest.approx(m[k], rel=REL, abs=1e-7), (i, k)
        assert int(first[f"fg_{i}"]) == int(m["fg"])
    assert int(first["count"]) == step_case["count"] == 2
    n = len(step_case["params"])
    assert sum(k.startswith("param_") for k in first) == n
    for i in range(n):
        assert rel_l2(first[f"param_{i}"], oihw(step_case["params"][i])) <= REL, i
        assert rel_l2(first[f"trace_{i}"], oihw(step_case["trace"][i])) <= REL, i
    if slices > 1:  # the hybrid layout reproduces the flat one
        flat = run_ranks(step_case, world, 1)[0]
        for k in first.keys() - {"shape"}:
            np.testing.assert_array_equal(first[k], flat[k], err_msg=k)


# ---------------------------------------------------------------- detection
@pytest.fixture(scope="module")
def det_models():
    spec = jy.ModelSpec(variant="n", nc=4)
    params = jax.tree.map(np.asarray, jy.init_params(jax.random.PRNGKey(0), spec))
    model = ty.params_from_jax(params, ty.ModelSpec(*spec), device="cpu")
    return spec, params, model


def assert_dets_close(ours: dict, ref: dict) -> None:
    for k in ("boxes_xywh", "scores", "valid"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(ours["classes"].numpy(), np.asarray(ref["classes"]))


def assert_dets_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_inference_step_over_two_devices_equals_reference(det_models):
    spec, params, model = det_models
    frames = np.random.default_rng(0).uniform(0, 1, (4, 96, 128, 3)).astype(np.float32)
    mesh = jmesh.make_mesh(2, dp=2, tp=1)
    with mesh:
        ref = jmesh.make_inference_step(spec, mesh, conf=0.05, max_det=50)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(frames))
    kw = dict(conf=0.05, max_det=50)
    two = tmesh.make_inference_step(ty.ModelSpec(*spec), ["cpu", "cpu"], **kw)(
        model, torch.from_numpy(frames))
    one = tmesh.make_inference_step(ty.ModelSpec(*spec), ["cpu"], **kw)(
        model, torch.from_numpy(frames))
    assert int(two["valid"].sum()) > 0
    assert_dets_close(two, ref)
    assert_dets_equal(two, one)


def test_tiled_detector_over_four_devices_equals_reference(det_models):
    spec, params, model = det_models
    src_h, src_w = 96, 512
    frame = np.random.default_rng(0).integers(0, 255, (src_h, src_w, 3), np.uint8)
    kw = dict(n_tiles=4, src_h=src_h, src_w=src_w, imgsz=96, conf=0.0, max_det=32, overlap=16)
    jp = jax.tree.map(jnp.asarray, params)
    ref_plain = jtiling.make_tiled_detector(jp, spec, **kw)(jnp.asarray(frame))
    ref_mesh = jtiling.make_tiled_detector(
        jp, spec, mesh=JaxMesh(np.asarray(jax.devices()[:4]), axis_names=("data",)), **kw)(
        jnp.asarray(frame))
    tspec = ty.ModelSpec(*spec)
    plain = ttiling.make_tiled_detector(model, tspec, **kw)(torch.from_numpy(frame))
    spread = ttiling.make_tiled_detector(model, tspec, devices=["cpu"] * 4, **kw)(
        torch.from_numpy(frame))
    assert int(spread["valid"].sum()) > 0
    assert_dets_close(plain, ref_plain)
    assert_dets_close(spread, ref_mesh)
    assert_dets_equal(spread, plain)
