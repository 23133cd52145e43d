"""The reader follows the device, and the smoke's decode phase rehearsed:
make_reader and extract's open_reader route a CUDA device with the native
backend to DeviceVideoReader (frames converted on the card), the CPU to
VideoReader, and GEOTRAX_VIDEO_BACKEND wins; probing a file where neither
decoder exists says what is missing; the new modules import neither JAX nor
the JAX package; the double-buffered driver and the serial loop given
tensor frames (CPU tensors stand in for the card's) write the same rows,
byte for byte, as given numpy frames, and so does the lockstep driver
(batch --parallel-videos); and chip_smoke.phase_decode on the
CPU at a small size in a subprocess under the import guard of
tests/test_torch_imports.py, its planar formats' checks and reads among
them (its part (f): tests/test_torch_imports_workers.py)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from geotrax_tpu_torch import cfg as tcfg
from geotrax_tpu_torch.io import native
from geotrax_tpu_torch.io import video as tvideo
from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
from geotrax_tpu_torch.models.detector import OracleDetector
from geotrax_tpu_torch.pipeline import extract as textract
from test_torch_imports import EPILOGUE, PORT, PRELUDE, ROOT, _imports

CLIP = ROOT / "tests" / "data" / "video" / "hevc_4k.mp4"

DECODE_GUARD = PRELUDE + r'''
import importlib.util, json, tempfile
from pathlib import Path
# a small clip of the fixtures' drifting scene, with its record, stands in for h264_4k.mp4
spec = importlib.util.spec_from_file_location(
    "make_fixtures", chip_smoke.DECODE_CLIP.with_name("make_fixtures.py"))
make_fixtures = importlib.util.module_from_spec(spec)
spec.loader.exec_module(make_fixtures)
clip = Path(tempfile.mkdtemp()) / "small.mp4"
small = make_fixtures.scene(6, 640, 360, vehicles=2)
make_fixtures.encode(clip, (f for _, f in small), 640, 360, "libx264",
                     opts={"x264-params": "bframes=2:b-adapt=0"})
clip.with_suffix(".json").write_text(json.dumps(make_fixtures.describe(clip)))
reader = chip_smoke.smoke_reader(512, 288, 0, 14, stop=6)
frames = chip_smoke.make_frames(reader)
_, fx, _ = chip_smoke.build_extractor("cpu", 512, 288, "n", 256, 0, 4, frames[0][1])
dc = chip_smoke.phase_decode(fx.detector, frames, reader, "cpu", tol_px=10.0, clip=clip,
                             rounds=1)
assert dc["max_abs_err"] == 0.0 and len(dc["checks"]) == 5, dc["checks"]
assert [c["shape"] for c in dc["checks"]] == [(288, 512), (288, 512), (288, 512), (1082, 1922),
                                              (22, 38)], dc["checks"]
assert dc["checks"][1]["pitch"] == (4096, 4096) and "ms" not in dc["checks"][0]
assert dc["checks"][0]["bound_by"] == "bytes", dc["checks"][0]
demux = dc["demux"]
assert demux["h264_4k"]["frame_count"] == 40 and demux["hevc_4k"]["codec"] == "hevc", demux
checks = dc["yuv_checks"]  # every planar format at the frames' size and the odd one, 2 pitched
assert len(checks) == 2 * len(chip_smoke.yuv.FORMATS) + 2, [c["name"] for c in checks]
assert all(c["max_abs_err"] == 0.0 and "ms" not in c for c in checks), checks
assert {c["kernel"] for c in checks} == {"yuv_rgb24", "yuv_scaled_rgb24"}, checks
assert [c["fmt"] for c in checks if c["name"] == "pitched"] == list(chip_smoke.YUV_PITCHED)
assert {c["shape"] for c in checks} == {(288, 512), chip_smoke.YUV_ODD_SIZE}, checks
reads = dc["yuv_reads"]
assert [(f, r["kernel"], r["frames_equal"], r["launches"]) for f, r in reads.items()] == [
    ("yuvj420p", "yuv_rgb24", 6, 0), ("yuv420p10le", "yuv_scaled_rgb24", 6, 0)], reads
runs = dc["runs"]
assert runs["planes"]["launches"] == runs["memory"]["launches"] == [0], runs
assert runs["planes"]["bytes"] == runs["memory"]["bytes"] > 0 and len(runs["planes"]["fps"]) == 1
f = dc["file"]
assert f["exit"] == 0 and f["backend"] == "native" and f["reader"] == "VideoReader", f
assert f["frames_equal"] == f["frames"] == 6 and f["checks"]["camera_err_px"] < 10.0, f
assert f["runs"]["file"]["bytes"] == f["runs"]["memory"]["bytes"] and f["decode_fps"] > 0, f
line = chip_smoke.decode_line(dc, 1.0, "cpu")
assert line.startswith("decode ok") and "files byte-equal" in line, line
assert "yuv444p10le 1919x1081 (seeded, yuv_scaled_rgb24): equal" in line, line
''' + EPILOGUE


def test_smoke_decode_phase_imports_nothing_refused():
    proc = subprocess.run([sys.executable, "-c", DECODE_GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout


@pytest.mark.parametrize("module", ["io/mp4.py", "ops/yuv.py", "io/video.py",
                                    "pipeline/extract.py"])
def test_new_modules_import_neither_jax_nor_the_jax_package(module):
    imported = {name.split(".")[0] for name, _ in _imports(PORT / module)}
    assert not imported & {"jax", "jaxlib", "geotrax_tpu"}, imported


class _Made:
    """Stands in for a reader class: records how it was made."""

    def __init__(self, kind, made):
        self.kind, self.made = kind, made

    def __call__(self, path, **kw):
        self.made.append((self.kind, kw))
        return self


@pytest.mark.parametrize("device,env,kind", [
    ("cuda", None, "device"), ("cuda:0", None, "device"), ("cpu", None, "host"),
    (None, None, "host"), ("cuda", "cv2", "host"), ("cuda", "native", "device"),
])
def test_make_reader_follows_the_device(device, env, kind, monkeypatch):
    made = []
    monkeypatch.setattr(tvideo, "DeviceVideoReader", _Made("device", made))
    monkeypatch.setattr(tvideo, "VideoReader", _Made("host", made))
    monkeypatch.setenv("GEOTRAX_DECODE_WORKERS", "1")
    if env is None:
        monkeypatch.delenv("GEOTRAX_VIDEO_BACKEND", raising=False)
    else:
        monkeypatch.setenv("GEOTRAX_VIDEO_BACKEND", env)
    tvideo.make_reader(CLIP, start=2, stop=5, device=device)
    assert [m[0] for m in made] == [kind]
    assert made[0][1]["start"] == 2 and made[0][1]["stop"] == 5
    if kind == "device":
        assert made[0][1]["device"] == device


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_open_reader_passes_the_configured_device(device, monkeypatch):
    import types

    from geotrax_tpu_torch.io import video

    seen = []
    monkeypatch.setattr(video, "make_reader", lambda src, **kw: seen.append(kw) or "reader")
    config = {"main": {"args": types.SimpleNamespace(device=device)}}
    assert textract.open_reader(CLIP, 1, 7, config) == "reader"
    assert seen == [{"start": 1, "stop": 7, "device": device}]


def test_reading_without_a_decoder_says_what_is_missing(monkeypatch):
    """No FFmpeg for the native decoder and no cv2: probing a file raises
    naming both, the reason and the variable."""
    def no_ffmpeg():
        raise RuntimeError("cannot build the native decoder: no libavcodec headers "
                           "(pkg-config and /usr/include)")

    monkeypatch.setattr(native, "load_library", no_ffmpeg)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    monkeypatch.delenv("GEOTRAX_VIDEO_BACKEND", raising=False)
    assert tvideo.get_backend() == "cv2"
    with pytest.raises(RuntimeError) as err:
        tvideo.probe_video(CLIP)
    text = str(err.value)
    for said in (str(CLIP), "no libavcodec headers", "cv2 is not installed", "FFmpeg",
                 "GEOTRAX_VIDEO_BACKEND", "NVDEC"):
        assert said in text, (said, text)
    with pytest.raises(RuntimeError, match="cv2 is not installed"):
        next(tvideo._cv2_frames(str(CLIP)))


class _TensorFrames:
    """A reader whose frames are torch tensors (the card's stand-in)."""

    def __init__(self, reader):
        self.reader, self.info = reader, reader.info

    def __iter__(self):
        for idx, frame in self.reader:
            yield idx, torch.from_numpy(frame)


@pytest.mark.parametrize("pipelined", [True, False])
def test_drivers_write_the_same_rows_from_tensor_frames(pipelined):
    """Three 8-frame chunks with a padded tail of 5, the oracle clip with a
    moving camera: tensor frames give the rows and transforms of numpy
    frames bit for bit, through the double-buffered driver and the serial
    loop alike."""
    def reader():
        return SyntheticVideoReader(width=320, height=240, n_frames=21,
                                    camera=(0.5, -0.3, 0.2, 1.002))

    boxes = reader()
    runs = {}
    for kind in ("numpy", "tensor"):
        det = OracleDetector(lambda i: [list(b) + [0.9, i % 2] for b in boxes.boxes_at(i)],
                             device="cpu")
        tracker_cfg, state, step, head = textract.make_extract_tracker(tcfg.DEFAULT, device="cpu")
        fx = textract.make_fused_extractor(tcfg.DEFAULT, det, tracker_cfg, state, step, 240, 320,
                                           head, chunk=8, device="cpu")
        source = reader() if kind == "numpy" else _TensorFrames(reader())
        runs[kind] = textract.track_video_fused(source, fx, chunk=8, pipelined=pipelined)
    (tracks, transforms, stats), (t_tracks, t_transforms, t_stats) = runs["numpy"], runs["tensor"]
    assert stats["chunks"] == t_stats["chunks"] == 3 and len(tracks) > 20
    assert tracks.tobytes() == t_tracks.tobytes()
    assert transforms.tobytes() == t_transforms.tobytes()
    np.testing.assert_array_equal(stats["h"], t_stats["h"])


def _lockstep_files(tmp, wrap) -> list:
    """extract_videos_batch on tests/test_torch_lockstep.py's three ragged
    oracle videos, stabilization on, each reader passed through ``wrap``:
    the bytes of each video's tracks and transforms files."""
    import test_torch_lockstep as lockstep
    from geotrax_tpu_torch.parallel import extract_batch as teb
    from geotrax_tpu_torch.utils import config_utils as tcu

    tmp.mkdir()
    readers = lockstep.port_readers(lockstep.RAGGED)
    oracle = lockstep.PortBatchOracle(readers)
    sources = [lockstep.port_args(tmp, i).source for i in range(lockstep.N_VIDEOS)]
    reader_of = {str(s): wrap(r) for s, r in zip(sources, readers)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(textract, "load_detector", lambda cfg, lg: oracle)
        mp.setattr(textract, "open_reader", lambda s, a, b, c: reader_of[str(s)])
        args = lockstep.port_args(tmp, 0)
        config = lockstep.tune(tcu.load_config_all(args, lockstep.LOG, needs_model=False), True,
                               "botsort", lockstep.ref_pex.TRACKER_PARAMS)
        teb.extract_videos_batch(sources, args, config, lockstep.LOG)
    out = tmp / "out"
    return [(out / f"V{i}{end}").read_bytes() for i in range(lockstep.N_VIDEOS)
            for end in (".txt", "_vid_transf.txt")]


def test_lockstep_writes_the_same_files_from_tensor_frames(tmp_path, monkeypatch):
    """The lockstep driver (batch --parallel-videos) given readers whose
    frames are tensors on its device (CPU tensors stand in for
    DeviceVideoReader's on the card) copies them into the staging buffer
    on the device, not through the host buffer, and writes each video's
    files byte for byte as given numpy frames."""
    direct = []
    put_device = textract.Staging.put_device
    monkeypatch.setattr(textract.Staging, "put_device",
                        lambda self, *a: direct.append(a[:2]) or put_device(self, *a))
    want = _lockstep_files(tmp_path / "numpy", lambda r: r)
    assert not direct
    got = _lockstep_files(tmp_path / "tensor", _TensorFrames)
    assert len(direct) == 36  # every frame of the ragged 10 + 14 + 12
    assert all(want) and got == want
