"""Make the video fixtures of tests/data/video, or encode other test clips.

    python tests/data/video/make_fixtures.py             # rewrites every fixture
    python tests/data/video/make_fixtures.py --records   # rewrites only their .json

The fixtures show the port's seeded synthetic scene
(``geotrax_tpu_torch/io/synthetic.py``: a structured background, 36 vehicles
moving on straight lines), seen by a camera drifting 2 px right and 1 px up
a frame, encoded through libavcodec into MP4 by ``fixture_encoder.cpp``
(built with g++ at first use):

  h264_4k.mp4   3840x2160, libx264, High profile, CABAC, 3 B-frames, 40
                frames (one 32-frame chunk and a tail of 8) at 30000/1001
                frames/s
  hevc_4k.mp4   3840x2160, libx265, Main profile, 8 frames at 30 frames/s
  h264_gop.mp4  640x360, libx264, High profile, 3 B-frames, open GOPs of 12
                frames (keyint 12, no scene cuts), 96 frames (8 GOPs: 4
                segments of 2 GOPs for the GOP-parallel reader) at
                30000/1001 frames/s, with an edit list (the B-frames' delay)

Beside each, ``<name>.json`` holds what libavformat's probe reports (width,
height, fps, frame_count), the display-order pts and key flags of its
packet scan (``scan_frame_pts``), the scene's camera drift, and, per frame
in display order, the SHA-1s of the Y, U and V planes that libavcodec decodes
(the port's decoder's ``gtx_read_frame_yuv``, before swscale) and of the
RGB frame that the reference's decoder gives (the same planes through its
swscale call). The tests recompute them, so they cannot go stale. ``encode`` also makes the small clips of the tests that
the port's demuxer must refuse (fragmented, MPEG-4 Part 2, 10-bit, 4:2:2,
full range).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
SOURCE = HERE / "fixture_encoder.cpp"
WIDTH, HEIGHT = 3840, 2160
CAMERA = (2.0, -1.0, 0.0, 1.0)
VEHICLES = 36
if str(ROOT) not in sys.path:  # run as a script from anywhere
    sys.path.insert(0, str(ROOT))
FIXTURES = {
    "h264_4k": dict(codec="libx264", frames=40, fps=(30000, 1001),
                    opts={"profile": "high", "preset": "faster", "crf": "30",
                          "x264-params": "bframes=3:b-adapt=0:keyint=40:cabac=1"}),
    "hevc_4k": dict(codec="libx265", frames=8, fps=(30, 1),
                    opts={"profile": "main", "preset": "fast", "crf": "32",
                          "x265-params": "bframes=3:keyint=8:log-level=error"}),
    "h264_gop": dict(codec="libx264", frames=96, fps=(30000, 1001), size=(640, 360),
                     opts={"profile": "high", "preset": "faster", "crf": "30",
                           "x264-params": "bframes=3:b-adapt=0:keyint=12:open-gop=1:"
                                          "scenecut=0:cabac=1"}),
}

_lib = None


def encoder() -> ctypes.CDLL:
    """The encoder library, built with g++ and FFmpeg's libraries (by
    ``geotrax_tpu_torch/io/native.build``) if it does not exist yet."""
    global _lib
    if _lib is None:
        from geotrax_tpu_torch.io import native

        lib = ctypes.CDLL(str(native.build(SOURCE)))
        strs = ctypes.POINTER(ctypes.c_char_p)
        lib.fx_open.restype = ctypes.c_void_p
        lib.fx_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                                strs, strs, ctypes.c_int, strs, strs, ctypes.c_int]
        lib.fx_write.restype = ctypes.c_int
        lib.fx_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fx_close.restype = ctypes.c_int
        lib.fx_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _strings(values) -> ctypes.Array:
    return (ctypes.c_char_p * max(1, len(values)))(*[str(v).encode() for v in values])


def encode(path, frames, width: int, height: int, codec: str = "libx264", fps=(30, 1),
           pix_fmt: str = "yuv420p", full_range: bool = False, opts=None, mux=None) -> Path:
    """Encode ``frames`` ((height, width, 3) uint8 RGB arrays) into ``path``
    (the container follows the suffix); ``opts`` are the encoder's options,
    ``mux`` the muxer's (such as ``{"movflags": "frag_keyframe+empty_moov"}``)."""
    lib = encoder()
    opts, mux = dict(opts or {}), dict(mux or {})
    handle = lib.fx_open(str(path).encode(), codec.encode(), width, height, fps[0], fps[1],
                         pix_fmt.encode(), int(full_range), _strings(opts.keys()),
                         _strings(opts.values()), len(opts), _strings(mux.keys()),
                         _strings(mux.values()), len(mux))
    if not handle:
        raise OSError(f"the fixture encoder cannot open {path} ({codec}, {pix_fmt})")
    try:
        for frame in frames:
            frame = np.ascontiguousarray(frame, dtype=np.uint8)
            if frame.shape != (height, width, 3):
                raise ValueError(f"frame {frame.shape} != ({height}, {width}, 3)")
            rc = lib.fx_write(handle, frame.ctypes.data)
            if rc < 0:
                raise OSError(f"the fixture encoder failed ({rc}) on {path}")
    finally:
        rc = lib.fx_close(handle)
    if rc < 0:
        raise OSError(f"the fixture encoder failed to close {path} ({rc})")
    return Path(path)


def scene(n_frames: int, width: int = WIDTH, height: int = HEIGHT, seed: int = 0,
          vehicles: int = VEHICLES):
    """The seeded synthetic drifting scene: a SyntheticVideoReader."""
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader

    rng = np.random.default_rng(seed + 1)
    boxes = []
    for _ in range(vehicles):
        w, h = (int(v) for v in rng.integers(40, 110, size=2))
        boxes.append({"xy0": (float(rng.uniform(0, width)), float(rng.uniform(0, height))),
                      "v": (float(rng.uniform(-6, 6)), float(rng.uniform(-6, 6))),
                      "wh": (w, h), "color": tuple(int(c) for c in rng.integers(0, 256, 3))})
    return SyntheticVideoReader(width=width, height=height, n_frames=n_frames, boxes=boxes,
                                seed=seed, camera=CAMERA)


def plane_hashes(path) -> list:
    """Per frame in display order, the SHA-1s of the Y, U and V planes that
    libavcodec decodes (the port's ``gtx_read_frame_yuv``)."""
    from geotrax_tpu_torch.io import native

    w, h, _, _ = native.native_probe(str(path))
    out = []
    for _, planes in native.native_frames_yuv(str(path)):
        y = planes[:h * w]
        uv = planes[h * w:].reshape(h // 2, w // 2, 2)
        out.append([hashlib.sha1(np.ascontiguousarray(p).tobytes()).hexdigest()
                    for p in (y, uv[..., 0], uv[..., 1])])
    return out


def describe(path) -> dict:
    """What libavformat's probe and packet scan report, the scene's camera
    and the per-frame SHA-1s of the planes and of the reference's RGB
    frames."""
    from geotrax_tpu_torch.io import native

    w, h, fps, count = native.native_probe(str(path))
    pts, keys = native.scan_frame_pts(str(path))
    rgb = [hashlib.sha1(f.tobytes()).hexdigest() for _, f in native.native_frames(str(path))]
    return {"width": w, "height": h, "fps": fps, "frame_count": count,
            "pts": [int(p) for p in pts], "keys": [int(k) for k in keys], "camera": list(CAMERA),
            "planes_sha1": plane_hashes(path), "rgb_sha1": rgb}


def main(argv=None) -> int:
    records_only = "--records" in (sys.argv[1:] if argv is None else argv)
    for name, spec in FIXTURES.items():
        path = HERE / f"{name}.mp4"
        if not records_only:
            width, height = spec.get("size", (WIDTH, HEIGHT))
            reader = scene(spec["frames"], width, height)
            encode(path, (f for _, f in reader), width, height, spec["codec"], spec["fps"],
                   opts=spec["opts"])
        info = describe(path)
        (HERE / f"{name}.json").write_text(json.dumps(info, indent=1) + "\n")
        print(f"{path.name}: {path.stat().st_size} bytes, {len(info['planes_sha1'])} frames, "
              f"{info['width']}x{info['height']} at {info['fps']} frames/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
