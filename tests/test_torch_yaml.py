"""The port's YAML writer (``io/yaml_emit.py``) against PyYAML: the bytes of
``yaml.dump(obj, default_flow_style=False, sort_keys=False)`` on the
reference's run-metadata shape, on edge values and on seeded random
documents of the writer's types."""

import argparse
import random
from pathlib import Path

import pytest
import yaml

from geotrax_tpu.utils.config_utils import load_config
from geotrax_tpu.utils.file_utils import convert_to_serializable
from geotrax_tpu_torch.io import yaml_emit


def pyyaml(obj) -> str:
    return yaml.dump(obj, default_flow_style=False, sort_keys=False)


def test_the_references_metadata_shape():
    """The dict ``_extract_impl.save_results`` dumps, built from the bundled
    default configuration and a CLI namespace."""
    full = load_config("default", None)
    args = argparse.Namespace(
        source=Path("/data/2024-05-01/D1/V_test.mp4"), cfg="default", output_folder="results",
        log_path=None, verbose=False, model=["models/geotrax_hbb_yolov8s_1920_v1.pt"],
        class_names=["0=car", "1=bus"], conf=0.25, classes=[0, 1, 2, 3], cut_frame_left=0,
        cut_frame_right=None, interpolate=True, show=None,
    )
    metadata = {
        "geotrax_tpu_version": "0.1.0",
        "video": {"source": str(args.source), "width": 3840, "height": 2160, "fps": 29.97,
                  "frames_processed": 18000},
        "runtime": {"avg_detect_ms": 24.13, "avg_stabilization_ms": 0.0, "pipeline_fps": 41.48,
                    "extraction_mode": "sequential"},
        "config": {
            "model": " ".join(args.model),
            "tracker": full["tracker"]["active"],
            "extraction": full["extraction"],
            "stabilo": full["stabilo"],
            "detection": {k: full["ultralytics"].get(k) for k in (
                "imgsz", "conf", "iou", "max_det", "classes", "agnostic_nms", "tiles")},
        },
        "args": args,
    }
    obj = convert_to_serializable(metadata)
    assert 0 in obj["config"]["extraction"]["dimension_estimation"]["tau_c"]  # int keys
    assert yaml_emit.dump(obj) == pyyaml(obj)


EDGES = [
    {}, [], {"a": {}, "b": [], "c": [[], {}]},
    {"none": None, "yes": True, "no": False, "zero": 0, "neg": -17, "big": 2 ** 70},
    {"floats": [0.0, -0.0, 1.0, -2.5, 1e17, 1e-7, 1.5e300, -3.25e-300, 0.1, 1.83, 123456789.125,
                float("inf"), float("-inf"), float("nan")]},
    {"quoted": ["", "true", "No", "null", "~", "123", "-7", "1.5", "1e5", "0x1F", "0o17", "1_000",
                "2024-05-01", "=", "<<", "- a", "-a", "a: b", "a:b", "a #b", "a#b", "#a", "!a",
                "&a", "*a", "|", ">", "%a", "@a", "`a", "'a", '"a', "? a", ": a", " lead",
                "trail ", "---", "...x", "it's", 'say "hi"', "tab\there", "two\nlines",
                "end\n", "\x85", "café", "日本", "nul\x00", "a\\b", ".inf", ".NaN",
                "hf://rfonod/geo-trax/geotrax_hbb_yolov8s_1920_v1.pt", "0=car"]},
    {0: "int key", -1: 1.7, 3: {4: [5]}, "mixed": {1: 2.85, "k": "v"}},
    {"long": " ".join(["word"] * 40), "long_quoted": "it's " * 30,
     "long_path": "/data/" + "x" * 120 + "/V test.mp4", "unbroken": "y" * 150},
    [[1, 2], [3, [4, []]], {"a": [1, {"b": None}]}, "tail"],
]


@pytest.mark.parametrize("obj", EDGES, ids=range(len(EDGES)))
def test_edge_values(obj):
    assert yaml_emit.dump(obj) == pyyaml(obj)


def test_seeded_random_documents():
    rng = random.Random(0)
    alphabet = list("abcXYZ019 _-:#'\",.[]{}!&*|>%@`?/=~\\\t\n") + ["\x85", "é", "\x7f"]

    def text(limit=None):
        s = "".join(rng.choice(alphabet) for _ in range(rng.choice([0, 1, 2, 5, 12, 90])))
        if limit:  # a key: short and on one line
            s = "".join(c for c in s if c not in "\n\x85")[:limit] or "k"
        return s

    def value(depth=0):
        r = rng.random()
        if depth < 3 and r < 0.2:
            return {rng.choice([text(40), rng.randint(-3, 3)]): value(depth + 1)
                    for _ in range(rng.randint(0, 3))}
        if depth < 3 and r < 0.35:
            return [value(depth + 1) for _ in range(rng.randint(0, 3))]
        return rng.choice([text(), rng.randint(-10 ** 9, 10 ** 9), rng.uniform(-1e3, 1e3),
                           rng.choice([True, False, None, 1e-9, 2.5e20])])

    for _ in range(400):
        obj = {"root": value(), "list": [value(), value()], 7: value()}
        assert yaml_emit.dump(obj) == pyyaml(obj)


def test_rejects_what_it_does_not_write():
    for bad in ({"a": object()}, {"a": (1).__class__}, {("t",): 1}, {"": 1}, {"x" * 130: 1}, "top"):
        with pytest.raises((TypeError, ValueError)):
            yaml_emit.dump(bad)
