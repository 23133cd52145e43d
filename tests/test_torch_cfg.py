"""The port's copy of the default configuration (geotrax_tpu_torch/cfg.py)
against the JAX package's ``cfg/default.yaml``: the extraction, stabilo and
tracker sections equal the YAML's, every tracker block among them, and each
detection key the port keeps in ``ultralytics`` has the YAML's value."""

from pathlib import Path

import pytest
import yaml

from geotrax_tpu_torch import cfg

REFERENCE = yaml.safe_load(
    (Path(__file__).resolve().parent.parent / "geotrax_tpu" / "cfg" / "default.yaml").read_text())


@pytest.mark.parametrize("section", ["extraction", "stabilo"])
def test_section_equals_reference(section):
    assert cfg.DEFAULT[section] == REFERENCE[section]


@pytest.mark.parametrize("tracker", cfg.TRACKER_CHOICES)
def test_tracker_block_equals_reference(tracker):
    assert cfg.DEFAULT["tracker"][tracker] == REFERENCE["tracker"][tracker]
    assert cfg.select_tracker({**cfg.DEFAULT["tracker"], "active": tracker}) == (
        tracker, REFERENCE["tracker"][tracker])


def test_tracker_section_and_detection_keys_equal_reference():
    assert cfg.DEFAULT["tracker"] == REFERENCE["tracker"]
    for key, value in cfg.DEFAULT["ultralytics"].items():
        assert REFERENCE["ultralytics"][key] == value, key
