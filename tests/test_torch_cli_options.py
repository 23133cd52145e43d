"""`extract` end to end under the options that change the chunk step: the
port's ``run_extraction`` against the reference's on the clip, checkpoint
and tolerances of tests/test_torch_cli.py (whose helpers it uses), for

- the ``stable`` preset: CLAHE on the full-resolution gray (downsample
  ratio 1.0, 4000 features, ratio 0.8), so the detector letterboxes the
  full frame itself (no shared resize);
- ``extraction.stabilize: false`` with botsort: detect + track only, the
  tracker's GMC from the standalone branch (512 corners per frame matched
  against the previous frame's, an affine fit, the features carried across
  the chunks of 8), and the 10-column tracks file with no transforms file;
- ``extraction.stabilize: false`` with bytetrack: no GMC at all."""

import pytest

from test_torch_cli import assert_files_match, make_assets, patched, preset_copy, run_pair  # noqa: F401

STAB_OFF = {"  stabilize: true        # append stabilized box columns to the tracks file\n":
            "  stabilize: false\n"}
CONFIGS = {
    "stable": ("stable", {}),
    "stab_off_botsort": ("default", STAB_OFF),
    "stab_off_bytetrack": ("default", {**STAB_OFF, "  active: botsort": "  active: bytetrack"}),
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return make_assets(tmp_path_factory.mktemp("cli_options"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_option_writes_the_references_files(assets, patched, name):
    preset, edits = CONFIGS[name]
    cfg = preset_copy(assets["tmp"] / f"{name}.yaml", preset, **edits)
    ref, port = run_pair(assets, cfg)
    assert_files_match(ref, port, stabilize=not name.startswith("stab_off"))
    meta = port[2]["config"]
    if name == "stable":
        assert meta["stabilo"]["clahe"] is True and meta["stabilo"]["downsample_ratio"] == 1.0
    else:
        assert meta["extraction"]["stabilize"] is False
        assert meta["tracker"] == name.rsplit("_", 1)[1]
