"""`aggregate` of the port against the JAX package's, on a synthetic
``PROCESSED/<date>/D<k>/<session>/results/`` tree of georeferenced CSVs
(written as the georeference stage writes them): two drones of one session
(D2's file first on disk, so the numeric drone order decides the ID
offsets), a second session and a second date and location, a missing lane
number, a missing road section and a file that does not follow the layout.
Every aggregated CSV must be byte-equal to the reference's, and each zip
must hold the same members with the same bytes."""

import argparse
import logging
import zipfile

import numpy as np
import pandas as pd
import pytest

from geotrax_tpu.pipeline import aggregate as jagg
from geotrax_tpu_torch.pipeline import aggregate as tagg

LOG = logging.getLogger("test-torch-aggregate")
COLUMNS = ["Vehicle_ID", "Timestamp", "Frame_Number", "Ortho_X", "Ortho_Y", "Local_X", "Local_Y",
           "Latitude", "Longitude", "Vehicle_Length", "Vehicle_Width", "Vehicle_Class",
           "Vehicle_Speed", "Vehicle_Acceleration", "Road_Section", "Lane_Number", "Visibility"]


def georeferenced(seed: int, n_vehicles: int, n_frames: int, day: str, lane_gap=False,
                  section_gap=False) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    rows = []
    for vid in range(1, n_vehicles + 1):
        for f in range(int(rng.integers(3, n_frames))):
            ms = (f * 33) % 1000
            rows.append({
                "Vehicle_ID": vid,
                "Timestamp": f"{day} 17:52:{13 + f // 30:02d}.{ms:03d}",
                "Frame_Number": f,
                "Ortho_X": round(float(rng.uniform(0, 5000)), 1),
                "Ortho_Y": round(float(rng.uniform(0, 5000)), 1),
                "Local_X": round(float(rng.uniform(-300, 300)), 2),
                "Local_Y": round(float(rng.uniform(-300, 300)), 2),
                "Latitude": round(float(37.39 + rng.uniform(0, 0.01)), 7),
                "Longitude": round(float(126.64 + rng.uniform(0, 0.01)), 7),
                "Vehicle_Length": round(float(rng.uniform(3.5, 12.0)), 2),
                "Vehicle_Width": round(float(rng.uniform(1.6, 2.6)), 2),
                "Vehicle_Class": int(rng.integers(0, 4)),
                "Vehicle_Speed": round(float(rng.uniform(0, 60)), 1),
                "Vehicle_Acceleration": round(float(rng.normal(0, 1)), 2),
                "Road_Section": int(rng.integers(1, 4)),
                "Lane_Number": str(int(rng.integers(1, 5))),
                "Visibility": int(rng.integers(0, 2)),
            })
    df = pd.DataFrame(rows, columns=COLUMNS)
    if lane_gap:
        df.loc[df.index[::7], "Lane_Number"] = ""  # vehicles off every lane
    if section_gap:
        df["Road_Section"] = df["Road_Section"].astype(float)
        df.loc[df.index[::5], "Road_Section"] = np.nan
    return df


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("campaign") / "PROCESSED"
    layout = [
        ("2022-10-07", "D2", "PM1", "A_clip_d2", 1, False, False),
        ("2022-10-07", "D1", "PM1", "A_clip_d1", 2, True, False),
        ("2022-10-07", "D1", "PM2", "A_clip_pm2", 3, False, True),
        ("2022-10-08", "D10", "AM1", "B_clip", 4, False, False),
    ]
    for date, drone, session, stem, seed, lane_gap, section_gap in layout:
        folder = root / date / drone / session / "results"
        folder.mkdir(parents=True)
        georeferenced(seed, 6, 12, date, lane_gap, section_gap).to_csv(
            folder / f"{stem}.csv", index=False)
    stray = root / "results"  # not <date>/D<k>/<session>/results
    stray.mkdir()
    georeferenced(5, 2, 5, "2022-10-07").to_csv(stray / "A_stray.csv", index=False)
    return root


@pytest.fixture(scope="module")
def aggregated(processed):
    outs = {}
    for name, module in (("jax", jagg), ("port", tagg)):
        out = processed.parent / f"DATASET_{name}"
        args = argparse.Namespace(input=processed, output_folder=out, cfg="default",
                                  log_path=None, verbose=False)
        module.aggregate_results(args, LOG)
        outs[name] = out
    return outs


def test_aggregated_csvs_are_byte_equal(aggregated):
    j_csv = sorted(p.relative_to(aggregated["jax"]) for p in aggregated["jax"].rglob("*.csv"))
    t_csv = sorted(p.relative_to(aggregated["port"]) for p in aggregated["port"].rglob("*.csv"))
    assert t_csv == j_csv and len(j_csv) == 3
    for rel in j_csv:
        assert (aggregated["port"] / rel).read_bytes() == (aggregated["jax"] / rel).read_bytes()
    merged = pd.read_csv(aggregated["port"] / "2022-10-07_A" / "2022-10-07_A_PM1.csv",
                         keep_default_na=False)
    assert list(merged.columns) == tagg.AGGREGATED_COLUMNS
    assert sorted(set(merged["Drone_ID"])) == [1, 2]
    assert (merged["Lane_Number"] == "").any()  # the missing lane stays empty


def test_zips_hold_the_same_members(aggregated):
    j_zip = sorted(p.name for p in aggregated["jax"].glob("*.zip"))
    assert sorted(p.name for p in aggregated["port"].glob("*.zip")) == j_zip
    assert j_zip == ["2022-10-07_A.zip", "2022-10-08_B.zip"]
    for name in j_zip:
        with zipfile.ZipFile(aggregated["jax"] / name) as jz, \
                zipfile.ZipFile(aggregated["port"] / name) as tz:
            assert sorted(jz.namelist()) == sorted(tz.namelist())
            for member in jz.namelist():
                assert tz.read(member) == jz.read(member)


def test_local_time_cuts_to_milliseconds():
    out = tagg.local_time(["2022-10-07 17:52:13.5", "2022-10-07 08:00:01.033333", np.nan])
    assert out[:2].tolist() == ["17:52:13.500", "08:00:01.033"] and np.isnan(out[2])
    with pytest.raises(ValueError):
        tagg.local_time(["0000-00-00 00:00:00.000"])
