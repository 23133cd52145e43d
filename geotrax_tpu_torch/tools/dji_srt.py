"""DJI SRT flight logs for the data-prep tools: the port's copy of
``tools/dji_srt.py``, with tables as ``{column: numpy array}`` dicts
(``io/table.py``) in place of pandas DataFrames.

DJI drones write telemetry as SRT subtitles next to each video: one block
per frame with a wall-clock window, a FrameCnt/SrtCnt counter, a datetime
line, and bracketed [key: value] telemetry (iso, shutter, fnum, ev, ct,
color_md, focal_len, latitude, longitude, rel_alt, abs_alt; spellings vary
by drone family). This module parses, shifts, merges and writes them, and
reads a video's flight log from its companion .srt or .csv.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace
from pathlib import Path

from geotrax_tpu_torch.io import table

_TIMING = re.compile(
    r"(\d{2}):(\d{2}):(\d{2})[,.](\d{3})\s*-->\s*(\d{2}):(\d{2}):(\d{2})[,.](\d{3})"
)
_COUNTER = re.compile(r"(FrameCnt|SrtCnt)\s*:\s*(\d+)")
_BRACKET = re.compile(r"\[([^\[\]]+)\]")
_PAIR = re.compile(r"([A-Za-z_]\w*)\s*:\s*([^,\[\]]+?)(?=\s+[A-Za-z_]\w*\s*:|,|$)")
_NUMBER = re.compile(r"[-+]?\d*\.?\d+")

# canonical name -> accepted spellings across DJI families
FIELD_ALIASES = {
    "iso": ("iso",),
    "shutter": ("shutter",),
    "fnum": ("fnum", "f_num", "aperture"),
    "ev": ("ev",),
    "ct": ("ct",),
    "color_md": ("color_md", "color_mode"),
    "focal_len": ("focal_len", "focal_length"),
    "latitude": ("latitude", "lat", "gps_lat"),
    "longitude": ("longitude", "lon", "longtitude", "gps_lon"),
    "rel_alt": ("rel_alt", "altitude", "h"),
    "abs_alt": ("abs_alt",),
}

NUMERIC_FIELDS = ("iso", "fnum", "ev", "ct", "focal_len",
                  "latitude", "longitude", "rel_alt", "abs_alt")


@dataclass
class SrtBlock:
    start_ms: int
    end_ms: int
    body: str  # everything after the timing line, newline-joined

    @property
    def frame_count(self):
        m = _COUNTER.search(self.body)
        return int(m.group(2)) if m else None

    def shifted(self, ms: int = 0, frames: int = 0) -> "SrtBlock":
        body = self.body
        if frames:
            body = _COUNTER.sub(
                lambda m: f"{m.group(1)}: {int(m.group(2)) + frames}", body
            )
        return replace(self, start_ms=self.start_ms + ms,
                       end_ms=self.end_ms + ms, body=body)

    def telemetry(self) -> dict:
        """Canonical telemetry dict (numeric fields parsed; missing -> None)."""
        raw: dict = {}
        for content in _BRACKET.findall(self.body):
            for m in _PAIR.finditer(content):
                raw.setdefault(m.group(1).lower(), m.group(2).strip())
        out: dict = {}
        for canonical, aliases in FIELD_ALIASES.items():
            value = next((raw[a] for a in aliases if a in raw), None)
            if value is not None and canonical in NUMERIC_FIELDS:
                num = _NUMBER.search(value)
                value = float(num.group()) if num else None
            out[canonical] = value
        return out


def _ts_ms(h, m, s, ms) -> int:
    return ((int(h) * 60 + int(m)) * 60 + int(s)) * 1000 + int(ms)


def ms_to_timestamp(ms: int) -> str:
    h, rem = divmod(int(ms), 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, msec = divmod(rem, 1_000)
    return f"{h:02d}:{m:02d}:{s:02d},{msec:03d}"


def parse_srt(text: str) -> list[SrtBlock]:
    blocks = []
    for chunk in re.split(r"\n\s*\n", text.strip()):
        lines = chunk.strip().splitlines()
        timing_idx = next(
            (i for i, ln in enumerate(lines) if _TIMING.match(ln.strip())), None
        )
        if timing_idx is None or timing_idx + 1 > len(lines):
            continue
        g = _TIMING.match(lines[timing_idx].strip()).groups()
        blocks.append(SrtBlock(
            start_ms=_ts_ms(*g[:4]),
            end_ms=_ts_ms(*g[4:]),
            body="\n".join(lines[timing_idx + 1:]),
        ))
    return blocks


def format_srt(blocks: list[SrtBlock]) -> str:
    parts = [
        f"{i}\n{ms_to_timestamp(b.start_ms)} --> {ms_to_timestamp(b.end_ms)}\n{b.body}\n"
        for i, b in enumerate(blocks, start=1)
    ]
    return "\n".join(parts)


def read_srt(path: Path) -> list[SrtBlock]:
    return parse_srt(Path(path).read_text(errors="replace"))


def write_srt(path: Path, blocks: list[SrtBlock]) -> None:
    Path(path).write_text(format_srt(blocks))


def merge_blocks(parts: list[list[SrtBlock]]) -> list[SrtBlock]:
    """Concatenate per-file block lists with continuous timestamps and frame
    counters (part k is shifted by the end time / last counter of the merged
    prefix)."""
    merged: list[SrtBlock] = []
    ms_off = 0
    frame_off = 0
    for blocks in parts:
        if not blocks:
            continue
        merged.extend(b.shifted(ms=ms_off, frames=frame_off) for b in blocks)
        ms_off = merged[-1].end_ms
        last = merged[-1].frame_count
        frame_off = last if last is not None else frame_off + len(blocks)
    return merged


def srt_table(blocks: list[SrtBlock]) -> dict:
    """Flight-log table: one row per block with the frame index and the
    telemetry (the .csv the georeference stage reads for timestamps),
    typed as ``pd.DataFrame(rows)`` types it."""
    rows = []
    for i, b in enumerate(blocks):
        t = b.telemetry()
        count = b.frame_count
        rows.append({
            "frame": count - 1 if count is not None else i,
            "time_ms": b.start_ms,
            **{k: t.get(k) for k in (
                "latitude", "longitude", "rel_alt", "abs_alt",
                "iso", "shutter", "fnum", "ev", "ct", "color_md", "focal_len",
            )},
        })
    return table.from_records(rows)


def companion_srt(video: Path) -> Path | None:
    """Find the .srt/.SRT next to a video, tolerating edited video stems
    (DJI_0212_trimmed.mp4 -> DJI_0212.SRT)."""
    video = Path(video)
    for stem in (video.stem, video.stem.split("_trimmed")[0], video.stem.rsplit("_", 1)[0]):
        for ext in (".srt", ".SRT"):
            cand = video.with_name(stem + ext)
            if cand.exists():
                return cand
    return None


# the frame counter isn't telemetry, but vendor CSVs spell it differently too
_FRAME_ALIASES = ("frame", "framecnt", "frame_cnt", "frame_index", "frame_no")


def normalize_log_columns(log: dict) -> dict:
    """Rename a flight-log table's columns to the canonical spellings of
    FIELD_ALIASES (+ 'frame'): vendor per-part CSVs that
    merge_videos_and_logs concatenates verbatim use 'altitude'/'lat'/... ."""
    lower = {c.lower(): c for c in log}
    rename = {}
    for canonical, aliases in list(FIELD_ALIASES.items()) + [("frame", _FRAME_ALIASES)]:
        if canonical in log:
            continue
        for a in aliases:
            if a in lower:
                rename[lower[a]] = canonical
                break
    return {rename.get(k, k): v for k, v in log.items()} if rename else log


def table_rows(log: dict) -> int:
    return len(next(iter(log.values()))) if log else 0


def flight_log(video: Path, prefer: str = "srt"):
    """Per-frame flight-log table of a video from its companion .srt or
    .csv, whichever exists and parses usably, with columns normalized to
    canonical spellings. prefer='csv' consults the .csv first (cut-tool CSVs
    carry rebased frame counters). A source that exists but yields no usable
    table (unreadable, empty, or no 'frame' column) falls through to the
    other; None when neither is usable."""
    video = Path(video)

    def _csv():
        p = video.with_suffix(".csv")
        if not p.exists():
            return None
        try:
            return normalize_log_columns(table.read_csv(p))
        except Exception:  # noqa: BLE001 — an unreadable log falls through
            return None

    def _srt():
        p = companion_srt(video)
        if p is None:
            return None
        try:
            return srt_table(read_srt(p))
        except Exception:  # noqa: BLE001
            return None

    for source in (_csv, _srt) if prefer == "csv" else (_srt, _csv):
        log = source()
        if log is not None and table_rows(log) and "frame" in log:
            return log
    return None
