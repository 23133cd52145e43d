"""The port's MP4 (ISO-BMFF) demuxer for H.264 and HEVC video, on the host.

    python -m geotrax_tpu_torch.io.mp4 clip.mp4 [--annexb out.h264]

``Mp4Video(path)`` reads the ``moov`` box of the first video track
(``mdhd``, ``stsd`` with ``avc1``/``avc3`` + ``avcC`` or ``hvc1``/``hev1``
+ ``hvcC``, ``stts``, ``ctts``, ``stsc``, ``stsz``, ``stco``/``co64``,
``stss``, ``elst``) and the sequence parameter set, with numpy and the
standard library only. ``info`` is the ``VideoInfo`` that libavformat's
probe gives for the file (the JAX package's ``probe_video``): the size
after the SPS's cropping, ``avg_frame_rate`` as libavformat derives it
(the track's timescale times its sample count over the sum of its sample
durations) and the sample count. ``samples()`` yields each sample's bytes
in decode order, read with ``os.pread``, as an Annex-B access unit: each
length-prefixed NAL unit behind a 4-byte start code, and the parameter
sets of the sample entry (VPS, SPS and PPS for HEVC; SPS and PPS for
H.264) in front of the first. ``pts`` holds each sample's presentation
time (decode time plus its ``ctts`` offset) in the track's timescale.

A file that the port cannot decode exactly raises ``UnsupportedVideo``
naming the file and the property: a fragmented file (``moof``/``mvex``),
another codec (MPEG-4 Part 2, ``mp4v``, among them), a bit depth above 8,
a chroma format other than 4:2:0, full range, an edit list that hides
frames, or no video track. The command line prints it and exits 1.

``frame_table(path)`` needs no decoder and none of the port's codecs: from
the sample tables alone (``Mp4Tables``: ``mdhd``, ``stts``, ``ctts``,
``stss``, ``elst``; any video sample entry, ``mp4v`` too) it gives the
display-order pts in libavformat's time base and the key flags that the
native decoder's packet scan (``io/native.scan_frame_pts``) gives, or None
for a file it cannot map exactly. The GOP-parallel reader splits a video
on it where only cv2 decodes.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import Iterator

import numpy as np

from geotrax_tpu_torch.io.video import VideoInfo

START_CODE = b"\x00\x00\x00\x01"
# Sample entries of the codecs the port decodes: fourcc -> codec
SAMPLE_ENTRIES = {b"avc1": "h264", b"avc3": "h264", b"hvc1": "hevc", b"hev1": "hevc"}
# Boxes whose children are boxes, on the way from moov to the sample table
CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}
# A VisualSampleEntry's fields before its child boxes
VISUAL_ENTRY_BYTES = 78
INT_MAX = 2**31 - 1
# The H.264 profiles whose SPS carries chroma_format_idc and bit depths
H264_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135}
CHROMA_NAMES = {0: "4:0:0 (monochrome)", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}
# What parsing a file that is not a well-formed MP4 raises
PARSE_ERRORS = (ValueError, OSError, struct.error, IndexError)


class UnsupportedVideo(ValueError):
    """A file the port's demuxer refuses; the message names the file and
    the property."""


@dataclass
class Sps:
    """What the port reads from a sequence parameter set."""
    width: int
    height: int
    chroma_format: int
    bit_depth: int
    full_range: bool


class BitReader:
    """MSB-first bits of a NAL unit's payload (emulation prevention bytes
    removed), with Exp-Golomb codes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3] if (self.pos >> 3) < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("malformed Exp-Golomb code")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def rbsp(nal: bytes, header_bytes: int) -> bytes:
    """The NAL unit's payload after its header, emulation prevention bytes
    (the 0x03 of 0x000003) removed."""
    out = bytearray()
    zeros = 0
    for b in nal[header_bytes:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _skip_scaling_list(r: BitReader, size: int) -> None:
    last = nxt = 8
    for _ in range(size):
        if nxt != 0:
            nxt = (last + r.se() + 256) % 256
        last = last if nxt == 0 else nxt


def _video_signal_full_range(r: BitReader) -> bool:
    """The VUI's video_full_range_flag (0 when absent), read from the start
    of vui_parameters, the same in H.264 and HEVC up to that flag."""
    if r.u(1):  # aspect_ratio_info_present_flag
        if r.u(8) == 255:  # Extended_SAR
            r.u(16)
            r.u(16)
    if r.u(1):  # overscan_info_present_flag
        r.u(1)
    if r.u(1):  # video_signal_type_present_flag
        r.u(3)  # video_format
        return bool(r.u(1))
    return False


def parse_h264_sps(nal: bytes) -> Sps:
    """H.264 seq_parameter_set_data (ITU-T H.264 7.3.2.1.1) up to the VUI's
    video_full_range_flag; the size is the frame's after its cropping."""
    r = BitReader(rbsp(nal, 1))
    profile = r.u(8)
    r.u(16)  # constraint flags, level_idc
    r.ue()  # seq_parameter_set_id
    chroma, depth = 1, 8
    if profile in H264_HIGH_PROFILES:
        chroma = r.ue()
        if chroma == 3:
            r.u(1)  # separate_colour_plane_flag
        depth = 8 + r.ue()
        depth = max(depth, 8 + r.ue())  # bit_depth_chroma_minus8
        r.u(1)  # qpprime_y_zero_transform_bypass_flag
        if r.u(1):  # seq_scaling_matrix_present_flag
            for i in range(8 if chroma != 3 else 12):
                if r.u(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    r.ue()  # log2_max_frame_num_minus4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()  # max_num_ref_frames
    r.u(1)  # gaps_in_frame_num_value_allowed_flag
    width_mbs = r.ue() + 1
    height_units = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)  # mb_adaptive_frame_field_flag
    r.u(1)  # direct_8x8_inference_flag
    crop = (0, 0, 0, 0)
    if r.u(1):  # frame_cropping_flag
        crop = (r.ue(), r.ue(), r.ue(), r.ue())
    full_range = _video_signal_full_range(r) if r.u(1) else False
    sub_w = 2 if chroma in (1, 2) else 1
    sub_h = 2 if chroma == 1 else 1
    unit_x = 1 if chroma == 0 else sub_w
    unit_y = (2 - frame_mbs_only) * (1 if chroma == 0 else sub_h)
    width = width_mbs * 16 - unit_x * (crop[0] + crop[1])
    height = (2 - frame_mbs_only) * height_units * 16 - unit_y * (crop[2] + crop[3])
    return Sps(width, height, chroma, depth, full_range)


def _skip_hevc_profile_tier_level(r: BitReader, max_sub_layers_minus1: int) -> None:
    r.u(8)  # general_profile_space, general_tier_flag, general_profile_idc
    r.u(32)  # general_profile_compatibility_flags
    r.u(48)  # progressive, interlaced, non-packed, frame-only and reserved flags
    r.u(8)  # general_level_idc
    present = [(r.u(1), r.u(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            r.u(2)
    for profile, level in present:
        if profile:
            r.u(88)
        if level:
            r.u(8)


def _skip_hevc_scaling_list_data(r: BitReader) -> None:
    for size_id in range(4):
        for _ in range(0, 6, 3 if size_id == 3 else 1):
            if not r.u(1):  # scaling_list_pred_mode_flag
                r.ue()  # scaling_list_pred_matrix_id_delta
                continue
            coefs = min(64, 1 << (4 + (size_id << 1)))
            if size_id > 1:
                r.se()  # scaling_list_dc_coef_minus8
            for _ in range(coefs):
                r.se()


def _hevc_short_term_rps(r: BitReader, idx: int, sets: list) -> list:
    """st_ref_pic_set(idx) of an SPS (H.265 7.3.7.8): its delta POCs, the
    derivation of 7.4.8 for a set predicted from the one before it."""
    if idx != 0 and r.u(1):  # inter_ref_pic_set_prediction_flag
        ref = sets[idx - 1]
        sign = r.u(1)
        delta_rps = (1 - 2 * sign) * (r.ue() + 1)
        deltas = []
        for j in range(len(ref) + 1):
            used = r.u(1)
            use_delta = 1 if used else r.u(1)
            if use_delta:
                d = (ref[j] if j < len(ref) else 0) + delta_rps
                if d != 0:
                    deltas.append(d)
        return deltas
    n_neg, n_pos = r.ue(), r.ue()
    deltas, poc = [], 0
    for _ in range(n_neg):
        poc -= r.ue() + 1
        r.u(1)
        deltas.append(poc)
    poc = 0
    for _ in range(n_pos):
        poc += r.ue() + 1
        r.u(1)
        deltas.append(poc)
    return deltas


def parse_hevc_sps(nal: bytes) -> Sps:
    """HEVC seq_parameter_set_rbsp (ITU-T H.265 7.3.2.2) up to the VUI's
    video_full_range_flag; the size is the frame's after its conformance
    window."""
    r = BitReader(rbsp(nal, 2))
    r.u(4)  # sps_video_parameter_set_id
    max_sub_layers_minus1 = r.u(3)
    r.u(1)  # sps_temporal_id_nesting_flag
    _skip_hevc_profile_tier_level(r, max_sub_layers_minus1)
    r.ue()  # sps_seq_parameter_set_id
    chroma = r.ue()
    if chroma == 3:
        r.u(1)
    width, height = r.ue(), r.ue()
    if r.u(1):  # conformance_window_flag
        sub_w = 2 if chroma in (1, 2) else 1
        sub_h = 2 if chroma == 1 else 1
        left, right, top, bottom = r.ue(), r.ue(), r.ue(), r.ue()
        width -= sub_w * (left + right)
        height -= sub_h * (top + bottom)
    depth = 8 + r.ue()
    depth = max(depth, 8 + r.ue())
    log2_max_poc_lsb = r.ue() + 4
    ordering_all = r.u(1)
    for _ in range(0 if ordering_all else max_sub_layers_minus1, max_sub_layers_minus1 + 1):
        r.ue()
        r.ue()
        r.ue()
    for _ in range(6):  # coding and transform block sizes, hierarchy depths
        r.ue()
    if r.u(1) and r.u(1):  # scaling_list_enabled_flag, sps_scaling_list_data_present_flag
        _skip_hevc_scaling_list_data(r)
    r.u(1)  # amp_enabled_flag
    r.u(1)  # sample_adaptive_offset_enabled_flag
    if r.u(1):  # pcm_enabled_flag
        r.u(4)
        r.u(4)
        r.ue()
        r.ue()
        r.u(1)
    sets: list = []
    for i in range(r.ue()):
        sets.append(_hevc_short_term_rps(r, i, sets))
    if r.u(1):  # long_term_ref_pics_present_flag
        for _ in range(r.ue()):
            r.u(log2_max_poc_lsb)
            r.u(1)
    r.u(1)  # sps_temporal_mvp_enabled_flag
    r.u(1)  # strong_intra_smoothing_enabled_flag
    full_range = _video_signal_full_range(r) if r.u(1) else False
    return Sps(width, height, chroma, depth, full_range)


def _boxes(read, start: int, end: int) -> Iterator[tuple[bytes, int, int]]:
    """(type, payload start, box end) of the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", read(pos, 8))
        header = 8
        if size == 1:
            size = struct.unpack(">Q", read(pos + 8, 8))[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            raise ValueError(f"box '{kind.decode('latin-1')}' at {pos} runs past its parent")
        yield kind, pos + header, pos + size
        pos += size


def _nal_list(config: bytes, pos: int, count: int) -> tuple[list, int]:
    """``count`` NAL units, each behind its 16-bit length, from ``pos`` of
    a configuration record; returns them and the position after them."""
    nals = []
    for _ in range(count):
        n = struct.unpack(">H", config[pos:pos + 2])[0]
        nals.append(config[pos + 2:pos + 2 + n])
        pos += 2 + n
    return nals, pos


def _full_box(data: bytes) -> tuple[int, bytes]:
    """(version, payload after version and flags) of a full box."""
    return data[0], data[4:]


class Mp4Tables:
    """The sample tables of an MP4 file's first video track, whatever its
    codec: ``timescale``, ``fourcc`` (of its sample entry), ``sizes``,
    ``offsets``, ``durations``, ``pts`` and ``keyframes`` in decode order,
    ``edits`` (the edit list's (duration, media time, rate integer, rate
    fraction) entries, empty without one), ``video_tracks`` and ``boxes``
    (the track's leaf boxes by type). A fragmented file, one without a
    video track and an edit list that hides frames raise
    ``UnsupportedVideo``."""

    def __init__(self, path):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            self._parse()
        except BaseException:
            self.close()
            raise

    # -- reading ------------------------------------------------------------
    def _read(self, pos: int, n: int) -> bytes:
        data = os.pread(self._fd, n, pos)
        if len(data) != n:
            raise ValueError(f"{self.path}: the file ends inside a box at {pos}")
        return data

    def _refuse(self, what: str):
        raise UnsupportedVideo(f"{self.path}: {what}")

    def _parse(self) -> None:
        size = os.fstat(self._fd).st_size
        moov = None
        for kind, start, end in _boxes(self._read, 0, size):
            if kind == b"moof":
                self._refuse("a fragmented MP4 (moof box)")
            if kind == b"moov":
                moov = (start, end)
        if moov is None:
            raise ValueError(f"{self.path}: no moov box (not an MP4 file?)")
        data = self._read(moov[0], moov[1] - moov[0])

        def read(pos, n):
            return data[pos:pos + n]

        tracks = []
        self.movie_timescale = 0
        for kind, start, end in _boxes(read, 0, len(data)):
            if kind == b"mvhd":
                version, body = _full_box(read(start, end - start))
                self.movie_timescale = struct.unpack(">I", body[16:20] if version == 1
                                                     else body[8:12])[0]
            if kind == b"mvex":
                self._refuse("a fragmented MP4 (mvex box)")
            if kind == b"trak":
                tracks.append(self._track(read, start, end))
        video = [t for t in tracks if t.get(b"hdlr", b"")[8:12] == b"vide"]
        if not video:
            self._refuse("no video track")
        self.video_tracks = len(video)
        self._table(video[0])

    def _track(self, read, start: int, end: int) -> dict:
        """The leaf boxes of a trak that the port reads, by type."""
        found: dict = {}

        def walk(s, e):
            for kind, cs, ce in _boxes(read, s, e):
                if kind in CONTAINERS:
                    walk(cs, ce)
                elif kind not in found:
                    found[kind] = read(cs, ce - cs)

        walk(start, end)
        return found

    def _table(self, t: dict) -> None:
        for need in (b"mdhd", b"stsd", b"stts", b"stsc", b"stsz"):
            if need not in t:
                raise ValueError(f"{self.path}: the video track has no '{need.decode()}' box")
        self.boxes = t
        version, mdhd = _full_box(t[b"mdhd"])
        self.timescale = struct.unpack(">I", mdhd[16:20] if version == 1 else mdhd[8:12])[0]
        self._sample_entry(t[b"stsd"])
        self._samples(t)
        self._edits(t.get(b"elst"), self.movie_timescale)

    def _sample_entry(self, stsd: bytes) -> None:
        _, body = _full_box(stsd)
        if struct.unpack(">I", body[:4])[0] < 1:
            raise ValueError(f"{self.path}: the video track has no sample entry")
        self.fourcc = body[8:12]

    def _samples(self, t: dict) -> None:
        _, stsz = _full_box(t[b"stsz"])
        const, count = struct.unpack(">II", stsz[:8])
        self.sizes = (np.full(count, const, np.int64) if const
                      else np.frombuffer(stsz[8:8 + 4 * count], ">u4").astype(np.int64))
        if b"stco" in t:
            _, body = _full_box(t[b"stco"])
            n = struct.unpack(">I", body[:4])[0]
            chunk_off = np.frombuffer(body[4:4 + 4 * n], ">u4").astype(np.int64)
        elif b"co64" in t:
            _, body = _full_box(t[b"co64"])
            n = struct.unpack(">I", body[:4])[0]
            chunk_off = np.frombuffer(body[4:4 + 8 * n], ">u8").astype(np.int64)
        else:
            raise ValueError(f"{self.path}: the video track has no chunk offsets")
        _, body = _full_box(t[b"stsc"])
        n = struct.unpack(">I", body[:4])[0]
        stsc = np.frombuffer(body[4:4 + 12 * n], ">u4").reshape(n, 3).astype(np.int64)
        # samples per chunk, chunk by chunk: each stsc run lasts to the next
        first = stsc[:, 0] - 1
        last = np.append(first[1:], len(chunk_off))
        per_chunk = np.repeat(stsc[:, 1], np.maximum(last - first, 0))
        if per_chunk.sum() < count:
            raise ValueError(f"{self.path}: the chunks hold {per_chunk.sum()} of {count} samples")
        chunk_of = np.repeat(np.arange(len(per_chunk)), per_chunk)[:count]
        chunk_first = np.concatenate([[0], np.cumsum(per_chunk)[:-1]])
        size_cum = np.concatenate([[0], np.cumsum(self.sizes)])
        self.offsets = chunk_off[chunk_of] + size_cum[np.arange(count)] \
            - size_cum[chunk_first[chunk_of]]
        _, body = _full_box(t[b"stts"])
        n = struct.unpack(">I", body[:4])[0]
        stts = np.frombuffer(body[4:4 + 8 * n], ">u4").reshape(n, 2).astype(np.int64)
        self.durations = np.repeat(stts[:, 1], stts[:, 0])
        if len(self.durations) != count:
            raise ValueError(f"{self.path}: stts covers {len(self.durations)} of {count} samples")
        dts = np.concatenate([[0], np.cumsum(self.durations)[:-1]])
        offsets = np.zeros(count, np.int64)
        if b"ctts" in t:
            version, body = _full_box(t[b"ctts"])
            n = struct.unpack(">I", body[:4])[0]
            raw = np.frombuffer(body[4:4 + 8 * n], ">u4").reshape(n, 2)
            values = raw[:, 1].astype(np.int64)
            if version == 1:
                values = raw[:, 1].view(">i4").astype(np.int64)
            offsets = np.repeat(values, raw[:, 0].astype(np.int64))[:count]
        self.pts = dts + offsets
        self.keyframes = np.arange(count)
        if b"stss" in t:
            _, body = _full_box(t[b"stss"])
            n = struct.unpack(">I", body[:4])[0]
            self.keyframes = np.frombuffer(body[4:4 + 4 * n], ">u4").astype(np.int64) - 1

    def _edits(self, elst, movie_timescale: int) -> None:
        """Refuse an edit list that hides frames, as libavformat would drop
        them: more than one media edit, or one that starts after the first
        frame's presentation time or ends before the last frame starts. An
        empty edit (a start delay) hides none."""
        self.edits = []
        if elst is None or len(self.pts) == 0:
            return
        version, body = _full_box(elst)
        n = struct.unpack(">I", body[:4])[0]
        fmt, step = (">QqHH", 20) if version == 1 else (">IiHH", 12)
        self.edits = edits = [struct.unpack(fmt, body[4 + i * step:4 + (i + 1) * step])
                              for i in range(n)]
        media = [e for e in edits if e[1] != -1]
        if not media:
            return
        if len(media) > 1:
            self._refuse(f"an edit list of {len(media)} media edits")
        duration, media_time, _, _ = media[0]
        first, last = int(self.pts.min()), int(self.pts.max())
        if media_time > first:
            self._refuse(f"an edit list that hides frames (media time {media_time} after the "
                         f"first frame's {first})")
        # the edit's duration is in the movie's timescale; 0 shows the rest
        if duration and movie_timescale and \
                last >= media_time + duration * self.timescale / movie_timescale:
            self._refuse(f"an edit list that hides frames (it ends before the last frame's "
                         f"presentation time {last})")

    def frame_table(self) -> tuple | None:
        """Display-order (pts, key flags) of every frame, equal to what
        libavformat's packet scan gives (``io/native.scan_frame_pts``; pts
        in the track's timescale, libavformat's time base for it): each
        sample's pts is its decode time plus its ``ctts`` offset; a media
        edit moves them so that the first shows at 0 (libavformat's edit
        list index, whatever the edit's media time up to the first frame's);
        samples sort by pts, ties in decode order; the ``stss`` samples
        (every sample without one) are the keys. Any sample entry will do
        (``mp4v``, ``avc1``, ``hvc1``, ...). None where that mapping is not
        known to be exact: more than one video track, an empty edit,
        several edits or a rate other than 1, partial sync samples
        (``stps``) or sample groups (``sbgp``) that libavformat may read as
        keys."""
        if self.video_tracks != 1 or b"stps" in self.boxes or b"sbgp" in self.boxes:
            return None
        pts, count = self.pts, len(self.sizes)
        if self.edits:
            if len(self.edits) != 1 or self.edits[0][1] < 0 or self.edits[0][2:] != (1, 0):
                return None
            pts = pts - pts.min()
        keys = np.zeros(count, np.int32)
        keys[self.keyframes[(self.keyframes >= 0) & (self.keyframes < count)]] = 1
        order = np.argsort(pts, kind="stable")
        return pts[order], keys[order]

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Mp4Video(Mp4Tables):
    """The first video track of an MP4 file that the port decodes: its
    ``info``, ``codec``, ``sps``, parameter sets and samples (see the
    module's docstring)."""

    def _refuse(self, what: str):
        super()._refuse(f"{what}; the port decodes H.264 and HEVC, 8-bit 4:2:0 limited range, "
                        f"in a plain (unfragmented) MP4")

    def _table(self, t: dict) -> None:
        super()._table(t)
        fps = Fraction(0)
        total = int(self.durations.sum())
        if self.timescale and total and len(self.sizes):
            fps = Fraction(self.timescale * len(self.sizes), total)
            if fps.numerator > INT_MAX or fps.denominator > INT_MAX:
                raise ValueError(f"{self.path}: frame rate {fps} needs av_reduce's approximation")
        self.fps = fps
        self.info = VideoInfo(self.sps.width, self.sps.height, float(fps), len(self.sizes))

    def _sample_entry(self, stsd: bytes) -> None:
        super()._sample_entry(stsd)
        _, body = _full_box(stsd)
        size, kind = struct.unpack(">I4s", body[4:12])
        codec = SAMPLE_ENTRIES.get(kind)
        if codec is None:
            name = {b"mp4v": "MPEG-4 Part 2 (mp4v)"}.get(kind, repr(kind.decode("latin-1")))
            self._refuse(f"codec {name}")
        self.codec = codec
        entry = body[4:4 + size]
        config = None
        for ckind, cs, ce in _boxes(lambda p, n: entry[p:p + n], 8 + VISUAL_ENTRY_BYTES, size):
            if ckind in (b"avcC", b"hvcC"):
                config = entry[cs:ce]
        if config is None:
            raise ValueError(f"{self.path}: the {codec} sample entry has no configuration box")
        if codec == "h264":
            self.length_size = (config[4] & 3) + 1
            sps_nals, pos = _nal_list(config, 6, config[5] & 0x1F)
            pps_nals, _ = _nal_list(config, pos + 1, config[pos])
            sets = sps_nals + pps_nals
            parse = parse_h264_sps
        else:
            self.length_size = (config[21] & 3) + 1
            pos, sets = 23, []
            for _ in range(config[22]):  # arrays of one NAL unit type each
                nals, pos = _nal_list(config, pos + 3, struct.unpack(">H", config[pos + 1:pos + 3])[0])
                sets += nals
            sps_nals = [s for s in sets if s and (s[0] >> 1) & 0x3F == 33]
            parse = parse_hevc_sps
        if not sps_nals:
            raise ValueError(f"{self.path}: the {codec} configuration holds no SPS")
        self.parameter_sets = sets
        self.sps = sps = parse(sps_nals[0])
        if sps.bit_depth != 8:
            self._refuse(f"{sps.bit_depth}-bit {codec}")
        if sps.chroma_format != 1:
            self._refuse(f"chroma format {CHROMA_NAMES.get(sps.chroma_format, sps.chroma_format)}")
        if sps.full_range:
            self._refuse("full range (video_full_range_flag 1)")

    # -- samples ------------------------------------------------------------
    def annexb(self, sample: bytes, first: bool = False) -> bytes:
        """One sample's NAL units behind start codes, the parameter sets in
        front when ``first``."""
        out = bytearray()
        if first:
            for nal in self.parameter_sets:
                out += START_CODE + nal
        pos, n = 0, self.length_size
        while pos + n <= len(sample):
            size = int.from_bytes(sample[pos:pos + n], "big")
            pos += n
            if size == 0 or pos + size > len(sample):
                raise ValueError(f"{self.path}: a NAL unit of {size} bytes overruns its sample")
            out += START_CODE + sample[pos:pos + size]
            pos += size
        return bytes(out)

    def samples(self) -> Iterator[bytes]:
        """Every sample in decode order as an Annex-B access unit (the
        parameter sets in front of the first)."""
        for i in range(len(self.sizes)):
            yield self.annexb(self._read(int(self.offsets[i]), int(self.sizes[i])), i == 0)

    def write_annexb(self, path) -> Path:
        """The whole elementary stream (``.h264``/``.hevc``) into ``path``."""
        with open(path, "wb") as f:
            for sample in self.samples():
                f.write(sample)
        return Path(path)


def frame_table(path) -> tuple | None:
    """Display-order (pts, key flags) of every frame of ``path``'s video
    track from its sample tables alone (``Mp4Tables.frame_table``), or None
    where they cannot give what libavformat's packet scan gives."""
    try:
        with Mp4Tables(path) as tables:
            return tables.frame_table()
    except PARSE_ERRORS:
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m geotrax_tpu_torch.io.mp4",
        description="Read an MP4's video track with the port's demuxer: print its size, frame "
                    "rate and frame count as JSON, optionally write its Annex-B stream.")
    parser.add_argument("source", type=Path)
    parser.add_argument("--annexb", type=Path, default=None, metavar="OUT",
                        help="write the elementary stream (.h264 / .hevc) to OUT")
    args = parser.parse_args(argv)
    try:
        with Mp4Video(args.source) as video:
            if args.annexb is not None:
                video.write_annexb(args.annexb)
            print(json.dumps({"codec": video.codec, "width": video.info.width,
                              "height": video.info.height, "fps": video.info.fps,
                              "frame_count": video.info.frame_count,
                              "keyframes": len(video.keyframes)}))
    except (UnsupportedVideo, ValueError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
