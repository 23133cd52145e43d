"""YUV -> packed RGB24, the YUV -> RGB step of decoding: three
hand-written CUDA kernels and their plain versions.

Replaces no Pallas kernel: the reference converts each decoded frame on the
host with swscale (``geotrax_tpu/io/native/decode.cpp:169-172``,
``sws_getContext(w, h, <the first frame's format>, w, h, AV_PIX_FMT_RGB24,
SWS_BILINEAR, ...)`` with no ``sws_setColorspaceDetails``: BT.601
coefficients whatever the stream signals, full range only for a ``yuvj``
format). Every plain version below is written from the arithmetic of
libswscale 6.7 (FFmpeg 5.1) on x86 and equals that call bit for bit; each
kernel does the same integer operations as its plain version.

- ``nv12_to_rgb24`` (``csrc/nv12_rgb24.cu``, plain ``nv12_to_rgb24_torch``):
  8-bit 4:2:0 limited range with even sides, the planes in NV12 layout.
- ``yuv_to_rgb24(planes, fmt)``: planar Y, U and V of any format of
  ``FORMATS`` at any size. ``route`` says which of swscale's two paths the
  reference takes, and so which kernel runs:
  - "unscaled": swscale's special converter (8-bit 4:2:0 and 4:2:2 with an
    even height), ``yuv_unscaled_to_rgb24`` launching ``csrc/yuv_rgb24.cu``,
    plain ``yuv_unscaled_to_rgb24_torch``;
  - "scaled": swscale's generic scaler (10-bit, 4:4:4, and 8-bit 4:2:0 or
    4:2:2 with an odd height), ``yuv_scaled_to_rgb24`` launching
    ``csrc/yuv_scaled_rgb24.cu``, plain ``yuv_scaled_to_rgb24_torch``.

CPU tensors run the plain versions; CUDA tensors launch the kernels or
raise; each launcher counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from geotrax_tpu_torch import _cuda

KERNEL = "nv12_rgb24"
# libswscale 6.7's x86 SIMD converter: ff_yuv2rgb_c_init_tables' BT.601
# limited-range coefficients times 2^13, rounded to 16 bits, and the
# offsets of Y (16 << 3) and of U and V (128 << 3)
Y_COEFF, Y_OFFSET, C_OFFSET = 9539, 128, 1024
VR_COEFF, UG_COEFF, VG_COEFF, UB_COEFF = 13075, -3209, -6660, 16525


def _check_planes(y: torch.Tensor, uv: torch.Tensor, name: str) -> tuple:
    if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise TypeError(f"{name}: the planes are uint8, got {y.dtype} and {uv.dtype}")
    if y.dim() != 2 or uv.dim() != 2:
        raise ValueError(f"{name}: Y is (H, W) and UV (H/2, W), got {tuple(y.shape)} and "
                         f"{tuple(uv.shape)}")
    h, w = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"{name}: 4:2:0 planes have even sides, got {h}x{w}")
    if tuple(uv.shape) != (h // 2, w):
        raise ValueError(f"{name}: UV of a {h}x{w} frame is ({h // 2}, {w}), got "
                         f"{tuple(uv.shape)}")
    return h, w


def nv12_to_rgb24_torch(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch NV12 -> RGB24: ``y`` (H, W) and ``uv`` (H/2, W, U and V
    interleaved) uint8 -> (H, W, 3) uint8, H and W even.

    The bytes of the reference decoder's swscale call on this repository's
    x86 hosts: for same-size yuv420p -> rgb24 with even height swscale
    takes its unscaled special converter, one chroma sample for each 2x2
    pixels with no interpolation, and where the CPU has MMXEXT or SSSE3 that
    is libswscale 6.7's SIMD converter (``yuv420_rgb24``; both give the same
    bytes). Its 16-bit fixed point: Y' = ((y << 3) - 128) * 9539 >> 16, Cb =
    (u << 3) - 1024, Cr = (v << 3) - 1024, R = Y' + (Cr * 13075 >> 16), G =
    Y' + (Cb * -3209 >> 16) + (Cr * -6660 >> 16), B = Y' + (Cb * 16525 >> 16),
    each clamped to 0..255 (pmulhw's floor of the high half, packuswb's
    saturation). Equal to that converter on all 2^24 (y, u, v). swscale's C
    table converter (a CPU without MMXEXT) rounds otherwise and is not
    this."""
    h, w = _check_planes(y, uv, "nv12_to_rgb24_torch")
    luma = (((y.to(torch.int32) << 3) - Y_OFFSET) * Y_COEFF) >> 16
    cb = (uv[:, 0::2].to(torch.int32) << 3) - C_OFFSET
    cr = (uv[:, 1::2].to(torch.int32) << 3) - C_OFFSET
    chroma = torch.stack([(cr * VR_COEFF) >> 16,
                          ((cb * UG_COEFF) >> 16) + ((cr * VG_COEFF) >> 16),
                          (cb * UB_COEFF) >> 16], dim=-1)
    up = chroma[:, None, :, None, :].expand(h // 2, 2, w // 2, 2, 3).reshape(h, w, 3)
    return (luma[..., None] + up).clamp_(0, 255).to(torch.uint8)


@lru_cache(maxsize=1)
def _kernel():
    """The C entry point ``gtx_nv12_rgb24`` (library built and loaded once)."""
    fn = _cuda.load(KERNEL).gtx_nv12_rgb24
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build(verbose: bool = False) -> tuple:
    """Compile the kernel (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(KERNEL, verbose=verbose)


def nv12_to_rgb24(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """NV12 planes -> (H, W, 3) uint8 RGB, as ``nv12_to_rgb24_torch``.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (one launch a frame) or raise. Each plane's rows may lie
    at any pitch (a row slice of a larger buffer), its bytes within a row
    contiguous. ``nv12_to_rgb24.launches`` counts the kernel launches."""
    if y.device.type == "cpu" and uv.device.type == "cpu":
        return nv12_to_rgb24_torch(y, uv)
    if y.device.type != "cuda" or uv.device != y.device:
        raise ValueError(f"nv12_to_rgb24: the planes lie on {y.device} and {uv.device}; the "
                         "kernel takes both on one CUDA device")
    h, w = _check_planes(y, uv, "nv12_to_rgb24")
    if y.stride(1) != 1 or uv.stride(1) != 1:
        raise ValueError("nv12_to_rgb24: the kernel takes planes whose rows are contiguous")
    if y.stride(0) < w or uv.stride(0) < w:
        raise ValueError(f"nv12_to_rgb24: row pitches {y.stride(0)} and {uv.stride(0)} are "
                         f"shorter than the width {w}")
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    if h == 0 or w == 0:
        return out
    kernel = _kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = kernel(y.data_ptr(), y.stride(0), uv.data_ptr(), uv.stride(0), out.data_ptr(), h, w,
                    stream)
    if rc != 0:
        raise RuntimeError(f"nv12_rgb24 kernel launch failed with CUDA error {rc}")
    nv12_to_rgb24.launches += 1
    return out


nv12_to_rgb24.launches = 0


# --------------------------------------------------------------------------
# planar formats: yuv_to_rgb24
# --------------------------------------------------------------------------

UNSCALED_KERNEL = "yuv_rgb24"
SCALED_KERNEL = "yuv_scaled_rgb24"


@dataclass(frozen=True)
class YuvFormat:
    """A planar YUV pixel format the card converts: libav's name, bits a
    sample, log2 of the chroma subsampling across (``sx``) and down
    (``sy``), and whether swscale converts it as full range (a ``yuvj``
    name: swscale reads the range from the format's name alone, so a
    10-bit stream flagged full range converts as limited range)."""

    name: str
    depth: int
    sx: int
    sy: int
    full_range: bool

    @property
    def dtype(self) -> torch.dtype:
        """The planes' tensor type: uint8, or int16 for libav's 16-bit
        little-endian words of 10-bit samples (0..1023)."""
        return torch.uint8 if self.depth == 8 else torch.int16

    @property
    def sample_bytes(self) -> int:
        return 1 if self.depth == 8 else 2

    def chroma_shape(self, h: int, w: int) -> tuple:
        """(rows, columns) of the U and V planes: rounded up for odd sides."""
        return -(-h >> self.sy), -(-w >> self.sx)

    def nbytes(self, h: int, w: int) -> int:
        """Bytes of a frame's three planes, one after the other."""
        ch, cw = self.chroma_shape(h, w)
        return (h * w + 2 * ch * cw) * self.sample_bytes


FORMATS = {f.name: f for f in (
    YuvFormat("yuv420p", 8, 1, 1, False), YuvFormat("yuvj420p", 8, 1, 1, True),
    YuvFormat("yuv422p", 8, 1, 0, False), YuvFormat("yuvj422p", 8, 1, 0, True),
    YuvFormat("yuv444p", 8, 0, 0, False), YuvFormat("yuvj444p", 8, 0, 0, True),
    YuvFormat("yuv420p10le", 10, 1, 1, False), YuvFormat("yuv422p10le", 10, 1, 0, False),
    YuvFormat("yuv444p10le", 10, 0, 0, False),
)}


def yuv_format(fmt) -> YuvFormat:
    """``fmt`` (a YuvFormat or libav's name) as a YuvFormat of ``FORMATS``;
    ``ValueError`` naming the format and the set for any other."""
    if isinstance(fmt, YuvFormat):
        return fmt
    if fmt not in FORMATS:
        raise ValueError(f"the card converts {', '.join(FORMATS)}, not {fmt}")
    return FORMATS[fmt]


def route(fmt, h: int, w: int) -> str:
    """The path of the reference's swscale call for an h x w frame of
    ``fmt``: "unscaled" where swscale takes its special converter
    (``ff_get_unscaled_swscale``: 8-bit 4:2:0 or 4:2:2 and an even height),
    "scaled" (its generic scaler) for the rest."""
    fmt = yuv_format(fmt)
    return "unscaled" if fmt.depth == 8 and fmt.sx == 1 and h % 2 == 0 else "scaled"


# ff_yuv2rgb_coeffs[SWS_CS_ITU601]: swscale's default (sws_getContext sets no
# other, and the reference calls no sws_setColorspaceDetails)
_INV_TABLE_601 = (104597, 132201, 25675, 53279)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _round_to_int16(f: int) -> int:
    """libswscale's roundToInt16 of a 16.16 value, read back as int16."""
    return max(-0x8000, min(0x7FFF, (f + (1 << 15)) >> 16))


@dataclass(frozen=True)
class Coefficients:
    """ff_yuv2rgb_c_init_tables' numbers for one range (BT.601, default
    brightness, contrast and saturation). The special converter's 16-bit
    fixed point: ``y_coeff``, ``y_offset`` and the four chroma coefficients
    (``vr``, ``ug``, ``vg``, ``ub``), 2^13 scale, as ``nv12_to_rgb24``'s.
    The generic scaler's full-chroma output (yuv2rgb_write_full): the same
    coefficients with ``full_y_offset`` (2^9 scale). Its table output
    (yuv2rgb_1's lookups into the 24-bit tables): ``table(i) =
    clip(((table_base + i) * cy - table_k + 0x8000) >> 16)``, and each
    chroma sample moves the index by ``(c * inc >> 16) - (inc >> 9)`` with
    ``inc`` one of ``t_vr``, ``t_ug``, ``t_vg``, ``t_ub``."""

    y_coeff: int
    y_offset: int
    vr: int
    ug: int
    vg: int
    ub: int
    full_y_offset: int
    cy: int
    table_base: int
    table_k: int
    t_vr: int
    t_ug: int
    t_vg: int
    t_ub: int


def coefficients(full_range: bool) -> Coefficients:
    crv, cbu, cgu, cgv = (_INV_TABLE_601[0], _INV_TABLE_601[1], -_INV_TABLE_601[2],
                          -_INV_TABLE_601[3])
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu, cgu, cgv = (_cdiv(c * 224, 255) for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = _cdiv(cy * 255, 219), 16 << 16

    def table_inc(c):  # the chroma coefficients in units of the luma table's steps
        return _cdiv(c * (1 << 16) + 0x8000, cy)

    return Coefficients(
        y_coeff=_round_to_int16(cy << 13), y_offset=_round_to_int16(oy << 3),
        vr=_round_to_int16(crv << 13), ug=_round_to_int16(cgu << 13),
        vg=_round_to_int16(cgv << 13), ub=_round_to_int16(cbu << 13),
        full_y_offset=_round_to_int16(oy << 9), cy=cy,
        table_base=384 if full_range else 326, table_k=(384 << 16) + oy,
        t_vr=table_inc(crv), t_ug=table_inc(cgu), t_vg=table_inc(cgv), t_ub=table_inc(cbu))


COEFFICIENTS = {False: coefficients(False), True: coefficients(True)}


def _check_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, fmt: YuvFormat,
               name: str) -> tuple:
    for plane in (y, u, v):
        if plane.dtype != fmt.dtype:
            raise TypeError(f"{name}: {fmt.name} planes are {fmt.dtype}, got {plane.dtype}")
        if plane.dim() != 2:
            raise ValueError(f"{name}: each plane is (rows, columns), got {tuple(plane.shape)}")
    h, w = y.shape
    if h == 0 or w == 0:
        raise ValueError(f"{name}: an empty frame ({h}x{w})")
    want = fmt.chroma_shape(h, w)
    if tuple(u.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"{name}: U and V of a {h}x{w} {fmt.name} frame are {want}, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    return h, w


def _chroma_up(c: torch.Tensor, fmt: YuvFormat, h: int, w: int) -> torch.Tensor:
    """Each chroma sample repeated over the pixels it covers."""
    return c.repeat_interleave(1 << fmt.sy, 0)[:h].repeat_interleave(1 << fmt.sx, 1)[:, :w]


def yuv_unscaled_to_rgb24_torch(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                                fmt) -> torch.Tensor:
    """Plain PyTorch version of swscale's special converter: planar 8-bit
    4:2:0 or 4:2:2 (either range) with an even height -> (H, W, 3) uint8.

    For such a same-size call swscale runs ``ff_yuv2rgb_get_func_ptr``'s
    converter, on x86 with SSSE3 libswscale 6.7's ``yuv420_rgb24_ssse3``
    (4:2:2 through the same loop, one chroma row a row): one chroma sample
    for each 2 pixels across (and 2 rows down in 4:2:0) with no
    interpolation, in ``nv12_to_rgb24_torch``'s 16-bit fixed point with the
    range's coefficients (``COEFFICIENTS``; full range: Y' = y, R = Y' +
    (Cr * 11485 >> 16) and so on). Any width; the chroma of an odd width's
    last pixel is its own sample (the plane is rounded up). Equal to that
    converter on all 2^24 (y, u, v) of each format. Where a width w > 16
    has w % 16 in 1..7 the converter leaves the last w % 16 pixels of each
    row unwritten (its vectors cover 16 pixels of a width rounded down to
    8); this version converts them as the others."""
    fmt = yuv_format(fmt)
    h, w = _check_yuv(y, u, v, fmt, "yuv_unscaled_to_rgb24_torch")
    if route(fmt, h, w) != "unscaled":
        raise ValueError(f"yuv_unscaled_to_rgb24_torch: swscale converts a {h}x{w} {fmt.name} "
                         "frame with its generic scaler (yuv_scaled_to_rgb24_torch)")
    k = COEFFICIENTS[fmt.full_range]
    luma = (((y.to(torch.int32) << 3) - k.y_offset) * k.y_coeff) >> 16
    cb = (u.to(torch.int32) << 3) - C_OFFSET
    cr = (v.to(torch.int32) << 3) - C_OFFSET
    chroma = torch.stack([(cr * k.vr) >> 16, ((cb * k.ug) >> 16) + ((cr * k.vg) >> 16),
                          (cb * k.ub) >> 16], dim=-1)
    return (luma[..., None] + _chroma_up(chroma, fmt, h, w)).clamp_(0, 255).to(torch.uint8)


def _bilinear_filter(xinc: int, src_w: int, dst_w: int, one: int, src_pos: int,
                     dst_pos: int, align: int) -> tuple:
    """libswscale 6.7's initFilter for SWS_BILINEAR with no source or
    destination vectors, on x86: per output sample its first source sample
    and its taps, normalised to ``one``. (positions, [taps])."""
    fone = 1 << (54 - min(max((src_w // dst_w).bit_length() - 1, 0), 8))
    if abs(xinc - 0x10000) < 10 and src_pos == dst_pos:  # unscaled
        size, taps, pos = 1, [[fone] for _ in range(dst_w)], list(range(dst_w))
    else:
        size = 3 if xinc <= 1 << 16 else 1 + _cdiv(2 * src_w + dst_w - 1, dst_w)
        size = max(min(size, src_w - 2), 1)
        taps, pos = [], []
        at = ((dst_pos * xinc) >> 7) - ((src_pos * 0x10000) >> 7)
        for _ in range(dst_w):
            xx = _cdiv(at - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for _ in range(size):
                d = abs(xx * (1 << 17) - at) << 13
                if xinc > 1 << 16:
                    d = _cdiv(d * dst_w, src_w)
                row.append(max((1 << 30) - d, 0) * (fone >> 30))
                xx += 1
            taps.append(row)
            at += 2 * xinc
    # reduce: drop near-zero taps on the left (keeping positions
    # monotonic) and count those on the right
    cutoff_at = 0.002 * fone
    min_size = 0
    for i in range(dst_w - 1, -1, -1):
        row, n, cut = taps[i], size, 0
        for _ in range(size):
            cut += abs(row[0])
            if cut > cutoff_at or (i < dst_w - 1 and pos[i] >= pos[i + 1]):
                break
            row[:] = row[1:] + [0]
            pos[i] += 1
        cut = 0
        for j in range(size - 1, 0, -1):
            cut += abs(row[j])
            if cut > cutoff_at:
                break
            n -= 1
        min_size = max(min_size, n)
    if min_size == 1 and align == 2:  # the MMX special case of an unscaled vertical filter
        align = 1
    out_size = (min_size + align - 1) & ~(align - 1)
    taps = [(row + [0] * out_size)[:out_size] for row in taps]
    for i, row in enumerate(taps):  # the borders
        if pos[i] < 0:
            for j in range(1, out_size):
                left = max(j + pos[i], 0)
                row[left] += row[j]
                row[j] = 0
            pos[i] = 0
        if pos[i] + out_size > src_w:
            shift = pos[i] + min(out_size - src_w, 0)
            acc = 0
            for j in range(out_size - 1, -1, -1):
                if pos[i] + j >= src_w:
                    acc += row[j]
                    row[j] = 0
            for j in range(out_size - 1, -1, -1):
                row[j] = 0 if j < shift else row[j - shift]
            pos[i] -= shift
            row[src_w - 1 - pos[i]] += acc
    normalised = []
    for row in taps:  # normalise to ``one``, carrying each tap's rounding error on
        total = max((sum(row) + one // 2) // one, 1)
        err, out = 0, []
        for c in row:
            c += err
            q = (c + total // 2) // total if c >= 0 else -((-c + total // 2) // total)
            out.append(q)
            err = c - q * total
        normalised.append(out)
    return pos, normalised


def _chroma_pos(sub: int) -> int:
    """get_local_pos of swscale's default chroma position (-513)."""
    return (((128 << sub) - 128) + 128) >> sub


@dataclass(frozen=True)
class ScaledPlan:
    """What swscale's generic scaler does to the chroma of an h x w frame,
    as the tables the plain version and the kernel share.

    ``full_chroma``: one chroma value per pixel (SWS_FULL_CHR_H_INT, which
    swscale forces for 4:4:4 input and for an odd width) and the
    full-chroma output; else one per 2 pixels across and the table output.
    ``columns``: chroma values per row of the output. ``hpos``/``hcoef``:
    the horizontal chroma filter where it interpolates (an odd width of
    4:2:x), per output column the first source column and its two 14-bit
    taps; None where it is the identity. ``rows``: per output row the two
    chroma rows that the vertical step sums (yuv2packed1: the filter's row
    alone, doubled, where the second tap is below 2048 of 4096, else the
    two rows the filter spans, each once)."""

    full_chroma: bool
    columns: int
    hpos: tuple | None
    hcoef: tuple | None
    rows: tuple


@lru_cache(maxsize=32)
def scaled_plan(fmt, h: int, w: int) -> ScaledPlan:
    fmt = yuv_format(fmt)
    ch, cw = fmt.chroma_shape(h, w)
    full = (fmt.sx == 0 and fmt.sy == 0) or w % 2 == 1
    dst_sx = 0 if full else 1
    cols = -(-w >> dst_sx)
    xinc = ((cw << 16) + (cols >> 1)) // cols
    pos, taps = _bilinear_filter(xinc, cw, cols, 1 << 14, _chroma_pos(fmt.sx),
                                 _chroma_pos(dst_sx), 4)
    hpos, hcoef = [], []
    for p, t in zip(pos, taps):  # at most two adjacent taps (the borders move them)
        nz = [j for j, c in enumerate(t) if c]
        if nz[-1] - nz[0] > 1:
            raise NotImplementedError(f"a horizontal chroma filter of {t} ({h}x{w})")
        hpos.append(p + nz[0])
        hcoef.append((t[nz[0]], t[nz[0] + 1] if nz[0] + 1 < len(t) else 0))
    if hpos == list(range(cols)) and all(c == (1 << 14, 0) for c in hcoef):
        hpos = hcoef = None  # the identity
    else:
        hpos, hcoef = tuple(hpos), tuple(hcoef)
    yinc = ((ch << 16) + (h >> 1)) // h
    pos, taps = _bilinear_filter(yinc, ch, h, 1 << 12, _chroma_pos(fmt.sy), _chroma_pos(0), 2)
    rows = []
    for p, t in zip(pos, taps):
        if len(t) == 1:
            rows.append((p, p))
        elif len(t) == 2 and t[0] + t[1] == 1 << 12 and 0 <= t[1]:
            rows.append((p, p + 1) if t[1] >= 2048 else (p, p))
        else:  # yuv2packedX's general filter: not reached at the same size
            raise NotImplementedError(f"a vertical chroma filter of {t} ({h}x{w})")
    return ScaledPlan(full, cols, hpos, hcoef, tuple(rows))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 that C's unsigned arithmetic leaves."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def yuv_scaled_to_rgb24_torch(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                              fmt) -> torch.Tensor:
    """Plain PyTorch version of swscale's generic scaler at the same size,
    SWS_BILINEAR, to RGB24: 10-bit, 4:4:4, and 8-bit 4:2:0 or 4:2:2 with an
    odd height (the frames ``route`` calls "scaled"), any size.

    libswscale 6.7's steps, in its integers: (1) the horizontal scaler
    makes 15-bit samples (hScale8To15 / hScale16To15: the 14-bit taps'
    sum >> 7 for 8-bit input, >> 9 for 10-bit, at most 32767): luma and
    4:4:4 chroma through the identity, the chroma of an odd width of 4:2:x
    through ``scaled_plan``'s bilinear taps; (2) the vertical step of
    yuv2packed1 (the luma's filter is the identity): each output row's
    chroma is its filter's row alone or the two rows it spans summed
    (``ScaledPlan.rows``), so 4:2:0's 3/4 and 1/4 rows are not weighted;
    (3) the output. With 4:2:x chroma and an even width, yuv2rgb24_1: Y =
    (Y15 + 64) >> 7, U and V the summed rows + 128 >> 8 (8-bit values,
    10-bit input rounded), each of R, G and B one lookup in the C
    converter's luma table moved by the chroma (``Coefficients``); with
    full chroma, yuv2rgb24_full_1: ((Y15 * 4 - offset) * y_coeff + 2^21 +
    V * vr ...) in C's wrapping 32-bit arithmetic, clipped to 30 bits (a
    sum that wraps negative clips to 0), >> 22. Equal to swscale on every
    (y, u, v) of the 8-bit formats and on seeded 10-bit samples."""
    fmt = yuv_format(fmt)
    h, w = _check_yuv(y, u, v, fmt, "yuv_scaled_to_rgb24_torch")
    plan = scaled_plan(fmt, h, w)
    k = COEFFICIENTS[fmt.full_range]
    shift = 7 if fmt.depth == 8 else 9
    dev = y.device
    rows = torch.tensor(plan.rows, dtype=torch.long, device=dev)

    def chroma(c: torch.Tensor) -> torch.Tensor:  # (h, columns): two 15-bit rows summed
        c = c.to(torch.int32)
        if plan.hpos is None:
            c15 = (c << 14) >> shift
        else:
            first = torch.tensor(plan.hpos, dtype=torch.long, device=dev)
            taps = torch.tensor(plan.hcoef, dtype=torch.int32, device=dev)
            second = (first + 1).clamp_max(c.shape[1] - 1)
            c15 = ((c[:, first] * taps[:, 0] + c[:, second] * taps[:, 1]) >> shift).clamp_max(32767)
        return c15[rows[:, 0]] + c15[rows[:, 1]]

    y15 = (y.to(torch.int32) << 14) >> shift
    us, vs = chroma(u), chroma(v)
    if not plan.full_chroma:
        y8 = (y15 + 64) >> 7
        uc = ((us + 128) >> 8).clamp(0, 255).repeat_interleave(2, 1)[:, :w]
        vc = ((vs + 128) >> 8).clamp(0, 255).repeat_interleave(2, 1)[:, :w]

        def shifted(c, inc):
            return ((c * inc) >> 16) - (inc >> 9)

        def table(i):
            return (((k.table_base + i) * k.cy - k.table_k + 0x8000) >> 16).clamp_(0, 255)

        out = torch.stack([table(y8 + shifted(vc, k.t_vr)),
                           table(y8 + shifted(uc, k.t_ug) + shifted(vc, k.t_vg)),
                           table(y8 + shifted(uc, k.t_ub))], dim=-1)
        return out.to(torch.uint8)
    luma = (y15.to(torch.int64) * 4 - k.full_y_offset) * k.y_coeff + (1 << 21)
    uf = (us.to(torch.int64) - (128 << 8)) * 2
    vf = (vs.to(torch.int64) - (128 << 8)) * 2
    out = torch.stack([_wrap32(luma + vf * k.vr),
                       _wrap32(luma + vf * k.vg + uf * k.ug),
                       _wrap32(luma + uf * k.ub)], dim=-1)
    return (out.clamp_(0, (1 << 30) - 1) >> 22).to(torch.uint8)


def yuv_to_rgb24_torch(planes, fmt) -> torch.Tensor:
    """The plain version of ``route``'s path for ``planes`` (Y, U, V)."""
    y, u, v = planes
    fmt = yuv_format(fmt)
    if route(fmt, *y.shape) == "unscaled":
        return yuv_unscaled_to_rgb24_torch(y, u, v, fmt)
    return yuv_scaled_to_rgb24_torch(y, u, v, fmt)


def _check_device_planes(planes, fmt: YuvFormat, name: str) -> tuple:
    y, u, v = planes
    if y.device.type != "cuda" or u.device != y.device or v.device != y.device:
        raise ValueError(f"{name}: the planes lie on {y.device}, {u.device} and {v.device}; the "
                         "kernel takes all three on one CUDA device")
    h, w = _check_yuv(y, u, v, fmt, name)
    for plane, width in ((y, w), (u, u.shape[1]), (v, v.shape[1])):
        if plane.stride(1) != 1:
            raise ValueError(f"{name}: the kernel takes planes whose rows are contiguous")
        if plane.stride(0) < width:
            raise ValueError(f"{name}: a row pitch of {plane.stride(0)} is shorter than the "
                             f"row's {width} samples")
    return h, w


@lru_cache(maxsize=1)
def _unscaled_kernel():
    """The C entry point ``gtx_yuv_rgb24`` (library built and loaded once)."""
    fn = _cuda.load(UNSCALED_KERNEL).gtx_yuv_rgb24
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _scaled_kernel():
    """The C entry point ``gtx_yuv_scaled_rgb24`` (library built and loaded once)."""
    fn = _cuda.load(SCALED_KERNEL).gtx_yuv_scaled_rgb24
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_unscaled(verbose: bool = False) -> tuple:
    """Compile ``csrc/yuv_rgb24.cu`` (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(UNSCALED_KERNEL, verbose=verbose)


def build_scaled(verbose: bool = False) -> tuple:
    """Compile ``csrc/yuv_scaled_rgb24.cu``; returns (path, log)."""
    return _cuda.build(SCALED_KERNEL, verbose=verbose)


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def yuv_unscaled_to_rgb24(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          fmt) -> torch.Tensor:
    """Planar 8-bit 4:2:0 / 4:2:2 with an even height -> (H, W, 3) uint8 RGB,
    as ``yuv_unscaled_to_rgb24_torch``. CPU tensors run the plain version;
    CUDA tensors launch ``csrc/yuv_rgb24.cu`` on the current stream (one
    launch a frame) or raise. Each plane's rows may lie at any pitch.
    ``yuv_unscaled_to_rgb24.launches`` counts the kernel launches."""
    fmt = yuv_format(fmt)
    if all(p.device.type == "cpu" for p in (y, u, v)):
        return yuv_unscaled_to_rgb24_torch(y, u, v, fmt)
    h, w = _check_device_planes((y, u, v), fmt, "yuv_unscaled_to_rgb24")
    if route(fmt, h, w) != "unscaled":
        raise ValueError(f"yuv_unscaled_to_rgb24: swscale converts a {h}x{w} {fmt.name} frame "
                         "with its generic scaler (yuv_scaled_to_rgb24)")
    k = COEFFICIENTS[fmt.full_range]
    coeffs = (ctypes.c_int * 6)(k.y_coeff, k.y_offset, k.vr, k.ug, k.vg, k.ub)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    kernel = _unscaled_kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = kernel(y.data_ptr(), y.stride(0), u.data_ptr(), u.stride(0), v.data_ptr(),
                    v.stride(0), out.data_ptr(), h, w, fmt.sy, coeffs, stream)
    _launch(UNSCALED_KERNEL, rc)
    yuv_unscaled_to_rgb24.launches += 1
    return out


yuv_unscaled_to_rgb24.launches = 0


@lru_cache(maxsize=32)
def _device_plan(fmt: YuvFormat, h: int, w: int, device: str) -> tuple:
    """``scaled_plan``'s tables on ``device`` (uploaded once a geometry):
    (rows (h, 2) int32, hpos (columns,) int32 or None, hcoef (columns, 2)
    int16 or None)."""
    plan = scaled_plan(fmt, h, w)
    rows = torch.tensor(plan.rows, dtype=torch.int32).to(device)
    if plan.hpos is None:
        return rows, None, None
    return (rows, torch.tensor(plan.hpos, dtype=torch.int32).to(device),
            torch.tensor(plan.hcoef, dtype=torch.int16).to(device))


def yuv_scaled_to_rgb24(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        fmt) -> torch.Tensor:
    """Planar Y, U, V of any format and size -> (H, W, 3) uint8 RGB through
    swscale's generic scaler, as ``yuv_scaled_to_rgb24_torch``. CPU tensors
    run the plain version; CUDA tensors launch ``csrc/yuv_scaled_rgb24.cu``
    on the current stream (one launch a frame; the plan's tables go to the
    card once a geometry) or raise. Each plane's rows may lie at any pitch;
    U and V share one. ``yuv_scaled_to_rgb24.launches`` counts the kernel
    launches."""
    fmt = yuv_format(fmt)
    if all(p.device.type == "cpu" for p in (y, u, v)):
        return yuv_scaled_to_rgb24_torch(y, u, v, fmt)
    h, w = _check_device_planes((y, u, v), fmt, "yuv_scaled_to_rgb24")
    if u.stride(0) != v.stride(0):
        raise ValueError(f"yuv_scaled_to_rgb24: U and V share one row pitch, got "
                         f"{u.stride(0)} and {v.stride(0)}")
    plan = scaled_plan(fmt, h, w)
    rows, hpos, hcoef = _device_plan(fmt, h, w, str(y.device))
    ch, cw = fmt.chroma_shape(h, w)
    k = COEFFICIENTS[fmt.full_range]
    prm = (ctypes.c_int * 18)(h, w, cw, ch, 7 if fmt.depth == 8 else 9, k.table_base, k.cy,
                              k.table_k, k.t_vr, k.t_ug, k.t_vg, k.t_ub, k.full_y_offset,
                              k.y_coeff, k.vr, k.ug, k.vg, k.ub)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    kernel = _scaled_kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = kernel(y.data_ptr(), y.stride(0), u.data_ptr(), v.data_ptr(), u.stride(0),
                    fmt.sample_bytes, int(plan.full_chroma),
                    None if hpos is None else hpos.data_ptr(),
                    None if hcoef is None else hcoef.data_ptr(), rows.data_ptr(),
                    out.data_ptr(), prm, stream)
    _launch(SCALED_KERNEL, rc)
    yuv_scaled_to_rgb24.launches += 1
    return out


yuv_scaled_to_rgb24.launches = 0


def yuv_to_rgb24(planes, fmt) -> torch.Tensor:
    """Planar (Y, U, V) of a format of ``FORMATS`` -> (H, W, 3) uint8 RGB,
    equal to the reference decoder's swscale call: ``route``'s launcher
    (``yuv_unscaled_to_rgb24`` or ``yuv_scaled_to_rgb24``). CPU tensors run
    the plain versions, CUDA tensors launch the kernels, anything else
    raises. 8-bit planes are uint8, 10-bit ones int16."""
    y, u, v = planes
    fmt = yuv_format(fmt)
    for plane in (y, u, v):
        if plane.device.type not in ("cpu", "cuda"):
            raise ValueError(f"yuv_to_rgb24: planes on {plane.device}; the CPU runs the plain "
                             "versions and a CUDA device the kernels")
    if y.dim() != 2:
        raise ValueError(f"yuv_to_rgb24: Y is (rows, columns), got {tuple(y.shape)}")
    if route(fmt, *y.shape) == "unscaled":
        return yuv_unscaled_to_rgb24(y, u, v, fmt)
    return yuv_scaled_to_rgb24(y, u, v, fmt)
