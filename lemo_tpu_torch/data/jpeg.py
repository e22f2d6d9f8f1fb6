"""JPEG decoding on the host (the port needs no cv2).

Real PROX recordings ship their Color frames as `Color/<frame>.jpg`, which
`lemo_tpu` reads with `cv2.imread(path)[:, :, ::-1]`. The port decodes
them with its own library, `csrc/jpeg_cpu.cpp`, built at first use with
the host C++ compiler into `lemo_tpu_torch/_build/`
(`_build.build_host_library`) and bound with ctypes; a failed build
raises with the compiler's message, and no call gives way to numpy.

- `read_jpeg(path)`: uint8 RGB [H, W, 3], the pixels cv2 gives, bit for
  bit: libjpeg-turbo's ISLOW integer IDCT, fancy upsampling and
  fixed-point YCbCr -> RGB tables (the library's header comment), a
  grayscale image repeated into three channels, and the EXIF orientation
  applied as cv2 applies it.
- `jpeg_imread(data, flags)`: `cv2.imread` in each of its three modes
  (`data.png.imread` dispatches a JPEG here): IMREAD_COLOR, BGR [H, W, 3],
  oriented; IMREAD_GRAYSCALE, [H, W], oriented (the Y component of a
  grayscale or YCbCr file, libjpeg's RGB -> Y weights for an RGB one);
  IMREAD_UNCHANGED, [H, W] for one component and BGR [H, W, 3] for three,
  in the stored orientation (cv2 applies none in that mode).
- `read_jpeg_plain(path)`, `decode_plain(data, channels)`: the same
  decode in numpy (Huffman decoding in Python, the IDCT, upsampling and
  colour conversion vectorised): the version the tests and
  `chip_smoke.py` hold the library to. Slow; for small images.
- `jpeg_header(path)`: the markers up to the first scan (and a
  progressive file's scan headers), and what the decoder refuses
  (`JpegHeader.unsupported`): lossless (SOF3), hierarchical (SOF5-7),
  arithmetic coding (SOF9-15, DAC), precision other than 8 bits,
  components other than 1 or 3, a height set by DNL, and a progressive
  file whose scans leave AC coefficients 1-9 of a component unrefined
  ("progressive scans incomplete": libjpeg-turbo smooths such blocks at
  output, which the port does not rebuild).

What is decoded: sequential (SOF0, SOF1) and progressive (SOF2) Huffman
JPEG, 1 or 3 components with integer sampling ratios (4:4:4, 4:2:2,
4:2:0, 4:4:0, 4:1:1), DQT and DHT anywhere before a scan, restart
intervals, several scans (progressive ones with spectral selection,
successive approximation and EOB runs), any image size.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct
from functools import lru_cache

import numpy as np

from lemo_tpu_torch import _build

JPEG_SOURCE = os.path.join(_build.CSRC, "jpeg_cpu.cpp")
EXTENSIONS = (".jpg", ".jpeg")
# cv2's imread flags, for `jpeg_imread` and `data.png.imread`
IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1
DECODED = ("sequential and progressive Huffman, 8-bit, 1 or 3 components, "
           "progressive scans complete")
# zigzag positions 0-9 in natural order: the coefficients whose unrefined
# bits make libjpeg-turbo smooth the blocks of a progressive file
SMOOTHED = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)

# zigzag index -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def is_jpeg_path(path: str) -> bool:
    return path.lower().endswith(EXTENSIONS)


# ---------------------------------------------------------------- markers


def _sof_refusal(m: int) -> str | None:
    """The name of a frame marker the decoder refuses, or None."""
    if m in (0xC0, 0xC1, 0xC2):
        return None
    arith = m >= 0xC9
    kind = {0: "sequential", 1: "sequential", 2: "progressive",
            3: "lossless"}[(m - 0xC0) & 3]
    if m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        kind = "hierarchical " + kind
    return (f"SOF{m - 0xC0} ({'arithmetic-coded ' if arith else ''}"
            f"{kind})")


def _exif_orientation(body: bytes) -> int | None:
    """Tag 274 (Orientation) of IFD0 of an APP1 "Exif" segment's TIFF
    data, or None."""
    if len(body) < 14 or body[:6] != b"Exif\x00\x00":
        return None
    return tiff_orientation(body[6:])


def tiff_orientation(tiff: bytes) -> int | None:
    """Tag 274 (Orientation) of IFD0 of TIFF-structured Exif data (an
    APP1 segment's after its "Exif" header, a PNG eXIf chunk's body), or
    None."""
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return None
    try:
        (off,) = struct.unpack(order + "I", tiff[4:8])
        (n,) = struct.unpack(order + "H", tiff[off:off + 2])
        for i in range(n):
            e = off + 2 + 12 * i
            tag, typ, count = struct.unpack(order + "HHI", tiff[e:e + 8])
            if tag == 0x0112 and typ == 3 and count >= 1:
                return struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
    except struct.error:
        return None
    return None


@dataclasses.dataclass
class JpegHeader:
    """What the markers before the first scan say. `unsupported` names
    the marker or property that the decoder refuses (None when it
    decodes the file); `orientation` is the EXIF tag's value (1 when
    absent); `scans` the (component ids, table selectors, Ss, Se, Ah,
    Al) of each scan header read (a progressive file's all, else its
    first)."""

    width: int = 0
    height: int = 0
    precision: int = 8
    sof: str = ""
    components: list = dataclasses.field(default_factory=list)
    restart_interval: int = 0
    jfif: bool = False
    adobe_transform: int | None = None
    orientation: int = 1
    unsupported: str | None = None
    scans: list = dataclasses.field(default_factory=list)

    @property
    def progressive(self) -> bool:
        return self.sof == "SOF2"


def _segments(data: bytes, start: int = 2):
    """Yield (marker, body, end) of each segment from `start` on (an
    SOS's body is its header; the entropy-coded data after it is
    skipped), up to EOI; standalone markers yield an empty body."""
    pos, n = start, len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return
        m = data[pos]
        pos += 1
        if m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if m == 0xD9:
            yield m, b"", pos
            return
        if pos + 2 > n:
            raise ValueError("JPEG: truncated segment")
        (ln,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + ln]
        if ln < 2 or len(body) != ln - 2:
            raise ValueError("JPEG: bad segment length")
        pos += ln
        yield m, body, pos


def _dqt(body: bytes) -> dict:
    """A DQT segment's tables: {table id: [8, 8] int64, natural order}."""
    out, k = {}, 0
    while k < len(body):
        pq, tq = body[k] >> 4, body[k] & 15
        k += 1
        if pq:
            vals = struct.unpack(">64H", body[k:k + 128])
            k += 128
        else:
            vals = list(body[k:k + 64])
            k += 64
        t = np.zeros(64, np.int64)
        t[NATURAL] = np.asarray(vals, np.int64)
        out[tq] = t.reshape(8, 8)
    return out


def _sos(body: bytes) -> tuple:
    """(component ids, table selectors, Ss, Se, Ah, Al) of an SOS header."""
    ns = body[0]
    ids = [body[1 + 2 * i] for i in range(ns)]
    tables = [body[2 + 2 * i] for i in range(ns)]
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    return ids, tables, ss, se, ahal >> 4, ahal & 15


def _incomplete(h: JpegHeader, quant: dict, scans: list) -> str | None:
    """libjpeg-turbo's smoothing_ok (jdcoefct.c) over a progressive
    file's scans: where its output pass would smooth the blocks (every
    component latched a quantization table, `quant`, with nonzero entries
    at zigzag 0-9 and had a DC scan, and some component's AC coefficient
    1-9 still has unknown bits), the refusal's text; else None."""
    known = {cid: [-1] * 64 for cid, _, _ in h.components}
    for ids, _, ss, se, _, al in scans:
        for cid in ids:
            if cid in known:
                known[cid][ss:se + 1] = [al] * (se + 1 - ss)
    short = []
    for cid, bits in known.items():
        q = quant.get(cid)
        if q is None or (q.reshape(-1)[list(SMOOTHED)] == 0).any() \
                or bits[0] < 0:
            return None
        if any(b != 0 for b in bits[1:10]):
            short.append(cid)
    if not short:
        return None
    return (f"progressive scans incomplete (AC coefficients 1-9 of "
            f"component{'s' * (len(short) > 1)} "
            f"{', '.join(map(str, short))} left unrefined, where "
            "libjpeg-turbo smooths the blocks)")


def _header_from(data: bytes, whole: bool = True) -> JpegHeader:
    """The header of the JPEG `data`; `whole`: `data` is the whole file,
    so that a progressive one's scan headers are all read (else they
    stop at the first)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    h = JpegHeader()
    tables, tq, quant = {}, {}, {}
    eoi = False
    for m, body, _ in _segments(data):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            h.sof = f"SOF{m - 0xC0}"
            if len(body) >= 6:
                h.precision = body[0]
                h.height, h.width = struct.unpack(">HH", body[1:5])
                nc = body[5]
                h.components = [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                 body[7 + 3 * i] & 15)
                                for i in range(nc) if 8 + 3 * i < len(body)]
                tq = {body[6 + 3 * i]: body[8 + 3 * i]
                      for i in range(nc) if 8 + 3 * i < len(body)}
            if h.unsupported is None:
                h.unsupported = _sof_refusal(m)
            if h.unsupported is None and h.precision != 8:
                h.unsupported = f"{h.precision}-bit precision ({h.sof})"
            if h.unsupported is None and len(h.components) not in (1, 3):
                h.unsupported = (f"{len(h.components)} components "
                                 f"({h.sof})")
            if h.unsupported is None and h.height == 0:
                h.unsupported = f"a height set by DNL ({h.sof})"
            if h.unsupported is None and any(
                    not 1 <= ch <= 4 or not 1 <= cv <= 4
                    or max(c[1] for c in h.components) % ch
                    or max(c[2] for c in h.components) % cv
                    for _, ch, cv in h.components):
                h.unsupported = f"fractional sampling ratios ({h.sof})"
        elif m == 0xCC and h.unsupported is None:
            h.unsupported = "DAC (arithmetic coding)"
        elif m == 0xDB:
            tables.update(_dqt(body))
        elif m == 0xDD and len(body) >= 2:
            (h.restart_interval,) = struct.unpack(">H", body[:2])
        elif m == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
            h.jfif = True
        elif m == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
            h.adobe_transform = body[11]
        elif m == 0xE1 and h.orientation == 1:
            o = _exif_orientation(body)
            if o is not None and 1 <= o <= 8:
                h.orientation = o
        elif m == 0xDA:
            scan = _sos(body)
            h.scans.append(scan)
            for cid in scan[0]:   # the table each component latches
                if cid not in quant and tq.get(cid) in tables:
                    quant[cid] = tables[tq[cid]]
            if not (whole and h.progressive and h.unsupported is None):
                break
        elif m == 0xD9:
            eoi = True
            break
    if not h.sof and h.unsupported is None:
        h.unsupported = "no frame (SOF) marker before the scan"
    if whole and h.progressive and h.unsupported is None:
        if not eoi:
            h.unsupported = "a progressive file without its EOI marker"
        else:
            h.unsupported = _incomplete(h, quant, h.scans)
    return h


def _read_head(path: str) -> bytes:
    """The file's bytes up to its first SOS header (the whole file when
    the headers are large)."""
    with open(path, "rb") as fh:
        data = fh.read(1 << 16)
        while True:
            try:
                for m, _, _ in _segments(data):
                    if m == 0xDA:
                        return data
            except ValueError:
                pass
            more = fh.read(1 << 20)
            if not more:
                return data
            data += more


def jpeg_header(path: str) -> JpegHeader:
    """Parse the markers of `path` up to its first scan, and a
    progressive file's scan headers to its end (see `JpegHeader`);
    raises ValueError, naming the file, on one that is no JPEG."""
    try:
        h = _header_from(_read_head(path), whole=False)
        if h.progressive and h.unsupported is None:
            with open(path, "rb") as fh:
                h = _header_from(fh.read())
        return h
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _refuse(path: str, h: JpegHeader) -> JpegHeader:
    if h.unsupported:
        raise ValueError(f"{path}: {h.unsupported} is not supported by the "
                         f"port's JPEG decoder ({DECODED})")
    return h


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation applied as cv2's `imread` applies it (flips
    and a transpose of the decoded [H, W] or [H, W, C] image)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------- library


@lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build_host_library(source=JPEG_SOURCE))
    lib.lemo_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.c_char_p, ctypes.c_int32]
    lib.lemo_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_char_p,
                                     ctypes.c_int32]
    lib.lemo_jpeg_dims.restype = ctypes.c_int
    lib.lemo_jpeg_decode.restype = ctypes.c_int
    return lib


def decode(data: bytes, channels: int = 3) -> np.ndarray:
    """The library's decode of a JPEG held in memory, in the file's
    stored orientation: uint8 RGB [H, W, 3] (`channels` 3) or grayscale
    [H, W] (1)."""
    lib = _load()
    err = ctypes.create_string_buffer(256)
    hwc = (ctypes.c_int32 * 3)()
    if lib.lemo_jpeg_dims(data, len(data), hwc, err, 256):
        raise ValueError(f"JPEG: {err.value.decode()}")
    out = np.empty((hwc[0], hwc[1], 3) if channels == 3 else
                   (hwc[0], hwc[1]), np.uint8)
    if lib.lemo_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                            channels, err, 256):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`cv2.imread(path)[:, :, ::-1]` for a JPEG the decoder takes:
    uint8 RGB [H, W, 3] through the host library."""
    with open(path, "rb") as fh:
        data = fh.read()
    h = _refuse(path, _header_from(data))
    try:
        img = decode(data, 3)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return apply_orientation(img, h.orientation)


def jpeg_imread(data: bytes, flags: int, name: str = "JPEG",
                plain: bool = False) -> np.ndarray:
    """`cv2.imread(path, flags)` of the JPEG `data` (see the module
    docstring) through the library, or through the numpy twin with
    `plain`."""
    if flags not in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR):
        raise ValueError(f"imread flags {flags}: not one of IMREAD_UNCHANGED, "
                         "IMREAD_GRAYSCALE, IMREAD_COLOR")
    h = _refuse(name, _header_from(data))
    gray = flags == IMREAD_GRAYSCALE or (flags == IMREAD_UNCHANGED
                                         and len(h.components) == 1)
    try:
        img = (decode_plain if plain else decode)(data, 1 if gray else 3)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if not gray:
        img = img[:, :, ::-1]
    if flags == IMREAD_UNCHANGED:
        return np.ascontiguousarray(img)
    return apply_orientation(img, h.orientation)


# ---------------------------------------------------------------- numpy twin


def _huff_table(counts, values) -> dict:
    """{(length, code): value} of a canonical Huffman table."""
    table, code, k = {}, 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            table[(ln, code)] = values[k]
            code += 1
            k += 1
        code <<= 1
    return table


class _Bits:
    """MSB-first bits of one restart interval's entropy-coded bytes
    (stuffing removed); zeros past the end, as libjpeg feeds them."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | (self.bits[self.pos] if self.pos < len(self.bits)
                            else 0)
            self.pos += 1
        return v

    def huff(self, table: dict) -> int:
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | self.get(1)
            v = table.get((ln, code))
            if v is not None:
                return v
        return 0


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _intervals(data: bytes, pos: int) -> tuple[list, int]:
    """The entropy-coded segment starting at `pos`, split at its RSTn
    markers and unstuffed; returns (intervals, position of the marker
    that ends the scan)."""
    out, cur, n = [], bytearray(), len(data)
    while pos < n:
        b = data[pos]
        if b != 0xFF:
            cur.append(b)
            pos += 1
            continue
        p = pos + 1
        while p < n and data[p] == 0xFF:
            p += 1
        if p < n and data[p] == 0x00:
            cur.append(0xFF)
            pos = p + 1
        elif p < n and 0xD0 <= data[p] <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            pos = p + 1
        else:
            break
    out.append(bytes(cur))
    return out, pos


_F = {k: int(v * 65536.0 + 0.5) for k, v in
      (("r", 1.40200), ("b", 1.77200), ("gr", 0.71414), ("gb", 0.34414),
       ("y_r", 0.29900), ("y_g", 0.58700), ("y_b", 0.11400))}


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's jpeg_idct_islow on [N, 8, 8] int coefficients
    (natural order) and the [8, 8] quantization table: [N, 8, 8] uint8.
    Its zero-AC shortcuts give the same values as the full formula."""
    c = {k: v for k, v in zip(
        ("0298", "0390", "0541", "0765", "0899", "1175", "1501", "1847",
         "1961", "2053", "2562", "3072"),
        (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819,
         20995, 25172))}

    def one_d(x, shift):
        # x [..., 8] along the transformed axis (last)
        z2, z3 = x[..., 2], x[..., 6]
        z1 = (z2 + z3) * c["0541"]
        tmp2 = z1 + z3 * -c["1847"]
        tmp3 = z1 + z2 * c["0765"]
        tmp0 = (x[..., 0] + x[..., 4]) << 13
        tmp1 = (x[..., 0] - x[..., 4]) << 13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, \
            tmp1 - tmp2
        o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * c["1175"]
        o0, o1, o2, o3 = (o0 * c["0298"], o1 * c["2053"], o2 * c["3072"],
                          o3 * c["1501"])
        z1, z2 = z1 * -c["0899"], z2 * -c["2562"]
        z3, z4 = z3 * -c["1961"] + z5, z4 * -c["0390"] + z5
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, \
            o3 + z1 + z4
        rnd = 1 << (shift - 1)
        outs = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                t13 - o0, t12 - o1, t11 - o2, t10 - o3]
        return np.stack([(v + rnd) >> shift for v in outs], axis=-1)

    x = coef.astype(np.int64) * q.astype(np.int64)
    ws = one_d(x.transpose(0, 2, 1), 11).transpose(0, 2, 1)   # columns
    out = one_d(ws, 18)                                       # rows
    idx = out & 1023
    return np.where(idx < 512, np.minimum(idx + 128, 255),
                    np.where(idx >= 896, idx - 896, 0)).astype(np.uint8)


def _upsample(plane: np.ndarray, dw: int, dh: int, hr: int, vr: int,
              W: int, H: int) -> np.ndarray:
    """jdsample.c on one component: [H, W] uint8 from its [>=dh, >=dw]
    plane."""
    p = plane[:dh, :dw].astype(np.int64)
    if hr == 1 and vr == 1:
        return plane[:H, :W]
    if hr == 2 and vr == 1 and dw > 2:          # h2v1_fancy_upsample
        o = np.empty((p.shape[0], 2 * dw), np.int64)
        o[:, 0] = p[:, 0]
        o[:, 1] = (p[:, 0] * 3 + p[:, 1] + 2) >> 2
        o[:, 2:-2:2] = (p[:, 1:-1] * 3 + p[:, :-2] + 1) >> 2
        o[:, 3:-2:2] = (p[:, 1:-1] * 3 + p[:, 2:] + 2) >> 2
        o[:, -2] = (p[:, -1] * 3 + p[:, -2] + 1) >> 2
        o[:, -1] = p[:, -1]
        return o[:H, :W].astype(np.uint8)
    rows = np.arange(dh)
    above = p[np.maximum(rows - 1, 0)]
    below = p[np.minimum(rows + 1, dh - 1)]
    if hr == 1 and vr == 2:                     # h1v2_fancy_upsample
        o = np.empty((2 * dh, dw), np.int64)
        o[0::2] = (p * 3 + above + 1) >> 2
        o[1::2] = (p * 3 + below + 2) >> 2
        return o[:H, :W].astype(np.uint8)
    if hr == 2 and vr == 2 and dw > 2:          # h2v2_fancy_upsample
        out = np.empty((2 * dh, 2 * dw), np.int64)
        for v, nb in ((0, above), (1, below)):
            t = p * 3 + nb
            o = out[v::2]
            o[:, 0] = (t[:, 0] * 4 + 8) >> 4
            o[:, 1] = (t[:, 0] * 3 + t[:, 1] + 7) >> 4
            o[:, 2:-2:2] = (t[:, 1:-1] * 3 + t[:, :-2] + 8) >> 4
            o[:, 3:-2:2] = (t[:, 1:-1] * 3 + t[:, 2:] + 7) >> 4
            o[:, -2] = (t[:, -1] * 3 + t[:, -2] + 8) >> 4
            o[:, -1] = (t[:, -1] * 4 + 7) >> 4
        return out[:H, :W].astype(np.uint8)
    ys, xs = np.arange(H) // vr, np.arange(W) // hr   # replication
    return plane[ys][:, xs]


def read_jpeg_plain(path: str) -> np.ndarray:
    """`read_jpeg` in numpy (see the module docstring)."""
    with open(path, "rb") as fh:
        data = fh.read()
    h = _refuse(path, _header_from(data))
    return apply_orientation(decode_plain(data, 3), h.orientation)


def decode_plain(data: bytes, channels: int = 3) -> np.ndarray:
    """`decode` in numpy: every scan into whole-image coefficient arrays
    (one [rows, columns, 64] array of blocks a component, natural order),
    then the IDCT with each component's latched table, upsampling and
    colour conversion."""
    h = _refuse("JPEG", _header_from(data))
    qt, dc, ac = {}, {}, {}
    comps, ri = [], 0
    frame = {}
    pos = 2
    while True:
        seg = next(_segments(data, pos), None)
        if seg is None:
            break
        m, body, pos = seg
        if m == 0xD9:
            break
        if m in (0xC0, 0xC1, 0xC2):
            nc = body[5]
            comps = [{"id": body[6 + 3 * i], "h": body[7 + 3 * i] >> 4,
                      "v": body[7 + 3 * i] & 15, "tq": body[8 + 3 * i]}
                     for i in range(nc)]
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            frame = {"hmax": hmax, "vmax": vmax, "progressive": m == 0xC2,
                     "mcux": -(-h.width // (8 * hmax)),
                     "mcuy": -(-h.height // (8 * vmax))}
            for c in comps:
                c["dw"] = -(-h.width * c["h"] // hmax)
                c["dh"] = -(-h.height * c["v"] // vmax)
                c["coef"] = np.zeros((frame["mcuy"] * c["v"],
                                      frame["mcux"] * c["h"], 64), np.int64)
                c["q"] = None
        elif m == 0xDB:
            qt.update(_dqt(body))
        elif m == 0xC4:
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = body[k + 1:k + 17]
                total = sum(counts)
                vals = body[k + 17:k + 17 + total]
                (ac if tc else dc)[th] = _huff_table(counts, vals)
                k += 17 + total
        elif m == 0xDD:
            (ri,) = struct.unpack(">H", body[:2])
        elif m == 0xDA:
            pos = _scan(data, body, pos, comps, frame, qt, dc, ac, ri)
    for c in comps:
        q = c["q"] if c["q"] is not None else np.zeros((8, 8), np.int64)
        by, bx = c["coef"].shape[:2]
        blocks = _idct_islow(c["coef"].reshape(-1, 8, 8), q)
        c["plane"] = blocks.reshape(by, bx, 8, 8).transpose(
            0, 2, 1, 3).reshape(by * 8, bx * 8)
    return _to_output(h, comps, frame["hmax"], frame["vmax"], channels)


def _block_sequential(bits, c, coef, dc, ac):
    s = bits.huff(dc[c["td"]])
    c["pred"] += _extend(bits.get(s), s) if s else 0
    coef[:] = 0
    coef[0] = c["pred"]
    k = 1
    while k < 64:
        rs = bits.huff(ac[c["ta"]])
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            coef[NATURAL[min(k, 63)]] = _extend(bits.get(s), s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break


def _ac_first(bits, table, coef, ss, se, al, eobrun) -> int:
    """One block of an AC first scan; returns the EOB run left."""
    if eobrun:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.huff(table)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            coef[NATURAL[min(k, 63)]] = _extend(bits.get(s), s) * (1 << al)
        elif r == 15:
            k += 15
        else:
            return (1 << r) + (bits.get(r) if r else 0) - 1
        k += 1
    return 0


def _ac_refine(bits, table, coef, ss, se, al, eobrun) -> int:
    """One block of an AC refine scan (jdphuff.c's decode_mcu_AC_refine);
    returns the EOB run left."""
    p1 = 1 << al

    def correct(pos):
        if bits.get(1) and not coef[pos] & p1:
            coef[pos] += p1 if coef[pos] >= 0 else -p1

    k = ss
    if eobrun == 0:
        while k <= se:
            rs = bits.huff(table)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.get(1) else -p1
            elif r != 15:
                eobrun = (1 << r) + (bits.get(r) if r else 0)
                break
            while k <= se:
                pos = NATURAL[k]
                if coef[pos]:
                    correct(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                coef[NATURAL[min(k, 63)]] = s
            k += 1
    if eobrun:
        for kk in range(k, se + 1):
            if coef[NATURAL[kk]]:
                correct(NATURAL[kk])
        eobrun -= 1
    return eobrun


def _scan(data, body, pos, comps, frame, qt, dc, ac, ri) -> int:
    """Decode one scan into the components' coefficients; returns the
    position after its entropy-coded data."""
    ids, sel, ss, se, ah, al = _sos(body)
    sc = []
    for cid, t in zip(ids, sel):
        c = next(c for c in comps if c["id"] == cid)
        c["td"], c["ta"] = t >> 4, t & 15
        if c["q"] is None:
            c["q"] = qt[c["tq"]]
        sc.append(c)
    intervals, end = _intervals(data, pos)
    if len(sc) == 1:
        c = sc[0]
        per_row = -(-c["dw"] // 8)
        units = [[(c, 0, 0)]]
        n_mcu = per_row * -(-c["dh"] // 8)
    else:
        per_row = frame["mcux"]
        units = [[(c, by, bx) for by in range(c["v"]) for bx in range(c["h"])]
                 for c in sc]
        n_mcu = frame["mcux"] * frame["mcuy"]
    per_interval = ri if ri else n_mcu
    eobrun = 0
    for m in range(n_mcu):
        if m % per_interval == 0:
            k = m // per_interval
            bits = _Bits(intervals[k] if k < len(intervals) else b"")
            eobrun = 0
            for c in sc:
                c["pred"] = 0
        my, mx = divmod(m, per_row)
        for unit in units:
            for c, by, bx in unit:
                if len(sc) == 1:
                    coef = c["coef"][my, mx]
                else:
                    coef = c["coef"][my * c["v"] + by, mx * c["h"] + bx]
                if not frame["progressive"]:
                    _block_sequential(bits, c, coef, dc, ac)
                elif ss == 0 and ah == 0:
                    s = bits.huff(dc[c["td"]])
                    c["pred"] += _extend(bits.get(s), s) if s else 0
                    coef[0] = c["pred"] * (1 << al)
                elif ss == 0:
                    coef[0] |= bits.get(1) << al
                elif ah == 0:
                    eobrun = _ac_first(bits, ac[c["ta"]], coef, ss, se, al,
                                       eobrun)
                else:
                    eobrun = _ac_refine(bits, ac[c["ta"]], coef, ss, se, al,
                                        eobrun)
    return end


def _to_output(h: JpegHeader, comps, hmax, vmax, channels) -> np.ndarray:
    H, W = h.height, h.width
    up = [_upsample(c["plane"], c["dw"], c["dh"], hmax // c["h"],
                    vmax // c["v"], W, H).astype(np.int64) for c in comps]
    if len(comps) == 1:
        if channels == 1:
            return up[0].astype(np.uint8)
        return np.repeat(up[0][:, :, None], 3, axis=2).astype(np.uint8)
    if h.jfif:
        rgb = False
    elif h.adobe_transform is not None:
        rgb = h.adobe_transform == 0
    else:
        rgb = [c["id"] for c in comps] == [82, 71, 66]
    if channels == 1:
        if not rgb:
            return up[0].astype(np.uint8)
        r, g, b = up
        y = (_F["y_r"] * r + _F["y_g"] * g + _F["y_b"] * b + 32768) >> 16
        return y.astype(np.uint8)
    if rgb:
        return np.stack(up, axis=-1).astype(np.uint8)
    y, cb, cr = up
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_F["r"] * x + 32768) >> 16
    cb_b = (_F["b"] * x + 32768) >> 16
    cr_g = -_F["gr"] * x
    cb_g = -_F["gb"] * x + 32768
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
