"""PNG reading and writing with `zlib` and numpy (the port needs no cv2),
and `read_color_frame`, which reads a PROX Color frame as PNG or JPEG
(`data.jpeg`).

Reads non-interlaced grayscale (8- and 16-bit), grayscale+alpha, RGB and
RGBA images with any of the five row filters; rows are unfiltered with
whole-row numpy operations (None, Up, and Sub as a running sum per byte
lane), and Average/Paeth rows, which depend on the pixel to their left,
byte by byte. Samples come back as the file stores them: uint8 or uint16
(big-endian on disk), [H, W] for grayscale, [H, W, C] otherwise, channels
in the file's order (RGB, where cv2 would give BGR).

Writes the same types, one filter for every row (None by default).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from lemo_tpu_torch.data.jpeg import is_jpeg_path, jpeg_header, read_jpeg

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    ftypes = data[:, 0]
    if not ftypes.any():                  # every row unfiltered
        return data[:, 1:].copy()
    rows = data[:, 1:].astype(np.int64)
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f = int(ftypes[y])
        line = rows[y]
        if f == 0:
            cur = line.copy()
        elif f == 1:
            cur = np.empty(stride, np.int64)
            for lane in range(bpp):
                cur[lane::bpp] = np.cumsum(line[lane::bpp]) % 256
        elif f == 2:
            cur = (line + prev) % 256
        elif f in (3, 4):
            cur = line.copy()
            up = prev.tolist()
            vals = cur.tolist()
            for x in range(stride):
                left = vals[x - bpp] if x >= bpp else 0
                if f == 3:
                    pred = (left + up[x]) >> 1
                else:
                    ul = up[x - bpp] if x >= bpp else 0
                    pred = _paeth(left, up[x], ul)
                vals[x] = (vals[x] + pred) % 256
            cur = np.asarray(vals, np.int64)
        else:
            raise ValueError(f"PNG: unknown row filter {f}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file into a numpy array (see the module docstring)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path} is not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG colour type {ctype}, depth {depth}, "
                         f"interlace {interlace} is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = img.reshape(h, w * ch, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def _filter(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    if ftype == 0:
        return rows
    r = rows.astype(np.int64)
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    ul = np.zeros_like(r)
    ul[1:, bpp:] = r[:-1, :-bpp]
    if ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    else:
        raise ValueError(f"PNG: unknown row filter {ftype}")
    return ((r - pred) % 256).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0,
              level: int = 6) -> None:
    """Encode uint8/uint16 [H, W] (grayscale) or [H, W, 3|4] (RGB/RGBA)
    with one row filter (0-4) for every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG: dtype {img.dtype} is not uint8/uint16")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    if depth == 16:
        be = img.astype(">u2").reshape(h, w * ch)
        rows = np.frombuffer(be.tobytes(), np.uint8).reshape(h, w * ch * 2)
    else:
        rows = img.reshape(h, w * ch)
    bpp = ch * depth // 8
    filtered = _filter(rows, bpp, filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), filtered],
                         axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(_SIG)
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                            0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        fh.write(chunk(b"IEND", b""))


def check_color_frames(color_dir: str) -> None:
    """Raise when `color_dir` holds a JPEG Color frame that
    `read_color_frame` cannot decode (progressive, lossless, arithmetic
    coded, 12-bit, 4 components: `data.jpeg.jpeg_header`), naming the
    frame and the marker: a run that renders over the Color frames calls
    this before its work, so that it refuses them up front and not after
    its fits. Each `.jpg` frame's markers up to its first scan are read
    (the callers look for `<frame>.jpg`, then `<frame>.png`). A missing
    folder passes (a frame without a Color image is skipped)."""
    if not os.path.isdir(color_dir):
        return
    for f in sorted(os.listdir(color_dir)):
        if not f.endswith(".jpg"):
            continue
        path = os.path.join(color_dir, f)
        what = jpeg_header(path).unsupported
        if what:
            raise ValueError(f"{path}: JPEG Color frame with {what}, which "
                             "the port's decoder does not take (baseline "
                             "and extended sequential Huffman, 8-bit, 1 or 3 "
                             "components); re-encode the frames as baseline "
                             "JPEG or PNG")


def read_color_frame(path: str) -> np.ndarray:
    """A Color frame as uint8 RGB [H, W, 3]: the pixels that
    `cv2.imread(path)[:, :, ::-1]` gives. A PNG: grayscale repeated into
    three channels, alpha dropped, 16-bit samples divided by 256 and
    rounded half to even. A JPEG (`.jpg`, `.jpeg`): `data.jpeg.read_jpeg`,
    the port's host decoder, bit for bit what cv2's libjpeg-turbo gives,
    the EXIF orientation applied."""
    if is_jpeg_path(path):
        return read_jpeg(path)
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: a Color frame must be PNG or JPEG")
    img = read_png(path)
    if img.dtype == np.uint16:
        img = np.clip(np.rint(img / 256.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])
