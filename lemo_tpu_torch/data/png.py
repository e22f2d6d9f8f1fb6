"""PNG reading and writing with `zlib` and numpy (the port needs no cv2),
the three `cv2.imread` modes that `lemo_tpu` reads frames with (`imread`,
PNG here and JPEG through `data.jpeg`), and `read_color_frame`, which
reads a PROX Color frame.

`decode_png` takes every PNG: colour types 0 (gray), 2 (RGB), 3
(palette), 4 (gray+alpha) and 6 (RGBA), bit depths 1, 2 and 4 (gray,
palette), 8 and 16, without or with Adam7 interlacing (each of the seven
passes unfiltered on its own), any of the five row filters (None, Up and
Sub with whole-row numpy operations, Average and Paeth byte by byte).
`read_png` gives its pixels in the file's channel order (a palette
expanded to RGB, or RGBA with tRNS; gray below 8 bits scaled to 8):
uint8 or uint16, [H, W] for gray, [H, W, C] otherwise.

`imread(path, flags)` gives what cv2 5.0.0 (its bundled libpng 1.6)
gives, in dtype, shape and bytes; each rule was pinned against cv2:

- IMREAD_UNCHANGED (-1; Depth frames): the file's depth (uint8, or
  uint16 at 16 bits); gray [H, W]; RGB as BGR; RGBA and gray+alpha as
  BGRA (gray repeated); a palette as BGR, BGRA when it has tRNS; RGB with
  tRNS as BGRA (alpha 0 where the pixel equals the tRNS colour, else the
  maximum); a gray tRNS ignored. The eXIf orientation is not applied.
- IMREAD_COLOR (1; Color frames): uint8 BGR [H, W, 3]; 16-bit samples
  truncated (`>> 8`, libpng's png_set_strip_16); alpha and tRNS dropped;
  gray repeated; the eXIf orientation applied as for a JPEG.
- IMREAD_GRAYSCALE (0; masks): uint8 [H, W], oriented like colour; gray
  and gray+alpha keep the gray sample (`>> 8` at 16 bits); RGB, RGBA and
  palette files go through libpng's png_do_rgb_to_gray with the weights
  cv2 sets (0.299, 0.587), which libpng keeps as 15-bit fixed point
  truncated: R 9797, G 19234, B 32768 - 9797 - 19234 = 3737. At 8 bits
  a pixel with R = G = B keeps R, any other gives
  `(9797 R + 19234 G + 3737 B) >> 15` (truncated); checked over all
  2**24 (R, G, B) triples of one 4096 x 4096 PNG, RGB and RGBA alike. At
  16 bits every pixel gives `((9797 R + 19234 G + 3737 B + 16384) >> 15)
  >> 8`. Where the file's gamma (a gAMA chunk, or 0.45455 for an sRGB
  chunk; libpng ignores cICP and an sRGB iCCP here) is significant
  (outside 0.95-1.05, or its reciprocal), libpng weights linearised
  samples instead: `from1[(9797 to1[R] + 19234 to1[G] + 3737 to1[B] +
  16384) >> 15]`, `to1`, `from1` its 8-bit tables (png_build_8bit_table:
  `floor(255 (i / 255) ** g + 0.5)` at g = 1 / gamma and gamma); checked
  on the full cube at gamma 0.45455 (gAMA and sRGB), 0.3 and 2.5. A
  16-bit colour file with such a gamma is refused in this mode.

PNG has no orientation of its own; cv2 reads an eXIf chunk's Orientation
tag, and the colour and grayscale modes apply it. Palette indices past
the PLTE chunk give black, as libpng's zero-filled palette does.

`write_png` writes 8- and 16-bit gray, RGB and RGBA, one filter for
every row (None by default).
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import zlib

import numpy as np

from lemo_tpu_torch.data.jpeg import (DECODED, IMREAD_COLOR, IMREAD_GRAYSCALE,
                                      IMREAD_UNCHANGED, apply_orientation,
                                      is_jpeg_path, jpeg_header, jpeg_imread,
                                      read_jpeg, tiff_orientation)

_SIG = b"\x89PNG\r\n\x1a\n"
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
# png_set_rgb_to_gray(png, 1, 0.299, 0.587) as libpng stores the weights:
# 15-bit fixed point, truncated, blue the remainder (9797, 19234, 3737)
_RC, _GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC
_SRGB_GAMMA = 45455


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


@dataclasses.dataclass
class PngFile:
    """A decoded PNG as the file stores it: `samples` [H, W, C] (uint8 at
    bit depths up to 8, the values unscaled, palette indices for colour
    type 3; uint16 at 16), channels in the file's order; `palette`
    [N, 3] uint8 (PLTE) or None; `trns` the tRNS chunk's body or None;
    `orientation` the eXIf chunk's Orientation tag (1 when absent);
    `gamma` the file gamma as libpng takes it from the chunks before the
    image data, in units of 1e-5 (an sRGB chunk: 45455; else the first
    gAMA chunk in libpng's range; 0 when neither)."""

    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: np.ndarray | None = None
    trns: bytes | None = None
    orientation: int = 1
    gamma: int = 0


def _unpack(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, row bytes] -> samples [h, w, ch]."""
    h = rows.shape[0]
    n = w * ch
    if depth == 16:
        b = rows[:, :2 * n].reshape(h, n, 2)
        out = (b[..., 0].astype(np.uint16) << 8) | b[..., 1]
    elif depth == 8:
        out = rows[:, :n]
    else:
        bits = np.unpackbits(rows, axis=1)[:, :n * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (bits.reshape(h, n, depth) * weights).sum(-1).astype(np.uint8)
    return out.reshape(h, w, ch)


def decode_png(data: bytes, name: str = "PNG") -> PngFile:
    """Parse and decompress a PNG held in memory (see `PngFile`): every
    colour type (0, 2, 3, 4, 6) at every bit depth it allows (1, 2, 4, 8,
    16), without or with Adam7 interlacing, each pass unfiltered on its
    own."""
    if data[:8] != _SIG:
        raise ValueError(f"{name} is not a PNG file")
    pos, ihdr, idat = 8, None, []
    palette = trns = None
    orientation, gamma, srgb = 1, 0, False
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3
                                                    ].reshape(-1, 3)
        elif kind == b"tRNS":
            trns = bytes(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            o = tiff_orientation(body)
            if o is not None and 1 <= o <= 8:
                orientation = o
        elif kind == b"gAMA" and not idat and not gamma and n == 4:
            (g,) = struct.unpack(">I", body)
            gamma = g if 16 <= g <= 625000000 else 0
        elif kind == b"sRGB" and not idat and n == 1:
            srgb = True
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth not in _DEPTHS.get(ctype, ()) or interlace not in (0, 1):
        raise ValueError(f"{name}: PNG colour type {ctype}, depth {depth}, "
                         f"interlace {interlace} is not a valid PNG")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    ch = PNG_CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue
        stride = -(-pw * ch * depth // 8)
        n = ph * (stride + 1)
        if off + n > len(raw):
            raise ValueError(f"{name}: PNG image data too short")
        rows = _unfilter(raw[off:off + n], ph, stride, bpp)
        off += n
        img[y0::dy, x0::dx] = _unpack(rows, pw, ch, depth)
    return PngFile(img, ctype, depth, palette, trns, orientation,
                   _SRGB_GAMMA if srgb else gamma)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file into a numpy array (see the module docstring)."""
    with open(path, "rb") as fh:
        f = decode_png(fh.read(), path)
    img = f.samples
    if f.color_type == 3 or f.bit_depth < 8:
        img = _expanded(f, alpha=True)[0]
    return img[..., 0] if img.shape[2] == 1 else img


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


# ---------------------------------------------------------------- cv2 reads


def _significant(g: int) -> bool:
    """libpng's png_gamma_significant (1e-5 units, threshold 0.05)."""
    return g < 95000 or g > 105000


def _reciprocal(g: int) -> int:
    return int(math.floor(1e10 / g + 0.5))


def _gamma_table(g: int) -> np.ndarray:
    """libpng's png_build_8bit_table: 255 * (i / 255) ** (g / 1e5),
    rounded, or the identity when `g` is not significant."""
    if not _significant(g):
        return np.arange(256, dtype=np.int64)
    t = [int(math.floor(255 * math.pow(i / 255.0, g * 0.00001) + 0.5))
         for i in range(256)]
    t[0], t[255] = 0, 255
    return np.asarray(t, np.int64)


def _rgb_to_gray(rgb: np.ndarray, depth: int, gamma: int,
                 name: str) -> np.ndarray:
    """libpng's png_do_rgb_to_gray with the weights cv2 asks for (see the
    module docstring): uint8 [H, W] from [H, W, 3] samples."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    screen = _reciprocal(gamma) if gamma else 0
    tables = gamma and (_significant(gamma) or _significant(screen))
    if depth == 16:
        if tables:
            raise ValueError(f"{name}: a grayscale read of a 16-bit colour "
                             f"PNG with file gamma {gamma / 1e5:g} (gAMA or "
                             "sRGB) is not supported")
        return (((_RC * r + _GC * g + _BC * b + 16384) >> 15) >> 8
                ).astype(np.uint8)
    if tables:
        to1 = _gamma_table(_reciprocal(gamma))
        from1 = _gamma_table(_reciprocal(screen))
        y = from1[(_RC * to1[r] + _GC * to1[g] + _BC * to1[b] + 16384) >> 15]
    else:
        y = (_RC * r + _GC * g + _BC * b) >> 15
    return np.where((r == g) & (g == b), r, y).astype(np.uint8)


def _expanded(f: PngFile, alpha: bool) -> tuple[np.ndarray, bool]:
    """The samples with libpng's expansions: a palette through its PLTE
    (indices past it black) into RGB, gray below 8 bits scaled to 8
    (x 255 / (2**depth - 1)). With `alpha`, a palette or RGB file's tRNS
    becomes an alpha channel (palette: its entries, 255 past them; RGB:
    0 where all three samples equal its colour, else the maximum). An
    invalid tRNS (an RGB one not 6 bytes, a palette one empty or longer
    than the palette) is ignored, as libpng ignores it. Returns (samples
    [H, W, C], whether C counts an alpha channel)."""
    img, ct, depth = f.samples, f.color_type, f.bit_depth
    if ct == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(len(f.palette), 256)] = f.palette[:256]
        idx = img[..., 0]
        out = pal[idx]
        t = f.trns
        if alpha and t and len(t) <= min(len(f.palette), 256):
            a = np.full(256, 255, np.uint8)
            a[:len(t)] = np.frombuffer(t, np.uint8)
            return np.concatenate([out, a[idx][..., None]], -1), True
        return out, False
    if ct == 0 and depth < 8:
        return img * np.uint8(255 // ((1 << depth) - 1)), False
    if ct == 2 and alpha and f.trns and len(f.trns) == 6:
        key = np.array(struct.unpack(">3H", f.trns), np.int64)
        if depth == 8:
            key &= 0xFF
        top = 65535 if depth == 16 else 255
        a = np.where((img == key).all(-1), 0, top).astype(img.dtype)
        return np.concatenate([img, a[..., None]], -1), True
    return img, ct in (4, 6)


def png_imread(f: PngFile, flags: int, name: str = "PNG") -> np.ndarray:
    """`cv2.imread(path, flags)` of a decoded PNG (see the module
    docstring)."""
    if flags not in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR):
        raise ValueError(f"imread flags {flags}: not one of IMREAD_UNCHANGED, "
                         "IMREAD_GRAYSCALE, IMREAD_COLOR")
    img, has_alpha = _expanded(f, alpha=flags == IMREAD_UNCHANGED)
    ch = img.shape[2]
    if flags == IMREAD_UNCHANGED:
        if ch == 1:
            return np.ascontiguousarray(img[..., 0])
        if ch == 2:                             # gray+alpha -> BGRA
            img = img[..., [0, 0, 0, 1]]
        order = [2, 1, 0, 3][:img.shape[2]]
        return np.ascontiguousarray(img[..., order])
    color = img[..., :ch - has_alpha]
    if flags == IMREAD_GRAYSCALE:
        if color.shape[2] == 3:
            out = _rgb_to_gray(color, f.bit_depth, f.gamma, name)
        else:
            out = color[..., 0]
            if out.dtype == np.uint16:
                out = (out >> 8).astype(np.uint8)
        return apply_orientation(out, f.orientation)
    if color.dtype == np.uint16:
        color = (color >> 8).astype(np.uint8)
    if color.shape[2] == 1:
        color = np.repeat(color, 3, axis=2)
    return apply_orientation(color[..., ::-1], f.orientation)


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """`cv2.imread(path, flags)` for a PNG or a JPEG (told apart by their
    first bytes, as cv2 tells them), bit for bit in dtype, shape and
    values: IMREAD_UNCHANGED (-1; Depth frames), IMREAD_GRAYSCALE (0;
    masks), IMREAD_COLOR (1, the default; Color frames, BGR). Raises
    ValueError, naming the file, where cv2 would return None or where the
    port refuses the file (see the module docstring and `data.jpeg`)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] == _SIG:
        return png_imread(decode_png(data, path), flags, path)
    if data[:2] == b"\xff\xd8":
        return jpeg_imread(data, flags, path)
    raise ValueError(f"{path} is neither a PNG nor a JPEG file")


def check_color_frames(color_dir: str) -> None:
    """Raise when `color_dir` holds a JPEG Color frame that
    `read_color_frame` cannot decode (lossless, hierarchical, arithmetic
    coded, 12-bit, 4 components, progressive scans incomplete:
    `data.jpeg.jpeg_header`), naming the frame and the marker: a run that
    renders over the Color frames calls this before its work, so that it
    refuses them up front and not after its fits. Each `.jpg` frame's
    markers up to its first scan are read, and a progressive frame's
    scan headers (the callers look for `<frame>.jpg`, then
    `<frame>.png`). A missing folder passes (a frame without a Color
    image is skipped)."""
    if not os.path.isdir(color_dir):
        return
    for f in sorted(os.listdir(color_dir)):
        if not f.endswith(".jpg"):
            continue
        path = os.path.join(color_dir, f)
        what = jpeg_header(path).unsupported
        if what:
            raise ValueError(f"{path}: JPEG Color frame with {what}, which "
                             f"the port's decoder does not take ({DECODED}); "
                             "re-encode the frames as baseline JPEG or PNG")


def read_color_frame(path: str) -> np.ndarray:
    """A Color frame as uint8 RGB [H, W, 3]: `cv2.imread(path)[:, :, ::-1]`,
    bit for bit (`imread`'s colour mode; a JPEG through `data.jpeg.
    read_jpeg`, which gives RGB without the copy)."""
    if is_jpeg_path(path):
        return read_jpeg(path)
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: a Color frame must be PNG or JPEG")
    return np.ascontiguousarray(imread(path, IMREAD_COLOR)[:, :, ::-1])
