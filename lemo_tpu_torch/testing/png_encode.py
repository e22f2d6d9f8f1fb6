"""A PNG encoder for test tooling, for the kinds that neither cv2 nor PIL
writes: Adam7-interlaced files, and any colour type at any bit depth it
allows, with PLTE, tRNS and other chunks as given. No CLI uses it; the
port's own writer is `data.png.write_png`.

`encode_png(samples, color_type, bit_depth, ...)` takes the samples as
the file stores them: [H, W] or [H, W, C] integers below 2**bit_depth,
channels in the file's order (palette indices for colour type 3). Rows
are packed MSB first below 8 bits and big-endian at 16; each row (of
each Adam7 pass) takes the filters 0-4 in turn, so that a decoder meets
every filter on every pass (unless `filters` says otherwise).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from lemo_tpu_torch.data.png import ADAM7, PNG_CHANNELS, _filter

_SIG = b"\x89PNG\r\n\x1a\n"


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_rows(img: np.ndarray, bit_depth: int) -> np.ndarray:
    """[h, w, C] samples -> [h, row bytes] uint8."""
    h = img.shape[0]
    flat = img.reshape(h, -1).astype(np.uint32)
    if bit_depth == 16:
        be = flat.astype(">u2")
        return np.frombuffer(be.tobytes(), np.uint8).reshape(h, -1)
    if bit_depth == 8:
        return flat.astype(np.uint8)
    per = 8 // bit_depth
    n = flat.shape[1]
    padded = np.zeros((h, -(-n // per) * per), np.uint32)
    padded[:, :n] = flat
    g = padded.reshape(h, -1, per)
    shifts = bit_depth * np.arange(per - 1, -1, -1, dtype=np.uint32)
    return (g << shifts).sum(-1).astype(np.uint8)


def _filtered(img: np.ndarray, bit_depth: int, ch: int, start: int,
              filters) -> bytes:
    rows = _pack_rows(img, bit_depth)
    bpp = max(1, ch * bit_depth // 8)
    out = []
    for y in range(rows.shape[0]):
        f = filters[(start + y) % len(filters)]
        # each row filtered against the row above it in this pass
        fr = _filter(rows[max(y - 1, 0):y + 1], bpp, f)[-1]
        out.append(bytes([f]) + fr.tobytes())
    return b"".join(out)


def encode_png(samples, color_type: int, bit_depth: int, *,
               palette=None, trns: bytes | None = None,
               interlace: bool = False, chunks_before=(),
               filters=(0, 1, 2, 3, 4), level: int = 6) -> bytes:
    """The bytes of a PNG file (see the module docstring). `palette`:
    [N, 3] uint8 for colour type 3; `trns`: the tRNS chunk's body;
    `chunks_before`: (kind, body) pairs written before the IDAT;
    `filters`: the row filters, taken in turn."""
    img = np.asarray(samples)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    if ch != PNG_CHANNELS[color_type]:
        raise ValueError(f"{ch} channels for colour type {color_type}")
    if int(img.max(initial=0)) >= 1 << bit_depth:
        raise ValueError(f"a sample does not fit in {bit_depth} bits")
    if interlace:
        raw = b""
        for k, (y0, x0, dy, dx) in enumerate(ADAM7):
            sub = img[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filtered(sub, bit_depth, ch, k, filters)
    else:
        raw = _filtered(img, bit_depth, ch, 0, filters)
    out = [_SIG, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth,
                                            color_type, 0, 0, int(interlace)))]
    out += [chunk(k, b) for k, b in chunks_before]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(chunk(b"tRNS", trns))
    out.append(chunk(b"IDAT", zlib.compress(raw, level)))
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def write_png_file(path: str, samples, color_type: int, bit_depth: int,
                   **kw) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(samples, color_type, bit_depth, **kw))
