"""A baseline JPEG encoder in numpy, for test tooling: the card's machine
has no encoder (no cv2, no PIL), and the port's decoder
(`data/jpeg.py`) needs frames to decode there. No CLI uses it.

`write_jpeg(path, img, quality=95, subsampling="420", restart_interval=0)`
writes a JFIF baseline JPEG (SOF0, Huffman) of uint8 RGB [H, W, 3] or
grayscale [H, W]: the Annex K quantization tables scaled by `quality` as
libjpeg scales them, the Annex K Huffman tables, 4:2:0 or 4:4:4 chroma
(2x2 means of the edge-replicated image), and a DRI restart interval in
MCUs when `restart_interval` > 0. The forward DCT is the orthonormal
float one, rounded at quantization; the entropy coding is vectorised
over all blocks, so a 1920x1080 frame takes under a second.
"""

from __future__ import annotations

import struct

import numpy as np

from lemo_tpu_torch.data.jpeg import NATURAL

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                   [24, 26, 56, 99], [47, 66, 99, 99]]

_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]


def _ac_values(head: list) -> list:
    """Annex K's AC value list: its irregular head, then every other
    symbol in increasing order."""
    return head + sorted(set(_AC_SYMBOLS) - set(head))


# (counts of codes of length 1..16, values), Annex K.3
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16]))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1]))


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline:
    entries in 1..255); natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(table) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) arrays indexed by symbol, of a canonical table."""
    counts, values = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            code_of[values[k]], len_of[values[k]] = code, ln
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _size(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    a = np.abs(v)
    s = np.zeros(a.shape, np.int64)
    while (a >> s).any():
        s += (a >> s) > 0
    return s


def _entropy(zz: np.ndarray, comp: np.ndarray, interval: np.ndarray,
             tables: list) -> list:
    """Huffman-code blocks [N, 64] (zigzag order) in coding order; block
    i uses tables[comp[i]] (dc, ac) and lies in restart interval
    interval[i]. Returns each interval's bytes, padded with 1-bits and
    byte-stuffed."""
    n = len(zz)
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):               # DC prediction per component
        idx = np.nonzero(comp == c)[0]
        prev = np.concatenate([[0], dc[idx[:-1]]])
        first = np.concatenate([[True],
                                interval[idx[1:]] != interval[idx[:-1]]])
        prev[first] = 0
        diff[idx] = dc[idx] - prev
    dc_code = np.stack([tables[c][0][0] for c in range(len(tables))])
    dc_len = np.stack([tables[c][0][1] for c in range(len(tables))])
    ac_code = np.stack([tables[c][1][0] for c in range(len(tables))])
    ac_len = np.stack([tables[c][1][1] for c in range(len(tables))])

    def item(sym_code, sym_len, value, s):
        bits = np.where(value >= 0, value, value + (1 << s) - 1) & \
            ((1 << s) - 1)
        return (sym_code << s) | bits, sym_len + s

    keys, vals, lens = [], [], []
    s = _size(diff)
    v, ln = item(dc_code[comp, s], dc_len[comp, s], diff, s)
    keys.append(np.arange(n) * 4096)
    vals.append(v)
    lens.append(ln)
    b, p = np.nonzero(zz[:, 1:])
    p = p + 1
    prev = np.concatenate([[0], p[:-1]])
    prev[np.concatenate([[True], b[1:] != b[:-1]])] = 0
    run = p - prev - 1
    for j in range(3):                       # ZRLs (runs of 16 zeros)
        z = run >= 16 * (j + 1)
        keys.append(b[z] * 4096 + p[z] * 64 + j)
        vals.append(ac_code[comp[b[z]], 0xF0])
        lens.append(ac_len[comp[b[z]], 0xF0])
    a = zz[b, p]
    s = _size(a)
    sym = ((run % 16) << 4) | s
    v, ln = item(ac_code[comp[b], sym], ac_len[comp[b], sym], a, s)
    keys.append(b * 4096 + p * 64 + 63)
    vals.append(v)
    lens.append(ln)
    last = np.zeros(n, np.int64)
    last[b] = p                              # the last nonzero's position
    e = np.nonzero(last < 63)[0]
    keys.append(e * 4096 + 4095)
    vals.append(ac_code[comp[e], 0x00])
    lens.append(ac_len[comp[e], 0x00])
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    blk = np.concatenate(keys)[order] // 4096
    # pad each interval to a byte with 1-bits
    iv = interval[blk]
    n_iv = int(interval.max()) + 1
    bits_iv = np.bincount(iv, weights=lens, minlength=n_iv).astype(np.int64)
    pad = (-bits_iv) % 8
    ends = np.searchsorted(iv, np.arange(n_iv), side="right")
    vals = np.insert(vals, ends, (1 << pad) - 1)
    lens = np.insert(lens, ends, pad)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    total = int(lens.sum())
    bitarr = np.zeros(total, np.uint8)
    for k in range(int(lens.max(initial=0))):
        m = lens > k
        bitarr[off[m] + k] = (vals[m] >> (lens[m] - 1 - k)) & 1
    data = np.packbits(bitarr)
    cut = np.concatenate([[0], np.cumsum((bits_iv + pad) // 8)])
    out = []
    for i in range(n_iv):
        seg = data[cut[i]:cut[i + 1]]
        ff = np.nonzero(seg == 0xFF)[0]
        out.append(np.insert(seg, ff + 1, 0).tobytes())
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 95, subsampling: str = "420",
                restart_interval: int = 0) -> bytes:
    """The JPEG file's bytes (see the module docstring)."""
    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    H, W = img.shape[:2]
    if subsampling not in ("420", "444"):
        raise ValueError(f"subsampling {subsampling!r}: '420' or '444'")
    hs = 1 if gray or subsampling == "444" else 2
    mh, mw = 8 * hs, 8 * hs
    Hp, Wp = -(-H // mh) * mh, -(-W // mw) * mw
    x = np.pad(img.astype(np.float64),
               ((0, Hp - H), (0, Wp - W)) + (() if gray else ((0, 0),)),
               mode="edge")
    if gray:
        planes = [x]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
        if hs == 2:
            planes[1:] = [p.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3))
                          for p in planes[1:]]
    qts = [_quant_table(_LUMA_Q, quality), _quant_table(_CHROMA_Q, quality)]
    D = _dct_matrix()
    mcuy, mcux = Hp // mh, Wp // mw
    zz = []
    for ci, p in enumerate(planes):
        blk = _blocks(np.rint(p) - 128.0)
        coef = D @ blk @ D.T
        q = qts[min(ci, 1)].reshape(8, 8)
        quant = np.rint(coef / q).astype(np.int64)
        f = ci == 0 and hs == 2
        if f:   # an MCU's four luma blocks in raster order
            quant = quant.reshape(mcuy, 2, mcux, 2, 8, 8).transpose(
                0, 2, 1, 3, 4, 5).reshape(mcuy, mcux, 4, 8, 8)
        else:
            quant = quant.reshape(mcuy, mcux, 1, 8, 8)
        zz.append(quant.reshape(mcuy, mcux, -1, 64)[..., NATURAL])
    per_mcu = [z.shape[2] for z in zz]
    blocks = np.concatenate(zz, axis=2).reshape(-1, 64)
    comp = np.tile(np.repeat(np.arange(len(zz)), per_mcu), mcuy * mcux)
    mcu = np.repeat(np.arange(mcuy * mcux), sum(per_mcu))
    interval = mcu // restart_interval if restart_interval else \
        np.zeros_like(mcu)
    tables = [(_codes(_DC_LUMA), _codes(_AC_LUMA))]
    if not gray:
        tables += [(_codes(_DC_CHROMA), _codes(_AC_CHROMA))] * 2
    chunks = _entropy(blocks, comp, interval, tables)

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(qts[:1 if gray else 2]):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            q[NATURAL].astype(np.uint8).tolist())))
    comps = [(1, hs, hs, 0)] + ([] if gray else [(2, 1, 1, 1), (3, 1, 1, 1)])
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, len(comps))
                        + b"".join(bytes([i, (h << 4) | v, t])
                                   for i, h, v, t in comps)))
    for tc, th, (counts, values) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA)) + (
            () if gray else ((0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA))):
        out.append(_segment(0xC4, bytes([(tc << 4) | th] + counts + values)))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([i, 0x00 if t == 0 else 0x11]) for i, _, _, t in comps)
        + b"\x00\x3f\x00"))
    for i, chunk in enumerate(chunks):
        if i:
            out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        out.append(chunk)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               subsampling: str = "420", restart_interval: int = 0) -> None:
    """Write `encode_jpeg(img, ...)` to `path`."""
    with open(path, "wb") as fh:
        fh.write(encode_jpeg(img, quality, subsampling, restart_interval))
