"""The port's three `cv2.imread` modes for PNG (`lemo_tpu_torch/data/
png.py`: `imread`, `read_color_frame`) against cv2, which `lemo_tpu` reads
Depth frames (IMREAD_UNCHANGED), masks (IMREAD_GRAYSCALE) and Color
frames (IMREAD_COLOR) with: every case must give cv2's dtype, shape and
bytes.

The committed fixtures of tests/data/png/ (written by
scripts/make_png_fixtures.py with PIL, cv2 and the port's test encoder)
are held to their stored cv2 digests, recomputed here; files of the test
encoder (`testing/png_encode.py`) cover every colour type, bit depth,
tRNS, Adam7 and eXIf orientation; the grayscale rule is held over a
subsample of the RGB cube, with and without file gamma. Three reads
that once differed from cv2 are held through the port's readers: a
16-bit Color frame (truncated, not rounded), a colour mask's gray
(libpng's weights, truncated) and a 16-bit mask (`>> 8`), the last two
through both packages' PROX window loading, so that `create_scan` keeps
the same depth points.
"""

import hashlib
import json
import os
import struct
import tempfile

import cv2
import numpy as np
import pytest

from lemo_tpu.data.prox import ProxRecording as JRec
from lemo_tpu.data.prox import ProxWindowDataset as JDataset
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.data import png
from lemo_tpu_torch.data.prox import ProxRecording, ProxWindowDataset
from lemo_tpu_torch.testing.png_encode import encode_png, write_png_file

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "png")
MODES = {"unchanged": -1, "grayscale": 0, "color": 1}


def _fixtures():
    with open(os.path.join(FIXTURES, "digests.json")) as fh:
        return json.load(fh)["files"]


def _digest(img):
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def _same_as_cv2(path, flags):
    ref = cv2.imread(path, flags)
    got = png.imread(path, flags)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        flags, got.dtype, got.shape, ref.dtype, ref.shape)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(_fixtures()))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fixture_digests(name, mode):
    """Each fixture's stored digest in each mode is cv2's (recomputed
    here), and the port's `imread` gives it."""
    want = _fixtures()[name][mode]
    path = os.path.join(FIXTURES, name)
    assert _digest(cv2.imread(path, MODES[mode])) == want
    assert _digest(png.imread(path, MODES[mode])) == want


# (colour type, bit depth)
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _samples(rng, ct, bd, h, w):
    """(samples, palette, tRNS) for one file of the kind."""
    top = 1 << bd
    if ct == 3:
        n = int(rng.randint(1, top + 1))     # indices past it are black
        pal = rng.randint(0, 256, (n, 3))
        trns = bytes(rng.randint(0, 256, rng.randint(1, n + 1)).tolist())
        return rng.randint(0, top, (h, w)), pal, trns
    ch = png.PNG_CHANNELS[ct]
    s = rng.randint(0, top, (h, w, ch))
    s[:2, :3] = s[0, 0]                      # the tRNS colour, repeated
    if ct == 0:
        return s, None, struct.pack(">H", int(s[0, 0, 0]))
    if ct == 2:
        return s, None, struct.pack(">3H", *map(int, s[0, 0]))
    return s, None, None


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("ct,bd", KINDS, ids=[f"ct{c}-{b}bit"
                                               for c, b in KINDS])
def test_every_kind_like_cv2(tmp_path, ct, bd, interlace):
    """Every colour type at every bit depth, plain and Adam7, without
    and with tRNS (where the type takes one), at sizes down to 1x1 (Adam7
    passes that are empty), in the three modes."""
    rng = np.random.RandomState(ct * 100 + bd + 7 * interlace)
    for h, w in ((13, 11), (1, 1), (3, 2), (9, 17)):
        s, pal, trns = _samples(rng, ct, bd, h, w)
        for t in (None, trns) if trns is not None else (None,):
            path = str(tmp_path / f"{h}x{w}_{t is not None}.png")
            write_png_file(path, s, ct, bd, palette=pal, trns=t,
                           interlace=interlace)
            for flags in MODES.values():
                _same_as_cv2(path, flags)


def _cube(step: int) -> np.ndarray:
    """uint8 RGB [n, n2, 3]: every `step`-th value of each channel, the
    last one included, and each gray value."""
    v = np.unique(np.r_[np.arange(0, 256, step), 255])
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    rgb = np.concatenate([rgb, np.repeat(np.arange(256)[:, None], 3, 1)])
    n = len(rgb)
    w = 256
    pad = -n % w
    rgb = np.concatenate([rgb, rgb[:pad]])
    return rgb.reshape(-1, w, 3).astype(np.uint8)


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
def test_grayscale_rule_over_the_colour_cube(tmp_path, alpha):
    """IMREAD_GRAYSCALE of an RGB and an RGBA file holding every 5th
    value of each channel (52**3 triples) and the gray axis: cv2's values,
    libpng's truncating weights (9797, 19234, 3737) >> 15, which the
    float weights rounded (the port's reading before) miss on about half
    the triples."""
    rgb = _cube(5)
    img = rgb
    if alpha:
        a = np.random.RandomState(0).randint(0, 256, rgb.shape[:2] + (1,))
        img = np.concatenate([rgb, a.astype(np.uint8)], -1)
    path = str(tmp_path / "cube.png")
    write_png_file(path, img, 6 if alpha else 2, 8)
    _same_as_cv2(path, cv2.IMREAD_GRAYSCALE)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    rule = np.where((r == g) & (g == b), r,
                    (9797 * r + 19234 * g + 3737 * b) >> 15)
    np.testing.assert_array_equal(png.imread(path, cv2.IMREAD_GRAYSCALE),
                                  rule)
    rounded = np.round(rgb.astype(np.float64) @ [0.299, 0.587, 0.114])
    assert (rounded != rule).mean() > 0.4


@pytest.mark.parametrize("chunks", [
    [(b"gAMA", struct.pack(">I", 45455))], [(b"sRGB", b"\x00")],
    [(b"gAMA", struct.pack(">I", 30000))],
    [(b"gAMA", struct.pack(">I", 250000))],
    [(b"gAMA", struct.pack(">I", 100000)), (b"sRGB", b"\x00")],
    [(b"gAMA", struct.pack(">I", 98000))],
    [(b"cICP", bytes([1, 13, 0, 1]))]],
    ids=["gAMA-0.45455", "sRGB", "gAMA-0.3", "gAMA-2.5", "gAMA-1+sRGB",
         "gAMA-0.98", "cICP"])
def test_grayscale_gamma_like_cv2(tmp_path, chunks):
    """A colour file's gamma (gAMA; sRGB wins over gAMA; cICP ignored)
    moves libpng's gray conversion onto linearised samples where it is
    significant: cv2's values over a subsample of the cube, RGB and
    palette (whose colours the same cube gives)."""
    rgb = _cube(15)
    path = str(tmp_path / "g.png")
    write_png_file(path, rgb, 2, 8, chunks_before=chunks)
    for flags in MODES.values():
        _same_as_cv2(path, flags)
    pal = np.random.RandomState(1).randint(0, 256, (256, 3))
    idx = np.random.RandomState(2).randint(0, 256, (20, 30))
    write_png_file(path, idx, 3, 8, palette=pal, chunks_before=chunks)
    _same_as_cv2(path, cv2.IMREAD_GRAYSCALE)


def test_grayscale_refuses_16bit_colour_with_gamma(tmp_path):
    """A 16-bit colour file with a significant gamma is refused by name
    in grayscale mode (libpng's 16-bit gamma tables are not rebuilt) and
    read in the other two."""
    s = np.random.RandomState(0).randint(0, 65536, (5, 6, 3))
    path = str(tmp_path / "g16.png")
    write_png_file(path, s, 2, 16,
                   chunks_before=[(b"gAMA", struct.pack(">I", 45455))])
    with pytest.raises(ValueError, match="16-bit colour PNG with file gamma"):
        png.imread(path, cv2.IMREAD_GRAYSCALE)
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        _same_as_cv2(path, flags)


def _tiff(orientation: int, order: str) -> bytes:
    e = "<" if order == "II" else ">"
    ifd = struct.pack(e + "H", 1) + struct.pack(
        e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    return order.encode() + struct.pack(e + "HI", 42, 8) + ifd


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_like_cv2(tmp_path, orientation):
    """An eXIf chunk's Orientation tag: cv2 applies it in colour and
    grayscale modes and not in IMREAD_UNCHANGED, and so does the port."""
    rng = np.random.RandomState(orientation)
    path = str(tmp_path / "o.png")
    for ct, ch in ((2, 3), (0, 1)):
        s = rng.randint(0, 256, (5, 7, ch))
        write_png_file(path, s, ct, 8, chunks_before=[
            (b"eXIf", _tiff(orientation, "II" if orientation % 2 else "MM"))])
        for flags in MODES.values():
            _same_as_cv2(path, flags)
    assert png.imread(path).shape[:2] == ((7, 5) if orientation >= 5
                                          else (5, 7))


@pytest.mark.parametrize("ct", [0, 2])
def test_color_frame_16bit_truncates(tmp_path, ct):
    """A 16-bit Color frame (gray or RGB): `read_color_frame` gives
    `cv2.imread(path)[:, :, ::-1]`, the samples truncated (`>> 8`), where
    dividing by 256 and rounding half to even (the port's reading before)
    is off by one on about half the samples."""
    s = np.random.RandomState(ct).randint(0, 65536, (32, 48, 1 + ct))
    path = str(tmp_path / "c16.png")
    write_png_file(path, s, ct, 16)
    ref = cv2.imread(path)[:, :, ::-1]
    got = png.read_color_frame(path)
    assert got.dtype == np.uint8 and got.shape == (32, 48, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ref[..., 0], s[..., 0] >> 8)
    assert (np.rint(s / 256.0)[..., 0] != ref[..., 0]).mean() > 0.4


def test_read_png_keeps_its_contract(tmp_path):
    """`read_png` (the samples in the file's channel order) on the kinds
    it now takes: a palette expanded to RGB (RGBA with tRNS), low-bit
    gray scaled to 8 bits, Adam7 the same as plain."""
    rng = np.random.RandomState(3)
    pal = rng.randint(0, 256, (16, 3))
    idx = rng.randint(0, 16, (9, 10))
    path = str(tmp_path / "p.png")
    write_png_file(path, idx, 3, 4, palette=pal)
    np.testing.assert_array_equal(png.read_png(path), pal[idx])
    write_png_file(path, idx, 3, 4, palette=pal, trns=bytes([7] * 16))
    np.testing.assert_array_equal(png.read_png(path)[..., 3], 7)
    write_png_file(path, idx % 4, 0, 2)
    np.testing.assert_array_equal(png.read_png(path), (idx % 4) * 85)
    rgb = rng.randint(0, 65536, (9, 10, 3))
    write_png_file(path, rgb, 2, 16, interlace=True)
    np.testing.assert_array_equal(png.read_png(path), rgb)


def _mask_files(kind: str, mask: np.ndarray, rng) -> tuple:
    """A PROX mask (0 = body, 255 = elsewhere) as a file of `kind`:
    gray16, body samples 1-255 and the rest high; rgb / rgba, body
    pixels near-black colours ((0, 0, 8), (1, 0, 6) and the like) whose
    truncated gray is 0 and whose rounded gray is 1. Returns (samples,
    colour type, bit depth)."""
    body = mask == 0
    n = int(body.sum())
    if kind == "gray16":
        s = np.where(body, 0, 65535).astype(np.int64)
        s[body] = rng.randint(1, 256, n)
        return s, 0, 16
    s = np.full(mask.shape + (3,), 255, np.int64)
    near = np.array([[0, 0, 8], [0, 0, 5], [3, 0, 0], [0, 1, 0], [1, 1, 0],
                     [1, 0, 6], [2, 0, 3]])
    s[body] = near[rng.randint(0, len(near), n)]
    if kind == "rgba":
        s = np.concatenate([s, rng.randint(0, 256, mask.shape + (1,))], -1)
        return s, 6, 8
    return s, 2, 8


@pytest.mark.parametrize("kind", ["gray16", "rgb", "rgba"])
def test_masks_give_create_scan_lemo_tpus_points(kind):
    """Masks that `lemo_tpu` reads with IMREAD_GRAYSCALE to a body of
    zeros (a 16-bit mask with body values 1-255, `>> 8`; colour masks
    whose body colours truncate to 0): both packages' window loading
    gives `create_scan` the same points. The port's reading before (a
    16-bit mask kept as uint16, a colour mask's gray rounded) dropped
    these body pixels' depth points."""
    base = tempfile.mkdtemp()
    info = j_write(base, num_frames=4, seed=5)
    rec_dir = info["recording_dir"]
    mdir = os.path.join(rec_dir, "BodyIndexColor")
    rng = np.random.RandomState(len(kind))
    for f in sorted(os.listdir(mdir)):
        path = os.path.join(mdir, f)
        mask = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        s, ct, bd = _mask_files(kind, mask, rng)
        write_png_file(path, s, ct, bd, filters=(0,))
        assert (cv2.imread(path, cv2.IMREAD_GRAYSCALE) == 0).sum() == \
            (mask == 0).sum() > 0
    kw = dict(output_params_dir=tempfile.mkdtemp(), batch_size=4, flip=True)
    td = ProxWindowDataset(ProxRecording.from_recording_dir(rec_dir), **kw)
    jd = JDataset(JRec.from_recording_dir(rec_dir), **kw)
    wt, wj = td.load_window(0), jd.load_window(0)
    assert wj["scan_mask"].sum(axis=1).min() > 50
    np.testing.assert_array_equal(wt["scan_mask"], wj["scan_mask"])
    np.testing.assert_array_equal(wt["scan"], wj["scan"])


def test_imread_refuses_by_name(tmp_path):
    """A file that is neither PNG nor JPEG, and an unknown mode, raise
    naming the file and the flags."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as fh:
        fh.write(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        png.imread(path)
    with open(path, "wb") as fh:
        fh.write(encode_png(np.zeros((2, 2), np.uint8), 0, 8))
    with pytest.raises(ValueError, match="imread flags 2"):
        png.imread(path, 2)
