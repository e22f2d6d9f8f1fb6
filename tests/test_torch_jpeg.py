"""The port's JPEG decoding (`lemo_tpu_torch/data/jpeg.py`: the host C++
library `csrc/jpeg_cpu.cpp` and its numpy twin `read_jpeg_plain`) against
cv2, which `lemo_tpu` reads Color frames with: every case must give
exactly `cv2.imread(path)[:, :, ::-1]`, bit for bit (the decoder follows
libjpeg-turbo's ISLOW IDCT, fancy upsampling and colour tables), and
`cv2.imread(path, flags)` in the grayscale and unchanged modes
(`data.png.imread`, `jpeg_imread`), sequential and progressive files
alike.

Also: the port's test encoder (`testing/jpeg_encode.py`) decoded alike
by cv2 and the port; the committed fixtures' stored cv2 digests in the
three modes recomputed with cv2 (so that they cannot drift from it); the
EXIF orientation of a hand-spliced APP1 segment; a progressive file cut
after some of its scans (which libjpeg-turbo would smooth) refused by
name; and the frames the decoder refuses (lossless, arithmetic-coded,
12-bit) named up front by `check_color_frames`.
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from lemo_tpu_torch.data import jpeg as J
from lemo_tpu_torch.data.png import check_color_frames, imread, \
    read_color_frame
from lemo_tpu_torch.testing.jpeg_encode import encode_jpeg, write_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
MODES = {"unchanged": -1, "grayscale": 0, "color": 1}
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _image(h, w, seed=0, noise=76.0):
    """uint8 BGR [h, w, 3]: gradients with a hard-edged square and
    noise, so that every band carries coefficients."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx * 7 + yy * 3) % 256], axis=-1).astype(np.float64)
    img[h // 4:h // 2, w // 4:w // 2] = (250, 20, 90)
    img = 0.7 * img + rng.rand(h, w, 3) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


# (size (h, w), quality, sampling or "gray", restart interval, optimized)
CASES = ([((h, w), q, s, 0, False) for h, w in ((23, 37), (48, 64))
          for q in (50, 75, 95, 100) for s in ("444", "422", "420")]
         + [((h, w), q, "gray", 0, False) for h, w in ((23, 37), (48, 64))
            for q in (75, 100)]
         + [((h, w), 90, s, ri, False) for h, w in ((23, 37), (48, 64))
            for s, ri in (("420", 1), ("444", 3), ("gray", 2))]
         + [((h, w), q, s, 0, True) for h, w in ((23, 37), (48, 64))
            for q, s in ((60, "420"), (95, "444"), (85, "gray"))]
         + [((48, 64), 90, s, 0, False) for s in ("440", "411")]
         + [((h, w), 90, "420", 0, False) for h, w in ((1, 1), (2, 3),
                                                       (9, 17))])


def _cv2_write(path, case, progressive=False):
    (h, w), q, s, ri, opt = case
    img = _image(h, w, seed=h * w + q)
    flags = [cv2.IMWRITE_JPEG_QUALITY, q,
             cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if s == "gray":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    else:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[s]]
    if ri:
        flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, ri]
    if opt:
        flags += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    assert cv2.imwrite(path, img, flags)


@pytest.mark.parametrize(
    "case", CASES, ids=[f"{h}x{w}-q{q}-{s}-rst{ri}-opt{int(o)}"
                        for (h, w), q, s, ri, o in CASES])
def test_decodes_like_cv2(tmp_path, case):
    path = str(tmp_path / "x.jpg")
    _cv2_write(path, case)
    ref = cv2.imread(path)[:, :, ::-1]
    lib = J.read_jpeg(path)
    plain = J.read_jpeg_plain(path)
    assert lib.dtype == plain.dtype == np.uint8
    assert lib.shape == plain.shape == ref.shape
    np.testing.assert_array_equal(lib, ref)
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(read_color_frame(path), ref)
    _modes_like_cv2(path, plain=True)


def _modes_like_cv2(path, plain=False):
    """`imread` (the library) and, with `plain`, the numpy twin in the
    three modes: cv2's dtype, shape and bytes."""
    with open(path, "rb") as fh:
        data = fh.read()
    for flags in MODES.values():
        ref = cv2.imread(path, flags)
        for got in [imread(path, flags)] + (
                [J.jpeg_imread(data, flags, plain=True)] if plain else []):
            assert got.dtype == ref.dtype and got.shape == ref.shape, flags
            np.testing.assert_array_equal(got, ref)


# progressive: (size (h, w), quality, sampling or "gray", restart interval,
# optimized; cv2 writes a progressive file's Huffman tables optimized)
PROGRESSIVE = ([((h, w), q, s, 0, False) for h, w in ((23, 37), (48, 64))
                for q in (50, 90, 100) for s in ("444", "422", "420", "gray")]
               + [((h, w), 90, s, ri, False) for h, w in ((23, 37), (48, 64))
                  for s, ri in (("420", 1), ("444", 3), ("gray", 2))]
               + [((48, 64), 90, s, 0, False) for s in ("440", "411")]
               + [((h, w), 90, "420", 0, False) for h, w in ((1, 1), (2, 3),
                                                             (9, 17))])


@pytest.mark.parametrize(
    "case", PROGRESSIVE, ids=[f"{h}x{w}-q{q}-{s}-rst{ri}"
                              for (h, w), q, s, ri, _ in PROGRESSIVE])
def test_progressive_decodes_like_cv2(tmp_path, case):
    """cv2's progressive files (10 scans for colour, 6 for grayscale:
    DC first and refine, AC bands with successive approximation, EOB
    runs, restarts in non-interleaved scans): the library and the numpy
    twin give cv2's pixels in the three modes."""
    path = str(tmp_path / "p.jpg")
    _cv2_write(path, case, progressive=True)
    h = J.jpeg_header(path)
    assert h.sof == "SOF2" and h.unsupported is None
    assert len(h.scans) == (6 if case[2] == "gray" else 10)
    ref = cv2.imread(path)[:, :, ::-1]
    np.testing.assert_array_equal(J.read_jpeg(path), ref)
    np.testing.assert_array_equal(J.read_jpeg_plain(path), ref)
    np.testing.assert_array_equal(read_color_frame(path), ref)
    _modes_like_cv2(path, plain=True)


def _cut(data: bytes, scans: int) -> bytes:
    sos = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and data[i + 1] == 0xDA]
    dht = data.rfind(b"\xff\xc4", sos[scans - 1], sos[scans])
    return data[:dht if dht > 0 else sos[scans]] + b"\xff\xd9"


@pytest.mark.parametrize("scans", range(1, 10))
def test_progressive_scans_cut_refused_by_name(tmp_path, scans):
    """A cv2 progressive file cut after `scans` of its 10 scans, its EOI
    kept: cv2 decodes it to other pixels than the whole file's
    (libjpeg-turbo smooths blocks whose AC coefficients 1-9 are still
    unrefined). The port refuses every such cut up front by name, in the
    header, both decoders and `check_color_frames`, and never decodes it
    silently."""
    ok, buf = cv2.imencode(".jpg", _image(48, 64), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    data = _cut(buf.tobytes(), scans)
    color = tmp_path / "Color"
    color.mkdir()
    path = color / "c.jpg"
    path.write_bytes(data)
    ref = cv2.imread(str(path))
    assert ref is not None and ref.shape == (48, 64, 3)
    what = "progressive scans incomplete"
    assert J.jpeg_header(str(path)).unsupported.startswith(what)
    with pytest.raises(ValueError, match=what):
        J.decode(data)
    with pytest.raises(ValueError, match=what):
        J.decode_plain(data)
    for flags in MODES.values():
        with pytest.raises(ValueError, match=what):
            imread(str(path), flags)
    with pytest.raises(ValueError, match=what) as e:
        check_color_frames(str(color))
    assert str(path) in str(e.value)


@pytest.mark.parametrize("sub,ri,gray", [("420", 0, False),
                                         ("444", 0, False),
                                         ("420", 2, False),
                                         ("444", 5, True)])
def test_encoder_decodes_alike(tmp_path, sub, ri, gray):
    """The port's test encoder: a file that cv2 and the port decode to
    the same pixels, close to its source."""
    img = _image(41, 70, seed=3, noise=4.0)[:, :, ::-1]
    if gray:
        img = np.ascontiguousarray(img[:, :, 0])
    path = str(tmp_path / "e.jpg")
    write_jpeg(path, img, quality=95, subsampling=sub, restart_interval=ri)
    ref = cv2.imread(path)[:, :, ::-1]
    np.testing.assert_array_equal(J.read_jpeg(path), ref)
    np.testing.assert_array_equal(J.read_jpeg_plain(path), ref)
    h = J.jpeg_header(path)
    assert (h.sof, h.restart_interval, h.unsupported) == ("SOF0", ri, None)
    src = np.repeat(img[:, :, None], 3, 2) if gray else img
    assert np.abs(ref.astype(int) - src).mean() < 6.0


def _fixtures():
    with open(os.path.join(FIXTURES, "digests.json")) as fh:
        return json.load(fh)["files"]


def _digest(img):
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_fixture_digests(name):
    """Each fixture's stored digests (cv2's three modes) are cv2's,
    recomputed here; the port decodes every fixture it takes to them
    (progressive ones too, the small ones through the numpy twin as
    well), and refuses the scan-cut one by name."""
    want = _fixtures()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as fh:
        data = fh.read()
    for mode, flags in MODES.items():
        assert _digest(cv2.imread(path, flags)) == want[mode], mode
    if "port_refuses" in want:
        assert J.jpeg_header(path).unsupported.startswith(
            want["port_refuses"])
        for flags in MODES.values():
            with pytest.raises(ValueError, match=want["port_refuses"]):
                imread(path, flags)
        with pytest.raises(ValueError, match=want["port_refuses"]):
            J.decode(data)
        return
    for mode, flags in MODES.items():
        assert _digest(imread(path, flags)) == want[mode], mode
        if os.path.getsize(path) < 4096:
            assert _digest(J.jpeg_imread(data, flags, plain=True)) == \
                want[mode], mode
    rgb = J.read_jpeg(path)
    assert _digest(rgb[:, :, ::-1]) == want["color"]


def _exif_app1(orientation: int, order: str) -> bytes:
    e = "<" if order == "II" else ">"
    ifd = struct.pack(e + "H", 2) + struct.pack(
        e + "HHI4s", 0x010F, 2, 4, b"cam\x00") + struct.pack(
        e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    tiff = order.encode() + struct.pack(e + "HI", 42, 8) + ifd
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_like_cv2(tmp_path, orientation):
    """A hand-spliced APP1 segment with the Orientation tag (after the
    JFIF marker; little-endian TIFF for odd values, big-endian for even):
    the port applies it as cv2's imread does."""
    ok, buf = cv2.imencode(".jpg", _image(23, 37), [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])
    data = buf.tobytes()
    app0_end = 2 + 2 + struct.unpack(">H", data[4:6])[0]
    spliced = (data[:app0_end]
               + _exif_app1(orientation, "II" if orientation % 2 else "MM")
               + data[app0_end:])
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as fh:
        fh.write(spliced)
    ref = cv2.imread(path)[:, :, ::-1]
    assert J.jpeg_header(path).orientation == orientation
    np.testing.assert_array_equal(J.read_jpeg(path), ref)
    np.testing.assert_array_equal(J.read_jpeg_plain(path), ref)
    assert ref.shape[:2] == ((37, 23) if orientation >= 5 else (23, 37))
    _modes_like_cv2(path)       # IMREAD_UNCHANGED keeps the stored order


def _with_marker(data: bytes, old: int, new: int) -> bytes:
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


@pytest.mark.parametrize("kind,marker", [
    ("progressive", "SOF2 (progressive)"),
    ("arithmetic", "SOF9 (arithmetic-coded sequential)"),
    ("arithmetic progressive", "SOF10 (arithmetic-coded progressive)"),
    ("12-bit", "12-bit precision"),
    ("lossless", "SOF3 (lossless)"),
    ("progressive, no EOI", "a progressive file without its EOI marker")])
def test_refused_frames_named_up_front(tmp_path, kind, marker):
    """`check_color_frames` names the frame and the marker of a JPEG the
    decoder refuses (a baseline file's SOF0 made SOF9, SOF10 or SOF3
    (lossless), or its precision 12; a progressive file without its
    EOI), and passes a folder of baseline frames and PNGs; a cv2
    progressive file, once refused, now passes and decodes to cv2's
    pixels."""
    color = tmp_path / "Color"
    color.mkdir()
    img = _image(16, 24)
    assert cv2.imwrite(str(color / "a.jpg"), img)
    assert cv2.imwrite(str(color / "b.png"), img)
    check_color_frames(str(color))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
                           if kind.startswith("progressive") else [])
    data = buf.tobytes()
    if kind.startswith("arithmetic"):
        data = _with_marker(data, 0xC0, 0xC9 if kind == "arithmetic"
                            else 0xCA)
    elif kind == "12-bit":
        i = data.index(b"\xff\xc0")
        data = data[:i + 4] + b"\x0c" + data[i + 5:]
    elif kind == "lossless":
        data = _with_marker(data, 0xC0, 0xC3)
    elif kind == "progressive, no EOI":
        data = data[:-2]
    bad = color / "c.jpg"
    bad.write_bytes(data)
    if kind == "progressive":
        h = J.jpeg_header(str(bad))
        assert (h.sof, h.unsupported) == (marker.split(" ")[0], None)
        check_color_frames(str(color))
        np.testing.assert_array_equal(read_color_frame(str(bad)),
                                      cv2.imread(str(bad))[:, :, ::-1])
        return
    assert J.jpeg_header(str(bad)).unsupported.startswith(marker)
    with pytest.raises(ValueError) as e:
        check_color_frames(str(color))
    assert str(bad) in str(e.value) and marker in str(e.value)
    with pytest.raises(ValueError, match=marker.split(" ")[0]):
        read_color_frame(str(bad))


def test_encoder_full_frame_size():
    """A 1920x1080 frame (PROX's Color size) through the encoder and
    both of the port's decoding paths' front ends: the header's size and
    sampling, and the library's pixels equal cv2's."""
    yy, xx = np.mgrid[0:1080, 0:1920]
    img = np.stack([xx * 255 // 1919, yy * 255 // 1079,
                    np.full_like(xx, 60)], axis=-1).astype(np.uint8)
    data = encode_jpeg(img, quality=95)
    h = J._header_from(data)
    assert (h.width, h.height, h.components) == (
        1920, 1080, [(1, 2, 2), (2, 1, 1), (3, 1, 1)])
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(J.decode(data), ref[:, :, ::-1])


def _adobe_app14(transform: int) -> bytes:
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return b"\xff\xee" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("markers,ids", [
    ("adobe0", (1, 2, 3)), ("adobe1", (1, 2, 3)), ("none", (1, 2, 3)),
    ("none", (82, 71, 66)), ("jfif+adobe0", (1, 2, 3))])
def test_colour_space_rules_like_cv2(tmp_path, markers, ids):
    """A 3-component file's colour space as libjpeg decides it: a JFIF
    marker means YCbCr, else an Adobe marker's transform (0: RGB, no
    conversion), else the component ids ('R', 'G', 'B' mean RGB). The
    file is a cv2 4:2:0 JPEG with its JFIF marker removed or kept, an
    Adobe APP14 spliced in, and its SOF/SOS component ids rewritten."""
    ok, buf = cv2.imencode(".jpg", _image(23, 37), [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])
    data = buf.tobytes()
    app0_end = 2 + 2 + struct.unpack(">H", data[4:6])[0]
    head = data[:app0_end] if markers.startswith("jfif") else data[:2]
    if "adobe" in markers:
        head += _adobe_app14(int(markers[-1]))
    rest = bytearray(data[app0_end:])
    sof = rest.index(b"\xff\xc0")
    sos = rest.index(b"\xff\xda")
    for k, cid in enumerate(ids):
        rest[sof + 10 + 3 * k] = cid
        rest[sos + 5 + 2 * k] = cid
    path = str(tmp_path / "c.jpg")
    with open(path, "wb") as fh:
        fh.write(head + bytes(rest))
    ref = cv2.imread(path)[:, :, ::-1]
    np.testing.assert_array_equal(J.read_jpeg(path), ref)
    np.testing.assert_array_equal(J.read_jpeg_plain(path), ref)
    _modes_like_cv2(path, plain=True)   # an RGB file's gray: libjpeg's Y


@pytest.mark.parametrize("order", ["tables_first", "tables_last", "com"])
def test_tables_anywhere_before_the_scan(tmp_path, order):
    """DQT and DHT in any order before SOS (all tables before the frame
    header, or after it in reverse), and COM and APPn segments between
    them, decode as cv2 decodes them."""
    ok, buf = cv2.imencode(".jpg", _image(48, 64), [
        cv2.IMWRITE_JPEG_QUALITY, 85,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["422"],
        cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    data = buf.tobytes()
    segs, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        segs.append(data[pos:pos + 2 + n])
        pos += 2 + n
    tables = [s for s in segs if s[1] in (0xDB, 0xC4)]
    other = [s for s in segs if s[1] not in (0xDB, 0xC4)]
    com = b"\xff\xfe\x00\x07note" + b"\xff\xe5\x00\x04\x00\x00"
    if order == "tables_first":
        segs = tables[::-1] + other
    elif order == "tables_last":
        segs = other + tables[::-1]
    else:
        segs = [x for s in segs for x in (s, com)]
    path = str(tmp_path / "t.jpg")
    with open(path, "wb") as fh:
        fh.write(data[:2] + b"".join(segs) + data[pos:])
    ref = cv2.imread(path)[:, :, ::-1]
    np.testing.assert_array_equal(J.read_jpeg(path), ref)
    np.testing.assert_array_equal(J.read_jpeg_plain(path), ref)


def test_several_scans_like_cv2(tmp_path):
    """A 4:4:4 baseline file coded as three non-interleaved scans, one a
    component, with the chroma Huffman tables defined between the first
    and the second scan (built from the test encoder's pieces): both
    decoders give cv2's pixels."""
    from lemo_tpu_torch.testing import jpeg_encode as E

    H, W = 21, 30
    x = np.pad(_image(H, W, noise=8.0)[:, :, ::-1].astype(np.float64),
               ((0, 3), (0, 2), (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
    qts = [E._quant_table(E._LUMA_Q, 90), E._quant_table(E._CHROMA_Q, 90)]
    huff = [(E._DC_LUMA, E._AC_LUMA), (E._DC_CHROMA, E._AC_CHROMA)]
    D = E._dct_matrix()

    def dht(t):
        return b"".join(E._segment(0xC4, bytes([(tc << 4) | t] + c + v))
                        for tc, (c, v) in enumerate(huff[t]))

    out = [b"\xff\xd8", E._segment(
        0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [E._segment(0xDB, bytes([t]) + bytes(
        q[J.NATURAL].astype(np.uint8).tolist())) for t, q in enumerate(qts)]
    out.append(E._segment(0xC0, struct.pack(">BHHB", 8, H, W, 3) + bytes(
        [1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])))
    out.append(dht(0))
    for ci, p in enumerate(planes):
        t = min(ci, 1)
        if ci == 1:
            out.append(dht(1))
        blocks = D @ E._blocks(np.rint(p) - 128.0) @ D.T
        zz = np.rint(blocks / qts[t].reshape(8, 8)).astype(
            np.int64).reshape(-1, 64)[:, J.NATURAL]
        tables = [(E._codes(huff[t][0]), E._codes(huff[t][1]))]
        zeros = np.zeros(len(zz), np.int64)
        out.append(E._segment(0xDA, bytes([1, ci + 1, 0x11 * t, 0, 63, 0])))
        out.append(E._entropy(zz, zeros, zeros, tables)[0])
    out.append(b"\xff\xd9")
    path = str(tmp_path / "s.jpg")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    ref = cv2.imread(path)[:, :, ::-1]
    assert ref.shape == (H, W, 3)
    np.testing.assert_array_equal(J.read_jpeg(path), ref)
    np.testing.assert_array_equal(J.read_jpeg_plain(path), ref)
