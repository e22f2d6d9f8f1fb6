"""Write the JPEG fixtures of tests/data/jpeg/ with cv2, and beside them
the sha256 of what cv2 decodes from each in its three imread modes.

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

Each fixture is a seeded synthetic image (gradients, filled shapes with
hard edges, a sinusoidal texture and mild noise, so that every
frequency band carries coefficients) written by `cv2.imwrite` with the
flags its name gives: two 1920x1080 frames at quality 95, 4:2:0 (the
size of PROX's Color frames), one sequential and one progressive, and
small ones at 4:2:2, 4:4:4 and 4:4:0, grayscale, with restart markers,
with optimized Huffman tables, and progressive at 4:2:0, 4:2:2, 4:4:4,
grayscale and with restart markers. One more is a progressive file cut
after its 6th scan, its EOI kept: cv2 decodes it (libjpeg-turbo smooths
its blocks), and the port refuses it by name ("progressive scans
incomplete"), which `digests.json` records under `port_refuses`.

`digests.json` maps each file to, for each mode (`unchanged`: flags -1,
`grayscale`: 0, `color`: 1), the sha256 of `cv2.imread(path,
flags).tobytes()`, its shape and dtype; `tests/test_torch_jpeg.py`
recomputes the digests with cv2 and `chip_smoke.py` phase 10h holds the
port's `data.png.imread` to them on the card's host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 RGB [h, w, 3]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / w * 200 + 30, yy / h * 180 + 40,
                    (1 - xx / w) * 120 + yy / h * 80], axis=-1)
    img += 18 * np.sin(xx / (3 + 0.01 * w) + yy / 7.0)[..., None] * \
        np.array([1.0, -0.6, 0.4])
    for _ in range(12):
        cx, cy = rng.rand() * w, rng.rand() * h
        r = (0.05 + 0.15 * rng.rand()) * min(h, w)
        col = rng.rand(3) * 255
        if rng.rand() < 0.5:
            m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        else:
            m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < 0.6 * r)
        img[m] = 0.3 * img[m] + 0.7 * col
    img += rng.randn(h, w, 3) * 3.0
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def fixtures(cv2) -> dict:
    """name -> (image [BGR or gray], cv2.imwrite flags)."""
    s = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
         "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
         "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
         "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}

    def flags(q, sub, *extra):
        return [cv2.IMWRITE_JPEG_QUALITY, q,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, s[sub], *extra]

    small = scene(48, 64, 1)[:, :, ::-1]
    odd = scene(23, 37, 2)[:, :, ::-1]
    return {
        "frame_1920x1080_q95_420.jpg": (scene(1080, 1920, 0)[:, :, ::-1],
                                        flags(95, "420")),
        "small_64x48_q90_422.jpg": (small, flags(90, "422")),
        "small_37x23_q75_444.jpg": (odd, flags(75, "444")),
        "small_64x48_q85_440.jpg": (small, flags(85, "440")),
        "small_37x23_q90_gray.jpg": (cv2.cvtColor(odd, cv2.COLOR_BGR2GRAY),
                                     [cv2.IMWRITE_JPEG_QUALITY, 90]),
        "small_64x48_q95_420_rst2.jpg": (
            small, flags(95, "420", cv2.IMWRITE_JPEG_RST_INTERVAL, 2)),
        "small_64x48_q80_420_optimized.jpg": (
            small, flags(80, "420", cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
        "small_64x48_q90_progressive.jpg": (
            small, flags(90, "420", cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
        "frame_1920x1080_q95_420_progressive.jpg": (
            scene(1080, 1920, 3)[:, :, ::-1],
            flags(95, "420", cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
        "small_64x48_q90_422_progressive.jpg": (
            small, flags(90, "422", cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
        "small_37x23_q85_444_progressive.jpg": (
            odd, flags(85, "444", cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
        "small_37x23_q90_gray_progressive.jpg": (
            cv2.cvtColor(odd, cv2.COLOR_BGR2GRAY),
            [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "small_64x48_q90_420_progressive_rst3.jpg": (
            small, flags(90, "420", cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                         cv2.IMWRITE_JPEG_RST_INTERVAL, 3)),
    }


# name of the cut file -> (the file it is cut from, scans kept)
CUTS = {"small_64x48_q90_progressive_cut6.jpg":
        ("small_64x48_q90_progressive.jpg", 6)}
PORT_REFUSES = {"small_64x48_q90_progressive_cut6.jpg":
                "progressive scans incomplete"}
MODES = {"unchanged": -1, "grayscale": 0, "color": 1}


def cut_after_scan(data: bytes, scans: int) -> bytes:
    """`data` up to the end of its `scans`-th scan (the tables defined
    for the next scan dropped too), then EOI."""
    sos = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and data[i + 1] == 0xDA]
    end = sos[scans]
    dht = data.rfind(b"\xff\xc4", sos[scans - 1], end)
    return data[:dht if dht > 0 else end] + b"\xff\xd9"


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def digests(cv2, path: str) -> dict:
    """{mode: digest of cv2.imread(path, flags)} for the three modes."""
    return {mode: digest(cv2.imread(path, flags))
            for mode, flags in MODES.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "jpeg"))
    a = ap.parse_args(argv)
    import cv2

    os.makedirs(a.out, exist_ok=True)
    out = {"cv2": cv2.__version__, "files": {}}
    for name, (img, flags) in fixtures(cv2).items():
        path = os.path.join(a.out, name)
        if not cv2.imwrite(path, img, flags):
            print(f"cv2.imwrite failed on {name}", file=sys.stderr)
            return 1
    for name, (src, scans) in CUTS.items():
        with open(os.path.join(a.out, src), "rb") as fh:
            data = cut_after_scan(fh.read(), scans)
        with open(os.path.join(a.out, name), "wb") as fh:
            fh.write(data)
    for name in sorted(fixtures(cv2)) + sorted(CUTS):
        path = os.path.join(a.out, name)
        out["files"][name] = digests(cv2, path)
        if name in PORT_REFUSES:
            out["files"][name]["port_refuses"] = PORT_REFUSES[name]
        print(f"{name}: {os.path.getsize(path)} bytes")
    with open(os.path.join(a.out, "digests.json"), "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
