"""Write the PNG fixtures of tests/data/png/, and beside them the sha256
of what cv2 decodes from each in its three imread modes.

    python scripts/make_png_fixtures.py [--out tests/data/png]

Each fixture is a small seeded image of the kind its name gives, written
by the tool that can write it:

- PIL: palette images at 8 bits without and with tRNS, and at 1, 2 and 4
  bits (one with tRNS); 1-bit grayscale (mode "1"); a gray+alpha mask
  ("LA").
- the port's test encoder (`lemo_tpu_torch/testing/png_encode.py`): 2-
  and 4-bit grayscale, which PIL does not write, and Adam7-interlaced
  8- and 16-bit grayscale and RGB, which neither cv2 nor PIL writes.
- cv2: 16-bit RGB and grayscale, and RGB and RGBA masks (a black body on
  a coloured background, with near-black pixels whose gray value rounds
  and truncates differently).

`digests.json` maps each file to, for each mode (`unchanged`: flags -1,
`grayscale`: 0, `color`: 1), the sha256 of `cv2.imread(path,
flags).tobytes()`, its shape and dtype; `tests/test_torch_png_modes.py`
recomputes them with cv2 and holds the port's `data.png.imread` to them,
and `chip_smoke.py` phase 10h holds the port to them on the card's host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"unchanged": -1, "grayscale": 0, "color": 1}


def mask_rgb(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 RGB [h, w, 3]: a black ellipse (the body) on a coloured
    background, and a band of near-black colours (channels 0-12) whose
    weighted gray lies between 0 and 1."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.randint(40, 256, (h, w, 3))
    body = ((yy - h / 2) / (0.35 * h)) ** 2 + ((xx - w / 2) / (0.2 * w)) ** 2
    img[body < 1] = 0
    img[:3] = rng.randint(0, 13, (3, w, 3))
    return img.astype(np.uint8)


def _pil_palette(idx: np.ndarray, palette: np.ndarray, path: str,
                 bits: int, trns: bytes | None) -> None:
    from PIL import Image

    im = Image.fromarray(idx.astype(np.uint8), "P")
    im.putpalette(palette.astype(np.uint8).reshape(-1).tolist())
    kw = {"bits": bits}
    if trns is not None:
        kw["transparency"] = trns
    im.save(path, **kw)


def write_fixtures(out: str) -> list:
    """Write every fixture into `out`; returns their names."""
    import cv2
    from PIL import Image

    sys.path.insert(0, ROOT)
    from lemo_tpu_torch.testing.png_encode import write_png_file

    rng = np.random.RandomState(0)
    h, w = 24, 32
    names = []

    def path(name):
        names.append(name)
        return os.path.join(out, name)

    pal = rng.randint(0, 256, (256, 3))
    pal[:8] = pal[:8, :1]                   # some gray entries
    idx = rng.randint(0, 256, (h, w))
    _pil_palette(idx, pal, path("palette8.png"), 8, None)
    _pil_palette(idx, pal, path("palette8_trns.png"), 8,
                 bytes(rng.randint(0, 256, 100).tolist()))
    for bits in (1, 2, 4):
        n = 1 << bits
        sub = rng.randint(0, n, (h, w))
        _pil_palette(sub, pal[:n], path(f"palette{bits}.png"), bits, None)
    _pil_palette(rng.randint(0, 16, (h, w)), pal[:16],
                 path("palette4_trns.png"), 4,
                 bytes(rng.randint(0, 256, 5).tolist()))
    Image.fromarray((rng.rand(h, w) > 0.5).astype(np.uint8) * 255,
                    "L").convert("1").save(path("gray1.png"))
    for bits in (2, 4):
        write_png_file(path(f"gray{bits}.png"),
                       rng.randint(0, 1 << bits, (h, w)), 0, bits)
    for bits in (8, 16):
        top = 1 << bits
        write_png_file(path(f"adam7_gray{bits}.png"),
                       rng.randint(0, top, (h + 3, w + 5)), 0, bits,
                       interlace=True)
        write_png_file(path(f"adam7_rgb{bits}.png"),
                       rng.randint(0, top, (h + 3, w + 5, 3)), 2, bits,
                       interlace=True)
    assert cv2.imwrite(path("rgb16.png"),
                       rng.randint(0, 65536, (h, w, 3)).astype(np.uint16))
    assert cv2.imwrite(path("gray16.png"),
                       rng.randint(0, 65536, (h, w)).astype(np.uint16))
    mask = mask_rgb(h, w, 1)
    assert cv2.imwrite(path("mask_rgb.png"), mask[:, :, ::-1])
    alpha = rng.randint(0, 256, (h, w, 1)).astype(np.uint8)
    assert cv2.imwrite(path("mask_rgba.png"),
                       np.concatenate([mask[:, :, ::-1], alpha], -1))
    gray = cv2.cvtColor(mask[:, :, ::-1], cv2.COLOR_BGR2GRAY)
    Image.fromarray(np.stack([gray, alpha[..., 0]], -1), "LA").save(
        path("mask_gray_alpha.png"))
    return names


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "png"))
    a = ap.parse_args(argv)
    import cv2

    os.makedirs(a.out, exist_ok=True)
    out = {"cv2": cv2.__version__, "files": {}}
    for name in sorted(write_fixtures(a.out)):
        path = os.path.join(a.out, name)
        out["files"][name] = {mode: digest(cv2.imread(path, flags))
                              for mode, flags in MODES.items()}
        print(f"{name}: {os.path.getsize(path)} bytes")
    with open(os.path.join(a.out, "digests.json"), "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
