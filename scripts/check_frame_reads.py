"""How far a checkout's port reads three kinds of frame from what
`lemo_tpu` reads with `cv2.imread`: a 16-bit Color PNG
(`read_color_frame`), a colour mask under IMREAD_GRAYSCALE (every 5th
value of each RGB channel), and 16-bit masks with body values 1-255
through both packages' PROX window loading (the depth points that
`create_scan` keeps a frame).

    JAX_PLATFORMS=cpu python scripts/check_frame_reads.py [--port ROOT]

`--port` is the root of the checkout whose `lemo_tpu_torch` is read (by
default this one; an older one, unpacked with `git archive`, shows the
reads as they were: a tree that still has `data.prox._gray` reads masks
through it). `lemo_tpu` is always this checkout's. Needs cv2 and runs on
the CPU (~15 s); prints one line a case.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default=ROOT)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(a.port))
    import cv2

    from lemo_tpu.data.prox import ProxRecording as JRec
    from lemo_tpu.data.prox import ProxWindowDataset as JDataset
    from lemo_tpu.testing.synthetic_prox import \
        write_synthetic_prox_recording
    from lemo_tpu_torch.data import png
    from lemo_tpu_torch.data import prox as tprox

    print(f"port: {os.path.dirname(png.__file__)}")
    rng = np.random.RandomState(0)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "f.png")
    for ch in (1, 3):
        s = rng.randint(0, 65536, (32, 48, ch)).astype(np.uint16)
        cv2.imwrite(path, s if ch == 3 else s[..., 0])
        ref = cv2.imread(path)[:, :, ::-1]
        got = png.read_color_frame(path)
        print(f"16-bit Color PNG, {ch} channel(s): {(got != ref).sum()} of "
              f"{ref.size} samples differ from cv2's")
    v = np.arange(0, 256, 5)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(
        -1, len(v), 3).astype(np.uint8)
    cv2.imwrite(path, rgb[:, :, ::-1])
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if hasattr(tprox, "_gray"):
        got = tprox._gray(png.read_png(path))
    else:
        got = png.imread(path, png.IMREAD_GRAYSCALE)
    print(f"colour mask, IMREAD_GRAYSCALE: {(got != ref).sum()} of "
          f"{ref.size} pixels differ from cv2's")
    info = write_synthetic_prox_recording(tmp, num_frames=4, seed=5)
    mdir = os.path.join(info["recording_dir"], "BodyIndexColor")
    for f in sorted(os.listdir(mdir)):
        p = os.path.join(mdir, f)
        m = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        cv2.imwrite(p, np.where(m == 0, rng.randint(1, 256, m.shape),
                                65535).astype(np.uint16))
    kw = dict(output_params_dir=tempfile.mkdtemp(), batch_size=4, flip=True)
    rec = info["recording_dir"]
    wt = tprox.ProxWindowDataset(tprox.ProxRecording.from_recording_dir(rec),
                                 **kw).load_window(0)
    wj = JDataset(JRec.from_recording_dir(rec), **kw).load_window(0)
    print(f"16-bit masks (body 1-255): scan points a frame, port "
          f"{wt['scan_mask'].sum(1).tolist()}, lemo_tpu "
          f"{wj['scan_mask'].sum(1).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
