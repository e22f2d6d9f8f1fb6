"""Rendering over JPEG Color frames, as real PROX recordings ship them, in
both packages on the CPU: `render_fitting` (body overlays and body in
scene) and `run_prox_fitting` with `render_results` on a two-window fit.
Both packages read the same `.jpg` files: `lemo_tpu` through
`cv2.imread`, the port through its own decoder (`data.jpeg`). Frames are
written by the port's encoder (`testing.jpeg_encode`, also through the
synthetic writer's `color_format="jpg"`) or by cv2 (baseline and
progressive). The overlays are held as tests/test_torch_raster.py holds
`render_body_overlay`'s: pixels equal but for at most 0.5% of the body's
(the two packages' vertices differ by rounding)."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.cli import render_fitting as j_cli
from lemo_tpu.config import ProxConfig as JConfig
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.cli import render_fitting as t_cli
from lemo_tpu_torch.config.prox_config import ProxConfig
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.data.jpeg import read_jpeg
from lemo_tpu_torch.data.png import read_png
from lemo_tpu_torch.fitting.prox import driver as t_driver
from lemo_tpu_torch.testing.jpeg_encode import write_jpeg
from lemo_tpu_torch.testing.synthetic_prox import \
    write_synthetic_prox_recording
from lemo_tpu_torch.utils.raster import rasterize_mesh

torch.set_num_threads(2)


def _frame(h, w, k):
    """uint8 RGB [h, w, 3], asymmetric left to right (the flip shows)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // w, yy * 255 // h,
                     np.full_like(xx, 40 * k)], axis=-1).astype(np.uint8)


def _write_jpeg_frames(rec_dir, frames, h, w, encoder):
    color = os.path.join(rec_dir, "Color")
    for f in os.listdir(color):
        os.remove(os.path.join(color, f))
    for k, fn in enumerate(frames):
        path = os.path.join(color, fn + ".jpg")
        if encoder == "port":
            write_jpeg(path, _frame(h, w, k), quality=95)
        else:
            assert cv2.imwrite(path, _frame(h, w, k)[:, :, ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 90,
                                cv2.IMWRITE_JPEG_PROGRESSIVE,
                                int(encoder == "cv2_progressive")])


def _hold(got, ref, verts, faces, w, h, f, cx, cy, flipped_frame=None):
    body = rasterize_mesh(verts, faces, w, h, f, f, cx, cy)[2].sum()
    assert got.shape == ref.shape == (h, w, 3) and body > 100
    n_diff = int((got != ref).any(-1).sum())
    assert n_diff <= 0.005 * body, (n_diff, body)
    if flipped_frame is not None:   # the decoded frame where no body is
        keep = (ref == flipped_frame).all(-1)
        assert keep.sum() > 0.5 * keep.size
        np.testing.assert_array_equal(got[keep], flipped_frame[keep])


@pytest.mark.parametrize("encoder", ["port", "cv2", "cv2_progressive"])
def test_render_fitting_over_jpeg_frames(tmp_path, encoder):
    """Both render_fitting CLIs on the recording's pkls with 320x240
    `.jpg` Color frames (baseline from the port's encoder or cv2, or
    progressive from cv2): the overlays and scene renders match, and the
    overlay keeps the frame (as cv2 decodes it, flipped) where no body
    is drawn."""
    W, H, F_ = 320, 240, 300.0
    info = write_synthetic_prox_recording(str(tmp_path / "p"),
                                          num_frames=4, seed=7,
                                          write_depth=False,
                                          color_format="jpg")
    _write_jpeg_frames(info["recording_dir"], info["frame_names"], H, W,
                       encoder)
    models = tmp_path / "models"
    models.mkdir()
    np.savez(models / "SMPLX_MALE.npz", **info["model_dict"])
    fitting = os.path.join(str(tmp_path / "p"), "PROXD",
                           info["recording_name"])
    argv = ["--fitting_dir", fitting, "--model_folder", str(models),
            "--recording_dir", info["recording_dir"], "--flip", "true",
            "--start", "0", "--step", "2", "--count", "2",
            "--rendering_mode", "both", "--fx", str(F_), "--fy", str(F_),
            "--cx", str(W / 2), "--cy", str(H / 2)]
    j_cli.main(argv + ["--out_dir", str(tmp_path / "j")])
    t_cli.main(argv + ["--out_dir", str(tmp_path / "t")], device="cpu")
    args = t_cli.build_parser().parse_args(argv)
    frames, verts, faces, _ = t_cli.rebuild_bodies(args, "cpu")
    assert frames == info["frame_names"][0:4:2]
    for i, fn in enumerate(frames):
        src = os.path.join(info["recording_dir"], "Color", fn + ".jpg")
        with open(src, "rb") as fh:
            assert (b"\xff\xc2" in fh.read()) == (encoder == "cv2_progressive")
        flipped = cv2.imread(src)[:, ::-1, ::-1]
        np.testing.assert_array_equal(read_jpeg(src)[:, ::-1], flipped)
        for kind in ("output", "scene"):
            got = read_png(str(tmp_path / "t" / f"{fn}_{kind}.png"))
            ref = read_png(str(tmp_path / "j" / f"{fn}_{kind}.png"))
            _hold(got, ref, verts[i], faces, W, H, F_, W / 2, H / 2,
                  flipped if kind == "output" else None)


def test_run_prox_fitting_renders_jpeg_frames(tmp_path):
    """`run_prox_fitting` with `render_results` on two windows of 2 steps
    in each package over the same `.jpg` Color frames (the synthetic
    writer's, then 160x120 frames from the port's encoder): an overlay
    for every frame, each matching `lemo_tpu`'s, and the port's check
    passes baseline JPEG up front."""
    W, H, F_ = 160, 120, 100.0
    info = write_synthetic_prox_recording(str(tmp_path / "p"),
                                          num_frames=13, seed=2,
                                          write_depth=False,
                                          color_format="jpg")
    color = os.path.join(info["recording_dir"], "Color")
    assert sorted(os.listdir(color)) == sorted(
        fn + ".jpg" for fn in info["frame_names"])
    assert read_jpeg(os.path.join(color, os.listdir(color)[0])).shape == \
        (8, 8, 3)
    _write_jpeg_frames(info["recording_dir"], info["frame_names"], H, W,
                       "port")
    kw = dict(recording_dir=info["recording_dir"], batch_size=8, maxiters=2,
              lr=0.005, flip=True, s2m=False, m2s=False, read_depth=False,
              read_mask=False, sdf_penetration=False, use_friction=False,
              use_motion_smooth_prior=False, interpenetration=False,
              contact=False, use_motion_infill_prior=False,
              render_results=True, focal_length_x=F_, focal_length_y=F_,
              camera_center_x=W / 2, camera_center_y=H / 2)
    t_cfg = ProxConfig(output_folder=str(tmp_path / "t"), **kw)
    j_cfg = JConfig(output_folder=str(tmp_path / "j"), **kw)
    vpp = {k: v.cpu().numpy() for k, v in info["vposer_params"].items()}
    t_model = t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                     device="cpu")
    res = t_driver.run_prox_fitting(
        t_cfg, t_driver.ProxAssets(model=t_model,
                                   vposer_params=from_numpy_tree(vpp, "cpu")),
        verbose=False)
    ref = j_driver.run_prox_fitting(
        j_cfg, j_driver.ProxAssets(
            model=j_load(info["model_dict"], use_pca=True, num_pca_comps=12),
            vposer_params={k: jnp.asarray(v) for k, v in vpp.items()}),
        verbose=False)
    assert len(res) == len(ref) == 2
    for a, b in zip(res, ref):
        assert abs(a.final_loss - b.final_loss) <= 1e-3 * abs(b.final_loss)
    name = info["recording_name"]
    t_img = os.path.join(str(tmp_path / "t"), name, "images")
    j_img = os.path.join(str(tmp_path / "j"), name, "images")
    frames = info["frame_names"]
    assert sorted(os.listdir(t_img)) == sorted(os.listdir(j_img)) == \
        [fn + ".png" for fn in frames]
    # each frame's body from the later window that holds it, as both
    # drivers write it
    from lemo_tpu_torch.body_model import make_forward_fn
    from lemo_tpu_torch.data.prox import read_prox_pkl

    recs = [read_prox_pkl(os.path.join(str(tmp_path / "t"), name,
                                       "results", fn, "000.pkl"))
            for fn in frames]
    params = t_model.zero_params(len(frames))
    for k in params:
        params[k] = torch.as_tensor(np.stack([r[k] for r in recs]))
    with torch.no_grad():
        verts = make_forward_fn(t_model)(params, t_model.consts)[
            "vertices"].numpy()
    faces = np.asarray(t_model.faces)
    for i, fn in enumerate(frames):
        got = read_png(os.path.join(t_img, fn + ".png"))
        want = read_png(os.path.join(j_img, fn + ".png"))
        flipped = cv2.imread(os.path.join(color, fn + ".jpg"))[:, ::-1, ::-1]
        _hold(got, want, verts[i], faces, W, H, F_, W / 2, H / 2, flipped)
