"""The port's host rasterizer (`utils/raster.py`, a copy) and its
render_fitting CLI against lemo_tpu's: the three raster functions
array-equal; both CLIs on one fitted synthetic recording, the rebuilt
vertices within 1e-5 m and every written PNG's pixels equal but for at
most 0.5% of the body's pixels (the vertices' rounding moves edge
pixels)."""

import os

import numpy as np
import pytest
import torch

from lemo_tpu.cli import render_fitting as j_cli
from lemo_tpu.testing.synthetic_prox import write_synthetic_prox_recording
from lemo_tpu.utils import raster as J
from lemo_tpu_torch.cli import render_fitting as t_cli
from lemo_tpu_torch.data.png import read_png, write_png
from lemo_tpu_torch.utils import raster as T
from tests.test_visibility_oracle import uv_sphere

torch.set_num_threads(2)

F_, W, H = 300.0, 320, 240


def _scene():
    body_v, body_f = uv_sphere([0.1, 0.05, 2.0], 0.4, n_theta=12, n_phi=12)
    scene_v = np.array([[-2, -2, 3.0], [2, -2, 3.0], [2, 2, 2.5],
                        [-2, 2, 1.8]], np.float64)
    scene_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return body_v, body_f, scene_v, scene_f


def test_rasterize_mesh_equal():
    body_v, body_f, _, _ = _scene()
    for a, b in zip(T.rasterize_mesh(body_v, body_f, W, H, F_, F_, 150, 110),
                    J.rasterize_mesh(body_v, body_f, W, H, F_, F_, 150,
                                     110)):
        np.testing.assert_array_equal(a, b)


def test_render_body_in_scene_equal():
    body_v, body_f, scene_v, scene_f = _scene()
    got = T.render_body_in_scene(body_v, body_f, scene_v, scene_f, W, H,
                                 F_, F_, W / 2, H / 2)
    ref = J.render_body_in_scene(body_v, body_f, scene_v, scene_f, W, H,
                                 F_, F_, W / 2, H / 2)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)


@pytest.mark.parametrize("dtype", ["uint8", "float"])
def test_render_body_overlay_equal(dtype):
    body_v, body_f, _, _ = _scene()
    img = np.random.RandomState(2).randint(0, 256, (H, W, 3)).astype(
        np.uint8)
    if dtype == "float":
        img = img / 255.0
    got = T.render_body_overlay(body_v, body_f, img, F_, F_, W / 2, H / 2,
                                color=(0.7, 0.7, 0.7))
    ref = J.render_body_overlay(body_v, body_f, img, F_, F_, W / 2, H / 2,
                                color=(0.7, 0.7, 0.7))
    np.testing.assert_array_equal(got, ref)
    assert T.PINK == J.PINK


def _write_color_frames(rec_dir, frames):
    """320x240 Color frames, asymmetric left to right (so the flip
    shows), written as RGB PNGs."""
    yy, xx = np.mgrid[0:H, 0:W]
    for k, fn in enumerate(frames):
        img = np.stack([(xx * 255 // W), (yy * 255 // H),
                        np.full_like(xx, 40 * k)], axis=-1).astype(np.uint8)
        write_png(os.path.join(rec_dir, "Color", fn + ".png"), img)


def test_render_fitting_clis_match(tmp_path):
    info = write_synthetic_prox_recording(str(tmp_path / "p"), num_frames=6,
                                          seed=7, write_depth=False)
    _write_color_frames(info["recording_dir"], info["frame_names"])
    models = tmp_path / "models"
    models.mkdir()
    np.savez(models / "SMPLX_MALE.npz", **info["model_dict"])
    fitting = os.path.join(str(tmp_path / "p"), "PROXD",
                           info["recording_name"])
    argv = ["--fitting_dir", fitting, "--model_folder", str(models),
            "--recording_dir", info["recording_dir"], "--flip", "true",
            "--start", "0", "--step", "2", "--count", "3",
            "--rendering_mode", "both", "--fx", str(F_), "--fy", str(F_),
            "--cx", "160", "--cy", "120"]
    j_cli.main(argv + ["--out_dir", str(tmp_path / "j")])
    t_cli.main(argv + ["--out_dir", str(tmp_path / "t")], device="cpu")

    args = t_cli.build_parser().parse_args(argv)
    frames, verts, faces, _ = t_cli.rebuild_bodies(args, "cpu")
    assert frames == info["frame_names"][0:6:2]
    from lemo_tpu.body_model import load_model, make_forward_fn
    from lemo_tpu.data.prox import read_prox_pkl

    jm = load_model(info["model_dict"], use_pca=True, num_pca_comps=12)
    recs = [read_prox_pkl(os.path.join(fitting, "results", fn, "000.pkl"))
            for fn in frames]
    params = jm.zero_params(len(recs))
    for k in params:
        params[k] = np.stack([r[k] for r in recs])
    ref_v = np.asarray(make_forward_fn(jm)(params, jm.consts)["vertices"])
    np.testing.assert_allclose(verts, ref_v, atol=1e-5)

    for name in ["fitting_frames.png"]:
        assert os.path.getsize(tmp_path / "t" / name) > 1000
    for i, fn in enumerate(frames):
        _, _, body = T.rasterize_mesh(verts[i], faces, W, H, F_, F_, 160,
                                      120)
        assert body.sum() > 500
        for kind in ("output", "scene"):
            got = read_png(str(tmp_path / "t" / f"{fn}_{kind}.png"))
            ref = read_png(str(tmp_path / "j" / f"{fn}_{kind}.png"))
            assert got.shape == ref.shape == (H, W, 3)
            n_diff = int((got != ref).any(-1).sum())
            assert n_diff <= 0.005 * body.sum(), (fn, kind, n_diff)
        # the overlay keeps the flipped frame where no body is drawn
        over = read_png(str(tmp_path / "t" / f"{fn}_output.png"))
        assert over[0, 0, 0] == 255 * (W - 1) // W


@pytest.mark.parametrize("mode,refused", [("body", True), ("both", True),
                                          ("3d", False)])
def test_render_fitting_refuses_jpeg_frames(tmp_path, monkeypatch, mode,
                                            refused):
    """A Color folder with a `.jpg` frame that the port's decoder refuses
    (a baseline file's SOF0 made SOF3, lossless) is refused before the
    bodies are rebuilt when overlays are asked for, with the marker
    named; `--rendering_mode 3d` reads no Color frame and goes on. The
    same frame as baseline JPEG passes the check in every mode."""
    import cv2

    color = tmp_path / "rec" / "Color"
    color.mkdir(parents=True)
    frame = color / "s001_frame_00001__00.00.00.029.jpg"
    img = np.random.RandomState(1).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    data = buf.tobytes()
    sof = data.index(b"\xff\xc0")
    frame.write_bytes(data[:sof + 1] + b"\xc3" + data[sof + 2:])
    rebuilt = []
    monkeypatch.setattr(t_cli, "rebuild_bodies",
                        lambda args, dev: rebuilt.append(1) or
                        ([], None, None, 0))
    argv = ["--fitting_dir", str(tmp_path / "fit"), "--model_folder",
            str(tmp_path), "--recording_dir", str(color.parent),
            "--rendering_mode", mode]
    if refused:
        with pytest.raises(ValueError, match=r"SOF3 \(lossless\)"):
            t_cli.main(argv, device="cpu")
        assert rebuilt == []
    else:
        t_cli.main(argv, device="cpu")
        assert rebuilt == [1]
    assert cv2.imwrite(str(frame), img)
    t_cli.main(argv, device="cpu")
    assert rebuilt == ([1] if refused else [1, 1])
