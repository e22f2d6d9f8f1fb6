"""The port's PROX mesh/render saver (`save_meshes` / `render_results`,
fit_temp_loadprox_slide.py:596-704) through `run_prox_fitting`, windows in
sequence and window-parallel: a ply per frame with the model's vertices
and faces and an overlay png per frame (as tests/test_prox_pipeline.py
checks lemo_tpu's), held against lemo_tpu's saver run on the same window
results in the same order: ply vertices within 1e-5 m, overlay pixels
equal but for at most 0.5% of the body's pixels."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.data.prox import ProxRecording as JRecording
from lemo_tpu.fitting.prox import driver as j_driver
from lemo_tpu.testing.synthetic_prox import write_synthetic_prox_recording
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.config.prox_config import ProxConfig
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.data.png import read_png, write_png
from lemo_tpu_torch.data.prox import read_ply_mesh, read_prox_pkl, \
    sliding_windows
from lemo_tpu_torch.fitting.prox import driver as t_driver
from lemo_tpu_torch.utils.raster import rasterize_mesh

torch.set_num_threads(2)

W, H, F_ = 160, 120, 100.0


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    root = tmp_path_factory.mktemp("saver")
    info = write_synthetic_prox_recording(str(root / "p"), num_frames=13,
                                          seed=2, write_depth=False)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([xx, yy * 2, np.full_like(xx, 90)],
                   axis=-1).astype(np.uint8)
    for fn in info["frame_names"]:
        write_png(os.path.join(info["recording_dir"], "Color", fn + ".png"),
                  img)
    return root, info


@pytest.mark.parametrize("window_parallel", [False, True])
def test_saver_outputs_match(recording, window_parallel):
    root, info = recording
    tag = "wp" if window_parallel else "seq"
    cfg = ProxConfig(
        recording_dir=info["recording_dir"],
        output_folder=str(root / f"out_{tag}"),
        batch_size=8, maxiters=2, lr=0.005, flip=True,
        s2m=False, m2s=False, read_depth=False, read_mask=False,
        sdf_penetration=False, use_friction=False,
        use_motion_smooth_prior=False, interpenetration=False,
        contact=False, use_motion_infill_prior=False,
        save_meshes=True, render_results=True,
        window_parallel=window_parallel, window_polish_iters=0,
        focal_length_x=F_, focal_length_y=F_,
        camera_center_x=W / 2, camera_center_y=H / 2)
    model = t_load(info["model_dict"], use_pca=True, num_pca_comps=12,
                   device="cpu")
    vpp = {k: np.asarray(v) for k, v in info["vposer_params"].items()}
    results = t_driver.run_prox_fitting(
        cfg, t_driver.ProxAssets(model=model,
                                 vposer_params=from_numpy_tree(vpp, "cpu")),
        verbose=False)
    frames = info["frame_names"]
    spans = sliding_windows(len(frames), cfg.batch_size)
    assert len(results) == len(spans) == 2

    # lemo_tpu's saver on the same window results, in the same order
    ref_out = str(root / f"ref_{tag}")
    save = j_driver._make_window_extras_saver(
        cfg, j_driver.ProxAssets(
            model=j_load(info["model_dict"], use_pca=True, num_pca_comps=12),
            vposer_params={k: jnp.asarray(v) for k, v in vpp.items()}),
        JRecording.from_recording_dir(info["recording_dir"]), ref_out)
    for (s, e), r in zip(spans, results):
        save(frames[s:e], r)

    out = os.path.join(cfg.output_folder, info["recording_name"])
    # a frame both windows hold: its pkl, like its ply, is the later
    # window's in both drivers
    for w, (s, e) in enumerate(spans):
        for i, fn in enumerate(frames[s:e]):
            if w + 1 < len(spans) and spans[w + 1][0] <= s + i:
                continue
            rec = read_prox_pkl(os.path.join(out, "results", fn, "000.pkl"))
            np.testing.assert_array_equal(rec["transl"],
                                          results[w].params["transl"][i])
    assert sorted(os.listdir(os.path.join(out, "meshes"))) == frames
    assert sorted(os.listdir(os.path.join(out, "images"))) == \
        [fn + ".png" for fn in frames]
    for fn in frames:
        v, f = read_ply_mesh(os.path.join(out, "meshes", fn, "000.ply"))
        rv, rf = read_ply_mesh(os.path.join(ref_out, "meshes", fn,
                                            "000.ply"))
        assert v.shape == (model.num_verts, 3)
        np.testing.assert_array_equal(f, model.faces)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_allclose(v, rv, atol=1e-5)
        got = read_png(os.path.join(out, "images", fn + ".png"))
        ref = read_png(os.path.join(ref_out, "images", fn + ".png"))
        body = rasterize_mesh(v, f, W, H, F_, F_, W / 2, H / 2)[2].sum()
        assert got.shape == ref.shape == (H, W, 3) and body > 100
        assert (got != ref).any(-1).sum() <= 0.005 * body


def test_saver_off_without_flags(recording):
    root, info = recording
    cfg = dataclasses.replace(ProxConfig(), recording_dir=info[
        "recording_dir"])
    assert t_driver._make_window_extras_saver(cfg, None, None, "x") is None


@pytest.mark.parametrize("with_faces", [True, False])
def test_ply_writer_bytes_match(tmp_path, with_faces):
    """The saver's ply files are byte for byte lemo_tpu's."""
    from lemo_tpu.data.prox import write_ply_vertices as j_write
    from lemo_tpu_torch.data.prox import write_ply_vertices as t_write

    rng = np.random.RandomState(5)
    v = (rng.randn(300, 3) * [1.0, 1e-5, 1e3]).astype(np.float32)
    f = rng.randint(0, 300, (500, 3)).astype(np.int32) if with_faces \
        else None
    t_write(str(tmp_path / "t.ply"), v, faces=f)
    j_write(str(tmp_path / "j.ply"), v, faces=f)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
