"""The port's drawings (`utils/plot3d.py`, `utils/viz.py`,
`utils/mesh_viewer.py`) against lemo_tpu's matplotlib ones: the 3-D view
equal to mplot3d's `proj_transform`, the marker sheet at lemo_tpu's size
with its colours where the view puts them, the fit overlay's cyan blend
exactly where the camera projects, the mesh images and grids; both CLIs
that draw run to their end with matplotlib unimportable, and no module
of the port imports it."""

import ast
import os
import subprocess
import sys

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from mpl_toolkits.mplot3d import proj3d

from lemo_tpu.fitting.prox.camera import PerspectiveCamera as JCamera
from lemo_tpu.utils import mesh_viewer as JM
from lemo_tpu.utils import viz as JV
from lemo_tpu_torch.data.png import read_png
from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera as TCamera
from lemo_tpu_torch.testing.sheet_check import sheet_faults
from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.testing.synthetic_prox import (
    write_synthetic_prox_recording)
from lemo_tpu_torch.utils import mesh_viewer as TM
from lemo_tpu_torch.utils import plot3d as P
from lemo_tpu_torch.utils import viz as TV

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(seed: int, flat: bool) -> np.ndarray:
    """A seeded [67, 3] marker frame; `flat`: every z equal."""
    x = np.random.RandomState(seed).randn(67, 3).astype(np.float32)
    if flat:
        x[:, 2] = 0.7
    return x


@pytest.mark.parametrize("flat", [False, True], ids=["spread", "flat_z"])
@pytest.mark.parametrize("elev,azim", [(30, -60), (10, -60), (10, 30)])
def test_projection_equals_mplot3d(flat, elev, azim):
    """lemo_tpu's frame (contact on, a second sequence on the same axes)
    on a fresh 3-D axis: the port's panel of the same frame projects
    every marker where `proj_transform(x, y, z, ax.get_proj())` does."""
    x = _frame(1000 + 100 * elev + azim, flat)
    contact = np.array([1.0, 0.0, 1.0, 1.0])
    fig = plt.figure(figsize=(3, 3))
    ax = fig.add_subplot(111, projection="3d")
    JV.plot_marker_frame(ax, x, "C0", contact)
    JV.plot_marker_frame(ax, x + 0.1, "C3")
    ax.view_init(elev=elev, azim=azim)
    ref = proj3d.proj_transform(x[:, 0], x[:, 1], x[:, 2], ax.get_proj())
    plt.close(fig)
    panel = P.Panel(elev, azim)
    TV.plot_marker_frame(panel, x, "C0", contact)
    TV.plot_marker_frame(panel, x + 0.1, "C3")
    for got, want in zip(panel.project(x), ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


SHEETS = {
    # the contact labels, the second sequence in C3, stride 2
    "second_seq": dict(T=8, second=True, stride=2, max_frames=16),
    # vis_opt_amass's call: stride 4, at most 16 panels, two rows
    "vis_opt_amass": dict(T=30, second=False, stride=4, max_frames=16),
}


@pytest.mark.parametrize("case", sorted(SHEETS))
def test_marker_sheet(case, tmp_path):
    """Both packages' sheets from the same arguments have one size
    (lemo_tpu's png is RGBA, the port's RGB), and each panel's drawing
    spans lemo_tpu's to 10 px on each side; in
    the port's each marker's pixel is C0 (C3 for the second sequence),
    each contact slot labelled above 0.5 red, unless a nearer disc
    covers it, the other slots not red, each limb's midpoint drawn and
    each title band dark somewhere (`testing.sheet_check`)."""
    c = SHEETS[case]
    rng = np.random.RandomState(len(case))
    seq = rng.randn(c["T"], 67, 3).astype(np.float32)
    contact = (rng.rand(c["T"], 4) > 0.5).astype(np.float32)
    second = seq + 0.1 if c["second"] else None
    kw = dict(second_seq=second, stride=c["stride"],
              max_frames=c["max_frames"])
    TV.save_marker_animation(seq, str(tmp_path / "t.png"), contact, **kw)
    JV.save_marker_animation(seq, str(tmp_path / "j.png"), contact, **kw)
    got = read_png(str(tmp_path / "t.png"))
    ref = read_png(str(tmp_path / "j.png"))[..., :3]
    assert got.shape == ref.shape
    # each panel's drawing (below its title) spans lemo_tpu's to 10 px
    for r in range(got.shape[0] // TV.PANEL_PX):
        for col in range(got.shape[1] // TV.PANEL_PX):
            spans = []
            for im in (got, ref):
                cell = im[r * TV.PANEL_PX + 20:(r + 1) * TV.PANEL_PX,
                          col * TV.PANEL_PX:(col + 1) * TV.PANEL_PX]
                ys, xs = np.nonzero((cell < 200).any(-1))
                spans.append(np.array([ys.min(), ys.max(), xs.min(),
                                       xs.max()]))
            assert np.abs(spans[0] - spans[1]).max() <= 10, (r, col, spans)
    faults, n = sheet_faults(got, seq, contact, second, c["stride"],
                             c["max_frames"])
    assert not faults, faults[:5]
    assert n["checked"] > 0.8 * n["discs"] and n["limbs"] > 0
    assert 0 < n["red_seen"] <= n["contacts"]


@pytest.mark.parametrize("spread", [0.3, 1.5], ids=["in_frame",
                                                     "past_the_edges"])
def test_fit_overlay(spread, tmp_path):
    """The port's projected vertices within 0.5 px of lemo_tpu's camera;
    the pixels holding them are the frame blended 0.4 toward cyan, every
    other pixel the frame's."""
    rng = np.random.RandomState(int(spread * 10))
    verts = (rng.randn(300, 3) * spread + [0, 0, 3]).astype(np.float32)
    image = rng.randint(0, 256, (90, 160, 3)).astype(np.uint8)
    kw = dict(focal_length_x=120.0, focal_length_y=110.0,
              center=(80.0, 45.0))
    TV.render_fit_overlay(verts, None, image, TCamera(**kw),
                          str(tmp_path / "t.png"))
    pts = TCamera(**kw).project(torch.as_tensor(verts)).numpy()
    ref = np.asarray(JCamera(**kw).project(verts))
    assert np.abs(pts - ref).max() <= 0.5
    got = read_png(str(tmp_path / "t.png"))
    assert got.shape == image.shape
    uv = np.floor(pts).astype(int)
    uv = uv[(uv[:, 0] >= 0) & (uv[:, 0] < 160) & (uv[:, 1] >= 0)
            & (uv[:, 1] < 90)]
    assert 50 < len(uv) and (spread < 1 or len(uv) < len(verts))
    hit = np.zeros((90, 160), bool)
    hit[uv[:, 1], uv[:, 0]] = True
    blend = np.rint(0.6 * image + 0.4 * np.array([0, 255, 255]))
    np.testing.assert_array_equal(got[hit], blend[hit].astype(np.uint8))
    np.testing.assert_array_equal(got[~hit], image[~hit])


@pytest.mark.parametrize("kind", ["faces", "points"])
@pytest.mark.parametrize("elev,azim", [(10, -60), (30, 30)])
def test_mesh_image(kind, elev, azim):
    """A [size[1], size[0], 3] image, white around the body, and every
    projected vertex's pixel drawn, with faces and as points."""
    md = synthetic_smplx_npz(num_verts=200)
    v = md["v_template"]
    img = TM.render_mesh_image(v, md["f"] if kind == "faces" else None,
                               size=(120, 100), elev=elev, azim=azim)
    assert img.shape == (100, 120, 3) and img.dtype == np.uint8
    white = (img == 255).all(-1)
    assert white[:, :10].all() and white[:, -10:].all()
    assert 0.5 < white.mean() < 1.0
    ax = P.Panel(elev, azim)
    ax.scatter(v, s=1, color="C0")
    tx, ty, _ = ax.project(v)
    u, w = P.view_to_pixels(tx, ty, TM.view_box((120, 100)))
    assert not white[np.floor(w).astype(int), np.floor(u).astype(int)].any()
    if kind == "faces":     # shaded: more than one colour on the body
        assert len(np.unique(img[~white], axis=0)) > 3
    else:
        assert TM.points_to_spheres(v[:3], 0.02) == {
            **JM.points_to_spheres(v[:3], 0.02),
            "centers": pytest.approx(v[:3])}


def _images():
    rng = np.random.RandomState(4)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((30, 40), (20, 40), (30, 25), (30, 40))]


@pytest.mark.parametrize("grid", ["imagearray2file", "show_image_grid"])
def test_grids(grid, tmp_path):
    """imagearray2file tiles [R, C] at R x C; show_image_grid tiles n at
    ceil(n / cols) x cols, written or returned; each cell of the largest
    height and width holds its image at its top left, white around."""
    ims = _images()
    out = str(tmp_path / "g.png")
    if grid == "imagearray2file":
        arr = np.stack([ims[0], ims[3]] * 2).reshape(2, 2, 30, 40, 3)
        assert TM.imagearray2file(arr, out) == out
        cells, cols, (h, w) = list(arr.reshape(4, 30, 40, 3)), 2, (30, 40)
    else:
        cells, cols, (h, w) = ims[:3], 2, (30, 40)
        assert TM.show_image_grid(cells, cols=cols, outpath=out) == out
        np.testing.assert_array_equal(TM.show_image_grid(cells, cols=cols),
                                      read_png(out))
    got = read_png(out)
    assert got.shape == (2 * h, cols * w, 3)
    seen = np.zeros(got.shape[:2], bool)
    for i, im in enumerate(cells):
        r, c = divmod(i, cols)
        np.testing.assert_array_equal(
            got[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]], im)
        seen[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = True
    assert (got[~seen] == 255).all()


def test_clis_draw_without_matplotlib(tmp_path):
    """With matplotlib unimportable, vis_opt_amass's and render_fitting's
    `main`s (`--rendering_mode both`) run to their end on the CPU and
    write every file: the sheets, each frame's overlay and scene."""
    models = tmp_path / "models"
    models.mkdir()
    for g in ("male", "female"):
        np.savez(models / f"SMPLX_{g.upper()}.npz",
                 **synthetic_smplx_npz(num_verts=536, gender=g, seed=5))
    res = tmp_path / "res" / "TotalCapture"
    res.mkdir(parents=True)
    rng = np.random.RandomState(3)
    np.save(res / "body_params_opt_clip_0.npy",
            (rng.randn(24, 72) * 0.3).astype(np.float32))
    np.save(res / "contact_lbl_rec_clip_0.npy",
            (rng.rand(24, 4) > 0.5).astype(np.float32))
    np.save(res / "gender_list.npy", np.array([1]))
    info = write_synthetic_prox_recording(str(tmp_path / "p"), num_frames=6,
                                          seed=7, write_depth=False)
    np.savez(models / "SMPLX_MALE.npz", **info["model_dict"])
    fitting = os.path.join(str(tmp_path / "p"), "PROXD",
                           info["recording_name"])
    out = tmp_path / "out"
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['mpl_toolkits'] = None\n"
        "from lemo_tpu_torch.cli import render_fitting, vis_opt_amass\n"
        f"vis_opt_amass.main(['--res_dir', {str(tmp_path / 'res')!r}, "
        f"'--body_model_path', {str(models)!r}, '--out', "
        f"{str(out / 'vis.png')!r}], device='cpu')\n"
        f"render_fitting.main(['--fitting_dir', {fitting!r}, "
        f"'--model_folder', {str(models)!r}, '--recording_dir', "
        f"{info['recording_dir']!r}, '--step', '2', '--count', '3', "
        "'--rendering_mode', 'both', '--fx', '300', '--fy', '300', "
        f"'--cx', '160', '--cy', '120', '--out_dir', {str(out)!r}], "
        "device='cpu')\n"
        "assert sys.modules['matplotlib'] is None\n")
    out.mkdir()
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    frames = info["frame_names"][0:6:2]
    want = {"vis.png", "fitting_frames.png"} | \
        {f"{fn}_{k}.png" for fn in frames for k in ("output", "scene")}
    assert want <= set(os.listdir(out)), sorted(os.listdir(out))
    assert read_png(str(out / "vis.png")).shape == (2 * 270, 4 * 270, 3)
    assert read_png(str(out / "fitting_frames.png")).shape == (270, 810, 3)


def test_port_imports_no_matplotlib():
    """No module of the port imports matplotlib or mpl_toolkits, at its
    top or inside a function."""
    found = []
    root = os.path.join(REPO, "lemo_tpu_torch")
    n_files = 0
    for d, subdirs, files in os.walk(root):
        if "_build" in subdirs:     # build outputs, git-ignored
            subdirs.remove("_build")
        for f in files:
            if not f.endswith(".py"):
                continue
            n_files += 1
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                found += [(path, name) for name in names
                          if name.split(".")[0] in ("matplotlib",
                                                    "mpl_toolkits")]
    assert n_files > 50 and not found, found
