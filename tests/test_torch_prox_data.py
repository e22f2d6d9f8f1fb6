"""The port's PROX data layer against `lemo_tpu`'s and against the
libraries it replaces (which the port itself never imports): the YAML
reader and writer against `yaml`, the PNG codec and the lens model
against `cv2`, and window loading against `lemo_tpu.data.prox`."""

import dataclasses
import glob
import os
import pickle
import tempfile

import cv2
import numpy as np
import pytest
import torch
import yaml

from lemo_tpu.config import parse_config as j_parse
from lemo_tpu.data.prox import ProxRecording as JRec
from lemo_tpu.data.prox import ProxWindowDataset as JDataset
from lemo_tpu.testing.synthetic_prox import \
    write_synthetic_prox_recording as j_write
from lemo_tpu_torch.config import parse_config
from lemo_tpu_torch.config.prox_config import ProxConfig, check_ported
from lemo_tpu_torch.config.yaml_subset import dump_yaml, load_yaml
from lemo_tpu_torch.data import png
from lemo_tpu_torch.data.projection import project_points, undistort_points
from lemo_tpu_torch.data.prox import ProxRecording, ProxWindowDataset, \
    sliding_windows
from lemo_tpu_torch.testing.synthetic_prox import \
    write_synthetic_prox_recording as t_write

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "cfg_files", "*.yaml")))
S3_ALL = os.path.join(REPO, "cfg_files", "PROXD_temp_S3_all_terms.yaml")


@pytest.fixture(scope="module")
def jax_recording():
    base = tempfile.mkdtemp()
    return j_write(base, num_frames=12, seed=2)


@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_yaml_reader_matches_safe_load(path):
    with open(path) as fh:
        text = fh.read()
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_parse_config_matches_jax(path):
    cfg = parse_config(["--config", path, "--maxiters", "7", "--s2m",
                        "true", "--frame_ids", "1", "3"])
    ref = j_parse(["--config", path, "--maxiters", "7", "--s2m", "true",
                   "--frame_ids", "1", "3"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


def test_conf_yaml_round_trip():
    cfg = parse_config(["--config", CFGS[0]])
    cfg.output_folder = 'a "quoted" yes # path'
    cfg.frame_ids = [1, 5]
    cfg.lr = 1e-05
    d = dataclasses.asdict(cfg)
    text = dump_yaml(d)
    assert load_yaml(text) == d
    assert yaml.safe_load(text) == d


@pytest.mark.parametrize("bad", ["a:\n  - 1\n", "a: {b: 1}\n", "a: 1:30\n",
                                 "- 1\n"])
def test_yaml_outside_subset_raises(bad):
    with pytest.raises(ValueError):
        load_yaml(bad)


@pytest.mark.parametrize("field,value", [("interpenetration", True),
                                         ("window_parallel", True),
                                         ("save_meshes", True),
                                         ("render_results", True)])
def test_unported_options_raise(field, value):
    """The options that once raised for want of their path
    (interpenetration, window_parallel, and save_meshes / render_results
    until the mesh/render saver) all pass the check now, alone and on the
    all-terms config."""
    cfg = dataclasses.replace(ProxConfig(), **{field: value})
    check_ported(cfg)
    shipped = parse_config(["--config", S3_ALL, f"--{field}", "true"])
    assert getattr(shipped, field) is True
    assert shipped.interpenetration and shipped.coll_candidates == 8192
    check_ported(shipped)


def test_render_results_refuses_jpeg_frames(tmp_path):
    """`render_results` over a JPEG Color frame that the port's decoder
    refuses (a progressive file cut after its third scan: its scans
    incomplete) stops `run_prox_fitting` before it loads or fits
    anything, with the frame and the reason named; with the flag off, or
    with the frame as a whole progressive or baseline JPEG (which the
    port decodes, as `lemo_tpu`'s cv2 does) or as PNG, the check
    passes."""
    from lemo_tpu_torch.fitting.prox.driver import run_prox_fitting

    color = tmp_path / "recordings" / "N0Sittingbooth_00162_01" / "Color"
    color.mkdir(parents=True)
    jpg = color / "s001_frame_00001__00.00.00.029.jpg"
    img = np.random.RandomState(0).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    whole = buf.tobytes()
    sos = whole.index(b"\xff\xda", whole.index(b"\xff\xda") + 2)
    sos = whole.index(b"\xff\xda", sos + 2)
    sos = whole.index(b"\xff\xda", sos + 2)
    jpg.write_bytes(whole[:whole.rfind(b"\xff\xc4", 0, sos)] + b"\xff\xd9")
    cfg = dataclasses.replace(
        ProxConfig(), recording_dir=str(color.parent), render_results=True,
        output_folder=str(tmp_path / "out"))
    with pytest.raises(ValueError, match="progressive scans incomplete") as e:
        check_ported(cfg)
    assert str(jpg) in str(e.value)
    with pytest.raises(ValueError, match="progressive scans incomplete"):
        run_prox_fitting(cfg, device="cpu")
    assert not (tmp_path / "out").exists()
    check_ported(dataclasses.replace(cfg, render_results=False))
    jpg.write_bytes(whole)
    check_ported(cfg)
    np.testing.assert_array_equal(png.read_color_frame(str(jpg)),
                                  cv2.imread(str(jpg))[:, :, ::-1])
    assert cv2.imwrite(str(jpg), img)
    check_ported(cfg)
    np.testing.assert_array_equal(png.read_color_frame(str(jpg)),
                                  cv2.imread(str(jpg))[:, :, ::-1])
    jpg.rename(jpg.with_suffix(".png"))
    check_ported(cfg)


@pytest.mark.parametrize("sub", ["Depth", "BodyIndexColor", "Color"])
def test_png_decoder_matches_cv2(jax_recording, sub):
    files = sorted(glob.glob(os.path.join(jax_recording["recording_dir"],
                                          sub, "*.png")))[:3]
    assert files
    for f in files:
        ref = cv2.imread(f, -1)
        out = png.read_png(f)
        if ref.ndim == 3:
            ref = ref[..., ::-1]          # cv2 gives BGR
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype,shape", [(np.uint8, (23, 31)),
                                         (np.uint16, (17, 29)),
                                         (np.uint8, (9, 11, 3))])
def test_png_writer_every_filter(ftype, dtype, shape):
    rng = np.random.RandomState(ftype)
    img = (rng.rand(*shape) * np.iinfo(dtype).max).astype(dtype)
    path = os.path.join(tempfile.mkdtemp(), "x.png")
    png.write_png(path, img, filter_type=ftype)
    np.testing.assert_array_equal(png.read_png(path), img)
    ref = cv2.imread(path, -1)
    np.testing.assert_array_equal(ref if ref.ndim == 2 else ref[..., ::-1],
                                  img)


def test_undistortion_matches_cv2():
    A = np.array([[365.2, 0, 257.1], [0, 364.8, 211.3], [0, 0, 1.0]])
    k = np.array([0.091, -0.271, 0.0012, -0.0021, 0.093])
    uv = np.stack(np.meshgrid(np.arange(0, 512, 9), np.arange(0, 424, 7)),
                  -1).reshape(-1, 2).astype(np.float64)
    ref = cv2.undistortPoints(uv.reshape(1, -1, 2).copy(), A, k)
    np.testing.assert_allclose(undistort_points(uv, A, k),
                               ref.reshape(-1, 2), rtol=0, atol=1e-12)


def test_projection_matches_cv2():
    A = np.array([[1060.5, 0, 951.3], [0, 1060.4, 536.8], [0, 0, 1.0]])
    k = np.array([0.05, -0.11, 0.001, 0.002, 0.03])
    R = cv2.Rodrigues(np.array([0.05, -0.1, 0.02]))[0]
    T = np.array([0.05, -0.02, 0.1])
    pts = np.random.RandomState(0).randn(300, 3) * 0.4 + [0, 0, 2.5]
    ref, _ = cv2.projectPoints(pts, R, T, A, k)
    np.testing.assert_allclose(project_points(pts, R, T, A, k),
                               ref.reshape(-1, 2), rtol=1e-12, atol=1e-9)


def _datasets(rec_dir, out_dir, batch):
    kw = dict(output_params_dir=out_dir, batch_size=batch, flip=True)
    return (ProxWindowDataset(ProxRecording.from_recording_dir(rec_dir),
                              **kw),
            JDataset(JRec.from_recording_dir(rec_dir), **kw))


def _same_window(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "warm_start":
            _same_window(a[k], b[k])
        elif k == "fns":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_load_window_matches_jax(jax_recording):
    td, jd = _datasets(jax_recording["recording_dir"], tempfile.mkdtemp(), 8)
    assert td.windows == jd.windows == sliding_windows(12, 8)
    np.testing.assert_array_equal(td.joint_weights(), jd.joint_weights())
    for w in range(len(td.windows)):
        wt, wj = td.load_window(w), jd.load_window(w)
        assert wt["scan_mask"].sum() > 0
        _same_window(wt, wj)


def test_writer_depth_is_a_zbuffered_splat():
    """Each vertex covers the (2r+1)^2 pixels around its projection and
    the nearest surface wins."""
    from lemo_tpu_torch.testing import synthetic_prox as sp

    r = sp.DEPTH_SPLAT_RADIUS
    # two vertices projecting to pixel (u, w) = (256, 212), then a farther
    # one to (256 + r + 1, 212) whose splat overlaps theirs by r columns
    v = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 1.5],
                  [(r + 1) * 3.0 / 365.0, 0.0, 3.0]])
    d = sp._render_depth(v, 365.0, 365.0, 256.0, 212.0)
    assert d.shape == (sp.DEPTH_H, sp.DEPTH_W)
    assert (d[212 - r:212 + r + 1, 256 - r:256 + r + 1] == 1.5).all()
    assert (d[212 - r:212 + r + 1, 256 + r + 1:256 + 2 * r + 2] == 3.0).all()
    assert (d > 0).sum() == (2 * r + 1) * (3 * r + 2)


def test_port_writer_reads_back_in_both_packages():
    """The port's recording (its own body model, VPoser and PNG encoder)
    is a PROX recording to both packages' loaders."""
    base = tempfile.mkdtemp()
    info = t_write(base, num_frames=10, seed=4)
    td, jd = _datasets(info["recording_dir"], tempfile.mkdtemp(), 10)
    wt, wj = td.load_window(0), jd.load_window(0)
    _same_window(wt, wj)
    assert wt["scan_mask"].sum(axis=1).min() > 50
    d = cv2.imread(glob.glob(os.path.join(info["recording_dir"], "Depth",
                                          "*.png"))[0], -1)
    assert d.dtype == np.uint16 and d.max() > 0
    fn = info["frame_names"][0]
    with open(os.path.join(base, "PROXD", info["recording_name"], "results",
                           fn, "000.pkl"), "rb") as fh:
        rec = pickle.load(fh)
    assert rec["pose_embedding"].shape == (1, 32)
