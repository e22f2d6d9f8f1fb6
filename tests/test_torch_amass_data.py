"""The AMASS data layer in the port vs lemo_tpu: the scan, every
representation mode of the builder, build_dataset with the ground-truth
hooks, the statistics' npz schemas, the Gaussian smoothing, the marker
tables and the synthetic writers."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from lemo_tpu.data import amass as j_amass
from lemo_tpu.data import markers as j_markers
from lemo_tpu.data import repr as j_repr
from lemo_tpu.data import stats as j_stats
from lemo_tpu.fitting import infill as j_infill
from lemo_tpu.ops import signal as j_signal
from lemo_tpu.testing import synthetic as j_synth
from lemo_tpu_torch.data import amass as t_amass
from lemo_tpu_torch.data import markers as t_markers
from lemo_tpu_torch.data import repr as t_repr
from lemo_tpu_torch.data import stats as t_stats
from lemo_tpu_torch.fitting import infill as t_infill
from lemo_tpu_torch.ops import signal as t_signal
from lemo_tpu_torch.testing import synthetic as t_synth

torch.set_num_threads(2)

T = 120          # 4 s at 30 fps
REP_ATOL = 1e-5  # representations, port vs lemo_tpu


@pytest.fixture(scope="module")
def amass_root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("amass"))
    t_synth.write_amass_dataset(d, "TotalCapture", num_subjects=1,
                                seqs_per_subject=2, num_frames=480, fps=60)
    t_synth.write_amass_dataset(d, "HumanEva", num_subjects=1,
                                seqs_per_subject=1, num_frames=600, fps=120)
    return d


@pytest.fixture(scope="module")
def builders():
    """lemo_tpu's builder and the port's, the port's representations
    computed on lemo_tpu's forward output: the two forwards differ by
    ~5e-7 m (held by test_markers_and_joints_match), and on the 400-vertex
    body, whose folded marker slots put the shoulder and hip markers
    close together, the heading amplifies that past the representations'
    tolerance. The transforms are what this file holds."""
    models = {g: j_synth.synthetic_smplx_npz(num_verts=400, gender=g, seed=2)
              for g in ("male", "female")}
    jb = j_amass.AmassRepresentationBuilder(models, with_hand=False)
    tb = t_amass.AmassRepresentationBuilder(models, with_hand=False,
                                            device="cpu")
    tb.own_forward = tb.markers_and_joints

    def shared(clip, T):
        m, j = jb.markers_and_joints(clip, T)
        return torch.as_tensor(np.array(m)), torch.as_tensor(np.array(j))

    tb.markers_and_joints = shared
    return jb, tb


@pytest.fixture(scope="module")
def clips(amass_root):
    ref = j_amass.scan_amass(["TotalCapture", "HumanEva"], amass_root)
    out = t_amass.scan_amass(["TotalCapture", "HumanEva"], amass_root)
    return ref, out


def _close(out, ref, atol=REP_ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol,
                               rtol=0)


def test_scan_matches(clips):
    ref, out = clips
    assert len(out) == len(ref) == 2 * 2 + 1
    for a, b in zip(out, ref):
        assert (a.gender, a.src_fps) == (b.gender, b.src_fps)
        for k in ("trans", "poses", "betas"):
            assert getattr(a, k).dtype == getattr(b, k).dtype
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.poses.shape == (T, 156)


def test_scan_skips_unsupported_fps(tmp_path):
    d = tmp_path / "BadSet" / "s0"
    d.mkdir(parents=True)
    np.savez(d / "x_poses.npz", poses=np.zeros((500, 156)),
             trans=np.zeros((500, 3)), betas=np.zeros(16),
             gender=np.array("male"), mocap_framerate=np.array(25.0))
    assert t_amass.scan_amass(["BadSet"], str(tmp_path)) == []


def test_markers_and_joints_match(builders, clips):
    jb, tb = builders
    for c_ref, c in zip(*clips):
        m_ref, j_ref = jb.markers_and_joints(c_ref, T)
        m, j = tb.own_forward(c, T)
        _close(m, m_ref)
        _close(j, j_ref)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("mode", ["local_markers_4chan", "local_markers",
                                  "local_joints_4chan"])
def test_local_modes_match(builders, clips, mode, smooth):
    jb, tb = builders
    for c_ref, c in zip(*clips):
        img_ref, piv_ref = getattr(jb, mode)(c_ref, T, smooth_forward=smooth)
        img, piv = getattr(tb, mode)(c, T, smooth_forward=smooth)
        assert tuple(img.shape) == tuple(img_ref.shape)
        _close(img, img_ref)
        _close(piv, piv_ref)


@pytest.mark.parametrize("with_hand", [False, True])
@pytest.mark.parametrize("mode", ["global_joints", "local_joints"])
def test_joint_modes_match(builders, clips, mode, with_hand):
    jb, tb = builders
    c_ref, c = clips[0][0], clips[1][0]
    ref = getattr(jb, mode)(c_ref, T, with_hand=with_hand)
    out = getattr(tb, mode)(c, T, with_hand=with_hand)
    assert out.shape == (T, (55 if with_hand else 25) * 3)
    _close(out, ref)


def test_global_markers_match(builders, clips):
    jb, tb = builders
    c_ref, c = clips[0][1], clips[1][1]
    out = tb.global_markers(c, T)
    assert out.shape == (T, 67 * 3)
    _close(out, jb.global_markers(c_ref, T))


def test_gt_eval_data_matches(builders, clips):
    jb, tb = builders
    c_ref, c = clips[0][2], clips[1][2]
    p_ref, tf_ref = jb.gt_eval_data(c_ref, T)
    p, tf = tb.gt_eval_data(c, T)
    assert p.dtype == p_ref.dtype and p.shape == (T, 169)
    np.testing.assert_array_equal(p, p_ref)
    _close(tf, tf_ref)


@pytest.mark.parametrize("mode", ["global_markers", "local_markers_4chan",
                                  "local_markers", "global_joints",
                                  "local_joints"])
def test_build_dataset_matches(builders, clips, mode):
    jb, tb = builders
    with_gt = mode == "local_markers_4chan"
    ref, aux_ref = j_amass.build_dataset(jb, clips[0], mode, with_gt=with_gt,
                                         smooth_forward=False)
    out, aux = t_amass.build_dataset(tb, clips[1], mode, with_gt=with_gt,
                                     smooth_forward=False)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    _close(out, ref)
    assert aux.keys() == aux_ref.keys()
    for k in aux:
        assert aux[k].dtype == aux_ref[k].dtype, k
        _close(aux[k], aux_ref[k])


@pytest.mark.parametrize("mode", ["global_markers", "local_markers",
                                  "local_markers_4chan"])
def test_stats_compute_save_load(tmp_path, mode):
    """The same images through both packages' compute/save give npz files
    with equal keys, dtypes and values; load reads either."""
    rng = np.random.RandomState(11)
    shape = {"global_markers": (5, T, 201), "local_markers": (5, T - 1, 211),
             "local_markers_4chan": (5, 4, T - 1, 208)}[mode]
    images = (rng.randn(*shape) * 0.3 + 0.1).astype(np.float32)
    p_ref, p_out = str(tmp_path / "ref.npz"), str(tmp_path / "out.npz")
    j_amass.compute_or_load_stats(images, mode, p_ref, "train")
    t_amass.compute_or_load_stats(images, mode, p_out, "train")
    with np.load(p_ref) as a, np.load(p_out) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    loaded = t_amass.compute_or_load_stats(None, mode, p_ref, "test")
    ref = j_amass.compute_or_load_stats(None, mode, p_ref, "test")
    x = rng.randn(*((2,) + shape[1:])).astype(np.float32)
    np.testing.assert_allclose(loaded.normalize(torch.as_tensor(x)).numpy(),
                               np.asarray(ref.normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    if mode == "local_markers":
        np.testing.assert_allclose(
            loaded.denormalize(torch.as_tensor(x)).numpy(),
            np.asarray(ref.denormalize(jnp.asarray(x))), rtol=1e-6,
            atol=1e-6)


def test_global_stats_denormalize_matches():
    rng = np.random.RandomState(12)
    clips = rng.randn(4, 30, 243).astype(np.float32)
    ref = j_stats.GlobalStats.compute(clips)
    out = t_stats.GlobalStats.compute(clips)
    x = rng.randn(2, 30, 243).astype(np.float32)
    np.testing.assert_allclose(out.denormalize(torch.as_tensor(x)).numpy(),
                               np.asarray(ref.denormalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sigma", [1.5, 20.0])
def test_gaussian_filter1d_nearest(axis, sigma):
    x = np.random.RandomState(13).randn(119, 3).astype(np.float32)
    out = t_signal.gaussian_filter1d_nearest(torch.as_tensor(x), sigma,
                                             axis=axis).numpy()
    ref = j_signal.gaussian_filter1d_nearest(jnp.asarray(x), sigma, axis=axis)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(out, scipy.ndimage.gaussian_filter1d(
        x.astype(np.float64), sigma, axis=axis, mode="nearest"), atol=1e-6)
    np.testing.assert_array_equal(t_signal.gaussian_kernel1d(sigma),
                                  j_signal.gaussian_kernel1d(sigma))


@pytest.mark.parametrize("smooth", [False, True])
def test_local_markers_flat_matches(smooth):
    rng = np.random.RandomState(14)
    pm = (rng.randn(1, 68, 3) * 0.3 + np.linspace(0, 1, 30)[:, None, None]
          * [0.4, 0.2, 0] + rng.randn(30, 68, 3) * 0.02).astype(np.float32)
    lbl = (rng.rand(30, 4) > 0.5).astype(np.float32)
    ref, piv_ref = j_repr.local_markers_flat(jnp.asarray(pm),
                                             jnp.asarray(lbl), smooth)
    out, piv = t_repr.local_markers_flat(torch.as_tensor(pm),
                                         torch.as_tensor(lbl), smooth)
    _close(out, ref)
    _close(piv, piv_ref)


def test_marker_tables_match(tmp_path):
    np.testing.assert_array_equal(t_markers.LEG_MASK_MARKER_SLOTS,
                                  j_markers.LEG_MASK_MARKER_SLOTS)
    np.testing.assert_array_equal(t_markers.FOOT_MARKER_SLOTS,
                                  j_markers.FOOT_MARKER_SLOTS)
    assert (t_markers.LEFT_HEEL, t_markers.RIGHT_HEEL, t_markers.LEFT_TOE,
            t_markers.RIGHT_TOE) == (j_markers.LEFT_HEEL,
                                     j_markers.RIGHT_HEEL,
                                     j_markers.LEFT_TOE, j_markers.RIGHT_TOE)
    t_synth.write_marker_jsons(str(tmp_path), 400)
    for name in ("SSM2.json", "SSM2_withhand.json"):
        path = str(tmp_path / name)
        for nv in (None, 300):
            np.testing.assert_array_equal(
                t_markers.marker_indices(markerset_json=path, num_verts=nv),
                j_markers.marker_indices(markerset_json=path, num_verts=nv))


@pytest.mark.parametrize("mode", ["local_markers_4chan", "local_markers"])
def test_infill_masks_match(mode):
    np.testing.assert_array_equal(t_infill.leg_mask_rows(208, mode),
                                  j_infill.leg_mask_rows(208, mode))
    out = t_infill.amass_input_mask(208, 119, mode)
    ref = j_infill.amass_input_mask(208, 119, mode)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            assert np.array_equal(x[k], y[k]), k


def test_synthetic_writers_match(tmp_path):
    """Same arrays (npz) and same bytes (json) as lemo_tpu's writers."""
    ref, out = tmp_path / "ref", tmp_path / "out"
    for mod, root in ((j_synth, ref), (t_synth, out)):
        mod.write_amass_dataset(str(root), "SFU", num_subjects=2,
                                seqs_per_subject=2, num_frames=300, fps=120,
                                seed=5)
        mod.write_smplx_model_dir(str(root / "models"), seed=7)
        mod.write_marker_jsons(str(root / "markers"), 536)
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(out) for p in out.rglob("*")
                           if p.is_file())
    assert len(files) == 4 + 3 + 2
    for rel in files:
        if rel.suffix == ".npz":
            _npz_equal(ref / rel, out / rel)
        else:
            assert (ref / rel).read_bytes() == (out / rel).read_bytes()
    assert json.loads((out / "markers" / "SSM2.json").read_text()) == \
        t_synth.synthetic_marker_set(536, 67)
    for seed in (0, 9):
        a = t_synth.synthetic_amass_npz(num_frames=50, seed=seed,
                                        gender="female")
        b = j_synth.synthetic_amass_npz(num_frames=50, seed=seed,
                                        gender="female")
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype


def test_builder_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None is valid here")
    models = {"male": t_synth.synthetic_smplx_npz(num_verts=400)}
    with pytest.raises(RuntimeError, match="CUDA"):
        t_amass.AmassRepresentationBuilder(models)


def test_builder_reads_model_dir(tmp_path, clips):
    """A model directory in the reference layout loads both genders."""
    t_synth.write_smplx_model_dir(str(tmp_path), seed=2)
    tb = t_amass.AmassRepresentationBuilder(str(tmp_path), device="cpu")
    assert sorted(tb.models) == ["female", "male"]
    assert all(m.config.flat_hand_mean and not m.config.use_pca
               for m in tb.models.values())
    img, _ = tb.local_markers_4chan(clips[1][0], T)
    assert img.shape == (4, T - 1, 208) and torch.isfinite(img).all()


def test_stats_roundtrip_shipped_asset(tmp_path):
    """The shipped infill statistics load, save and load again unchanged
    (at the fitters' float32)."""
    here = os.path.dirname(t_stats.__file__)
    path = os.path.join(here, "..", "assets", "infill_stats.npz")
    s = t_stats.Local4ChanStats.load(path, "cpu")
    s.save(str(tmp_path / "again.npz"))
    s2 = t_stats.Local4ChanStats.load(str(tmp_path / "again.npz"), "cpu")
    for f in ("Xmean_local", "Xstd_local"):
        assert torch.equal(getattr(s, f), getattr(s2, f))
    for f in ("Xmean_global_xy", "Xstd_global_xy", "Xmean_global_r",
              "Xstd_global_r"):
        assert getattr(s, f) == getattr(s2, f)
