"""The port's marker occlusion masks (`utils/occlusion_mask.py`,
`cli/get_occlusion_mask.py`) against lemo_tpu's. The masks are compared
entry for entry. The pixel buckets are int32 truncations of
u / width * res, and lemo_tpu's jitted CPU code may contract the
projection into FMAs, so the unit cases run lemo_tpu op by op
(`jax.disable_jit`); the CLIs also differ by the body forward's rounding
(2e-6 m), so a differing entry must lie that close to a bucket edge or
to the margin."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.cli import get_occlusion_mask as j_cli
from lemo_tpu.testing.synthetic_prox import write_synthetic_prox_recording
from lemo_tpu.utils.occlusion_mask import marker_occlusion_mask as j_mask
from lemo_tpu_torch.cli import get_occlusion_mask as t_cli
from lemo_tpu_torch.utils.occlusion_mask import marker_occlusion_mask \
    as t_mask

torch.set_num_threads(2)

K = dict(fx=1000.0, fy=1000.0, cx=960.0, cy=540.0)


def test_scene_occludes_markers_behind_it():
    """tests/test_utils_misc.py's wall: markers in front of a wall of
    points at z = 2 visible, behind it occluded."""
    xs, ys = np.meshgrid(np.linspace(-1, 1, 300), np.linspace(-1, 1, 300))
    wall = np.stack([xs.ravel(), ys.ravel(),
                     np.full(xs.size, 2.0)], axis=1).astype(np.float32)
    markers = np.zeros((2, 67, 3), np.float32)
    markers[0, :, 2] = 1.0
    markers[1, :, 2] = 3.0
    markers[:, :, 0] = np.linspace(-0.3, 0.3, 67)
    mask = t_mask(torch.as_tensor(markers), torch.as_tensor(wall), **K)
    assert mask.shape == (2, 67) and mask.dtype == torch.float32
    assert mask[0].mean() > 0.9 and mask[1].mean() < 0.1
    with jax.disable_jit():
        ref = np.asarray(j_mask(jnp.asarray(markers), jnp.asarray(wall),
                                **K))
    np.testing.assert_array_equal(mask.numpy(), ref)


def test_no_scene_all_visible():
    markers = np.zeros((1, 67, 3), np.float32)
    markers[..., 2] = 1.5
    far = np.full((10, 3), 100.0, np.float32)
    mask = t_mask(torch.as_tensor(markers), torch.as_tensor(far), **K)
    assert (mask.numpy() == 1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scenes_match(seed):
    """Random clouds in and out of the image (behind the camera too) and
    markers among them: the same mask, with both values present."""
    rng = np.random.RandomState(seed)
    scene = (rng.rand(30000, 3) * [6, 4, 4] + [-3, -2, -0.5]).astype(
        np.float32)
    markers = (rng.rand(6, 67, 3) * [3, 2, 3] + [-1.5, -1, -0.2]).astype(
        np.float32)
    margin = float(rng.choice([0.05, 0.1, 0.3]))
    got = t_mask(torch.as_tensor(markers), torch.as_tensor(scene),
                 fx=1060.53, fy=1060.38, cx=951.30, cy=536.77, res=128,
                 margin=margin).numpy()
    with jax.disable_jit():
        ref = np.asarray(j_mask(jnp.asarray(markers), jnp.asarray(scene),
                                fx=1060.53, fy=1060.38, cx=951.30,
                                cy=536.77, res=128, margin=margin))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    root = tmp_path_factory.mktemp("occlusion")
    info = write_synthetic_prox_recording(str(root / "p"), num_frames=12,
                                          seed=3, write_depth=False)
    models = root / "models"
    models.mkdir()
    np.savez(models / "SMPLX_MALE.npz", **info["model_dict"])
    fitting = os.path.join(str(root / "p"), "PROXD", info["recording_name"])
    return root, info, str(models), fitting


def _flips_within(markers, scene_cam, ref, tol=2e-5):
    """Per marker-frame: whether moving the marker by at most `tol` m
    along x, y and z (the 27 corners and centres of that cube) gives the
    port's mask `ref`'s value there."""
    hit = np.zeros(ref.shape, bool)
    for dx in (-tol, 0.0, tol):
        for dy in (-tol, 0.0, tol):
            for dz in (-tol, 0.0, tol):
                m = markers + torch.tensor([dx, dy, dz])
                hit |= t_mask(m, scene_cam, fx=1060.53, fy=1060.38,
                              cx=951.30, cy=536.77).numpy() == ref
    return hit


@pytest.mark.parametrize("scene", ["sdf", "wall"])
def test_clis_match(recording, scene):
    """Both packages' CLIs on one recording's fitted pkls: with the SDF's
    zero-crossing points, and with a wall of points placed in front of
    the bodies' lower half (so that both values occur)."""
    root, info, models, fitting = recording
    argv = ["--fitting_dir", fitting, "--recording_dir",
            info["recording_dir"], "--model_folder", models]
    if scene == "wall":
        c = info["gt_body_centroid"]                      # camera coords
        xs, ys = np.meshgrid(np.arange(-1.5, 1.5, 0.004),
                             np.arange(c[:, 1].mean(), 1.5, 0.004))
        wall = np.stack([xs.ravel(), ys.ravel(),
                         np.full(xs.size, c[:, 2].min() - 0.4)], axis=1)
        pts = wall @ info["R_c2w"].T + info["t_c2w"]       # to the world
        np.save(root / "wall.npy", pts)
        argv += ["--scene_points", str(root / "wall.npy")]
    j_cli.main(argv + ["--out_dir", str(root / f"j_{scene}")])
    got = t_cli.main(argv + ["--out_dir", str(root / f"t_{scene}")],
                     device="cpu")
    ref = np.load(root / f"j_{scene}" / "mask_markers.npy")
    saved = np.load(root / f"t_{scene}" / "mask_markers.npy")
    np.testing.assert_array_equal(saved, got)
    assert got.shape == ref.shape == (12, 67) and got.dtype == np.float32
    if scene == "wall":
        assert 0 < got.mean() < 1
    diff = got != ref
    if diff.any():
        from lemo_tpu_torch.data.prox import ProxRecording

        rec = ProxRecording.from_recording_dir(info["recording_dir"])
        R, t = rec.load_cam2world()
        if scene == "wall":
            pts = np.load(root / "wall.npy")
        else:
            sdf, lo, hi, _ = rec.load_sdf()
            pts = t_cli.scene_points_from_sdf(sdf, lo, hi)
        scene_cam = torch.as_tensor((pts - t) @ R, dtype=torch.float32)
        markers, _ = t_cli.fitted_markers(fitting, models, "male", "cpu")
        assert _flips_within(markers, scene_cam, ref)[diff].all()
