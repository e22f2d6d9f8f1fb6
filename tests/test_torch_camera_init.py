"""Camera init in the port vs lemo_tpu (tests/test_api_parity.py's
TestCameraInit on both packages): `guess_init_depth` within rtol 1e-6,
`camera_init_loss` with and without the depth term, and
`fit_camera_init`'s final translation within 1e-4 of lemo_tpu's after
60 Adam steps on the 300-vertex synthetic SMPL-X, its loss falling."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import make_forward_fn as j_fwd
from lemo_tpu.fitting.prox import camera_init as j_ci
from lemo_tpu.fitting.prox.camera import PerspectiveCamera as JCamera
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.body_model import make_forward_fn as t_fwd
from lemo_tpu_torch.body_model.vertex_ids import smpl_to_openpose
from lemo_tpu_torch.fitting.prox import camera_init as t_ci
from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera as TCamera

torch.set_num_threads(2)


@pytest.mark.parametrize("focal", [1000.0, 5000.0])
def test_guess_init_depth_matches(focal):
    rng = np.random.RandomState(55)
    j3 = rng.randn(4, 25, 3).astype(np.float32)
    j2 = (rng.randn(4, 25, 2) * 100).astype(np.float32)
    ref = np.asarray(j_ci.guess_init_depth(jnp.asarray(j3), jnp.asarray(j2),
                                           focal))
    out = t_ci.guess_init_depth(torch.as_tensor(j3), torch.as_tensor(j2),
                                focal).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert (out[:, :2] == 0).all() and (out[:, 2] > 0).all()


def test_camera_init_loss_matches():
    rng = np.random.RandomState(4)
    proj = (rng.randn(3, 25, 2) * 50).astype(np.float32)
    gt = (rng.randn(3, 25, 2) * 50).astype(np.float32)
    transl = rng.randn(3, 3).astype(np.float32)
    est = rng.randn(3, 3).astype(np.float32)
    for e in (None, est):
        ref = j_ci.camera_init_loss(jnp.asarray(proj), jnp.asarray(gt),
                                    jnp.asarray(transl),
                                    None if e is None else jnp.asarray(e))
        out = t_ci.camera_init_loss(torch.as_tensor(proj),
                                    torch.as_tensor(gt),
                                    torch.as_tensor(transl),
                                    None if e is None else torch.as_tensor(e))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_fit_camera_init_matches_jax():
    md = synthetic_smplx_npz(num_verts=300, seed=6)
    mapper = smpl_to_openpose()
    jm = j_load(md, use_pca=True, num_pca_comps=12)
    tm = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    jcam = JCamera(1000.0, 1000.0, (960.0, 540.0))
    tcam = TCamera(1000.0, 1000.0, (960.0, 540.0))
    gt_transl = np.asarray([[0.1, 0.2, 2.5], [0.0, 0.3, 2.8]], np.float32)
    init_transl = np.asarray([[0.0, 0.0, 2.0], [0.0, 0.0, 2.0]], np.float32)

    gt = jm.zero_params(2)
    gt["transl"] = jnp.asarray(gt_transl)
    jf = j_fwd(jm)
    gt2d = jcam.project(jf(gt, jm.consts)["joints"][:, jnp.asarray(mapper)])
    init = jm.zero_params(2)
    init["transl"] = jnp.asarray(init_transl)
    ref, ref_losses = j_ci.fit_camera_init(jf, jm.consts, mapper, jcam, init,
                                           gt2d, num_steps=60, lr=0.05)

    init_t = tm.zero_params(2)
    init_t["transl"] = torch.as_tensor(init_transl)
    out, losses = t_ci.fit_camera_init(
        t_fwd(tm), tm.consts, mapper, tcam, init_t,
        torch.as_tensor(np.array(gt2d)), num_steps=60, lr=0.05)
    assert losses.shape == (60,)
    assert float(losses[-1]) < float(losses[0])
    np.testing.assert_allclose(losses[0].item(), float(ref_losses[0]),
                               rtol=1e-5)
    np.testing.assert_allclose(out["transl"].numpy(),
                               np.asarray(ref["transl"]), atol=1e-4)
    np.testing.assert_allclose(out["global_orient"].numpy(),
                               np.asarray(ref["global_orient"]), atol=1e-4)
    err = np.abs(out["transl"].numpy() - gt_transl)
    assert err.mean() < 0.3
