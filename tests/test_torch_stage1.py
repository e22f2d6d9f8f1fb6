"""AMASS Stage 1 in the port vs lemo_tpu on the 400-vertex setup: the
loss on shared inputs, the parallel fit (T=8, 150 steps) and the
sequential warm-started chain (T=3, 20 steps) by final loss and marker
error against the synthetic ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import make_forward_fn as j_fwd
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.data.markers import marker_indices
from lemo_tpu.fitting import amass_perframe as j_s1
from lemo_tpu.fitting import params as j_P
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.body_model import make_forward_fn as t_fwd
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting import amass_perframe as t_s1
from lemo_tpu_torch.fitting import params as t_P

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    md = synthetic_smplx_npz(num_verts=400, seed=4)
    jm = j_load(md, use_pca=True, num_pca_comps=12)
    tm = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    vpp_j = {k: np.asarray(v) for k, v in
             j_vp.init_vposer(jax.random.PRNGKey(0)).items()}
    ids = marker_indices(False, num_verts=400)
    return jm, tm, vpp_j, from_numpy_tree(vpp_j, "cpu"), ids


def _gt(jm, vpp_j, ids, T, seed):
    """Ground-truth rows and their markers through lemo_tpu's stack."""
    rng = np.random.RandomState(seed)
    gt72 = np.zeros((T, 72), np.float32)
    gt72[:, 0:3] = rng.randn(T, 3) * 0.1 + [0, 0.4, 1.0]
    gt72[:, 3:6] = [0, 1.6, 3.14]
    gt72[:, 6:16] = rng.randn(10) * 0.3
    gt72[:, 16:48] = rng.randn(T, 32) * 0.5
    gt72[:, 48:] = rng.randn(T, 24) * 0.2
    sp = j_P.smplx_params_from_72(jnp.asarray(gt72), vpp_j)
    markers = j_fwd(jm)(sp, jm.consts)["vertices"][:, jnp.asarray(ids), :]
    return gt72, np.array(markers)


def _marker_err(tm, vpp_t, ids, x72, target):
    sp = t_P.smplx_params_from_72(torch.as_tensor(np.array(x72)), vpp_t)
    with torch.no_grad():
        m = t_fwd(tm)(sp, tm.consts)["vertices"][:, torch.as_tensor(ids)]
    return float((m - torch.as_tensor(target)).abs().mean())


def test_default_init_matches():
    ref = j_s1.default_init(5)
    out = t_s1.default_init(5)
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)


def test_stage1_loss_matches(setup):
    jm, tm, vpp_j, vpp_t, ids = setup
    rng = np.random.RandomState(5)
    T = 6
    v = {"transl": rng.randn(T, 3) * 0.1, "rot6d": rng.randn(T, 6),
         "other": rng.randn(T, 56) * 0.3}
    v = {k: x.astype(np.float32) for k, x in v.items()}
    shape10 = np.tile(rng.randn(10).astype(np.float32) * 0.3, (T, 1))
    target = (rng.randn(T, 67, 3) * 0.3 + [0, 0.4, 1.0]).astype(np.float32)
    w = j_s1.Stage1Weights(1.0, 0.05, 0.02, 0.03)
    ref = j_s1.make_stage1_loss(jm, vpp_j, ids, w)(
        {k: jnp.asarray(x) for k, x in v.items()}, jnp.asarray(shape10),
        jnp.asarray(target))
    out = t_s1.make_stage1_loss(tm, vpp_t, ids, t_s1.Stage1Weights(
        1.0, 0.05, 0.02, 0.03))(
        {k: torch.as_tensor(x) for k, x in v.items()},
        torch.as_tensor(shape10), torch.as_tensor(target))
    assert abs(float(out) - float(ref)) / abs(float(ref)) < 1e-5


def test_parallel_fit_matches(setup):
    """T=8, 150 steps: both packages recover the ground-truth markers and
    end at the same loss."""
    jm, tm, vpp_j, vpp_t, ids = setup
    gt72, target = _gt(jm, vpp_j, ids, 8, seed=9)
    beta = gt72[0, 6:16]
    x_ref, l_ref = j_s1.fit_clip(jm, vpp_j, ids, jnp.asarray(target),
                                 jnp.asarray(beta), mode="parallel",
                                 num_steps=150)
    x, losses = t_s1.fit_clip(tm, vpp_t, ids, target, beta, mode="parallel",
                              num_steps=150, device="cpu")
    assert x.shape == (8, 72) and losses.shape == (150,)
    l_ref = np.asarray(l_ref)
    assert float(losses[-1]) < float(losses[0]) * 0.2
    # lr 0.1 on an L1 loss: the two trajectories agree step by step until
    # f32 rounding tips an L1 sign (~step 12), then only statistically
    np.testing.assert_allclose(losses[:10].numpy(), l_ref[:10], rtol=1e-3)
    assert abs(float(losses[-1]) - l_ref[-1]) < 0.1 * l_ref[-1]
    err = _marker_err(tm, vpp_t, ids, x, target)
    err_ref = _marker_err(tm, vpp_t, ids, x_ref, target)
    assert err < 0.05 and abs(err - err_ref) < 0.2 * err_ref, (err, err_ref)
    np.testing.assert_array_equal(x[:, 6:16].numpy(),
                                  np.tile(beta, (8, 1)))


def test_sequential_fit_matches(setup):
    """T=3, 20 steps a frame, each frame warm-started from the last."""
    jm, tm, vpp_j, vpp_t, ids = setup
    gt72, target = _gt(jm, vpp_j, ids, 3, seed=10)
    beta = gt72[0, 6:16]
    x_ref, l_ref = j_s1.fit_clip(jm, vpp_j, ids, jnp.asarray(target),
                                 jnp.asarray(beta), mode="sequential",
                                 num_steps=20)
    x, last = t_s1.fit_clip(tm, vpp_t, ids, target, beta, mode="sequential",
                            num_steps=20, device="cpu")
    assert x.shape == (3, 72) and last.shape == (3,)
    np.testing.assert_allclose(last.numpy(), np.asarray(l_ref), rtol=2e-3)
    # held by each frame's final loss and the marker error: lr 0.1 on an
    # L1 loss lets rounding tip a few parameters' paths (2 of 216 moved
    # by up to 2.3e-3) without moving the fit
    err = _marker_err(tm, vpp_t, ids, x, target)
    err_ref = _marker_err(tm, vpp_t, ids, x_ref, target)
    assert abs(err - err_ref) < 1e-3 * max(err_ref, 1.0), (err, err_ref)


def test_fused_path_fit_matches_separate(setup):
    """The fused body-model path (on the CPU its kernels' plain twins)
    gives the parallel fit of the separate-matmul path."""
    jm, tm, vpp_j, vpp_t, ids = setup
    _, target = _gt(jm, vpp_j, ids, 4, seed=11)
    fused = t_load(synthetic_smplx_npz(num_verts=400, seed=4), use_pca=True,
                   num_pca_comps=12, build_fused=True, device="cpu")
    beta = np.zeros(10, np.float32)
    x_s, l_s = t_s1.make_stage1_fitter(tm, vpp_t, ids, 30, device="cpu")(
        target, beta)
    x_f, l_f = t_s1.make_stage1_fitter(fused, vpp_t, ids, 30,
                                       device="cpu")(target, beta)
    # two forms of one fit, at lemo_tpu's tolerances for that
    # (tests/test_fitting_stage2.py:165-170)
    np.testing.assert_allclose(l_f.numpy(), l_s.numpy(), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(x_f.numpy(), x_s.numpy(), rtol=6e-2,
                               atol=2e-3)


def test_fitter_without_device_needs_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None is valid here")
    _, tm, _, vpp_t, ids = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        t_s1.make_stage1_fitter(tm, vpp_t, ids)
    with pytest.raises(ValueError):
        t_s1.fit_clip(tm, vpp_t, ids, np.zeros((2, 67, 3)), np.zeros(10),
                      mode="other", device="cpu")
