"""The port's BodyModel API (human_body_prior naming, the VPoser variant)
and `lbs(pose2rot=False)` against lemo_tpu's on the 300-vertex synthetic
SMPL-X, with the same numpy inputs: forwards at the body model's 2e-6,
gradients rel 5e-5 (tests/test_torch_body_model.py's tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lemo_tpu.body_model.lbs as j_lbs
from lemo_tpu.body_model import body_model_api as J
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.ops.rotations import aa_to_matrot as j_aa_to_matrot
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.body_model import body_model_api as T
from lemo_tpu_torch.body_model import lbs as t_lbs
from lemo_tpu_torch.body_model import vposer as t_vp
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.ops.rotations import aa_to_matrot as t_aa_to_matrot

torch.set_num_threads(2)

MD = synthetic_smplx_npz(num_verts=300)
PATHS = ["separate", "fused"]


def _named(B, seed):
    rng = np.random.RandomState(seed)

    def r(n, s):
        return (rng.randn(B, n) * s).astype(np.float32)

    return {"trans": r(3, 1.0), "root_orient": r(3, 0.5),
            "pose_body": r(63, 0.4), "pose_hand": r(90, 0.3),
            "pose_jaw": r(3, 0.2), "pose_eye": r(6, 0.2),
            "betas": r(10, 0.5), "expression": r(10, 0.5)}


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.fixture(scope="module")
def vposer():
    jp = j_vp.init_vposer(jax.random.PRNGKey(0))
    return jp, from_numpy_tree({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


@pytest.mark.parametrize("use_posedirs", [True, False])
@pytest.mark.parametrize("path", PATHS)
def test_forward_matches(path, use_posedirs):
    """Named parameters through both packages' BodyModel; without pose
    blend shapes the port's fused path runs on a zeroed pose block."""
    jb = J.BodyModel(MD, use_posedirs=use_posedirs)
    tb = T.BodyModel(MD, use_posedirs=use_posedirs,
                     build_fused=(path == "fused"), device="cpu")
    p = _named(4, seed=3)
    ref = jb(**{k: jnp.asarray(v) for k, v in p.items()})
    out = tb(**{k: torch.as_tensor(v) for k, v in p.items()})
    np.testing.assert_array_equal(out.f, np.asarray(ref.f))
    for key in ("v", "Jtr", "full_pose"):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   np.asarray(getattr(ref, key)), atol=2e-6,
                                   err_msg=key)


def test_defaults_fill_missing_parameters():
    """Only `pose_body` given: the batch comes from it, the rest is zero,
    as in lemo_tpu's."""
    p = _named(2, seed=5)["pose_body"]
    ref = J.BodyModel(MD, batch_size=7)(pose_body=jnp.asarray(p))
    out = T.BodyModel(MD, batch_size=7, device="cpu")(
        pose_body=torch.as_tensor(p))
    assert out.v.shape == (2, 300, 3)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), atol=2e-6)


@pytest.mark.parametrize("path", PATHS)
def test_vposer_variant_matches(vposer, path):
    """`poZ_body` decoded by each package's VPoser from the same weights
    (the decode agrees within 1e-5 rad, so the vertices within 1e-5)."""
    jp, tp = vposer
    p = _named(3, seed=7)
    p.pop("pose_body")
    z = (np.random.RandomState(8).randn(3, 32) * 0.8).astype(np.float32)
    ref = J.BodyModelWithPoser(MD, vposer_params=jp)(
        poZ_body=jnp.asarray(z), **{k: jnp.asarray(v) for k, v in p.items()})
    out = T.BodyModelWithPoser(MD, vposer_params=tp,
                               build_fused=(path == "fused"), device="cpu")(
        poZ_body=torch.as_tensor(z),
        **{k: torch.as_tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), atol=1e-5)
    np.testing.assert_allclose(out.full_pose.numpy(),
                               np.asarray(ref.full_pose), atol=1e-5)


def test_vposer_default_weights_are_seeded():
    tb = T.BodyModelWithPoser(MD, device="cpu")
    ref = t_vp.init_vposer(torch.Generator().manual_seed(0))
    assert tb.vposer_params.keys() == ref.keys()
    for k in ref:
        assert torch.equal(tb.vposer_params[k], ref[k]), k


@pytest.mark.parametrize("path", PATHS)
def test_gradients_match(path):
    """d/d(pose_body, betas) of a seeded weighted sum of v."""
    p = _named(3, seed=11)
    w = np.random.RandomState(12).randn(3, 300, 3).astype(np.float32)
    jb = J.BodyModel(MD)

    def jloss(pose_body, betas):
        q = {k: jnp.asarray(v) for k, v in p.items()}
        q.update(pose_body=pose_body, betas=betas)
        return (jb(**q).v * w).sum()

    g_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(p["pose_body"]),
                                            jnp.asarray(p["betas"]))
    tb = T.BodyModel(MD, build_fused=(path == "fused"), device="cpu")
    q = {k: torch.as_tensor(v).requires_grad_(k in ("pose_body", "betas"))
         for k, v in p.items()}
    (tb(**q).v * torch.as_tensor(w)).sum().backward()
    for name, g in zip(("pose_body", "betas"), g_ref):
        assert _rel(q[name].grad.numpy(), np.asarray(g)) < 5e-5, name


def _lbs_case(seed=4, B=3):
    tb = T.BodyModel(MD, device="cpu")
    tf = T.BodyModel(MD, build_fused=True, device="cpu")
    rng = np.random.RandomState(seed)
    shape = (rng.randn(B, 20) * 0.5).astype(np.float32)
    aa = (rng.randn(B, 55, 3) * 0.4).astype(np.float32)
    return tb.model, tf.model, shape, aa


def _t_lbs(model, shape, pose, pose2rot):
    c = model.consts
    fc = ({k: c[k] for k in ("fused_dirs", "lbs_w_pad", "j_ext")}
          if "fused_dirs" in c else None)
    return t_lbs.lbs(shape, pose, c["v_template"], c["shapedirs_flat"],
                     c.get("posedirs"), c["J_regressor"], model.parents,
                     c["lbs_weights"], pose2rot=pose2rot, fused_consts=fc)


@pytest.mark.parametrize("path", PATHS)
def test_lbs_pose2rot_false_matches(path):
    """Rotation matrices in: the vertices and joints, and the VJP with
    respect to the matrices and the shape components, against
    lemo_tpu's `lbs(pose2rot=False)` (its separate-matmul path)."""
    sep, fused, shape, aa = _lbs_case()
    model = fused if path == "fused" else sep
    mats = np.array(j_aa_to_matrot(jnp.asarray(aa))).reshape(3, -1)
    c = {k: jnp.asarray(v.numpy()) for k, v in sep.consts.items()}
    cot = np.random.RandomState(6).randn(3, 300, 3).astype(np.float32)

    def jfwd(s, m):
        return j_lbs.lbs(s, m, c["v_template"], c["shapedirs_flat"],
                         c["posedirs"], c["J_regressor"], sep.parents,
                         c["lbs_weights"], pose2rot=False)

    old = j_lbs.LBS_IMPL
    j_lbs.LBS_IMPL = "xla"
    try:
        (jv, jj), vjp = jax.vjp(jfwd, jnp.asarray(shape), jnp.asarray(mats))
        g_shape, g_mats = vjp((jnp.asarray(cot), jnp.zeros_like(jj)))
    finally:
        j_lbs.LBS_IMPL = old
    s_t = torch.as_tensor(shape).requires_grad_(True)
    m_t = torch.as_tensor(mats).requires_grad_(True)
    v, jt = _t_lbs(model, s_t, m_t, pose2rot=False)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=2e-6)
    np.testing.assert_allclose(jt.detach().numpy(), np.asarray(jj),
                               atol=2e-6)
    (v * torch.as_tensor(cot)).sum().backward()
    assert _rel(m_t.grad.numpy(), np.asarray(g_mats)) < 5e-5
    assert _rel(s_t.grad.numpy(), np.asarray(g_shape)) < 5e-5


def test_fused_pose2rot_false_matches_pose2rot_true():
    """The fused path's plain versions: matrices from `aa_to_matrot` give
    the vertices of the axis-angle input (the two round differently, so
    by tolerance), and the gradient with respect to the matrices is the
    separate path's."""
    sep, fused, shape, aa = _lbs_case(seed=9, B=5)
    s = torch.as_tensor(shape)
    v_aa, j_aa = _t_lbs(fused, s, torch.as_tensor(aa).reshape(5, -1), True)
    m = t_aa_to_matrot(torch.as_tensor(aa)).reshape(5, -1)
    v_m, j_m = _t_lbs(fused, s, m, False)
    np.testing.assert_allclose(v_m.numpy(), v_aa.numpy(), atol=1e-5)
    np.testing.assert_allclose(j_m.numpy(), j_aa.numpy(), atol=1e-5)
    cot = torch.as_tensor(np.random.RandomState(2).randn(5, 300, 3)
                          .astype(np.float32))
    grads = []
    for model in (fused, sep):
        mt = m.clone().requires_grad_(True)
        (_t_lbs(model, s, mt, False)[0] * cot).sum().backward()
        grads.append(mt.grad.numpy())
    assert _rel(grads[0], grads[1]) < 5e-5
