"""lemo_tpu_torch.ops.rotations vs lemo_tpu.ops.rotations: values and
gradients on the same numpy inputs (random, at the identity and at pi)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.ops import rotations as JR
from lemo_tpu_torch.ops import rotations as TR

torch.set_num_threads(2)

RNG = np.random.RandomState(21)


def _aa_inputs(kind):
    if kind == "random":
        return (RNG.randn(16, 3) * 0.8).astype(np.float32)
    if kind == "identity":
        return np.zeros((4, 3), np.float32)
    # rotations by pi (just below, so the two packages agree on the sign
    # of the ambiguous axis) about the coordinate axes and a random axis
    ax = np.concatenate([np.eye(3), RNG.randn(1, 3)])
    ax = ax / np.linalg.norm(ax, axis=1, keepdims=True)
    return (ax * (np.pi - 1e-3)).astype(np.float32)


def _input(fn_name, kind):
    aa = _aa_inputs(kind)
    if fn_name in ("aa_to_matrot", "aa_to_rot6d"):
        return aa
    if fn_name == "aa_to_matrot_planes":
        return aa.T.reshape(3, 1, -1).copy()
    R = np.asarray(JR.aa_to_matrot(jnp.asarray(aa)))
    if fn_name in ("matrot_to_quat", "matrot_to_aa", "matrot_to_rot6d"):
        return R
    if fn_name == "quat_to_aa":
        return np.asarray(JR.matrot_to_quat(jnp.asarray(R)))
    six = np.asarray(JR.matrot_to_rot6d(jnp.asarray(R)))
    # perturb the 6-D input off the manifold: Gram-Schmidt must cope
    return (six + RNG.randn(*six.shape).astype(np.float32) * 0.05
            if kind == "random" else six)


FNS = ["aa_to_matrot", "aa_to_matrot_planes", "matrot_to_quat",
       "quat_to_aa", "matrot_to_aa", "rot6d_to_matrot", "matrot_to_rot6d",
       "aa_to_rot6d", "rot6d_to_aa"]
KINDS = ["random", "identity", "pi"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn_name", FNS)
def test_values_match(fn_name, kind):
    x = _input(fn_name, kind)
    ref = np.asarray(getattr(JR, fn_name)(jnp.asarray(x)))
    out = getattr(TR, fn_name)(torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn_name", FNS)
def test_gradients_match(fn_name, kind):
    x = _input(fn_name, kind)
    out_shape = np.asarray(getattr(JR, fn_name)(jnp.asarray(x))).shape
    c = np.random.RandomState(5).randn(*out_shape).astype(np.float32)

    g_ref = np.asarray(jax.grad(
        lambda a: (getattr(JR, fn_name)(a) * c).sum())(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    (getattr(TR, fn_name)(xt) * torch.as_tensor(c)).sum().backward()
    g = xt.grad.numpy()
    assert np.isfinite(g).all()
    scale = max(np.abs(g_ref).max(), 1.0)
    assert np.abs(g - g_ref).max() / scale < 1e-5, np.abs(g - g_ref).max()


def _leftover_inputs(fn_name):
    rng = np.random.RandomState(31)
    if fn_name == "transform_mat":
        R = np.asarray(JR.aa_to_matrot(jnp.asarray(
            rng.randn(2, 4, 3).astype(np.float32))))
        return R, rng.randn(2, 4, 3).astype(np.float32)
    if fn_name == "pack_params_6d":
        return ((rng.randn(6, 72) * 0.5).astype(np.float32),)
    if fn_name == "unpack_params_6d":
        x72 = (rng.randn(6, 72) * 0.5).astype(np.float32)
        return (np.asarray(JR.pack_params_6d(jnp.asarray(x72))),)
    if fn_name == "rotate_by_matrix":
        R = np.asarray(JR.aa_to_matrot(jnp.asarray(
            rng.randn(3).astype(np.float32))))
        return rng.randn(5, 7, 3).astype(np.float32), R
    return ((rng.randn(3, 5, 3) * 0.8).astype(np.float32),)


LEFTOVERS = ["transform_mat", "pack_params_6d", "unpack_params_6d",
             "rotate_by_matrix", "batched_aa_to_matrot"]


@pytest.mark.parametrize("fn_name", LEFTOVERS)
def test_leftovers_match(fn_name):
    """The helpers no fit path calls (transform_mat, the 6-D packing of
    [T, 72] rows, rotate_by_matrix, the batched Rodrigues): values and
    the gradient of every input."""
    xs = _leftover_inputs(fn_name)
    ref = np.asarray(getattr(JR, fn_name)(*map(jnp.asarray, xs)))
    xt = [torch.as_tensor(x).requires_grad_(True) for x in xs]
    out = getattr(TR, fn_name)(*xt)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    c = np.random.RandomState(7).randn(*ref.shape).astype(np.float32)
    g_ref = jax.grad(lambda *a: (getattr(JR, fn_name)(*a) * c).sum(),
                     argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    (out * torch.as_tensor(c)).sum().backward()
    for x, g in zip(xt, g_ref):
        scale = max(np.abs(np.asarray(g)).max(), 1.0)
        assert np.abs(x.grad.numpy() - np.asarray(g)).max() / scale < 1e-5
