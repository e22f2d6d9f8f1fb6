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
