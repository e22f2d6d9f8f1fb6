"""lemo_tpu_torch.ops.quaternions vs lemo_tpu.ops.quaternions: every
function (the five `data/repr.py` uses and the rest of the Holden
helpers) on the same seeded numpy inputs, values within 1e-6 (rad or
unit quaternion components) and, where differentiable, gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.ops import quaternions as JQ
from lemo_tpu_torch.ops import quaternions as TQ

torch.set_num_threads(2)


def _unit(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _inputs(name):
    rng = np.random.RandomState(17)
    q0, q1 = _unit(rng, 12), _unit(rng, 12)
    v0, v1 = rng.randn(12, 3).astype(np.float32), \
        rng.randn(12, 3).astype(np.float32)
    if name in ("qmul",):
        return q0, q1
    if name in ("qconj", "to_matrix", "pivot_from_quaternion",
                "to_euler_xyz", "to_euler_yzx"):
        return (q0,)
    if name == "qnormalize":
        return (q0 * rng.uniform(0.5, 2.0, (12, 1)).astype(np.float32),)
    if name == "qrot":
        return q0, v0
    if name == "from_angle_axis":
        return rng.uniform(-3, 3, 12).astype(np.float32), v0
    if name == "between":
        return v0, v1
    if name == "slerp":
        return q0, q1, rng.rand(12).astype(np.float32)
    if name == "from_matrix":
        return (np.array(JQ.to_matrix(jnp.asarray(q0))),)
    return ((rng.randn(12, 3) * 0.8).astype(np.float32),)   # from_euler


def _call(mod, name, *args):
    if name.startswith(("to_euler_", "from_euler_")):
        base, order = name.rsplit("_", 1)
        return getattr(mod, base)(*args, order=order)
    return getattr(mod, name)(*args)


NAMES = ["qmul", "qconj", "qnormalize", "qrot", "from_angle_axis",
         "between", "pivot_from_quaternion", "slerp", "to_matrix",
         "from_matrix", "to_euler_xyz", "to_euler_yzx", "from_euler_xyz",
         "from_euler_yzx"]


@pytest.mark.parametrize("name", NAMES)
def test_values_and_gradients_match(name):
    xs = _inputs(name)
    ref = np.asarray(_call(JQ, name, *map(jnp.asarray, xs)))
    xt = [torch.as_tensor(x).requires_grad_(True) for x in xs]
    out = _call(TQ, name, *xt)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    c = np.random.RandomState(3).randn(*ref.shape).astype(np.float32)
    g_ref = jax.grad(lambda *a: (_call(JQ, name, *a) * c).sum(),
                     argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    (out * torch.as_tensor(c)).sum().backward()
    for x, g in zip(xt, g_ref):
        g = np.asarray(g)
        assert np.isfinite(x.grad.numpy()).all()
        scale = max(np.abs(g).max(), 1.0)
        assert np.abs(x.grad.numpy() - g).max() / scale < 1e-5, name


def test_slerp_nearly_parallel_matches():
    """Nearly parallel (and opposite-signed) pairs take the normalized
    lerp branch in both packages. The value only: arccos has no finite
    derivative there, in either package."""
    rng = np.random.RandomState(4)
    q0 = _unit(rng, 6)
    q1 = q0 + 1e-8
    q1[3:] = -q1[3:]
    t = rng.rand(6).astype(np.float32)
    ref = np.asarray(JQ.slerp(*map(jnp.asarray, (q0, q1, t))))
    out = TQ.slerp(*map(torch.as_tensor, (q0, q1, t))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_qid_matches():
    ref = np.asarray(JQ.qid((2, 3)))
    out = TQ.qid((2, 3))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_between_antipodal_pole_is_nan_in_both():
    v = np.array([[1.0, 0.0, 0.0]], np.float32)
    ref = np.asarray(JQ.between(jnp.asarray(v), jnp.asarray(-v)))
    out = TQ.between(torch.as_tensor(v), torch.as_tensor(-v)).numpy()
    assert np.isnan(ref).all() and np.isnan(out).all()


def test_unknown_euler_order_raises():
    with pytest.raises(NotImplementedError):
        TQ.to_euler(torch.zeros(1, 4), order="zxy")
