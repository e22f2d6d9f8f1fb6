"""Kinematic chain: the port's plain twins (the CPU side of
lemo_tpu_torch.body_model.chain_cuda) vs lemo_tpu's level chain and its
Pallas chain kernel (interpret mode), on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import chain_pallas as JCP
from lemo_tpu.body_model import lbs as JL
from lemo_tpu.ops.rotations import aa_to_matrot
from lemo_tpu.testing.synthetic import SMPLX_PARENTS
from lemo_tpu_torch.body_model import chain_cuda as TC
from lemo_tpu_torch.body_model import lbs as TL

torch.set_num_threads(2)

PARENTS = SMPLX_PARENTS.copy()
PARENTS[0] = 0


def _inputs(B, seed):
    rng = np.random.RandomState(seed)
    J = len(PARENTS)
    R = np.asarray(aa_to_matrot(jnp.asarray(
        rng.randn(B, J, 3).astype(np.float32) * 0.5)))
    joints = rng.randn(B, J, 3).astype(np.float32)
    return R, joints


def _planes(B, seed):
    """Random chain planes [9|3, 56, B] and cotangents of the outputs."""
    rng = np.random.RandomState(seed)
    R, _ = _inputs(B, seed)
    rl = np.zeros((9, 56, B), np.float32)
    rl[:, :55] = R.transpose(2, 3, 1, 0).reshape(9, 55, B)
    tl = np.zeros((3, 56, B), np.float32)
    tl[:, :55] = rng.randn(3, 55, B) * 0.2
    drg = rng.randn(9, 56, B).astype(np.float32)
    dtg = rng.randn(3, 56, B).astype(np.float32)
    return rl, tl, drg, dtg


PARENTS_PADDED = tuple(int(p) for p in PARENTS) + (0,)


@pytest.mark.parametrize("reference", ["level", "pallas"])
@pytest.mark.parametrize("B", [1, 5])
def test_forward_matches_jax(B, reference):
    R, joints = _inputs(B, seed=B)
    jfn = (JL.rigid_transform_chain_level if reference == "level"
           else JCP.rigid_transform_chain_pallas)
    pj_ref, rel_ref = jfn(jnp.asarray(R), jnp.asarray(joints), PARENTS)
    pj, rel = TC.rigid_transform_chain_cuda(
        torch.as_tensor(R), torch.as_tensor(joints), PARENTS)
    np.testing.assert_allclose(pj.numpy(), np.asarray(pj_ref), atol=1e-5)
    np.testing.assert_allclose(rel.numpy(), np.asarray(rel_ref), atol=1e-5)


@pytest.mark.parametrize("B", [1, 5])
def test_level_chain_matches_jax(B):
    R, joints = _inputs(B, seed=10 + B)
    pj_ref, rel_ref = JL.rigid_transform_chain_level(
        jnp.asarray(R), jnp.asarray(joints), PARENTS)
    pj, rel = TL.rigid_transform_chain_level(
        torch.as_tensor(R), torch.as_tensor(joints), PARENTS)
    np.testing.assert_allclose(pj.numpy(), np.asarray(pj_ref), atol=1e-5)
    np.testing.assert_allclose(rel.numpy(), np.asarray(rel_ref), atol=1e-5)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("B", [1, 5])
def test_plain_backward_matches_autograd(B):
    rl, tl, drg, dtg = _planes(B, seed=20 + B)
    rl_t = torch.as_tensor(rl).requires_grad_(True)
    tl_t = torch.as_tensor(tl).requires_grad_(True)
    rg, tg = TC.chain_planes_plain_fwd(rl_t, tl_t, PARENTS_PADDED)
    ((rg * torch.as_tensor(drg)).sum()
     + (tg * torch.as_tensor(dtg)).sum()).backward()
    drl, dtl = TC.chain_planes_plain_bwd(
        torch.as_tensor(rl), torch.as_tensor(tl), rg.detach(),
        torch.as_tensor(drg), torch.as_tensor(dtg), PARENTS_PADDED)
    assert _rel(drl.numpy(), rl_t.grad.numpy()) < 1e-5
    assert _rel(dtl.numpy(), tl_t.grad.numpy()) < 1e-5


@pytest.mark.parametrize("B", [1, 5])
def test_plain_twins_match_pallas_custom_vjp(B):
    rl, tl, drg, dtg = _planes(B, seed=30 + B)
    Bp = 128
    pad = ((0, 0), (0, 0), (0, Bp - B))
    (rg_ref, tg_ref), vjp = jax.vjp(
        lambda a, b: JCP._chain_planes(a, b, PARENTS_PADDED),
        jnp.asarray(np.pad(rl, pad)), jnp.asarray(np.pad(tl, pad)))
    drl_ref, dtl_ref = vjp((jnp.asarray(np.pad(drg, pad)),
                            jnp.asarray(np.pad(dtg, pad))))
    rg, tg = TC.chain_planes_plain_fwd(torch.as_tensor(rl),
                                       torch.as_tensor(tl), PARENTS_PADDED)
    np.testing.assert_allclose(rg.numpy(), np.asarray(rg_ref)[..., :B],
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(tg_ref)[..., :B],
                               atol=1e-5)
    drl, dtl = TC.chain_planes_plain_bwd(
        torch.as_tensor(rl), torch.as_tensor(tl), rg,
        torch.as_tensor(drg), torch.as_tensor(dtg), PARENTS_PADDED)
    assert _rel(drl.numpy(), np.asarray(drl_ref)[..., :B]) < 1e-5
    assert _rel(dtl.numpy(), np.asarray(dtl_ref)[..., :B]) < 1e-5


def test_chain_function_gradients_match_jax():
    """Gradients through the autograd.Function (plain twins on the CPU)
    vs JAX's custom VJP through rigid_transform_chain_pallas."""
    R, joints = _inputs(3, seed=40)

    def jloss(r, j):
        pj, rel = JCP.rigid_transform_chain_pallas(r, j, PARENTS)
        return (rel ** 2).sum() + (pj * 0.3).sum()

    g_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(R),
                                            jnp.asarray(joints))
    r_t = torch.as_tensor(R).requires_grad_(True)
    j_t = torch.as_tensor(joints).requires_grad_(True)
    pj, rel = TC.rigid_transform_chain_cuda(r_t, j_t, PARENTS)
    ((rel ** 2).sum() + (pj * 0.3).sum()).backward()
    assert _rel(r_t.grad.numpy(), np.asarray(g_ref[0])) < 1e-5
    assert _rel(j_t.grad.numpy(), np.asarray(g_ref[1])) < 1e-5


def test_non_monotone_topology_falls_back():
    """A tree that numbers a parent after its child: the drop-in renumbers
    the joints into a topological order, runs the chain, and maps back."""
    parents = np.array([0, 2, 0, 1], np.int64)
    rng = np.random.RandomState(3)
    R = np.asarray(aa_to_matrot(jnp.asarray(
        rng.randn(2, 4, 3).astype(np.float32) * 0.3)))
    joints = rng.randn(2, 4, 3).astype(np.float32)
    pj_ref, rel_ref = JL.rigid_transform_chain_level(
        jnp.asarray(R), jnp.asarray(joints), parents)
    pj, rel = TC.rigid_transform_chain_cuda(
        torch.as_tensor(R), torch.as_tensor(joints), parents)
    np.testing.assert_allclose(pj.numpy(), np.asarray(pj_ref), atol=1e-5)
    np.testing.assert_allclose(rel.numpy(), np.asarray(rel_ref), atol=1e-5)


def test_non_monotone_topology_runs_the_chain_planes(monkeypatch):
    """The renumbered tree goes through the kernels' autograd.Function
    (its CPU twin here), not around it, and matches lemo_tpu's level chain
    on a 55-joint tree with its joints shuffled."""
    calls = []
    real = TC.chain_planes_plain_fwd
    monkeypatch.setattr(TC, "chain_planes_plain_fwd",
                        lambda *a: calls.append(a[2]) or real(*a))
    rng = np.random.RandomState(4)
    shuffle = np.concatenate([[0], 1 + rng.permutation(len(PARENTS) - 1)])
    pos = np.argsort(shuffle)
    parents = pos[PARENTS[shuffle]]
    parents[0] = 0
    assert not TC._topological(tuple(int(p) for p in parents))
    R, joints = _inputs(3, seed=70)
    pj_ref, rel_ref = JL.rigid_transform_chain_level(
        jnp.asarray(R), jnp.asarray(joints), parents)
    pj, rel = TC.rigid_transform_chain_cuda(
        torch.as_tensor(R), torch.as_tensor(joints), parents)
    assert len(calls) == 1
    assert all(p < j for j, p in enumerate(calls[0]) if j > 0)
    np.testing.assert_allclose(pj.numpy(), np.asarray(pj_ref), atol=1e-5)
    np.testing.assert_allclose(rel.numpy(), np.asarray(rel_ref), atol=1e-5)


def test_chain_planes_refuses_non_monotone_topology():
    """The planes entry (the fused path's) walks joints in index order: a
    tree whose parents are not numbered before their children raises
    instead of composing in the wrong order."""
    rl, tl, _, _ = _planes(2, seed=60)
    bad = (0, 2) + PARENTS_PADDED[2:]
    with pytest.raises(ValueError, match="parents"):
        TC.chain_planes(torch.as_tensor(rl), torch.as_tensor(tl), bad)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor handed to a kernel wrapper raises (the twins serve
    the CPU only through the autograd.Function's dispatch)."""
    rl, tl, _, _ = _planes(2, seed=50)
    with pytest.raises(ValueError, match="CUDA"):
        TC.chain_fwd_kernel(torch.as_tensor(rl), torch.as_tensor(tl),
                            PARENTS_PADDED)
