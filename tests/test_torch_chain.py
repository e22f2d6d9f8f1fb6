"""Kinematic chain: the port's plain twins (the CPU side of
lemo_tpu_torch.body_model.chain_cuda) vs lemo_tpu's level chain and its
Pallas chain kernel (interpret mode), on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lemo_tpu.body_model as JBM
import lemo_tpu.testing.synthetic as JSYN
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


# --- the level schedule the kernels walk -----------------------------------

def _renumbered_shuffle():
    """The 55-joint tree with its joints shuffled (a parent numbered after
    its child), renumbered as rigid_transform_chain_cuda renumbers it."""
    rng = np.random.RandomState(4)
    shuffle = np.concatenate([[0], 1 + rng.permutation(len(PARENTS) - 1)])
    parents = np.argsort(shuffle)[PARENTS[shuffle]]
    parents[0] = 0
    par = tuple(int(p) for p in parents)
    order = TC._topological_order(par)
    pos = {j: k for k, j in enumerate(order)}
    return tuple([0] + [pos[par[j]] for j in order[1:]])


TREES = {"smplx": PARENTS_PADDED,
         "smpl": tuple(int(p) for p in JSYN.SMPL_PARENTS[:24]),
         "renumbered": _renumbered_shuffle()}


@pytest.mark.parametrize("tree", list(TREES))
def test_schedule_walks_each_joint_once_after_its_parent(tree):
    """Every joint on exactly one level, the root alone on the first, each
    joint one level below its parent; each parent's children listed once,
    in decreasing index."""
    parents = (0,) + TREES[tree][1:]
    sched = TC.chain_schedule(parents)
    flat = [j for lv in sched.levels for j in lv]
    assert sorted(flat) == list(range(len(parents)))
    assert sched.levels[0] == (0,)
    level_of = {j: d for d, lv in enumerate(sched.levels) for j in lv}
    for j in range(1, len(parents)):
        assert level_of[j] == level_of[parents[j]] + 1
    for p, kids in enumerate(sched.children):
        assert list(kids) == sorted(kids, reverse=True)
        assert set(kids) == {c for c in range(1, len(parents))
                             if parents[c] == p}
    packed, nlev = TC._schedule_on(parents, "cpu")
    assert nlev == len(sched.levels)
    assert packed.numel() == 4 * len(parents) + nlev + 1


def test_schedule_refuses_trees_past_the_kernels_limits():
    deep = tuple([0] + list(range(TC.MAX_LEVELS)))          # one long chain
    with pytest.raises(ValueError, match="levels"):
        TC._schedule_on(deep, "cpu")
    wide = (0,) * (TC.MAX_JOINTS + 8)
    with pytest.raises(ValueError, match="joints"):
        TC._schedule_on(wide, "cpu")


# --- the affine form: chain + rel-joint translations + bone affines ---------

@pytest.fixture(scope="module")
def jax_model():
    return JBM.load_model(JSYN.synthetic_smplx_npz(), use_pca=True,
                          num_pca_comps=12, build_fused=True)


def _jax_affine(rl, jr, parents):
    """lemo_tpu/body_model/lbs.py:_lbs_fused's composition around its
    Pallas chain (interpret mode on the CPU), as a function of (rl, jr)."""
    J, Jp = len(parents), rl.shape[1]
    msub = np.eye(Jp, dtype=np.float32)
    for j in range(1, J):
        msub[j, int(parents[j])] -= 1.0
    tl = jnp.einsum("jp,npb->njb", jnp.asarray(msub), jr,
                    precision=jax.lax.Precision.HIGHEST)
    rg, tg = JCP._chain_planes(rl, tl, tuple(int(p) for p in parents)
                               + (0,) * (Jp - J))
    rel_t = jnp.stack([tg[m] - (rg[3 * m] * jr[0] + rg[3 * m + 1] * jr[1]
                                + rg[3 * m + 2] * jr[2]) for m in range(3)])
    return jnp.concatenate([rg, rel_t], axis=0), tg


def _lbs_fused_capture(jm, B, seed, monkeypatch):
    """lemo_tpu's `_lbs_fused` on random shape and pose: its rotation
    planes, rest-pose joint planes, bone affines and posed joints."""
    from lemo_tpu.body_model import vertex_pallas as JVP

    fc = jm.consts
    rng = np.random.RandomState(seed)
    J = fc["j_ext"].shape[0] // 3
    S = fc["j_ext"].shape[1] - 1
    shape = (rng.randn(B, S) * 0.5).astype(np.float32)
    pose = (rng.randn(B, 3 * J) * 0.4).astype(np.float32)
    seen = {}
    real_chain, real_vertex = JCP._chain_planes, JVP.fused_lbs_vertices_planes

    def chain_spy(rl, tl, parents):
        seen["rl"] = rl
        return real_chain(rl, tl, parents)

    def vertex_spy(catT, A_pl, *rest):
        seen["A"] = A_pl
        return real_vertex(catT, A_pl, *rest)

    monkeypatch.setattr(JCP, "_chain_planes", chain_spy)
    monkeypatch.setattr(JVP, "fused_lbs_vertices_planes", vertex_spy)
    _, posed = JL._lbs_fused(jnp.asarray(shape), jnp.asarray(pose),
                             jm.parents, fc, fc["lbs_w_pad"].shape[0])
    # the rest-pose joint planes, as _lbs_fused forms them
    Bp, Jp = seen["rl"].shape[2], seen["rl"].shape[1]
    cat_s = jnp.concatenate([jnp.pad(jnp.asarray(shape).T,
                                     ((0, 0), (0, Bp - B))),
                             jnp.ones((1, Bp), jnp.float32)])
    jr = jnp.matmul(fc["j_ext"], cat_s, precision=jax.lax.Precision.HIGHEST)
    jr = jnp.pad(jr.reshape(3, J, Bp), ((0, 0), (0, Jp - J), (0, 0)))
    return (np.asarray(seen["rl"]), np.asarray(jr), np.asarray(seen["A"]),
            np.asarray(posed))


@pytest.mark.parametrize("B", [1, 5])
def test_affine_plain_matches_jax_lbs_fused(jax_model, B, monkeypatch):
    """The affine form's plain twin (the CPU path of chain_affine_planes)
    against the bone affines and posed joints of lemo_tpu's _lbs_fused,
    on the planes it formed."""
    rl, jr, A_ref, posed_ref = _lbs_fused_capture(jax_model, B, 80 + B,
                                                  monkeypatch)
    parents = tuple(int(p) for p in jax_model.parents)
    J = len(parents)
    A, tg = TC.chain_affine_planes(torch.as_tensor(rl), torch.as_tensor(jr),
                                   parents)
    np.testing.assert_allclose(A.numpy(), A_ref, atol=1e-5)
    np.testing.assert_allclose(tg[:, :J, :B].permute(2, 1, 0).numpy(),
                               posed_ref, atol=1e-5)
    # the test's own composition is _lbs_fused's, to the bit
    A_j, _ = _jax_affine(jnp.asarray(rl), jnp.asarray(jr), parents)
    np.testing.assert_array_equal(np.asarray(A_j), A_ref)


@pytest.mark.parametrize("B", [1, 5])
def test_affine_gradients_match_jax(jax_model, B, monkeypatch):
    """Gradients through chain_affine_planes (its plain twin on the CPU,
    differentiated by autograd) against JAX's VJP of the same composition
    around the Pallas chain's custom VJP."""
    rl, jr, _, _ = _lbs_fused_capture(jax_model, B, 90 + B, monkeypatch)
    parents = tuple(int(p) for p in jax_model.parents)
    rng = np.random.RandomState(B)
    dA = rng.randn(12, *rl.shape[1:]).astype(np.float32)
    dtg = rng.randn(3, *rl.shape[1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: _jax_affine(a, b, parents),
                     jnp.asarray(rl), jnp.asarray(jr))
    drl_ref, djr_ref = vjp((jnp.asarray(dA), jnp.asarray(dtg)))
    rl_t = torch.as_tensor(rl).requires_grad_(True)
    jr_t = torch.as_tensor(jr).requires_grad_(True)
    A, tg = TC.chain_affine_planes(rl_t, jr_t, parents)
    ((A * torch.as_tensor(dA)).sum()
     + (tg * torch.as_tensor(dtg)).sum()).backward()
    assert _rel(rl_t.grad.numpy(), np.asarray(drl_ref)) < 1e-5
    assert _rel(jr_t.grad.numpy(), np.asarray(djr_ref)) < 1e-5


def test_affine_unfused_composition_is_the_plain_twin_on_cpu():
    """On the CPU the eager composition around chain_planes (what the card
    checks the affine kernels against, bit for bit) is the plain twin."""
    rl, tl, _, _ = _planes(3, seed=61)
    jr = torch.as_tensor(tl)
    parents = tuple(int(p) for p in PARENTS)
    A, tg = TC.chain_affine_planes_unfused(torch.as_tensor(rl), jr, parents)
    A_p, tg_p = TC.chain_affine_plain_fwd(torch.as_tensor(rl), jr, parents)
    assert torch.equal(A, A_p) and torch.equal(tg, tg_p)


def test_affine_kernel_wrappers_refuse_cpu_tensors():
    rl, tl, _, _ = _planes(2, seed=51)
    parents = tuple(int(p) for p in PARENTS)
    with pytest.raises(ValueError, match="CUDA"):
        TC.chain_affine_fwd_kernel(torch.as_tensor(rl), torch.as_tensor(tl),
                                   parents)
